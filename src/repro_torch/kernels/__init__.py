"""Hand-written Hopper kernels, their plain versions and launch counts."""
