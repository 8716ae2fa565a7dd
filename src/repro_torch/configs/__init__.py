"""Architecture configs (copies of the JAX package's dataclasses)."""
