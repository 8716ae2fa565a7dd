"""Hymba-1.5B [arXiv:2411.13676; hf:nvidia/Hymba-1.5B-Base].

Hybrid-head blocks: attention heads and Mamba(SSM) heads run in PARALLEL on
the same input; outputs are normalised and averaged.  Sliding-window
attention everywhere except global full-attention layers {0, 15, 31}.
Meta-tokens are stubbed (noted in DESIGN.md).  ssm_state=16.
Sub-quadratic (SWA + SSM; 3 global layers carry the long KV) => runs long_500k.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="hymba-1.5b", family="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5, head_dim=64,
    d_ff=5504, vocab_size=32001,
    norm="rmsnorm", norm_eps=1e-6, mlp="swiglu",
    sliding_window=1024, global_layer_ids=(0, 15, 31),
    ssm_state=16, ssm_expand=2, hybrid_parallel=True,
    subquadratic=True,
    source="arXiv:2411.13676; hf",
))
