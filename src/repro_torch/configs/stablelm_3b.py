"""StableLM-3B (stablelm-2 family) [hf:stabilityai/stablelm-2-1_6b; unverified].

LayerNorm, partial rotary (25% of head_dim), MHA kv==heads.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="stablelm-3b", family="dense",
    n_layers=32, d_model=2560, n_heads=32, n_kv_heads=32, head_dim=80,
    d_ff=6912, vocab_size=50304,
    norm="layernorm", norm_eps=1e-5, mlp="swiglu",
    partial_rotary=0.25, rope_theta=10_000.0,
    source="hf:stabilityai/stablelm-2-1_6b; unverified",
))
