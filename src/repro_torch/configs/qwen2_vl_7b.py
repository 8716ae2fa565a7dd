"""Qwen2-VL-7B backbone [arXiv:2409.12191; hf].

Vision frontend is a STUB: ``input_specs`` provides precomputed patch
embeddings + an is-image mask; the backbone consumes a mixed embedding stream.
M-RoPE uses 3 position streams (t, h, w) with sections (16, 24, 24) half-dim
pairs (sums to head_dim/2 = 64).
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen2-vl-7b", family="vlm",
    n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4, head_dim=128,
    d_ff=18944, vocab_size=152064,
    norm="rmsnorm", norm_eps=1e-6, mlp="swiglu",
    attn_bias=True, rope_theta=1_000_000.0,
    mrope_sections=(16, 24, 24),
    frontend="vision_patches",
    source="arXiv:2409.12191; hf:Qwen/Qwen2-VL-7B-Instruct",
))
