"""Qwen2-0.5B [arXiv:2407.10671; hf:Qwen/Qwen2-0.5B].

GQA kv=2, QKV bias, tied embeddings.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen2-0.5b", family="dense",
    n_layers=24, d_model=896, n_heads=14, n_kv_heads=2, head_dim=64,
    d_ff=4864, vocab_size=151936,
    norm="rmsnorm", norm_eps=1e-6, mlp="swiglu",
    attn_bias=True, tie_embeddings=True, rope_theta=1_000_000.0,
    source="arXiv:2407.10671; hf",
))
