"""StarCoder2-3B [arXiv:2402.19173; hf:bigcode/starcoder2-3b].

GQA kv=2, LayerNorm, GELU MLP with bias, RoPE.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="starcoder2-3b", family="dense",
    n_layers=30, d_model=3072, n_heads=24, n_kv_heads=2, head_dim=128,
    d_ff=12288, vocab_size=49152,
    norm="layernorm", norm_eps=1e-5, mlp="gelu", mlp_bias=True,
    attn_bias=True, attn_out_bias=True, rope_theta=999_999.44,
    source="arXiv:2402.19173; hf",
))
