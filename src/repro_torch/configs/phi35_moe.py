"""Phi-3.5-MoE (42B total / 6.6B active) [hf:microsoft/Phi-3.5-MoE-instruct].

16 experts, top-2 routing, no shared experts. GQA 32H/8KV.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="phi3.5-moe-42b-a6.6b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=6400, vocab_size=32064,
    norm="layernorm", norm_eps=1e-5, mlp="swiglu",
    rope_theta=10_000.0,
    n_experts=16, n_shared_experts=0, top_k=2, moe_d_ff=6400,
    source="hf:microsoft/Phi-3.5-MoE-instruct",
))
