"""DeepSeekMoE-16B [arXiv:2401.06066; hf:deepseek-ai/deepseek-moe-16b-base].

Fine-grained MoE: 64 routed experts (top-6) + 2 shared experts, expert
d_ff=1408.  Layer 0 keeps a dense FFN with d_ff=10944 (first_k_dense_replace=1
in the HF config).  MHA (kv == heads == 16).
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="deepseek-moe-16b", family="moe",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=1408, vocab_size=102400,
    norm="rmsnorm", norm_eps=1e-6, mlp="swiglu",
    rope_theta=10_000.0,
    n_experts=64, n_shared_experts=2, top_k=6, moe_d_ff=1408,
    first_dense_layers=1, dense_d_ff=10944, router_scale=True,
    source="arXiv:2401.06066; hf",
))
