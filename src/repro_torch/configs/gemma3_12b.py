"""Gemma-3-12B [hf:google/gemma-3-1b-pt scaled; unverified].

5:1 local:global sliding-window pattern (window 1024), GeGLU, qk-norm,
head_dim=256, 262k vocab, embeddings scaled by sqrt(d_model).
Layer pattern "LLLLLG" cycles over 48 layers = 8 repeats.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="gemma3-12b", family="dense",
    n_layers=48, d_model=3840, n_heads=16, n_kv_heads=8, head_dim=256,
    d_ff=15360, vocab_size=262144,
    norm="rmsnorm", norm_eps=1e-6, mlp="geglu",
    qk_norm=True, embed_scale=True, tie_embeddings=True,
    rope_theta=1_000_000.0,
    sliding_window=1024, layer_pattern="LLLLLG",
    source="hf:google/gemma-3-12b-pt family; unverified",
))
