"""Whisper-base [arXiv:2212.04356; unverified].

Encoder-decoder; the conv frontend is a STUB — ``input_specs`` provides
precomputed frame embeddings (batch, 1536, d_model) (1500 mel frames padded
to 1536 for even sharding).  Decoder: self-attn (causal) + cross-attn.
Learned positions (no RoPE).
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="whisper-base", family="audio",
    n_layers=6, d_model=512, n_heads=8, n_kv_heads=8, head_dim=64,
    d_ff=2048, vocab_size=51865,
    norm="layernorm", norm_eps=1e-5, mlp="gelu", mlp_bias=True,
    attn_bias=True, attn_out_bias=True,
    rope_theta=0.0,  # 0 => learned absolute positions
    is_encoder_decoder=True, n_encoder_layers=6, encoder_seq_len=1536,
    frontend="audio_frames",
    source="arXiv:2212.04356; unverified",
))
