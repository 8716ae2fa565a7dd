"""xLSTM-350M [arXiv:2405.04517; unverified].

24 blocks at 7:1 mLSTM:sLSTM (every 8th block is sLSTM).  mLSTM: matrix
memory with exponential gating, chunkwise-parallel training form; sLSTM:
scalar memory, sequential lax.scan recurrence.  Sub-quadratic => runs
long_500k.  d_ff=0 per the assignment (block-internal up/down projections
use ssm_expand).
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="xlstm-350m", family="ssm",
    n_layers=24, d_model=1024, n_heads=4, n_kv_heads=4, head_dim=256,
    d_ff=0, vocab_size=50304,
    norm="rmsnorm", norm_eps=1e-6, mlp="swiglu",
    ssm_expand=2, slstm_every=8,
    subquadratic=True,
    source="arXiv:2405.04517; unverified",
))
