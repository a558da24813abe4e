"""mamba2-370m [ssm] — SSD (state-space duality), attention-free.

[arXiv:2405.21060; unverified] 48L, d_model=1024, vocab=50280,
ssm_state=128.
"""
from repro_torch.configs.base import ArchConfig, SSD, register

MAMBA2_370M = register(ArchConfig(
    name="mamba2-370m",
    family="ssm",
    n_layers=48,
    d_model=1024,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab=50280,
    period=(SSD,),
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=128,
    ssm_groups=1,
    conv_width=4,
    source="arXiv:2405.21060 (Mamba-2); assignment spec",
))
