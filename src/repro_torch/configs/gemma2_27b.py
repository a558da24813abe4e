"""gemma2-27b [dense] — alternating local/global attention, logit softcaps.

[arXiv:2408.00118; hf] 46L, d_model=4608, 32H (GQA kv=16), d_ff=36864,
vocab=256000. Head dim 4608 / 32 = 144, as the JAX package derives it
(the published model uses 128 with a query scale of 144^-0.5).
"""
from repro_torch.configs.base import ArchConfig, GLOBAL, LOCAL, register

GEMMA2_27B = register(ArchConfig(
    name="gemma2-27b",
    family="dense",
    n_layers=46,
    d_model=4608,
    n_heads=32,
    n_kv_heads=16,
    d_ff=36864,
    vocab=256_000,
    period=(LOCAL, GLOBAL),
    window=4096,
    attn_softcap=50.0,
    final_softcap=30.0,
    act="gelu",
    emb_scale=True,
    source="arXiv:2408.00118 (Gemma 2); assignment spec",
))
