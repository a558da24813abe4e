"""gemma2-2b [dense] — alternating local/global attention, logit softcaps.

[arXiv:2408.00118; hf] 26L, d_model=2304, 8H (GQA kv=4), d_ff=9216,
vocab=256000.
"""
from repro_torch.configs.base import ArchConfig, GLOBAL, LOCAL, register

GEMMA2_2B = register(ArchConfig(
    name="gemma2-2b",
    family="dense",
    n_layers=26,
    d_model=2304,
    n_heads=8,
    n_kv_heads=4,
    d_ff=9216,
    vocab=256_000,
    period=(LOCAL, GLOBAL),
    window=4096,
    attn_softcap=50.0,
    final_softcap=30.0,
    act="gelu",
    emb_scale=True,
    source="arXiv:2408.00118 (Gemma 2); assignment spec",
))
