"""gemma3-12b [dense] — 5:1 local:global attention, 128k context.

[hf:google/gemma-3-1b-pt family; unverified] Spec per assignment: 48L,
d_model=3840, 16H (GQA kv=8), d_ff=15360, vocab=262144. Head dim
3840 / 16 = 240, QK-norm, no logit softcaps.
"""
from repro_torch.configs.base import ArchConfig, GLOBAL, LOCAL, register

GEMMA3_12B = register(ArchConfig(
    name="gemma3-12b",
    family="dense",
    n_layers=48,
    d_model=3840,
    n_heads=16,
    n_kv_heads=8,
    d_ff=15360,
    vocab=262_144,
    period=(LOCAL,) * 5 + (GLOBAL,),   # 5:1 local:global
    window=1024,
    rope_theta=1_000_000.0,
    qk_norm=True,
    act="gelu",
    emb_scale=True,
    source="hf:google/gemma-3 family; assignment spec",
))
