"""mistral-large-123b [dense] — all-global GQA decoder, untied head.

[hf:mistralai/Mistral-Large-Instruct-2407; unverified] 88L, d_model=12288,
96H (GQA kv=8, so 12 query heads a KV head), d_ff=28672, vocab=32768.
"""
from repro_torch.configs.base import ArchConfig, GLOBAL, register

MISTRAL_LARGE_123B = register(ArchConfig(
    name="mistral-large-123b",
    family="dense",
    n_layers=88,
    d_model=12288,
    n_heads=96,
    n_kv_heads=8,
    d_ff=28672,
    vocab=32768,
    period=(GLOBAL,),
    rope_theta=1_000_000.0,
    act="silu",
    tie_embeddings=False,
    source="hf:mistralai/Mistral-Large-Instruct-2407; assignment spec",
))
