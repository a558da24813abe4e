"""phi3.5-moe-42b-a6.6b [moe] — 16 experts, top-2 routing.

[hf:microsoft/Phi-3.5-MoE-instruct; hf] 32L, d_model=4096, 32H (GQA kv=8),
expert d_ff=6400, vocab=32064.
"""
from repro_torch.configs.base import ArchConfig, GLOBAL, register

PHI35_MOE = register(ArchConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=6400,
    vocab=32064,
    period=(GLOBAL,),
    n_experts=16,
    top_k=2,
    d_ff_expert=6400,
    act="silu",
    tie_embeddings=False,
    source="hf:microsoft/Phi-3.5-MoE-instruct; assignment spec",
))
