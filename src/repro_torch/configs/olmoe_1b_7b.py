"""olmoe-1b-7b [moe] — 64 experts, top-8 routing.

[arXiv:2409.02060; hf] 16L, d_model=2048, 16H (GQA kv=16), expert
d_ff=1024, vocab=50304.
"""
from repro_torch.configs.base import ArchConfig, GLOBAL, register

OLMOE_1B_7B = register(ArchConfig(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1024,
    vocab=50304,
    period=(GLOBAL,),
    n_experts=64,
    top_k=8,
    d_ff_expert=1024,
    act="silu",
    source="arXiv:2409.02060 (OLMoE); assignment spec",
))
