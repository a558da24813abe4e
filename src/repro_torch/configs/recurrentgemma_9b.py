"""recurrentgemma-9b [hybrid] — RG-LRU + local attention, 1:2 pattern.

[arXiv:2402.19427 (Griffin); unverified] 38L, d_model=4096, 16H (GQA
kv=1 = MQA), d_ff=12288, vocab=256000. Pattern: 2 recurrent blocks per
local-attention block; 38 = 12 full (rglru, rglru, local) periods + 2
remainder rglru layers.
"""
from repro_torch.configs.base import ArchConfig, LOCAL, RGLRU, register

RECURRENTGEMMA_9B = register(ArchConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    d_ff=12288,
    vocab=256_000,
    period=(RGLRU, RGLRU, LOCAL),
    window=2048,
    lru_width=4096,
    conv_width=4,
    act="gelu",
    emb_scale=True,
    source="arXiv:2402.19427 (Griffin/RecurrentGemma); assignment spec",
))
