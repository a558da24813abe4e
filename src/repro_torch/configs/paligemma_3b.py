"""paligemma-3b [vlm] — SigLIP vision frontend + gemma decoder.

[arXiv:2407.07726; hf] 18L, d_model=2048, 8H (GQA kv=1), d_ff=16384,
vocab=257216. Backbone only: the SigLIP tower is a stub, as in the JAX
package; callers pass precomputed patch embeddings (``cond_embeddings``,
(B, 256, d_model)), which the model reads as a fully visible prefix.
"""
from repro_torch.configs.base import ArchConfig, GLOBAL, register

PALIGEMMA_3B = register(ArchConfig(
    name="paligemma-3b",
    family="vlm",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    d_ff=16384,
    vocab=257_216,
    period=(GLOBAL,),
    act="gelu",
    emb_scale=True,
    prefix_tokens=256,
    source="arXiv:2407.07726 (PaliGemma); assignment spec",
))
