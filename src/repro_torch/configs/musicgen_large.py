"""musicgen-large [audio] — decoder-only over EnCodec tokens.

[arXiv:2306.05284; hf] 48L, d_model=2048, 32H (kv=32), d_ff=8192,
vocab=2048. Backbone only: the EnCodec / text-conditioning frontend is a
stub, as in the JAX package; callers pass precomputed conditioning frame
embeddings (``cond_embeddings``, (B, 64, d_model)), read as a fully
visible prefix (a prefix-LM). A GELU MLP without GLU and an untied head.
"""
from repro_torch.configs.base import ArchConfig, GLOBAL, register

MUSICGEN_LARGE = register(ArchConfig(
    name="musicgen-large",
    family="audio",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab=2048,
    period=(GLOBAL,),
    act="gelu",
    glu=False,
    prefix_tokens=64,
    tie_embeddings=False,
    source="arXiv:2306.05284 (MusicGen); assignment spec",
))
