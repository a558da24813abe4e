"""Architecture configuration (the port's copy of ``repro.configs.base``).

``ArchConfig`` keeps the JAX package's fields one for one, with ``dtype``
as the same name string; ``compute_dtype`` maps it to a torch dtype.
``reduced()`` derives the CPU smoke-test variant of the same family.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

# Layer kinds usable in a period pattern.
GLOBAL = "global"   # full causal attention
LOCAL = "local"     # sliding-window attention
SSD = "ssd"         # mamba2 state-space duality block
RGLRU = "rglru"     # Griffin RG-LRU recurrent block

_TORCH_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                  # dense|moe|ssm|hybrid|audio|vlm|cnn
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    period: Tuple[str, ...]      # repeating layer-kind pattern
    # attention
    window: int = 4096
    attn_softcap: Optional[float] = None
    final_softcap: Optional[float] = None
    rope_theta: float = 10_000.0
    qk_norm: bool = False
    head_dim: Optional[int] = None
    # mlp
    act: str = "silu"
    glu: bool = True
    # moe
    n_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    capacity_factor: float = 1.25
    # ssm (mamba2)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 128
    ssm_groups: int = 1
    conv_width: int = 4
    # rglru (griffin)
    lru_width: Optional[int] = None
    # multimodal stub frontend
    prefix_tokens: int = 0
    # misc
    tie_embeddings: bool = True
    emb_scale: bool = False
    dtype: str = "bfloat16"
    vocab_pad_multiple: int = 128
    source: str = ""

    @property
    def head_dim_(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // max(self.n_heads, 1)

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return ((self.vocab + m - 1) // m) * m

    @property
    def n_periods(self) -> int:
        return self.n_layers // len(self.period)

    @property
    def remainder(self) -> Tuple[str, ...]:
        return self.period[: self.n_layers % len(self.period)]

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def lru_width_(self) -> int:
        return self.lru_width if self.lru_width else self.d_model

    @property
    def compute_dtype(self) -> torch.dtype:
        return _TORCH_DTYPES[self.dtype]

    def layer_kinds(self) -> Tuple[str, ...]:
        """Kind of every layer in order: the period repeated, then the
        remainder (the JAX model scans the periods and unrolls the rest)."""
        return self.period * self.n_periods + self.remainder


_REGISTRY: Dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get(name: str) -> ArchConfig:
    from repro_torch import configs as _c  # noqa: F401  (registration)
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch '{name}'; ported: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def reduced(cfg: ArchConfig, *, n_layers: Optional[int] = None,
            d_model: int = 128, seq: int = 64) -> ArchConfig:
    """A tiny same-family variant for CPU smoke tests."""
    period = cfg.period
    nl = n_layers if n_layers is not None else max(len(period), 2)
    n_heads = max(2, min(cfg.n_heads, 4))
    kv = max(1, min(cfg.n_kv_heads, n_heads))
    changes = dict(
        name=cfg.name + "-reduced",
        n_layers=nl,
        d_model=d_model,
        n_heads=n_heads,
        n_kv_heads=kv,
        head_dim=d_model // n_heads,
        d_ff=d_model * 3,
        vocab=512,
        window=min(cfg.window, max(seq // 2, 8)),
        vocab_pad_multiple=128,
    )
    if cfg.is_moe:
        changes.update(n_experts=4, top_k=2, d_ff_expert=d_model * 2)
    if SSD in period:
        changes.update(ssm_state=16, ssm_head_dim=32, ssm_chunk=16)
    if RGLRU in period:
        changes.update(lru_width=d_model)
    if cfg.prefix_tokens:
        changes.update(prefix_tokens=8)
    return dataclasses.replace(cfg, **changes)
