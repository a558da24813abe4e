"""Container-codec registry: the one place container names mean something.

A ``Codec`` packs a float tensor into a ``PackedTensor`` (named payload
tensors plus the shape and dtype to rebuild it) and unpacks it back. The
serving KV cache and the training stash resolve their container through
``get()``; parametric families (the ``sfp*-m{K}e{E}`` geometries) resolve
through factories registered with ``register_factory``.
"""
from __future__ import annotations

import abc
import difflib
from typing import Callable, Dict, List, Optional, Tuple

import torch


class PackedTensor:
    """A compressed tensor: named payload tensors + reconstruction meta."""

    __slots__ = ("codec", "shape", "dtype", "data")

    def __init__(self, codec: str, shape: Tuple[int, ...],
                 dtype: torch.dtype, data: Dict[str, torch.Tensor]):
        self.codec = codec
        self.shape = tuple(shape)
        self.dtype = dtype
        self.data = dict(data)

    def __repr__(self):
        parts = ", ".join(f"{k}:{tuple(v.shape)}"
                          for k, v in sorted(self.data.items()))
        return (f"PackedTensor({self.codec}, shape={self.shape}, "
                f"dtype={self.dtype}, {parts})")


class Codec(abc.ABC):
    """Uniform interface of every compressed-tensor representation."""

    name: str = "?"

    @abc.abstractmethod
    def pack(self, x: torch.Tensor, bits=None) -> PackedTensor:
        """Compress ``x`` (``bits`` would quantize mantissas first)."""

    @abc.abstractmethod
    def unpack(self, packed: PackedTensor) -> torch.Tensor:
        """Rebuild the tensor from its packed form."""

    @abc.abstractmethod
    def packed_bits(self, x: torch.Tensor, bits=None) -> float:
        """Exact footprint of pack(x, bits), in bits."""

    def pack_fields(self, dtype):
        """Payload word geometry for fused consumers, or None."""
        del dtype
        return None


_REGISTRY: Dict[str, Codec] = {}
_FACTORIES: List[Callable[[str], Optional[Codec]]] = []
_BUILT: Dict[str, Codec] = {}  # what the factories built, by name


def register(codec: Codec) -> Codec:
    _REGISTRY[codec.name] = codec
    return codec


def register_factory(factory: Callable[[str], Optional[Codec]]) -> None:
    """Register a name -> Codec-or-None resolver for a parametric family;
    ``get`` consults it for unknown names and caches what it builds apart
    from the registry, so ``names()`` lists only registered codecs."""
    _FACTORIES.append(factory)


def get(name: str) -> Codec:
    if name in _REGISTRY:
        return _REGISTRY[name]
    if name in _BUILT:
        return _BUILT[name]
    for factory in _FACTORIES:
        codec = factory(name)
        if codec is not None:
            _BUILT[name] = codec
            return codec
    raise KeyError(f"unknown container codec {name!r}; registered: {names()}")


def names():
    return sorted(_REGISTRY)


def validate_name(name: str, *, what: str = "container codec") -> Codec:
    """Resolve ``name``, raising ValueError with a did-you-mean hint."""
    try:
        return get(name)
    except KeyError:
        pass
    best = difflib.get_close_matches(name, names(), n=1, cutoff=0.55)
    hint = f"; did you mean {best[0]!r}?" if best else ""
    raise ValueError(f"unknown {what} {name!r}{hint} (registered: {names()})")
