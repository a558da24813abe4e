"""Container-codec registry: the one place container names mean something.

A ``Codec`` packs a float tensor into a ``PackedTensor`` (named payload
tensors plus the shape and dtype to rebuild it) and unpacks it back. The
serving KV cache, the training stash and checkpoint compression resolve
their container through ``get()``; parametric families (the
``sfp*-m{K}e{E}`` geometries) resolve through factories registered with
``register_factory``.

The host streams (``encode_host`` / ``decode_host``) are the checkpoint
format of the JAX package, byte for byte: part dtypes carry numpy's names
(``"uint8"``, ``"bfloat16"``, ...), and bf16 parts travel as their 16-bit
patterns, since numpy has no bf16.
"""
from __future__ import annotations

import abc
import difflib
import re
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
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

    def packed_spec(self, shape: Tuple[int, ...], dtype: torch.dtype
                    ) -> PackedTensor:
        """The skeleton of ``pack``'s output for a ``shape`` / ``dtype``
        tensor, for cache, buffer and checkpoint planning: a
        ``PackedTensor`` whose parts are meta tensors (their shapes and
        dtypes, no memory). The plain versions pack a fake CPU tensor,
        which propagates shapes without data (the JAX package's
        ``eval_shape`` of a pack)."""
        from torch._subclasses.fake_tensor import FakeTensorMode
        with FakeTensorMode():
            packed = self.pack(torch.empty(tuple(shape), dtype=dtype))
            parts = {k: (tuple(v.shape), v.dtype)
                     for k, v in packed.data.items()}
        return PackedTensor(packed.codec, packed.shape, packed.dtype, {
            k: torch.empty(s, dtype=dt, device="meta")
            for k, (s, dt) in parts.items()})

    def roundtrip(self, x: torch.Tensor, bits=None) -> torch.Tensor:
        """pack -> unpack: the fake-quant view of the realized container."""
        return self.unpack(self.pack(x, bits))

    def lossless_for(self, dtype) -> bool:
        """True iff pack(x) -> unpack is bit-exact for every ``dtype``
        tensor with bits=None. Checkpoint compression gates on it when no
        quantization was asked for."""
        return False

    # -- host-side serialization (checkpoint compression) ------------------

    def encode_host(self, arr, bits: Optional[int] = None
                    ) -> Tuple[np.ndarray, Dict[str, Any]]:
        """Serialize ``arr`` into a flat uint8 stream + JSON-able meta: the
        packed parts' raw bytes in sorted-name order (fixed-width codecs;
        variable-length ones override). A tensor packs on its own device,
        so on the card the kernel packs and only the parts cross to the
        host; a numpy array packs on the CPU."""
        packed = self.pack(as_tensor(arr), bits)
        parts = {k: host_bits(v) for k, v in sorted(packed.data.items())}
        stream = (np.concatenate([a.reshape(-1).view(np.uint8)
                                  for a, _ in parts.values()])
                  if parts else np.zeros(0, np.uint8))
        meta = {"parts": {k: {"shape": list(a.shape), "dtype": name,
                              "nbytes": int(a.nbytes)}
                          for k, (a, name) in parts.items()}}
        if bits is not None:
            meta["bits"] = int(bits)
        return stream, meta

    def decode_host(self, stream: np.ndarray, meta: Dict[str, Any],
                    shape: Tuple[int, ...], dtype: torch.dtype,
                    device=None) -> torch.Tensor:
        """Invert ``encode_host``, unpacking on ``device`` (default the
        CPU)."""
        data, off = {}, 0
        for k, p in meta["parts"].items():
            nb = int(p["nbytes"])
            data[k] = tensor_from_bits(
                np.array(stream[off:off + nb]), p["dtype"]).reshape(
                    p["shape"]).to(device)
            off += nb
        return self.unpack(PackedTensor(self.name, shape, dtype, data))


def dtype_name(dtype: torch.dtype) -> str:
    """numpy's name of a torch dtype: ``torch.bfloat16`` -> "bfloat16"."""
    return str(dtype).rsplit(".", 1)[-1]


def torch_dtype(name: str) -> torch.dtype:
    """Inverse of ``dtype_name``."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"no torch dtype named {name!r}")
    return dt


# bf16 and the unsigned ints cross to numpy through a signed view of the
# same width (numpy has no bf16; torch's unsigned ints lack some ops).
_BIT_VIEWS = {torch.bfloat16: (torch.int16, np.uint16),
              torch.uint16: (torch.int16, np.uint16),
              torch.uint32: (torch.int32, np.uint32),
              torch.uint64: (torch.int64, np.uint64)}


def host_bits(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    """A tensor as (a host numpy copy of its bytes, numpy's name of its
    dtype). bf16 comes back as its uint16 patterns."""
    name = dtype_name(t.dtype)
    view = _BIT_VIEWS.get(t.dtype)
    t = t.detach().contiguous()
    if view is not None:
        t = t.view(view[0])
    arr = t.to("cpu", copy=True).numpy()
    return (arr if view is None else arr.view(view[1])), name


def tensor_from_bits(arr: np.ndarray, name: str) -> torch.Tensor:
    """A CPU tensor of dtype ``name`` sharing the bytes of the contiguous,
    writable ``arr`` (any numpy dtype whose width divides the data's, such
    as a uint8 stream or bf16's uint16 patterns)."""
    dt = torch_dtype(name)
    view = _BIT_VIEWS.get(dt)
    if view is None:
        return torch.from_numpy(arr.view(np.dtype(name)))
    signed, unsigned = view
    return torch.from_numpy(arr.view(unsigned).view(
        np.dtype(dtype_name(signed)))).view(dt)


def as_tensor(arr) -> torch.Tensor:
    """A tensor as it is (on its device), or a numpy array as a CPU tensor
    with the same bits (bf16 as an ``ml_dtypes`` array, read through its
    16-bit pattern)."""
    if isinstance(arr, torch.Tensor):
        return arr
    a = np.ascontiguousarray(arr)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


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


# Canonical shapes of the parametric families, shown in validation errors.
PARAMETRIC_GRAMMAR = "sfp-m{K}e{E} (dense), sfp{8|16}-m{K}e{E} (fixed-lane)"


def _resolvable(name: str) -> bool:
    try:
        get(name)
        return True
    except Exception:
        return False


def suggest_name(name: str) -> Optional[str]:
    """Best-effort did-you-mean for an unresolvable container name.

    Candidates are the registered names plus parametric names rebuilt from
    the digits of the input (so ``sfp-2me4`` / ``sfpm2e4`` map back to
    ``sfp-m2e4``); every candidate is validated through ``get`` before it
    is offered.
    """
    cands = list(names())
    digits = re.findall(r"\d+", name)
    if "sfp" in name:
        if len(digits) == 2:
            cands.append(f"sfp-m{digits[0]}e{digits[1]}")
        if len(digits) == 3 and digits[0] in ("8", "16"):
            cands.append(f"sfp{digits[0]}-m{digits[1]}e{digits[2]}")
    good = [c for c in cands if _resolvable(c)]
    best = difflib.get_close_matches(name, good, n=1, cutoff=0.55)
    return best[0] if best else None


def validate_name(name: str, *, what: str = "container codec") -> Codec:
    """Resolve ``name`` through the registry and the parametric factories,
    raising ``ValueError`` with a did-you-mean hint on failure (the
    launchers' argparse validators go through it)."""
    try:
        return get(name)
    except KeyError:
        pass
    hint = suggest_name(name)
    msg = f"unknown {what} {name!r}"
    if hint:
        msg += f"; did you mean {hint!r}?"
    msg += f" (registered: {names()}; parametric: {PARAMETRIC_GRAMMAR})"
    raise ValueError(msg)
