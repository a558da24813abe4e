"""``Codec.packed_spec``: the skeleton of a pack, with no memory.

The JAX package's ``packed_spec`` is ``jax.eval_shape`` of ``pack``; the
port's plain versions pack a fake CPU tensor (shapes and dtypes only) and
hand back meta tensors. Held, as JAX's ``tests/test_codecs.py`` holds
its own, to ``pack``'s output part for part, for every registered codec
and some parametric geometries, on bf16 and f32 (the fixed-lane word
codecs also off the 128-lane row: a flat pack pads), and to JAX's spec.
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from repro import codecs as jcodecs
from repro_torch import codecs as tcodecs
from repro_torch.codecs.base import dtype_name

NAMES = tuple(tcodecs.names()) + ("sfp-m2e4", "sfp-m7e7", "sfp8-m2e4",
                                  "sfp16-m3e10")


def _x(shape, dtype):
    rng = np.random.default_rng(0)
    return torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("name", NAMES)
def test_packed_spec_matches_pack(name, dtype):
    codec = tcodecs.get(name)
    for shape in ((2, 3, 128), (4, 256)):
        spec = codec.packed_spec(shape, dtype)
        packed = codec.pack(_x(shape, dtype))
        assert spec.codec == packed.codec and spec.shape == packed.shape
        assert spec.dtype == packed.dtype == dtype
        assert spec.data.keys() == packed.data.keys()
        for k, s in spec.data.items():
            assert s.device.type == "meta", (name, k)
            assert s.shape == packed.data[k].shape, (name, k)
            assert s.dtype == packed.data[k].dtype, (name, k)


@pytest.mark.parametrize("name", tcodecs.names())
def test_packed_spec_matches_jax(name):
    for shape in ((2, 3, 128), (4, 256)):
        spec = tcodecs.get(name).packed_spec(shape, torch.bfloat16)
        jspec = jcodecs.get(name).packed_spec(shape, jnp.bfloat16)
        assert spec.data.keys() == jspec.data.keys()
        for k, s in spec.data.items():
            assert tuple(s.shape) == tuple(jspec.data[k].shape), (name, k)
            assert dtype_name(s.dtype) == np.dtype(jspec.data[k].dtype).name


def test_packed_spec_runs_no_kernel(monkeypatch):
    """The spec comes from the plain versions: with the kernel library
    unable to load it is still built."""
    from repro_torch.kernels import _lib

    def fail():
        raise _lib.KernelUnavailable("mocked: no kernel library")
    monkeypatch.setattr(_lib, "load", fail)
    spec = tcodecs.get("sfp-m2e4").packed_spec((8, 128), torch.bfloat16)
    assert tuple(spec.data["payload"].shape) == (8, 112)
