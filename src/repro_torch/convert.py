"""Turn the JAX package's parameter tree and training state into the
port's.

The JAX model stacks each period's layers on a leading ``n_periods`` axis
(it scans over them) under ``params["periods"]["slot{i}"]`` and keeps the
remainder layers under ``params["rem"]``. The port keeps one dict per
layer in order: period 0 slot 0, period 0 slot 1, ..., then the
remainder. Input leaves are numpy arrays (e.g. ``np.asarray`` of the JAX
arrays); bf16 arrives as an ``ml_dtypes`` array and is reinterpreted
through its 16-bit pattern, so ``ml_dtypes`` is never imported.
``cnn_params_from_jax`` does the same for ``repro.models.cnn``'s tree,
turning its HWIO convolution kernels into the port's OIHW.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.core import bitchop
from repro_torch.optim import adamw
from repro_torch.policies import PolicyState
from repro_torch.train.state import TrainState

# The port's controller states, by the name of the JAX NamedTuple.
_CTRL_STATES = {cls.__name__: cls for cls in (bitchop.BitChopState,
                                              bitchop.BitWaveState)}


def to_tensor(a: np.ndarray, device="cpu") -> torch.Tensor:
    """A numpy array (bf16 included) as a tensor with the same bits."""
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        bits = torch.from_numpy(a.view(np.uint16).view(np.int16).copy())
        return bits.view(torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def _tree(x, fn):
    if isinstance(x, dict):
        return {k: _tree(v, fn) for k, v in x.items()}
    return fn(x)


def _ctrl(x, device):
    """Controller state: nested dicts (a composite's, by sub-policy name)
    whose leaves are arrays or BitChop / BitWave state NamedTuples."""
    if isinstance(x, dict):
        return {k: _ctrl(v, device) for k, v in x.items()}
    cls = _CTRL_STATES.get(type(x).__name__)
    if cls is not None:
        return cls(*(to_tensor(np.asarray(v), device) for v in x))
    return to_tensor(np.asarray(x), device)


def _index(tree, i: int):
    return _tree(tree, lambda a: a[i])


def from_jax(params: Dict[str, Any], cfg, device="cpu") -> Dict[str, Any]:
    """JAX ``DecoderModel`` params (nested dicts of numpy arrays) -> the
    port's ``{"embed", "final_norm", "layers": [...]}``, with ``"head"``
    when the model's unembedding is untied. Also converts trees shaped
    like the params (AdamW's moments, the error-feedback residual)."""
    conv = lambda t: _tree(t, lambda a: to_tensor(np.asarray(a), device))
    layers = []
    for p in range(cfg.n_periods):
        period = _index(params["periods"], p)
        for i in range(len(cfg.period)):
            layers.append(conv(period[f"slot{i}"]))
    for i in range(len(cfg.remainder)):
        layers.append(conv(params["rem"][f"slot{i}"]))
    out = {"embed": conv(params["embed"]),
           "final_norm": conv(params["final_norm"]),
           "layers": layers}
    if "head" in params:    # an untied unembedding
        out["head"] = conv(params["head"])
    return out


def cnn_params_from_jax(params: Dict[str, Any], device="cpu"
                        ) -> Dict[str, Any]:
    """JAX ``CNN`` params (nested dicts of numpy arrays) -> the port's
    ``models.cnn.CNN`` params, bit for bit: every 4-D leaf (an HWIO
    convolution kernel; depthwise ``(kh, kw, 1, C)``) becomes OIHW
    (``(C, 1, kh, kw)``), every other leaf keeps its layout."""
    def leaf(a):
        t = to_tensor(np.asarray(a))
        if t.dim() == 4:
            t = t.permute(3, 2, 0, 1).contiguous()
        return t.to(device)
    return _tree(params, leaf)


def state_from_jax(state, cfg, device="cpu", seed: int = 0) -> TrainState:
    """A JAX ``TrainState`` (its leaves as numpy arrays) -> the port's:
    parameters (requiring grad), AdamW m/v/count, the learned bitlengths
    (nested per sub-policy for a composite such as "qm+qe"), the step and
    the error-feedback residual (stacked by period like the parameters;
    None stays None). The JAX key has no torch counterpart; the port's
    generator is seeded with ``seed``. Controller state keeps its
    nesting, BitChop and BitWave registers as the port's state
    NamedTuples of 0-d tensors."""
    params = from_jax(state.params, cfg, device)
    for p in adamw.leaves(params):
        p.requires_grad_(True)
    opt = adamw.AdamWState(m=from_jax(state.opt.m, cfg, device),
                           v=from_jax(state.opt.v, cfg, device),
                           count=int(np.asarray(state.opt.count)))
    learn = _tree(state.pstate.learn, lambda v: to_tensor(
        np.asarray(v, np.float32), device).requires_grad_())
    ctrl = _ctrl(state.pstate.ctrl, device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    residual = getattr(state, "grad_residual", None)
    return TrainState(params=params, opt=opt,
                      pstate=PolicyState(learn=learn, ctrl=ctrl),
                      step=int(np.asarray(state.step)), gen=gen,
                      grad_residual=(None if residual is None
                                     else from_jax(residual, cfg, device)))
