"""Probe of the Quantum Mantissa stash estimator's sensitivity.

  python -m repro_torch.launch.probe_estimator --arch gemma2-2b \
      --preset full --container sfp8 --batch 4 --seq 1024 --qm-init-bits 2.5

Takes one training step from the same seed under four routes: every
kernel; the plain versions everywhere; every kernel but the attention
backward (autograd through the plain attention instead); every kernel but
attention (forward and backward plain). For each period it prints the
stash estimator's value dn = sum(dh * r) / frac, with r = h_q - Q(h_q,
floor n), and the sum of the magnitudes sum(|dh * r|) / frac it is a
residual of, one JSON line per route. Accepts the training launcher's
flags; ``--layers`` cuts the depth.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json

import torch

from repro_torch.core import containers
from repro_torch.data import synthetic
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.launch import train as tlaunch
from repro_torch.models.model import DecoderModel
from repro_torch.policies import quantum
from repro_torch.train import step as step_mod

_RECORDS: list = []


@dataclasses.dataclass(frozen=True)
class _RecordingQM(quantum.QMPolicy):
    """QM that keeps each stash estimate and the magnitude it cancels."""

    def stash_grad(self, dh, h_q, pslice, dims):
        out = super().stash_grad(dh, h_q, pslice, dims)
        nf = torch.clamp(pslice["act"].detach(), 0.0, float(dims.man_bits))
        floor_n = torch.floor(nf)
        r = (h_q - containers.truncate_mantissa(
            h_q, floor_n.to(torch.int32))).to(torch.float32)
        scale = torch.clamp(nf - floor_n, min=0.05)
        _RECORDS.append({"dn": out["act"].item(),
                         "abs_sum": (torch.sum(torch.abs(
                             dh.to(torch.float32) * r)) / scale).item()})
        return out


@contextlib.contextmanager
def _route(name):
    """Swap in the plain versions the route asks for, and restore them."""
    bwd = fa.flash_attention_bwd
    if name == "plain":
        ops.force_backend("plain")
    elif name == "attention backward plain":
        fa.flash_attention_bwd = (
            lambda q, k, v, o, do, lse, **kw: fa.plain_bwd(q, k, v, do, **kw))
    elif name == "attention plain":
        ops.force_backend("plain attention")
    try:
        yield
    finally:
        ops.force_backend(None)
        fa.flash_attention_bwd = bwd


ROUTES = ("kernels", "plain", "attention backward plain", "attention plain")


def main(argv=None) -> list:
    ap = tlaunch.build_parser()
    ap.add_argument("--layers", type=int, default=None)
    args = ap.parse_args(argv)
    args.policy = "qm"
    cfg, model, tc, batch, seq = tlaunch.build(args)
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    model = DecoderModel(cfg, _RecordingQM(**dataclasses.asdict(model.policy)),
                         device=model.device)
    corpus = synthetic.MarkovCorpus(synthetic.SyntheticConfig(
        vocab=cfg.vocab, seq_len=seq, global_batch=batch, seed=args.seed))
    b = {k: torch.from_numpy(v).long().to(model.device)
         for k, v in corpus.batch(0).items()}
    out = []
    for name in ROUTES:
        _RECORDS.clear()
        with _route(name):
            state = step_mod.init_state(model, args.seed, tc)
            state, met = step_mod.make_train_step(model, tc)(state, b)
        rec = {"route": name, "loss": float(met["loss"]),
               "grad_norm": float(met["grad_norm"]),
               # the backward visits the periods last to first
               "dn": [r["dn"] for r in reversed(_RECORDS)],
               "abs_sum": [r["abs_sum"] for r in reversed(_RECORDS)],
               "act_bits": state.pstate.learn["act"].detach().cpu().tolist()}
        print(json.dumps(rec), flush=True)
        out.append(rec)
        del state
        if model.device.type == "cuda":
            torch.cuda.empty_cache()
    return out


if __name__ == "__main__":
    main()
