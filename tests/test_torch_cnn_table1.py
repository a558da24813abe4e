"""The port's BitChop Table I twin on the CPU against the JAX package's
record: ResNet-8, 80 steps of 16 synthetic images from seed 0
(``train.cnn.run("bitchop")``), then the stash of its final parameters
priced at the controller's end width (``train.cnn.stash_footprint``), as
``chip_smoke.py --phase cnn`` computes the ``resnet8_bitchop`` row.

JAX's row (``experiments/bench_results.json``, ``table1_footprint``) ends
at 9 mantissa bits and 0.5507x fp32. The port draws its weights and images
with torch from the same seed, not JAX's: the trajectories differ, and the
end point is what must agree. BitChop's n is an integer: equal. The
footprint depends on the stashed values (their exponents, through Gecko):
held to 1e-3 of fp32's bits.

The run also names the same trajectory on every device: weights and
images are drawn on the CPU (``run`` moves them), so the card's run is
held to this one by the smoke, step by step.
"""
import json
from pathlib import Path

import pytest
import torch

from repro_torch.models import cnn
from repro_torch.train import cnn as cnn_train

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def jax_row():
    rec = json.loads((ROOT / "experiments" / "bench_results.json")
                     .read_text())
    return rec["table1_footprint"]["resnet8_bitchop"]


def test_bitchop_table1_twin_ends_at_jax_end_point(jax_row):
    run = cnn_train.run("bitchop", steps=80, seed=0, device="cpu")
    n = run["final_bc_bits"]
    assert n == jax_row["mantissa_bits"] == 9
    # The controller narrows one bit a step once the loss falls, and holds.
    bits = [h["bc_bits"] for h in run["history"]]
    assert bits[0] == cnn_train.MAX_BITS and bits[-1] == n
    assert all(a >= b for a, b in zip(bits, bits[1:]))
    stash = cnn_train.stash(run["params"], "bitchop", act_bits=float(n),
                            device="cpu")
    fp = cnn_train.stash_footprint(stash, float(n))
    assert fp["fp32_bits"] == jax_row["fp32_bits"]
    assert abs(fp["vs_fp32"] - jax_row["vs_fp32"]) <= 1e-3


def test_run_draws_weights_and_images_on_the_cpu(monkeypatch):
    """``run`` starts from the CPU's draws, moved to its device: the stem's
    weights and the first batch it trains on equal the CPU's bit for
    bit (the step updates the weights in place, so they are copied)."""
    seen = []
    step = cnn_train.make_step

    def recording(model, mode, **kw):
        fn = step(model, mode, **kw)

        def wrapped(state, batch, **k):
            seen.append((state.params["stem"]["w"].detach().clone(),
                         batch))
            return fn(state, batch, **k)
        return wrapped
    monkeypatch.setattr(cnn_train, "make_step", recording)
    cnn_train.run("none", steps=1, seed=3, device="cpu")
    stem, batch = seen[0]
    want = cnn.CNN(cnn.RESNET8, device="cpu").init(3)
    assert torch.equal(stem, want["stem"]["w"])
    ref = cnn_train.batch_at(cnn.RESNET8, 3, 0, 16, "cpu")
    assert torch.equal(batch["images"], ref["images"])
    assert torch.equal(batch["labels"], ref["labels"])
