"""The port's CNNs (``repro_torch.models.cnn``) against the JAX package's
``repro.models.cnn`` on the CPU.

Configurations: ResNet-8 at batch 4; a ResNet-18-shaped cut (3 stages of
one block, widths 8/16/32) at 66x66, so that the stride-2 stem runs and
pads (0, 1) as XLA's SAME does; MobileNetV3-Small at its published widths
on 32x32 images and 10 classes; ResNet-8's widths at an odd size, 67x67
(stride-2 stem, then 34 -> 17 -> 9). JAX initialises the weights, and
the norms' scales and biases are drawn as trained ones would be (1 +
0.2 N(0, 1) and 0.2 N(0, 1)): at init every bias is 0, and MobileNetV3's
last block, a norm with no residual feeding the average pool, would then
pool to 0 and give logits of rounding noise (~1e-7) with nothing to
compare. ``convert.cnn_params_from_jax`` hands the weights over bit for
bit; the images come from JAX's ``synthetic_images``.

Tolerances (f32). Logits and every stash tensor (in NHWC order) within
1e-5 of each tensor's largest element, but for the sites whose norms
pool 4 positions (MobileNetV3's last stage at 32x32), held to 1e-3: a
norm over 2x2 values divides by a small spread, and there each
framework's own f32 forward was measured 2.1e-5 to 6.7e-5 from an f64
evaluation of the same forward, the two 1.6e-4 apart at most.

Quantized forwards run at 1 mantissa bit. A one-ulp difference between
the two frameworks' convolutions can move a value across a truncation
boundary (a flip, one n-bit mantissa step). So every site of a quantized
stash is held, in NHWC order, to its tolerance but for under 1e-3 of its
elements, each of which may differ by one n-bit step; the logits to
1e-5. With these weights one flip was measured (MobileNetV3 under
bitwave, 1 of s3b0.out's 3,072 values), and it did not spread. Flips can
cascade: the per-sample norm after a flip spreads its shift over the
channel, where more values cross (at n = 3 a first flip near ResNet-8's
stem grew to 247 of 16,384 values at s2b0.out; at n = 1 the ResNet
forwards flipped for 2 of 18 weight seeds tried and MobileNetV3's for 4
of 6, at times to 50,000 values and more), and then this test fails.
Gradients run under QM at 0.5 bits (the draw injected as 1) from a
forward that must show no flip (measured so for every configuration):
the parameters' within 1e-5 of each tensor's largest, the per-site
bitlengths' (sums of g * (Q(x, 1) - Q(x, 0)) whose terms cancel) within
1e-4 of the largest site's.

MobileNetV3 here (as in the JAX package) ends every block in a norm, so
the average pool of its last stage is the sum of that stage's n3 biases
whatever the image: its logits depend on fc and those biases alone, and
every other gradient is zero up to rounding. Those two are held to 1e-5,
and of the bitlengths those of the last stage's outputs (fed from the
pool along the residual chain) to 1e-4; the rest only to being noise on
both sides (under 1e-2 of the largest; measured 5.5e-4 and 7.9e-4,
rounding amplified by the 2x2 norms' backward).
"""
import dataclasses
import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro import policies as jpolicies
from repro.core import containers as jcontainers
from repro.models import cnn as jcnn
from repro_torch import convert
from repro_torch import policies as tpolicies
from repro_torch.core import containers as tcontainers
from repro_torch.core.stash import float_leaves
from repro_torch.models import cnn as tcnn

torch.set_num_threads(2)

STEM2 = dict(name="resnet18-cut", stages=(1, 1, 1), widths=(8, 16, 32),
             stem_width=8, n_classes=10, img_size=66)
CASES = {
    "resnet8": ("RESNET8", {}, 4),
    "resnet18-stem2": ("RESNET18", STEM2, 2),
    "mobilenetv3-32": ("MOBILENETV3_SMALL", dict(img_size=32, n_classes=10),
                       2),
    "resnet8-odd67": ("RESNET8", dict(img_size=67), 2),
}
BITS = 1  # the quantized forwards' mantissa bits


def _tol(shape):
    """A stash tensor's tolerance, relative to its largest element."""
    return 1e-3 if len(shape) == 4 and shape[1] * shape[2] == 4 else 1e-5


def _cfgs(case):
    name, cut, batch = CASES[case]
    jc = dataclasses.replace(getattr(jcnn, name), **cut)
    tc = dataclasses.replace(getattr(tcnn, name), **cut)
    return jc, tc, batch


def _trained_norms(params, seed=0):
    """The JAX tree with every norm's scale and bias drawn from ``seed``."""
    rng = np.random.default_rng(seed)

    def walk(tree):
        if isinstance(tree, dict) and set(tree) == {"scale", "bias"}:
            c = tree["scale"].shape
            return {"scale": jnp.asarray(
                        1 + 0.2 * rng.standard_normal(c), jnp.float32),
                    "bias": jnp.asarray(0.2 * rng.standard_normal(c),
                                        jnp.float32)}
        if isinstance(tree, dict):
            return {k: walk(v) for k, v in tree.items()}
        return tree

    return walk(params)


def _setup(case, jpol="none", tpol="none"):
    jc, tc, batch = _cfgs(case)
    jm = jcnn.CNN(jc, jpol)
    jp = _trained_norms(jm.init(jax.random.PRNGKey(0)))
    b = jcnn.synthetic_images(jax.random.PRNGKey(1), batch, jc)
    tm = tcnn.CNN(tc, tpol, device="cpu")
    tp = convert.cnn_params_from_jax(jax.tree.map(np.asarray, jp))
    img = torch.from_numpy(np.array(b["images"])).permute(0, 3, 1, 2)
    labels = torch.from_numpy(np.asarray(b["labels"]).astype(np.int64))
    return (jm, jp, b), (tm, tp, {"images": img, "labels": labels})


def _rel(got, want):
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _jax_forward(jm, jp, images, bits=None, key=None):
    """JAX's ``forward(..., collect_stash=True)`` under ``jax.jit`` (one
    compile in place of an op-by-op run); the stash's names and tags are
    recorded while it traces."""
    meta = []

    def f(p, im, nb):
        logits, stash = jm.forward(p, im, act_bits=nb, key=key,
                                   collect_stash=True)
        meta[:] = [(s["name"], s["signless"], s["relu_pool"]) for s in stash]
        return logits, [s["tensor"] for s in stash]

    logits, tensors = jax.jit(f)(jp, images, bits)
    return logits, [dict(name=n, signless=sl, relu_pool=rp, tensor=t)
                    for (n, sl, rp), t in zip(meta, tensors)]


def _site_names(jm, jp, b):
    names = []

    def f(p, im):
        names[:] = [s["name"] for s in jm.forward(p, im,
                                                  collect_stash=True)[1]]
        return 0

    jax.eval_shape(f, jp, b["images"])
    return names


@pytest.mark.parametrize("name", ["RESNET18", "RESNET8",
                                  "MOBILENETV3_SMALL"])
def test_configs_and_parameter_counts_match_jax(name):
    jc, tc = getattr(jcnn, name), getattr(tcnn, name)
    for f in dataclasses.fields(jc):
        assert getattr(tc, f.name) == getattr(jc, f.name), f.name
    assert {f.name for f in dataclasses.fields(tc)} == \
        {f.name for f in dataclasses.fields(jc)}
    assert tc.compute_dtype == torch.float32
    jshapes = jax.tree.leaves(jax.eval_shape(jcnn.CNN(jc).init,
                                             jax.random.PRNGKey(0)))
    tparams = [t for _, t in float_leaves(
        tcnn.CNN(tc, device="cpu").init(0))]
    assert sum(t.numel() for t in tparams) == \
        sum(math.prod(s.shape) for s in jshapes)
    assert sorted(t.numel() for t in tparams) == \
        sorted(math.prod(s.shape) for s in jshapes)
    expected = {"RESNET18": 11_679_040, "RESNET8": 77_840,
                "MOBILENETV3_SMALL": 8_337_784}[name]
    assert sum(t.numel() for t in tparams) == expected


@pytest.mark.parametrize("size", [7, 8, 9, 16, 17, 33, 66, 67])
@pytest.mark.parametrize("stride,k,groups", [(1, 3, 1), (2, 3, 1),
                                             (2, 1, 1), (2, 3, 4)])
def test_conv_pads_as_xla_same(size, stride, k, groups):
    """The SAME padding formula, stride 2 on even sizes (0, 1), depthwise
    included: equal to ``lax.conv_general_dilated`` to 1e-6."""
    rng = np.random.default_rng(size * 10 + stride)
    x = rng.standard_normal((2, size, size, 4)).astype(np.float32)
    w = rng.standard_normal((k, k, 4 // groups, 4)).astype(np.float32)
    want = np.asarray(jcnn.conv(jnp.asarray(x), jnp.asarray(w), stride,
                                groups))
    got = tcnn.conv(torch.from_numpy(x).permute(0, 3, 1, 2),
                    torch.from_numpy(w).permute(3, 2, 0, 1).contiguous(),
                    stride, groups).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("case", list(CASES))
def test_forward_and_stash_match_jax(case):
    (jm, jp, b), (tm, tp, tb) = _setup(case)
    jl, js = _jax_forward(jm, jp, b["images"])
    tl, ts = tm.forward(tp, tb["images"], collect_stash=True)
    assert tl.shape == jl.shape
    assert _rel(tl.numpy(), np.asarray(jl)) <= 1e-5
    assert [(s["name"], s["signless"], s["relu_pool"]) for s in ts] == \
        [(s["name"], s["signless"], s["relu_pool"]) for s in js]
    for j, t in zip(js, ts):
        want, got = np.asarray(j["tensor"]), t["tensor"]
        assert got.shape == want.shape, j["name"]
        # The NHWC view lists the values in JAX's order, so Gecko's 8x8
        # groups of reshape(-1) see the same exponents.
        assert _rel(got.reshape(-1).numpy(), want.reshape(-1)) <= \
            _tol(want.shape), j["name"]


def _inject(monkeypatch):
    """Both frameworks' Bernoulli draw replaced by ceil(n)."""
    def j_draw(n_float, key, max_bits, min_bits=0):
        nf = jnp.clip(jnp.asarray(n_float, jnp.float32), float(min_bits),
                      float(max_bits))
        return jnp.ceil(nf).astype(jnp.int32)

    def t_draw(n_float, generator, max_bits, min_bits=0, shape=None):
        nf = torch.clamp(n_float.detach().float(), float(min_bits),
                         float(max_bits))
        n = torch.ceil(nf).to(torch.int32)
        return n if shape is None else n.expand(tuple(shape)).clone()

    monkeypatch.setattr(jcontainers, "stochastic_bitlength", j_draw)
    monkeypatch.setattr(tcontainers, "stochastic_bitlength", t_draw)


def _flipped_sites(js, ts, n):
    """Hold two quantized stashes site by site: each within its tolerance
    but for under 1e-3 of its elements, each off by at most one n-bit
    mantissa step (a truncation flip), and each site but ``pool`` keeping
    at most n mantissa bits. Returns the names of the sites that flipped."""
    flipped = []
    for j, t in zip(js, ts):
        want = np.asarray(j["tensor"]).reshape(-1)
        got = t["tensor"].detach().reshape(-1).numpy()
        assert got.shape == want.shape and np.isfinite(got).all()
        if j["name"] != "pool":
            kept = tcontainers.truncate_mantissa(t["tensor"], n)
            assert torch.equal(kept, t["tensor"]), j["name"]
        d = np.abs(got - want)
        bad = d > _tol(j["tensor"].shape) * np.max(np.abs(want))
        if bad.any():
            assert bad.mean() < 1e-3, (j["name"], bad.mean())
            mag = np.maximum(np.abs(got), np.abs(want))[bad]
            step = np.exp2(np.floor(np.log2(mag)) - n)
            assert (d[bad] <= step * (1 + 1e-6)).all(), j["name"]
            flipped.append(j["name"])
    return flipped


QUANT = {
    # name: (policy, bits as a function of (site names, framework))
    "qm-int": ("qm", lambda names, fw: {
        k: fw.float(BITS) for k in names}),
    "qm-frac": ("qm", lambda names, fw: {
        k: fw.float(BITS - 0.5) for k in names}),
    "bitchop": ("bitchop", lambda names, fw: fw.int(BITS)),
    "bitwave": ("bitwave", lambda names, fw: {
        k: {"act": fw.int(BITS), "act_e": fw.int(5)} for k in names}),
    "static": ("static", lambda names, fw: None),  # static_act_bits=1
}


class _J:
    float = staticmethod(jnp.float32)
    int = staticmethod(jnp.int32)


class _T:
    @staticmethod
    def float(v):
        return torch.tensor(v, dtype=torch.float32)

    @staticmethod
    def int(v):
        return torch.tensor(v, dtype=torch.int32)


@pytest.mark.parametrize("quant", list(QUANT))
@pytest.mark.parametrize("case", list(CASES))
def test_quantized_forward_matches_jax(case, quant, monkeypatch):
    """qm at an integer n and at a fractional n (draw injected as ceil),
    bitchop at a scalar n, bitwave at a per-site slice dict (mantissa 1,
    exponent 5: flushes and saturates), static at 1 act bit."""
    _inject(monkeypatch)
    policy, bits = QUANT[quant]
    kw = dict(static_act_bits=BITS) if policy == "static" else {}
    (jm, jp, b), (tm, tp, tb) = _setup(
        case, jpolicies.get(policy, container="bit_exact", **kw),
        tpolicies.get(policy, container="bit_exact", **kw))
    names = _site_names(jm, jp, b)
    jl, js = _jax_forward(jm, jp, b["images"], bits(names, _J),
                          jax.random.PRNGKey(2))
    tl, ts = tm.forward(tp, tb["images"], act_bits=bits(names, _T),
                        collect_stash=True)
    assert [s["name"] for s in ts] == names
    _flipped_sites(js, ts, BITS)
    assert _rel(tl.detach().numpy(), np.asarray(jl)) <= 1e-5


@pytest.mark.parametrize("case", list(CASES))
def test_gradients_match_jax(case, monkeypatch):
    """d loss / d params and d loss / d per-site bits under qm at 0.5
    bits (draw injected as 1) against jax.value_and_grad(argnums=(0, 1))."""
    _inject(monkeypatch)
    (jm, jp, b), (tm, tp, tb) = _setup(case, jpolicies.get("qm"),
                                       tpolicies.get("qm"))
    names = _site_names(jm, jp, b)
    key = jax.random.PRNGKey(3)

    def jloss(p, nb):
        return jm.loss(p, b, act_bits=nb, key=key)

    (jl, jaux), (jgp, jgn) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(
        jp, {k: jnp.float32(0.5) for k in names})
    for t in float_leaves(tp):
        t[1].requires_grad_(True)
    tbits = {k: torch.tensor(0.5, requires_grad=True) for k in names}
    tl, taux = tm.loss(tp, tb, act_bits=tbits)
    leaves = [t for _, t in float_leaves(tp)]
    grads = torch.autograd.grad(tl, leaves + list(tbits.values()),
                                allow_unused=True)
    # The loss's forward, stashed: gradients are comparable only while the
    # two forwards see the same truncations.
    _, js = _jax_forward(jm, jp, b["images"],
                         {k: jnp.float32(0.5) for k in names}, key)
    _, ts = tm.forward(tp, tb["images"], act_bits=tbits, collect_stash=True)
    assert _flipped_sites(js, ts, 1) == []
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    assert float(taux["acc"]) == float(jaux["acc"])
    want = [t for _, t in float_leaves(convert.cnn_params_from_jax(
        jax.tree.map(np.asarray, jgp)))]
    assert len(want) == len(leaves)
    gn = np.asarray([0.0 if g is None else float(g)
                     for g in grads[len(leaves):]])
    jn = np.asarray([float(jgn[k]) for k in names])
    assert jn[-1] == 0 and gn[-1] == 0  # pool: stashed, never quantized
    if case.startswith("mobilenet"):
        # The logits are fc over the sum of the last stage's n3 biases:
        # every other gradient is zero up to rounding, on both sides.
        top = max(float(np.max(np.abs(w.numpy()))) for w in want)
        dead = []
        for (path, _), g, w in zip(float_leaves(tp), grads, want):
            if path == ("fc",) or (path[0].startswith("s4")
                                   and path[1:] == ("n3", "bias")):
                assert _rel(g.numpy(), w.numpy()) <= 1e-5, path
            else:
                dead.append(max(float(np.max(np.abs(g.numpy()))),
                                float(np.max(np.abs(w.numpy())))))
        # Measured 5.5e-4 of the largest: rounding amplified by the 2x2
        # norms' backward, where the true gradient is 0.
        assert max(dead) <= 1e-2 * top
        # Of the bitlengths only the last stage's outputs, whose cotangent
        # comes from the pool along the residual chain, are live (the
        # others measured under 7.9e-4 of the largest).
        live = np.asarray([k.startswith("s4") and k.endswith(".out")
                           for k in names])
        scale = np.max(np.abs(jn[live]))
        assert np.max(np.abs(gn - jn)[live]) <= 1e-4 * scale, (gn, jn)
        assert np.max(np.abs(np.r_[gn[~live], jn[~live]])) <= 1e-2 * scale
        return
    for (path, _), g, w in zip(float_leaves(tp), grads, want):
        assert _rel(g.numpy(), w.numpy()) <= 1e-5, path
    assert np.max(np.abs(jn)) > 0
    assert np.max(np.abs(gn - jn)) <= 1e-4 * np.max(np.abs(jn)), (gn, jn)


@pytest.mark.parametrize("policy", ["qm", "qe", "bitchop", "bitwave",
                                    "static"])
def test_sites_without_bits_skip_policies_that_need_them(policy):
    """With no act bits, the policies that require them (as in JAX:
    ``requires_act_bits``) leave every site as the full-precision forward
    does; static quantizes at its own bits. ``pool`` is never quantized."""
    model = tcnn.CNN(tcnn.RESNET8, policy, device="cpu")
    assert model.policy.requires_act_bits == \
        jpolicies.get(policy).requires_act_bits == (policy != "static")
    params = model.init(0)
    images = tcnn.synthetic_images(torch.Generator().manual_seed(1), 2,
                                   tcnn.RESNET8, "cpu")["images"]
    _, got = model.forward(params, images, collect_stash=True)
    _, full = tcnn.CNN(tcnn.RESNET8, device="cpu").forward(
        params, images, collect_stash=True)
    for g, f in zip(got, full):
        if policy != "static":
            assert torch.equal(g["tensor"], f["tensor"]), g["name"]
        elif g["name"] != "pool":  # each site keeps static's 3 bits
            assert torch.equal(g["tensor"], tcontainers.truncate_mantissa(
                g["tensor"], 3)), g["name"]
            assert not torch.equal(g["tensor"], f["tensor"]), g["name"]
    if policy == "static":  # the first site: Q(full precision, 3)
        assert torch.equal(got[0]["tensor"], tcontainers.truncate_mantissa(
            full[0]["tensor"], 3))
    assert not torch.equal(got[-1]["tensor"].view(torch.int32) & 0xFFFF,
                           torch.zeros_like(got[-1]["tensor"],
                                            dtype=torch.int32))


def test_cnn_params_from_jax_keeps_every_bit():
    jc = jcnn.MOBILENETV3_SMALL
    jp = jax.tree.map(np.asarray, jcnn.CNN(dataclasses.replace(
        jc, n_classes=10)).init(jax.random.PRNGKey(0)))
    tp = convert.cnn_params_from_jax(jp)
    blk = jp["s1b0"]
    # HWIO -> OIHW; the depthwise (3, 3, 1, C) -> (C, 1, 3, 3).
    assert tp["s1b0"]["dw"].shape == (blk["dw"].shape[3], 1, 3, 3)
    assert tp["stem"]["w"].shape == (16, 3, 3, 3)
    assert tp["s1b0"]["se_r"].shape == blk["se_r"].shape
    for path, t in float_leaves(tp):
        a = jp
        for k in path:
            a = a[k]
        back = t.permute(2, 3, 1, 0).numpy() if t.dim() == 4 else t.numpy()
        np.testing.assert_array_equal(back.view(np.uint32),
                                      a.view(np.uint32))
    assert tp["fc"].shape == (576, 10)
