"""Structure of the PyTorch port: import boundaries, config parity, device
rules, kernel wrappers that never fall back, codec coverage, conversion."""
import ast
import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from repro import configs as jconfigs
from repro.configs.base import reduced as jreduced
from repro import codecs as jcodecs
from repro_torch import codecs as tcodecs
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch import policies as tpolicies
from repro_torch.configs.base import reduced as treduced
from repro_torch.kernels import _lib
from repro_torch.kernels import bitplane_pack as tbp
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import gecko_pack as tgp
from repro_torch.kernels import mantissa_quant as tmq
from repro_torch.kernels import ops as tops
from repro_torch.kernels import packed_flash_decode as tpfd
from repro_torch.kernels import sfp_pack as tsp
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.models import cnn as tcnn
from repro_torch.models.model import DecoderModel
from repro_torch.train import cnn as tcnn_train
from repro_torch.serve import engine

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_repro(path):
    bad = [m for m in _imports(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro", "ml_dtypes")]
    assert not bad, f"{path} imports {bad}"


def _same_fields(jc, tc):
    for f in dataclasses.fields(jc):
        assert getattr(tc, f.name) == getattr(jc, f.name), f.name
    assert {f.name for f in dataclasses.fields(tc)} == \
        {f.name for f in dataclasses.fields(jc)}
    assert str(tc.compute_dtype).split(".")[-1] == jnp.dtype(
        jc.compute_dtype).name


@pytest.mark.parametrize("cut", [None, dict(), dict(n_layers=4, d_model=256)])
def test_gemma2_2b_config_matches_jax(cut):
    jc, tc = jconfigs.get("gemma2-2b"), tconfigs.get("gemma2-2b")
    if cut is not None:
        jc, tc = jreduced(jc, **cut), treduced(tc, **cut)
    _same_fields(jc, tc)
    assert tc.layer_kinds() == tuple(
        jc.period[i % len(jc.period)] for i in range(jc.n_layers))


def _no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_gpu(monkeypatch):
    _no_gpu(monkeypatch)
    cfg = treduced(tconfigs.get("gemma2-2b"))
    with pytest.raises(RuntimeError, match="CUDA"):
        DecoderModel(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        DecoderModel(cfg, "qm")
    with pytest.raises(RuntimeError, match="CUDA"):
        tserve.main(["--arch", "gemma2-2b", "--preset", "tiny"])
    with pytest.raises(RuntimeError, match="CUDA"):
        ttrain.main(["--arch", "gemma2-2b", "--preset", "tiny", "--steps",
                     "1"])
    model = DecoderModel(cfg, device="cpu")
    params = model.init(0)
    model.device = torch.device("cuda")  # a model placed on the card
    with pytest.raises(RuntimeError, match="CUDA"):
        engine.generate(model, params, torch.zeros((1, 4), dtype=torch.long),
                        2)


def test_cnn_entry_points_raise_without_gpu(monkeypatch):
    _no_gpu(monkeypatch)
    for cfg in (tcnn.RESNET18, tcnn.RESNET8, tcnn.MOBILENETV3_SMALL):
        with pytest.raises(RuntimeError, match="CUDA"):
            tcnn.CNN(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        tcnn.CNN(tcnn.RESNET8, "qm")
    with pytest.raises(RuntimeError, match="CUDA"):
        tcnn.synthetic_images(torch.Generator(), 2, tcnn.RESNET8)
    with pytest.raises(RuntimeError, match="CUDA"):
        tcnn_train.run("qm", steps=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        tcnn_train.stash({}, "none")
    with pytest.raises(ValueError, match="mode"):
        tcnn_train.make_step(tcnn.CNN(tcnn.RESNET8, device="cpu"), "qe")


@pytest.mark.parametrize("mode", ["none", "qm", "bitchop"])
def test_cnn_run_on_cpu_when_asked(monkeypatch, mode):
    """ResNet-8, 2 steps of batch 4 and the Table I stash, on the CPU."""
    _no_gpu(monkeypatch)
    r = tcnn_train.run(mode, steps=2, batch=4, device="cpu")
    assert len(r["history"]) == 2
    assert all(np.isfinite(h["loss"]) for h in r["history"])
    bits = {"qm": r["final_qm_bits_per_layer"],
            "bitchop": float(r["final_bc_bits"])}.get(mode)
    stash = tcnn_train.stash(r["params"], mode, act_bits=bits, device="cpu")
    assert [s["name"] for s in stash][-1] == "pool"
    assert stash[0]["tensor"].shape == (8, 32, 32, 16)
    fp = tcnn_train.stash_footprint(stash, 23 if bits is None else bits)
    assert fp["fp32_bits"] == 32 * 8 * 73_792
    assert 0 < fp["vs_fp32"] < 1 and fp["vs_bf16"] == 2 * fp["vs_fp32"]


def test_launcher_runs_on_cpu_when_asked(monkeypatch):
    _no_gpu(monkeypatch)
    rep = tserve.run_batch(tserve.build_parser().parse_args(
        ["--arch", "gemma2-2b", "--preset", "tiny", "--batch", "2",
         "--prompt-len", "8", "--max-new", "3", "--kv-container", "sfp8",
         "--device", "cpu"]))
    assert rep["tokens"] == 6 and len(rep["sample"]) == 3


def _meta(shape, dtype):
    """A tensor that is not on the CPU (stands in for a CUDA tensor)."""
    return torch.empty(shape, dtype=dtype, device="meta")


N_DIRECT = 13  # the first entries call a kernel wrapper directly


def _wrapper_calls(fields, dense):
    q = _meta((2, 1, 4, 192), torch.bfloat16)
    pay = _meta((2, 16, 384), torch.uint8)
    dpay = _meta((2, 16, 3 * dense.group_payload_bytes), torch.uint8)
    bas = _meta((2, 16, 3), torch.uint8)
    pos = _meta((2,), torch.int32)
    x = _meta((2, 16, 2, 192), torch.bfloat16)
    lse = _meta((4, 16), torch.float32)
    rows = _meta((8, 128), torch.bfloat16)
    n = _meta((), torch.int32)
    planes = _meta((8, dense.group_payload_bytes), torch.uint8)
    groups = _meta((8, 64), torch.uint8)
    gbases, gplanes = _meta((8, 8), torch.uint8), _meta((8, 63), torch.uint8)
    return [
        ("sfp_pack", lambda: tsp.sfp_pack(rows, fields)),
        ("sfp_quantize_pack", lambda: tsp.sfp_quantize_pack(rows, n, fields)),
        ("sfp_unpack", lambda: tsp.sfp_unpack(
            _meta((8, 128), torch.uint8), _meta((8, 1), torch.uint8),
            torch.bfloat16, fields)),
        ("bitplane_pack", lambda: tbp.bitplane_pack(rows, dense)),
        ("bitplane_quantize_pack", lambda: tbp.bitplane_quantize_pack(
            rows, n, dense)),
        ("bitplane_unpack", lambda: tbp.bitplane_unpack(
            planes, _meta((8, 1), torch.uint8), torch.bfloat16, dense)),
        ("mantissa_quantize", lambda: tmq.mantissa_quantize(rows, n)),
        ("flash_attention", lambda: tfa.flash_attention(x, x, x, q_rep=1)),
        ("flash_attention_bwd", lambda: tfa.flash_attention_bwd(
            x, x, x, x, x, lse, q_rep=1)),
        ("packed_flash_decode", lambda: tpfd.packed_flash_decode(
            q, pay, bas, pay, bas, pos, fields)),
        ("packed_flash_decode_dense", lambda: tpfd.packed_flash_decode_dense(
            q, dpay, bas, dpay, bas, pos, dense)),
        ("gecko_pack", lambda: tgp.gecko_pack(groups)),
        ("gecko_unpack", lambda: tgp.gecko_unpack(gbases, gplanes)),
        ("ops.sfp_compress_nd", lambda: tops.sfp_compress_nd(
            _meta((2, 16, 384), torch.bfloat16), fields, n=3)),
        ("ops.sfp_compress_nd dense", lambda: tops.sfp_compress_nd(
            _meta((2, 16, 384), torch.bfloat16), dense, n=3)),
        ("ops.sfp_decompress_nd", lambda: tops.sfp_decompress_nd(
            tops.Packed(pay, bas), torch.bfloat16, fields)),
        ("ops.sfp_decompress_nd dense", lambda: tops.sfp_decompress_nd(
            tops.Packed(dpay, bas), torch.bfloat16, dense)),
        ("ops.sfp_decompress dense", lambda: tops.sfp_decompress(
            tops.Packed(planes, _meta((8, 1), torch.uint8)), (1000,),
            torch.bfloat16, dense)),
        ("ops.mantissa_quantize", lambda: tops.mantissa_quantize(rows, 3)),
        ("ops.attention", lambda: tops.attention(
            _meta((2, 16, 4, 192), torch.bfloat16), x, x, softcap=50.0)),
        ("ops.packed_flash_decode", lambda: tops.packed_flash_decode(
            q, tops.Packed(pay, bas), tops.Packed(pay, bas), pos,
            fields=fields)),
        ("ops.packed_flash_decode dense", lambda: tops.packed_flash_decode(
            q, tops.Packed(dpay, bas), tops.Packed(dpay, bas), pos,
            fields=dense)),
        ("ops.gecko_encode", lambda: tops.gecko_encode(groups)),
        ("ops.gecko_decode", lambda: tops.gecko_decode(gbases, gplanes)),
    ]


def _fields():
    return (tcodecs.fields_for("sfp8", torch.bfloat16),
            tcodecs.fields_for("sfp-m2e4", torch.bfloat16))


@pytest.mark.parametrize("i", range(24))
def test_wrappers_raise_when_library_cannot_load(monkeypatch, i):
    """A tensor off the CPU goes to the kernel or raises: never to the
    plain version, even when the kernel library is unavailable."""
    def fail():
        raise _lib.KernelUnavailable("mocked: no kernel library")
    monkeypatch.setattr(_lib, "load", fail)
    calls = _wrapper_calls(*_fields())
    assert len(calls) == 24
    name, call = calls[i]
    with pytest.raises(_lib.KernelUnavailable, match="mocked"):
        call()


def test_wrappers_check_device_before_launch(monkeypatch):
    monkeypatch.setattr(_lib, "load", lambda: object())
    for name, call in _wrapper_calls(*_fields())[:N_DIRECT]:
        with pytest.raises(ValueError):
            call()
    # Each wrapper refuses the other layout's geometry.
    sfp8, dense = _fields()
    with pytest.raises(ValueError, match="dense bit-plane"):
        tsp._check_fields("bitplane_pack", sfp8, dense=True)
    with pytest.raises(ValueError, match="fixed-lane"):
        tsp._check_fields("sfp_pack", dense)


def test_unpack_has_no_kernel_yet(monkeypatch):
    """The sfp_unpack kernel exists now: its wrapper checks device, word
    dtype and output dtype before it launches, and never falls back."""
    monkeypatch.setattr(_lib, "load", lambda: object())
    f = tcodecs.fields_for("sfp8", torch.bfloat16)
    bases = _meta((2, 1), torch.uint8)
    with pytest.raises(ValueError, match="CUDA"):
        tops.sfp_decompress_nd(tops.Packed(_meta((2, 128), torch.uint8),
                                           bases), torch.bfloat16, f)
    with pytest.raises(ValueError, match="uint8"):
        tsp.sfp_unpack(_meta((2, 128), torch.int16), bases, torch.bfloat16,
                       f)
    with pytest.raises(ValueError, match="bf16 or f32"):
        tsp.sfp_unpack(_meta((2, 128), torch.uint8), bases, torch.float16,
                       f)


def test_plain_backend_hook_is_test_only(monkeypatch):
    tops.force_backend("plain")
    try:
        x = torch.randn(4, 256).to(torch.bfloat16)
        p = tops.sfp_compress_nd(x, tcodecs.fields_for("sfp8", x.dtype))
        assert p.payload.shape == (4, 256) and p.bases.shape == (4, 2)
    finally:
        tops.force_backend(None)
    # 'plain attention' leaves every other entry point on its kernel: a
    # tensor off the CPU reaches the packing kernel's wrapper (here, a
    # library that cannot load), while attention takes its plain version.
    def fail():
        raise _lib.KernelUnavailable("mocked: no kernel library")
    monkeypatch.setattr(_lib, "load", fail)
    tops.force_backend("plain attention")
    try:
        with pytest.raises(_lib.KernelUnavailable, match="mocked"):
            tops.sfp_compress_nd(_meta((4, 256), torch.bfloat16),
                                 tcodecs.fields_for("sfp8", torch.bfloat16))
        q = torch.randn(1, 4, 2, 16)
        assert tops.attention(q.to("meta"), q[:, :, :1].to("meta"),
                              q[:, :, :1].to("meta")).shape == (1, 4, 2, 16)
    finally:
        tops.force_backend(None)
    with pytest.raises(ValueError):
        tops.force_backend("interpret")


@pytest.mark.parametrize("name", ["sfp-m1e2", "gecko8", "sfp-m2e4",
                                  "sfp8-m2e5"])
def test_unported_containers_say_so(name):
    """None of these four names waits for a slice any more: gecko8 is
    registered, the parametric SFP names resolve through the codec
    factory, and each packs byte-equal to the JAX package."""
    assert tcodecs.validate_name(name).name == name
    x = torch.linspace(-3, 3, 384).to(torch.bfloat16).reshape(3, 128)
    got = tcodecs.get(name).pack(x, bits=1)
    want = jcodecs.get(name).pack(
        jnp.asarray(x.float().numpy()).astype(jnp.bfloat16), bits=1)
    assert set(got.data) == set(want.data)
    for k, v in want.data.items():
        np.testing.assert_array_equal(got.data[k].numpy(), np.asarray(v))


def test_codec_names_and_validation():
    tcodecs.get("sfp-m2e4")  # built by the factory, not registered
    assert tcodecs.names() == ["bit_exact", "gecko8", "sfp16", "sfp8"]
    with pytest.raises(ValueError, match="did you mean 'sfp8'"):
        tcodecs.validate_name("spf8")
    with pytest.raises(ValueError, match="unknown container"):
        tcodecs.validate_name("sfp-m2")
    x = torch.linspace(-3, 3, 256).to(torch.bfloat16)
    for name in ("sfp8", "bit_exact"):
        got = tcodecs.get(name).pack(x, bits=3)
        want = jcodecs.get(name).pack(jnp.asarray(x.float().numpy()).astype(
            jnp.bfloat16), bits=3)
        np.testing.assert_array_equal(
            got.data["payload"].view(torch.int16 if name == "bit_exact"
                                     else torch.uint8).numpy(),
            np.asarray(want.data["payload"]).view(
                np.int16 if name == "bit_exact" else np.uint8))


def test_policy_names_and_validation():
    assert tpolicies.names() == ("afloat", "bitchop", "bitwave", "none",
                                 "qe", "qm", "static")
    # The controller, static and afloat policies' modules and gradient
    # compression are among the files whose imports are checked (no jax,
    # no repro).
    for rel in ("core/bitchop.py", "policies/bitwave.py",
                "policies/static.py", "policies/afloat.py",
                "train/grad_compress.py"):
        assert ROOT / "src" / "repro_torch" / rel in PORT_FILES, rel
    assert tpolicies.coerce(None).name == "none"
    assert tpolicies.get("qm", container="sfp8", gamma=0.2).gamma == 0.2
    with pytest.raises(ValueError, match="did you mean 'qm'"):
        tpolicies.validate_name("qn")
    comp = tpolicies.get("qm+qe", container="sfp-m2e4", gamma=0.2)
    assert isinstance(comp, tpolicies.CompositePolicy)
    assert comp.name == "qm+qe" and comp.container == "sfp-m2e4"
    assert [p.gamma for p in comp.policies] == [0.2, 0.2]
    assert tpolicies.validate_name("qm+qe") == ("qm", "qe")
    assert tpolicies.validate_name("qm+bitchop") == ("qm", "bitchop")
    for name in ("afloat", "qm+afloat"):
        assert tpolicies.validate_name(name) == tuple(name.split("+"))
        assert tpolicies.get(name, container="sfp-m2e4").name == name
    with pytest.raises(ValueError, match="duplicate"):
        tpolicies.validate_name("qm+qm")
    with pytest.raises(TypeError):
        tpolicies.get("none", gamma=0.1)


def test_convert_keeps_bits_and_unstacks_periods():
    rng = np.random.default_rng(0)
    bf = jnp.asarray(rng.standard_normal((3, 4)), jnp.bfloat16)
    t = convert.to_tensor(np.asarray(bf))
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.view(torch.int16).numpy().view(np.uint16),
                                  np.asarray(bf).view(np.uint16))
    cfg = dataclasses.replace(treduced(tconfigs.get("gemma2-2b")),
                              n_layers=5)
    stacked = {"embed": {"table": np.zeros((2, 2), np.float32)},
               "final_norm": {"scale": np.zeros(2, np.float32)},
               "periods": {f"slot{s}": {"w": np.arange(2, dtype=np.float32)
                                        * 10 + s} for s in range(2)},
               "rem": {"slot0": {"w": np.float32(99)}}}
    layers = convert.from_jax(stacked, cfg)["layers"]
    assert [float(layer["w"]) for layer in layers] == [0, 1, 10, 11, 99]


# The checkpoint slice's modules: among the files whose imports are checked
# (no jax, ml_dtypes or repro), and obs/validate.py stdlib-only as JAX's is.
CKPT_SLICE = ("checkpoint/__init__.py", "checkpoint/manager.py",
              "obs/validate.py", "serve/precision.py", "train/loop.py",
              "launch/train.py", "launch/serve.py", "codecs/base.py")


@pytest.mark.parametrize("rel", CKPT_SLICE)
def test_checkpoint_slice_imports(rel):
    path = ROOT / "src" / "repro_torch" / rel
    assert path in PORT_FILES
    mods = {m.split(".")[0] for m in _imports(path)}
    assert not mods & {"jax", "jaxlib", "repro", "ml_dtypes"}, mods
    if rel == "obs/validate.py":
        assert mods <= {"__future__", "argparse", "json", "re", "sys",
                        "pathlib", "typing"}, mods


@pytest.mark.parametrize("cut", [None, dict(), dict(n_layers=12,
                                                    d_model=256)])
def test_gemma3_12b_config_matches_jax(cut):
    """The port's registry has gemma3-12b, field for field JAX's (head dim
    240, QK norm, no softcaps, a 5:1 period), also as the launchers' tiny
    and small presets cut it."""
    assert "gemma3-12b" in tconfigs.base._REGISTRY
    jc, tc = jconfigs.get("gemma3-12b"), tconfigs.get("gemma3-12b")
    if cut is not None:
        jc, tc = jreduced(jc, **cut), treduced(tc, **cut)
    _same_fields(jc, tc)
    assert tc.layer_kinds() == tuple(
        jc.period[i % len(jc.period)] for i in range(jc.n_layers))
    assert not tc.remainder


@pytest.mark.parametrize("container", ["sfp8", "sfp-m2e4"])
def test_gemma3_launchers_run_on_cpu_when_asked(monkeypatch, container):
    """``launch.serve`` and ``launch.train --preset tiny`` take
    ``--arch gemma3-12b`` as they take gemma2-2b."""
    _no_gpu(monkeypatch)
    rep = tserve.run_batch(tserve.build_parser().parse_args(
        ["--arch", "gemma3-12b", "--preset", "tiny", "--batch", "2",
         "--prompt-len", "40", "--max-new", "3", "--kv-container",
         container, "--device", "cpu"]))
    assert rep["tokens"] == 6 and len(rep["sample"]) == 3
    policy = "qm" if container == "sfp8" else "qm+qe"
    out = ttrain.main(["--arch", "gemma3-12b", "--preset", "tiny",
                       "--policy", policy, "--container", container,
                       "--steps", "1", "--device", "cpu"])
    assert len(out["history"]) == 1
    assert np.isfinite(out["history"][0]["loss"])
    assert out["state"].params["layers"][0]["attn"]["q_norm"][
        "scale"].shape == (32,)


DENSE_CONFIGS = ("gemma2-27b", "mistral-large-123b")


@pytest.mark.parametrize("arch", DENSE_CONFIGS)
@pytest.mark.parametrize("cut", [None, dict(), dict(n_layers=4,
                                                    d_model=256)])
def test_dense_config_matches_jax(arch, cut):
    """The port's registry has gemma2-27b (head dim 144, softcaps 50 / 30)
    and mistral-large-123b (GQA rep 12, an untied head), field for field
    JAX's, also as the launchers' tiny and small presets cut them; both
    build, and only the untied one has a head."""
    assert arch in tconfigs.base._REGISTRY
    jc, tc = jconfigs.get(arch), tconfigs.get(arch)
    if cut is not None:
        jc, tc = jreduced(jc, **cut), treduced(tc, **cut)
    _same_fields(jc, tc)
    assert tc.layer_kinds() == tuple(
        jc.period[i % len(jc.period)] for i in range(jc.n_layers))
    assert not tc.remainder
    if cut is not None:
        params = DecoderModel(tc, device="cpu").init(0)
        assert ("head" in params) == (not tc.tie_embeddings)


@pytest.mark.parametrize("arch,container", [
    ("gemma2-27b", "sfp8"), ("mistral-large-123b", "sfp8"),
    ("mistral-large-123b", "sfp-m2e4")])
def test_dense_config_launchers_run_on_cpu_when_asked(monkeypatch, arch,
                                                      container):
    """``launch.serve`` and ``launch.train --preset tiny`` take
    ``--arch gemma2-27b`` and ``--arch mistral-large-123b``."""
    _no_gpu(monkeypatch)
    rep = tserve.run_batch(tserve.build_parser().parse_args(
        ["--arch", arch, "--preset", "tiny", "--batch", "2",
         "--prompt-len", "40", "--max-new", "3", "--kv-container",
         container, "--device", "cpu"]))
    assert rep["tokens"] == 6 and len(rep["sample"]) == 3
    policy = "qm" if container == "sfp8" else "qm+qe"
    out = ttrain.main(["--arch", arch, "--preset", "tiny", "--policy",
                       policy, "--container", container, "--steps", "1",
                       "--device", "cpu"])
    assert len(out["history"]) == 1
    assert np.isfinite(out["history"][0]["loss"])
    cfg = treduced(tconfigs.get(arch))
    assert ("head" in out["state"].params) == (not cfg.tie_embeddings)


def test_train_profile_writes_a_trace(monkeypatch, tmp_path):
    """``launch.train --profile-steps N --profile-start S --profile-dir D``
    (JAX's flags and defaults) writes the window's Chrome trace under D,
    on the CPU too, beside the printed kernel table."""
    _no_gpu(monkeypatch)
    args = ttrain.build_parser().parse_args(["--arch", "gemma2-2b"])
    assert (args.profile_start, args.profile_dir) == (
        1, "experiments/traces/train")
    out = ttrain.main(["--arch", "gemma2-2b", "--preset", "tiny",
                       "--policy", "qm", "--container", "sfp8", "--steps",
                       "3", "--profile-steps", "1", "--profile-start", "2",
                       "--profile-dir", str(tmp_path / "traces"),
                       "--device", "cpu"])
    trace = tmp_path / "traces" / "train_steps_2-2.json"
    assert out["profile"]["trace"] == str(trace)
    assert out["profile"]["steps"] == 1
    events = json.loads(trace.read_text())["traceEvents"]
    assert any(e.get("ph") == "X" for e in events)
