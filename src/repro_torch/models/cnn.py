"""CNNs of the paper's evaluation (§VI): ResNet-18, ResNet-8 and
MobileNetV3-Small (the port of ``repro.models.cnn``).

Parameters are a plain dict laid out as the JAX package's, except that
convolution kernels are OIHW (depthwise ``(C, 1, kh, kw)`` with
``groups=C``); ``repro_torch.convert.cnn_params_from_jax`` transposes
JAX's HWIO tree leaf by leaf. Activations are NCHW-logical tensors in
``torch.channels_last`` memory, so the NHWC view each stash entry keeps
(``permute(0, 2, 3, 1)``) costs nothing and lists the values in JAX's
order: Gecko groups 64 consecutive values of ``reshape(-1)``, and another
order would give other exponent bits.

Convolutions pad as XLA's "SAME" does: for a stride-2 3x3 convolution on
an even size the padding is (0, 1), not PyTorch's symmetric (1, 1).

``forward(..., act_bits=, generator=)`` quantizes every stash site
through the policy's ``quantize_act``: ``act_bits`` is a scalar, a
``{site: value}`` dict or a ``{site: slice dict}`` dict (BitWave's
``{"act", "act_e"}``); a policy that ``requires_act_bits`` skips a site
whose bits are None. Draws come from ``generator``, one a site in site
order. ``collect_stash=True`` returns every stashed activation with its
``signless`` and ``relu_pool`` tags for ``core.footprint``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch import policies, resolve_device
from repro_torch.configs.base import _TORCH_DTYPES
from repro_torch.models import common

# The class prototypes of ``synthetic_images`` come from this seed (they
# define the task); the caller's generator draws labels and noise.
PROTO_SEED = 1234


@dataclasses.dataclass(frozen=True)
class CNNConfig:
    name: str = "resnet18"
    arch: str = "resnet"          # 'resnet' | 'mobilenetv3'
    stages: Tuple[int, ...] = (2, 2, 2, 2)
    widths: Tuple[int, ...] = (64, 128, 256, 512)
    stem_width: int = 64
    n_classes: int = 1000
    img_size: int = 224
    in_ch: int = 3
    dtype: str = "float32"

    @property
    def compute_dtype(self) -> torch.dtype:
        return _TORCH_DTYPES[self.dtype]


RESNET18 = CNNConfig()
RESNET8 = CNNConfig(name="resnet8", stages=(1, 1, 1), widths=(16, 32, 64),
                    stem_width=16, n_classes=10, img_size=32)
MOBILENETV3_SMALL = CNNConfig(
    name="mobilenetv3-small", arch="mobilenetv3",
    stages=(1, 2, 3, 2, 3), widths=(16, 24, 40, 96, 576),
    stem_width=16, n_classes=1000, img_size=224)


def same_pads(size: int, k: int, stride: int) -> Tuple[int, int]:
    """XLA's "SAME" padding (low, high) of one spatial dimension."""
    total = max((-(-size // stride) - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
         groups: int = 1) -> torch.Tensor:
    """``lax.conv_general_dilated(padding="SAME")`` on NCHW / OIHW."""
    (top, bottom), (left, right) = (
        same_pads(x.shape[d], w.shape[d], stride) for d in (2, 3))
    if top == bottom and left == right:
        return F.conv2d(x, w, stride=stride, padding=(top, left),
                        groups=groups)
    return F.conv2d(F.pad(x, (left, right, top, bottom)), w, stride=stride,
                    groups=groups)


def norm(params, x: torch.Tensor) -> torch.Tensor:
    """Per-sample, per-channel affine norm over H and W (f32 statistics,
    population variance, eps 1e-5), cast back to ``x``'s dtype."""
    xf = x.to(torch.float32)
    var, mu = torch.var_mean(xf, dim=(2, 3), keepdim=True, correction=0)
    y = (xf - mu) * torch.rsqrt(var + 1e-5)
    return (y * params["scale"][:, None, None]
            + params["bias"][:, None, None]).to(x.dtype)


def _hswish(x: torch.Tensor) -> torch.Tensor:
    return x * F.relu6(x + 3.0) / 6.0


def _stashed(x: torch.Tensor) -> torch.Tensor:
    """A stash entry: detached, in NHWC order (a view under channels_last)."""
    x = x.detach()
    return x.permute(0, 2, 3, 1) if x.dim() == 4 else x


class CNN:
    def __init__(self, cfg: CNNConfig, policy=None,
                 device: Optional[Union[str, torch.device]] = None):
        """``policy``: a ``policies.Policy``, a registry name or None (full
        precision). ``device`` defaults to CUDA and raises without a GPU;
        pass ``device="cpu"`` for the CPU."""
        self.cfg = cfg
        self.policy = policies.coerce(policy)
        self.device = resolve_device(device)
        self.dims = policies.ScopeDims.for_dtype(cfg.compute_dtype)

    # -- parameters ----------------------------------------------------------

    def _blocks(self):
        """(name, stage, cin, cout, stride) of every block in order."""
        cfg, cin = self.cfg, self.cfg.stem_width
        for si, (n_blocks, cout) in enumerate(zip(cfg.stages, cfg.widths)):
            for bi in range(n_blocks):
                yield (f"s{si}b{bi}", cin, cout,
                       2 if (bi == 0 and si > 0) else 1)
                cin = cout

    def init(self, seed: int = 0) -> Dict[str, Any]:
        """Random weights from a ``torch.Generator`` seeded with ``seed``:
        N(0, 1 / fan_in) kernels and matrices, norms at scale 1, bias 0."""
        cfg, dev, dt = self.cfg, self.device, self.cfg.compute_dtype
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)

        def kernel(kh, kw, cin, cout):
            return common.normal_init((cout, cin, kh, kw), gen, dev, dt,
                                      scale=(kh * kw * cin) ** -0.5)

        def norm_init(c):
            return {"scale": torch.ones(c, dtype=torch.float32, device=dev),
                    "bias": torch.zeros(c, dtype=torch.float32, device=dev)}

        params = {"stem": {"w": kernel(3, 3, cfg.in_ch, cfg.stem_width),
                           "n": norm_init(cfg.stem_width)}}
        for name, cin, cout, stride in self._blocks():
            if cfg.arch == "resnet":
                blk = {"c1": kernel(3, 3, cin, cout), "n1": norm_init(cout),
                       "c2": kernel(3, 3, cout, cout), "n2": norm_init(cout)}
                if stride != 1 or cin != cout:
                    blk["proj"] = kernel(1, 1, cin, cout)
            else:
                exp = max(cin * 3, cout)
                red = max(exp // 4, 8)
                blk = {"pw1": kernel(1, 1, cin, exp), "n1": norm_init(exp),
                       "dw": kernel(3, 3, 1, exp), "n2": norm_init(exp),
                       "se_r": common.normal_init((exp, red), gen, dev, dt),
                       "se_e": common.normal_init((red, exp), gen, dev, dt),
                       "pw2": kernel(1, 1, exp, cout), "n3": norm_init(cout)}
            params[name] = blk
        cin = cfg.widths[-1]
        params["fc"] = common.normal_init((cin, cfg.n_classes), gen, dev, dt)
        return params

    # -- forward -------------------------------------------------------------

    def _quant(self, x, bits, generator, stash, name, *, signless,
               relu_pool):
        """Quantize one stash site through the policy and record it."""
        pol = self.policy
        if pol.enabled:
            b = bits[name] if isinstance(bits, dict) else bits
            if b is not None or not pol.requires_act_bits:
                pslice = b if isinstance(b, dict) else {"act": b}
                x = pol.quantize_act(x, pslice, generator, self.dims)
        if stash is not None:
            stash.append({"name": name, "tensor": _stashed(x),
                          "signless": signless, "relu_pool": relu_pool})
        return x

    def forward(self, params, images: torch.Tensor, *, act_bits=None,
                generator: Optional[torch.Generator] = None,
                collect_stash: bool = False
                ) -> Tuple[torch.Tensor, Optional[List[Dict]]]:
        """Logits of NCHW-logical ``images`` and, with ``collect_stash``,
        the stash entries in site order (the last one ``pool``)."""
        cfg = self.cfg
        if generator is None:
            generator = torch.Generator(device=self.device)
            generator.manual_seed(0)
        stash: Optional[List[Dict]] = [] if collect_stash else None

        def quant(x, name, signless):
            return self._quant(x, act_bits, generator, stash, name,
                               signless=signless, relu_pool=False)

        x = images.to(cfg.compute_dtype).contiguous(
            memory_format=torch.channels_last)
        x = conv(x, params["stem"]["w"], stride=1 if cfg.img_size <= 64 else 2)
        x = quant(F.relu(norm(params["stem"]["n"], x)), "stem", True)
        for name, _, _, stride in self._blocks():
            blk = params[name]
            if cfg.arch == "resnet":
                r = x
                y = F.relu(norm(blk["n1"], conv(x, blk["c1"], stride)))
                y = quant(y, f"{name}.a1", True)
                y = norm(blk["n2"], conv(y, blk["c2"]))
                if "proj" in blk:
                    r = conv(r, blk["proj"], stride)
                x = quant(F.relu(y + r), f"{name}.out", True)
            else:
                y = _hswish(norm(blk["n1"], conv(x, blk["pw1"])))
                y = quant(y, f"{name}.exp", False)
                y = _hswish(norm(blk["n2"], conv(y, blk["dw"], stride,
                                                 groups=y.shape[1])))
                se = torch.mean(y.to(torch.float32), dim=(2, 3))
                se = torch.sigmoid(
                    F.relu(se @ blk["se_r"].to(torch.float32))
                    @ blk["se_e"].to(torch.float32))
                y = y * se[:, :, None, None].to(y.dtype)
                y = norm(blk["n3"], conv(y, blk["pw2"]))
                x = y + x if y.shape == x.shape else y
                x = quant(x, f"{name}.out", False)

        # global average pool (a pooled-after-ReLU tensor for GIST++)
        pooled = torch.mean(x.to(torch.float32), dim=(2, 3))
        if stash is not None:
            stash.append({"name": "pool", "tensor": pooled.detach(),
                          "signless": True,
                          "relu_pool": cfg.arch == "resnet"})
        return pooled @ params["fc"].to(torch.float32), stash

    def loss(self, params, batch, *, act_bits=None,
             generator: Optional[torch.Generator] = None):
        """(mean cross-entropy, {"xent", "acc"})."""
        logits, _ = self.forward(params, batch["images"], act_bits=act_bits,
                                 generator=generator)
        labels = batch["labels"]
        logp = F.log_softmax(logits, dim=-1)
        nll = -torch.gather(logp, 1, labels[:, None]).mean()
        acc = torch.mean((torch.argmax(logits, -1) == labels)
                         .to(torch.float32))
        return nll, {"xent": nll, "acc": acc}


def synthetic_images(generator: torch.Generator, n: int, cfg: CNNConfig,
                     device: Optional[Union[str, torch.device]] = None
                     ) -> Dict[str, torch.Tensor]:
    """Clusterable images: class-conditional gaussian blobs + noise, as
    NCHW-logical channels_last tensors. The class prototypes come from
    ``PROTO_SEED``; ``generator`` (on ``device``) draws labels and noise."""
    dev = resolve_device(device)
    shape = (cfg.img_size, cfg.img_size, cfg.in_ch)
    labels = torch.randint(0, cfg.n_classes, (n,), generator=generator,
                           device=dev)
    pgen = torch.Generator(device=dev)
    pgen.manual_seed(PROTO_SEED)
    protos = torch.randn((cfg.n_classes,) + shape, generator=pgen,
                         device=dev) * 1.2
    imgs = protos[labels] + 0.3 * torch.randn((n,) + shape,
                                              generator=generator, device=dev)
    return {"images": imgs.to(cfg.compute_dtype).permute(0, 3, 1, 2),
            "labels": labels}
