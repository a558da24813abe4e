"""Decoder model for the GLOBAL/LOCAL attention families with a dense MLP.

Parameters are a plain dict: ``embed``, ``final_norm`` and ``layers``, one
dict per layer in order (the JAX package stacks each period's layers and
scans over them; ``repro_torch.convert`` unstacks that tree). Serving runs
``prefill`` over the prompt and ``decode_step`` per token over a KV cache
that is updated in place — raw bf16, or packed by a registry codec
(``kv_container``) and read through the fused decode kernel.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig, GLOBAL, LOCAL
from repro_torch.models import attention, common
from repro_torch.serve import kvcache


class DecoderModel:
    def __init__(self, cfg: ArchConfig, kv_container: Optional[str] = None,
                 device: Optional[Union[str, torch.device]] = None):
        """``device`` defaults to CUDA and raises without a GPU; pass
        ``device="cpu"`` for the plain path on the CPU."""
        bad = set(cfg.period) - {GLOBAL, LOCAL}
        if bad or cfg.is_moe or not cfg.tie_embeddings or cfg.qk_norm:
            raise NotImplementedError(
                f"{cfg.name}: only dense GLOBAL/LOCAL attention models with "
                f"tied embeddings are ported (got period {cfg.period})")
        self.cfg = cfg
        self.kv_container = kv_container
        self.device = resolve_device(device)
        self.kinds = cfg.layer_kinds()

    # -- parameters ----------------------------------------------------------

    def init(self, seed: int = 0) -> Dict[str, Any]:
        """Random weights from a ``torch.Generator`` seeded with ``seed``
        (normal, fan_in ** -0.5; embeddings unit scale; norms zero)."""
        cfg, dev, dt = self.cfg, self.device, self.cfg.compute_dtype
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        params = {
            "embed": {"table": common.normal_init(
                (cfg.padded_vocab, cfg.d_model), gen, dev, dt, scale=1.0)},
            "final_norm": common.rmsnorm_init(cfg.d_model, dev, dt),
            "layers": [],
        }
        for _ in self.kinds:
            params["layers"].append({
                "pre_norm": common.rmsnorm_init(cfg.d_model, dev, dt),
                "attn": attention.attn_init(cfg, gen, dev, dt),
                "mlp_norm": common.rmsnorm_init(cfg.d_model, dev, dt),
                "mlp": common.mlp_init(cfg.d_model, cfg.d_ff, cfg.glu, gen,
                                       dev, dt),
            })
        return params

    # -- serving -------------------------------------------------------------

    def _emb_scale(self):
        return (self.cfg.d_model ** 0.5) if self.cfg.emb_scale else None

    def _cache_len(self, kind: str, max_len: int) -> int:
        if self.kv_container is not None:
            return kvcache.cache_len(self.cfg, kind, max_len)
        return min(max_len, self.cfg.window) if kind == LOCAL else max_len

    def init_cache(self, batch: int, max_len: int) -> Dict[str, Any]:
        cfg = self.cfg
        if self.kv_container is not None:
            layers = [kvcache.packed_cache_init(
                cfg, kind, batch, max_len, self.kv_container,
                device=self.device) for kind in self.kinds]
        else:
            layers = [attention.cache_init(cfg, kind, batch, max_len,
                                           cfg.compute_dtype, self.device)
                      for kind in self.kinds]
        return {"layers": layers}

    def prefill(self, params, tokens: torch.Tensor, max_len: int
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """Process a prompt (B, S): (last-position logits (B, 1, V) f32,
        cache sized for ``max_len`` positions)."""
        cfg = self.cfg
        B, S = tokens.shape
        max_len = max(max_len, S)
        h = common.embed(params["embed"], tokens, self._emb_scale())
        positions = torch.arange(S, device=tokens.device)
        caches = []
        for lp, kind in zip(params["layers"], self.kinds):
            hn = common.rmsnorm(lp["pre_norm"], h)
            out, (k, v) = attention.attention_train(
                lp["attn"], hn, cfg, kind=kind, positions=positions,
                return_kv=True)
            h = h + out
            L = self._cache_len(kind, max_len)
            if kind == LOCAL:
                k, v = attention.ring_pack_kv(k, v, L)
            else:
                k = F.pad(k, (0, 0, 0, 0, 0, L - S))
                v = F.pad(v, (0, 0, 0, 0, 0, L - S))
            c = attention.KVCache(k=k.to(cfg.compute_dtype),
                                  v=v.to(cfg.compute_dtype))
            if self.kv_container is not None:
                c = kvcache.pack_prefill_cache(c, self.kv_container)
            caches.append(c)
            hm = common.rmsnorm(lp["mlp_norm"], h)
            h = h + common.mlp(lp["mlp"], hm, cfg.act, cfg.glu)
        h = common.rmsnorm(params["final_norm"], h)
        logits = common.unembed(params, h[:, -1:], softcap=cfg.final_softcap,
                                valid_vocab=cfg.vocab)
        return logits, {"layers": caches}

    def decode_step(self, params, cache: Dict[str, Any], token: torch.Tensor,
                    pos) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """One decode step, updating ``cache`` in place. token (B, 1);
        ``pos`` an int or (B,) absolute positions. Returns (logits
        (B, 1, V) f32, cache)."""
        cfg = self.cfg
        B = token.shape[0]
        pos = torch.as_tensor(pos, dtype=torch.int64, device=token.device)
        pos = pos.reshape(-1).expand(B).contiguous()
        h = common.embed(params["embed"], token, self._emb_scale())
        for i, (lp, kind) in enumerate(zip(params["layers"], self.kinds)):
            hn = common.rmsnorm(lp["pre_norm"], h)
            if self.kv_container is not None:
                out, _ = kvcache.attention_decode_packed(
                    lp["attn"], hn, cache["layers"][i], pos, cfg, kind=kind,
                    container=self.kv_container)
            else:
                out, _ = attention.attention_decode(
                    lp["attn"], hn, cache["layers"][i], pos, cfg, kind=kind)
            h = h + out
            hm = common.rmsnorm(lp["mlp_norm"], h)
            h = h + common.mlp(lp["mlp"], hm, cfg.act, cfg.glu)
        h = common.rmsnorm(params["final_norm"], h)
        logits = common.unembed(params, h, softcap=cfg.final_softcap,
                                valid_vocab=cfg.vocab)
        return logits, cache
