"""Checkpoint manager: atomic, versioned, async (the port of
``repro.checkpoint.manager``, on its on-disk format: either package
restores the other's checkpoints bit for bit).

Layout:
  <dir>/step_00000123.tmp-<nonce>/   (written, then renamed atomically)
  <dir>/step_00000123/
      manifest.json                  (leaf names, shapes, dtypes, step)
      arr_00000.npy ...              (one file per leaf)

Fault-tolerance contract:
  * writes are crash-safe (tmp dir + rename; readers never see partials);
  * ``keep`` old checkpoints are retained for rollback;
  * optional codec compression of non-optimizer leaves: any registry
    container (``repro_torch.codecs``). ``bit_exact`` (the default when
    only ``compress_bits`` is given, on f32 leaves only) truncates
    mantissas; ``gecko8`` writes the Gecko exponent stream (lossless for
    bf16 leaves).

Leaf names are ``jax.tree_util.keystr`` of the same structure: a
NamedTuple field is ``.field``, a dict key ``['k']`` (keys in sorted
order), a list or tuple index ``[i]``; None holds no leaf. A Python int
is saved as a 0-d array and restored as an int, a ``torch.Generator`` as
its ``get_state()`` bytes, a bf16 tensor as its uint16 patterns
(``stored_as``).

``save(blocking=False)`` finishes every device-to-host copy and every
on-device pack before it returns, since the next step updates the
parameters in place; the writer thread only serializes host bytes. A
leaf packs on its own device, so on the card the codec's kernel packs and
only the packed parts cross to the host.

A sharded tree (DTensor leaves, the sharded train step's state) is saved
in the same format: every rank of the leaves' mesh calls ``save``, each
leaf is gathered whole on the calling thread (never in the writer
thread), the rank at the mesh's origin writes, and the others wait for
its write (in ``save``, or in ``wait`` after a non-blocking save).
``restore(shardings=)`` loads each leaf on the host and keeps this rank's
shard of it, so a checkpoint restores onto a mesh of another shape or
layout, or onto fewer ranks (elastic restart).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
import uuid
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import codecs, resolve_device
from repro_torch.distributed import sharding as shd
from repro_torch.codecs.base import (dtype_name, host_bits, tensor_from_bits,
                                     torch_dtype)

_COMPRESSIBLE_DTYPES = {"float32", "bfloat16", "float16"}

_NATIVE_DTYPES = {
    "float64", "float32", "float16", "int64", "int32", "int16", "int8",
    "uint64", "uint32", "uint16", "uint8", "bool", "complex64", "complex128",
}

STALE_TMP_S = 300  # a tmp dir older than this is a crash leftover


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _walk(node, path: str, out: list) -> None:
    if node is None:
        return
    if _is_namedtuple(node):
        for f in node._fields:
            _walk(getattr(node, f), f"{path}.{f}", out)
    elif isinstance(node, dict):
        for k in sorted(node):
            _walk(node[k], f"{path}[{k!r}]", out)
    elif isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            _walk(v, f"{path}[{i}]", out)
    else:
        out.append((path, node))


def named_leaves(tree: Any) -> List[Tuple[str, Any]]:
    """(manifest name, leaf) of every leaf of ``tree``, in file order."""
    out: List[Tuple[str, Any]] = []
    _walk(tree, "", out)
    return out


def leaf_names(tree: Any) -> List[str]:
    """The manifest names of ``tree``'s leaves, in file order."""
    return [name for name, _ in named_leaves(tree)]


def _rebuild(like: Any, leaves) -> Any:
    """``like``'s structure over the next leaves of the iterator."""
    if like is None:
        return None
    if _is_namedtuple(like):
        return type(like)(*(_rebuild(getattr(like, f), leaves)
                            for f in like._fields))
    if isinstance(like, dict):
        new = {k: _rebuild(like[k], leaves) for k in sorted(like)}
        return type(like)((k, new[k]) for k in like)
    if isinstance(like, (list, tuple)):
        return type(like)([_rebuild(v, leaves) for v in like])
    return next(leaves)


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3,
                 compress_bits: Optional[int] = None,
                 compress_codec: Optional[str] = None):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.compress_bits = compress_bits
        # compress_bits alone: bit_exact mantissa truncation of f32 leaves
        # only (the JAX package's historical behaviour).
        if compress_codec is None and compress_bits is not None:
            compress_codec = codecs.BIT_EXACT
            self._compress_dtypes = {"float32"}
        else:
            self._compress_dtypes = _COMPRESSIBLE_DTYPES
        self.compress_codec = compress_codec
        self._thread: Optional[threading.Thread] = None
        self._barrier = None   # the group that waits for rank 0's write
        self._error: Optional[BaseException] = None

    # ------------------------------------------------------------------

    def _step_dir(self, step: int) -> Path:
        return self.dir / f"step_{step:08d}"

    def all_steps(self) -> List[int]:
        steps = []
        for p in self.dir.glob("step_*"):
            if p.is_dir() and not p.name.endswith(".tmp") and "tmp-" not in p.name:
                try:
                    steps.append(int(p.name.split("_")[1]))
                except (IndexError, ValueError):
                    continue
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    # ------------------------------------------------------------------

    def save(self, step: int, tree: Any, *, blocking: bool = True,
             extra: Optional[Dict[str, Any]] = None) -> None:
        """Snapshot to host (device copies and packs done on return), then
        write, on a thread unless ``blocking``.

        ``extra`` is JSON-able run metadata recorded verbatim in the
        manifest (e.g. the precision-policy name) and read back by
        :meth:`read_extra`."""
        self.wait()  # never two writers at once (gc races on tmp dirs)
        codec = (codecs.get(self.compress_codec)
                 if self.compress_codec is not None else None)
        named = named_leaves(tree)
        meshes = [leaf.device_mesh for _, leaf in named
                  if isinstance(leaf, shd.DTensor)]
        writer = not meshes or shd.is_rank0(meshes[0])
        host = []
        for i, (name, leaf) in enumerate(named):
            leaf = shd.full(leaf)   # every rank of the mesh gathers
            if writer:
                host.append(self._snapshot(i, name, leaf, codec))
            del leaf
        if meshes:
            self._barrier = shd.mesh_group(meshes[0])
        if writer and blocking:
            self._write(int(step), host, extra)
        elif writer:
            self._thread = threading.Thread(
                target=self._write_guarded, args=(int(step), host, extra),
                daemon=True)
            self._thread.start()
        if blocking:
            self.wait()

    def _snapshot(self, i: int, name: str, leaf: Any, codec
                  ) -> Tuple[Dict[str, Any], np.ndarray]:
        """(manifest entry, host bytes) of one leaf."""
        if isinstance(leaf, torch.Generator):
            leaf = leaf.get_state()
        if isinstance(leaf, torch.Tensor):
            leaf = leaf.detach()
            dname, shape = dtype_name(leaf.dtype), list(leaf.shape)
        else:
            leaf = np.array(leaf)  # a copy, as a device tensor's snapshot
            dname, shape = str(leaf.dtype), list(leaf.shape)
        entry = {"name": name, "file": f"arr_{i:05d}.npy", "dtype": dname,
                 "shape": shape}
        # Compress only where lossy quantization was asked for
        # (compress_bits) or the codec is bit-exact for this dtype: gecko8
        # keeps 7 mantissa bits, so f32 leaves stay raw without bits.
        if (codec is not None and dname in self._compress_dtypes
                and len(shape) >= 2 and "opt" not in name
                and (self.compress_bits is not None
                     or codec.lossless_for(torch_dtype(dname)))):
            arr, meta = codec.encode_host(leaf, self.compress_bits)
            entry["codec"] = codec.name
            entry["codec_meta"] = meta
        elif isinstance(leaf, torch.Tensor):
            arr, _ = host_bits(leaf)
        else:
            arr = leaf
        if entry.get("codec") is None and dname not in _NATIVE_DTYPES:
            # bf16 has no numpy dtype: store its bits in a uint of the
            # same width (host_bits already gave them).
            entry["stored_as"] = f"uint{arr.dtype.itemsize * 8}"
        return entry, arr

    def _write_guarded(self, step, host, extra):
        try:
            self._write(step, host, extra)
        except BaseException as e:  # pragma: no cover
            self._error = e

    def _write(self, step: int, host, extra=None) -> None:
        final = self._step_dir(step)
        tmp = self.dir / f"{final.name}.tmp-{uuid.uuid4().hex[:8]}"
        tmp.mkdir(parents=True)
        manifest = {"step": step, "time": time.time(), "leaves": []}
        if extra:
            manifest["extra"] = extra
        for i, (entry, arr) in enumerate(host):
            host[i] = None  # release each leaf's host bytes once written
            np.save(tmp / entry["file"], arr)
            manifest["leaves"].append(entry)
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        if final.exists():
            # re-save of an existing step: swap the old dir out first
            # (os.replace cannot overwrite a non-empty directory).
            old = self.dir / f"{final.name}.old-{uuid.uuid4().hex[:8]}"
            os.rename(final, old)
            os.replace(tmp, final)
            shutil.rmtree(old, ignore_errors=True)
        else:
            os.replace(tmp, final)  # atomic publish
        self._gc()

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: max(0, len(steps) - self.keep)]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)
        # only reap stale tmp dirs (crash leftovers): a live writer may own
        # a fresh one.
        now = time.time()
        for p in self.dir.glob("step_*.tmp-*"):
            try:
                if now - p.stat().st_mtime > STALE_TMP_S:
                    shutil.rmtree(p, ignore_errors=True)
            except OSError:
                pass

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._barrier is not None:
            group, self._barrier = self._barrier, None
            torch.distributed.barrier(group=group)
        self.check()

    def check(self) -> None:
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    # ------------------------------------------------------------------

    def read_extra(self, step: int) -> Dict[str, Any]:
        """Run metadata recorded at save time ({} when there is none)."""
        manifest = json.loads(
            (self._step_dir(step) / "manifest.json").read_text())
        return manifest.get("extra", {})

    def restore(self, step: int, like: Any,
                shardings: Optional[Any] = None) -> Any:
        """Restore into the structure of ``like``: every tensor on the
        device and in the dtype of ``like``'s leaf, with its
        ``requires_grad``; ints as ints; a generator on the device of
        ``like``'s generator. A CUDA leaf needs a GPU.

        ``shardings`` (``like``'s structure, a ``sharding.Sharding`` or
        None at each leaf or subtree) re-places leaves: each becomes a
        DTensor holding this rank's shard, on the mesh's device (the
        elastic restart onto another mesh). Without it a DTensor leaf of
        ``like`` keeps its own sharding."""
        d = self._step_dir(step)
        manifest = json.loads((d / "manifest.json").read_text())
        leaves = named_leaves(like)
        by_name = {e["name"]: e for e in manifest["leaves"]}
        missing = [name for name, _ in leaves if name not in by_name]
        if missing:
            extra = manifest.get("extra", {})
            hint = (f" (checkpoint was saved with {extra})" if extra else "")
            raise ValueError(
                f"checkpoint step {step} lacks leaves {missing[:4]}"
                f"{'...' if len(missing) > 4 else ''} for the requested "
                f"state tree — e.g. a different precision policy{hint}")
        sh = (_aligned(like, shardings) if shardings is not None else
              [shd.sharding_of(leaf) if isinstance(leaf, shd.DTensor)
               else None for _, leaf in leaves])
        out = [_restore_leaf(d, by_name[name], name, leaf, s)
               for (name, leaf), s in zip(leaves, sh)]
        return _rebuild(like, iter(out))


def _aligned(like: Any, shardings: Any) -> List[Any]:
    """Per leaf of ``like`` (in ``named_leaves`` order), its sharding from
    the tree ``shardings`` (None under a None subtree)."""
    out: List[Any] = []

    def walk(node, sh):
        if node is None:
            return
        if _is_namedtuple(node):
            for f in node._fields:
                walk(getattr(node, f), None if sh is None else getattr(sh, f))
        elif isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], None if sh is None else sh[k])
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, None if sh is None else sh[i])
        else:
            out.append(sh)
    walk(like, shardings)
    return out


def _restore_leaf(d: Path, entry: Dict[str, Any], name: str, leaf: Any,
                  sharding=None):
    device = (resolve_device(leaf.device) if hasattr(leaf, "device")
              else torch.device("cpu"))
    if sharding is not None:
        device = resolve_device(sharding.mesh.device_type)
    arr = np.load(d / entry["file"])
    if isinstance(leaf, torch.Generator):
        gen = torch.Generator(device=device)
        gen.set_state(torch.from_numpy(arr))
        return gen
    if "codec" in entry:
        t = codecs.get(entry["codec"]).decode_host(
            arr, entry["codec_meta"], tuple(entry["shape"]),
            torch_dtype(entry["dtype"]), device=device)
    else:
        t = tensor_from_bits(arr, entry["dtype"])
    expect = tuple(getattr(leaf, "shape", t.shape))
    if tuple(t.shape) != expect:
        raise ValueError(
            f"checkpoint leaf {name} shape {tuple(t.shape)} != {expect}")
    if sharding is not None:
        return shd.distribute(t.to(device=device, dtype=leaf.dtype), sharding)
    if isinstance(leaf, torch.Tensor):
        t = t.to(device=device, dtype=leaf.dtype)
        return t.requires_grad_() if leaf.requires_grad else t
    if isinstance(leaf, (bool, int, float)):
        return type(leaf)(t.item())
    if isinstance(leaf, np.ndarray):
        return t.numpy().astype(leaf.dtype)
    return t
