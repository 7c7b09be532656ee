"""Checkpoint store: manifest, raw-byte shards and a COMMITTED marker.

The port of ``repro.checkpoint.store``, in the same on-disk format, so
either package restores the other's checkpoints:

    <root>/step_000123/
        manifest.json      # step, extra, tree structure, sha1[:12] digests
        shard_00000.npz    # {"<tree>:<leaf path>": raw uint8 bytes}, <= 1 GiB
        COMMITTED          # written LAST — a checkpoint without it is torn

A save is written into ``step_XXXXXXXXX.tmp`` and renamed into place;
``latest()`` ignores torn checkpoints, so a process killed mid-save
restarts from the previous good step.  Trees are nested dicts (and
lists/tuples) of arrays — numpy or torch, on any device; leaf paths join
dict keys and sequence indices with ``/``, dict keys in sorted order, as
the reference's JAX tree paths do.  Restored leaves are numpy arrays.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import time
from types import SimpleNamespace

import numpy as np
import torch

from .. import obs

COMMITTED = "COMMITTED"
_MAX_SHARD_BYTES = 1 << 30


def host_copy(leaf) -> np.ndarray:
    """A leaf as a numpy array that owns its bytes (a copy of a tensor, so
    later in-place steps cannot change what is saved)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.asarray(leaf)


def _flatten(tree, prefix: str = "") -> dict[str, np.ndarray]:
    """{leaf path: array}, in the reference's leaf order (sorted dict keys,
    sequence order); None is an empty subtree, as in JAX."""
    if tree is None:
        return {}
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return {prefix: host_copy(tree)}
    flat = {}
    for k, v in items:
        flat.update(_flatten(v, f"{prefix}/{k}" if prefix else k))
    return flat


def _unflatten(tree_like, flat: dict[str, np.ndarray], prefix: str = ""):
    """``tree_like``'s structure with each leaf replaced by ``flat``'s array
    of the same path (shapes checked)."""
    if isinstance(tree_like, dict):
        return {k: _unflatten(v, flat, f"{prefix}/{k}" if prefix else str(k))
                for k, v in tree_like.items()}
    if isinstance(tree_like, (list, tuple)):
        return type(tree_like)(
            _unflatten(v, flat, f"{prefix}/{i}" if prefix else str(i))
            for i, v in enumerate(tree_like))
    arr = flat[prefix]
    if arr.shape != tuple(tree_like.shape):
        raise ValueError(f"{prefix}: saved shape {arr.shape}, expected "
                         f"{tuple(tree_like.shape)}")
    return arr


class CheckpointStore:
    def __init__(self, root: str, keep: int = 3):
        self.root = root
        self.keep = keep
        os.makedirs(root, exist_ok=True)
        self._thread: threading.Thread | None = None

    # ------------------------------------------------------------------ save
    def save(self, step: int, trees: dict, extra: dict | None = None) -> str:
        """trees: {name: nested dict of arrays}; extra: JSON-serialisable
        metadata.  Blocking; see save_async."""
        with obs.get_tracer().span("ckpt.save", step=step):
            return self._save(step, trees, extra)

    def _save(self, step: int, trees: dict, extra: dict | None = None) -> str:
        d = os.path.join(self.root, f"step_{step:09d}")
        tmp = d + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {"step": step, "extra": extra or {}, "trees": {},
                    "time": time.time()}
        shard_idx = 0
        buf, buf_bytes = {}, 0
        digests = {}

        def flush():
            nonlocal shard_idx, buf, buf_bytes
            if not buf:
                return
            # raw bytes, as the reference stores them (npz cannot hold
            # every dtype); dtype and shape live in the manifest
            raw = {k: np.frombuffer(np.ascontiguousarray(v).tobytes(), np.uint8)
                   for k, v in buf.items()}
            np.savez(os.path.join(tmp, f"shard_{shard_idx:05d}.npz"), **raw)
            shard_idx += 1
            buf, buf_bytes = {}, 0

        for tname, tree in trees.items():
            entry = {}
            for key, arr in _flatten(tree).items():
                full = f"{tname}:{key}"
                entry[key] = {"shape": list(arr.shape), "dtype": str(arr.dtype),
                              "shard": None}
                digests[full] = hashlib.sha1(arr.tobytes()).hexdigest()[:12]
                if buf_bytes + arr.nbytes > _MAX_SHARD_BYTES:
                    flush()
                entry[key]["shard"] = shard_idx
                buf[full] = arr
                buf_bytes += arr.nbytes
            manifest["trees"][tname] = entry
        flush()
        manifest["digests"] = digests
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        with open(os.path.join(tmp, COMMITTED), "w") as f:
            f.write(str(step))
        if os.path.exists(d):
            shutil.rmtree(d)
        os.rename(tmp, d)
        self._gc()
        reg = obs.get_metrics()
        if reg.enabled:
            total = sum(
                int(np.prod(meta["shape"])) * np.dtype(meta["dtype"]).itemsize
                for entry in manifest["trees"].values()
                for meta in entry.values())
            reg.counter("ckpt.save_total").inc()
            reg.counter("ckpt.save.bytes_total").inc(total)
            reg.gauge("ckpt.save.seconds").set(time.time() - manifest["time"])
        return d

    def save_async(self, step: int, trees: dict, extra: dict | None = None):
        """Copy every leaf to host memory now; write on a background
        thread."""
        host_trees = {k: _unflatten(t, _flatten(t)) for k, t in trees.items()}
        self.wait()
        self._thread = threading.Thread(
            target=self.save, args=(step, host_trees, extra), daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    # --------------------------------------------------------------- restore
    def latest(self) -> int | None:
        steps = []
        for name in os.listdir(self.root):
            d = os.path.join(self.root, name)
            if name.startswith("step_") and os.path.exists(os.path.join(d, COMMITTED)):
                steps.append(int(name.split("_")[1]))
        return max(steps) if steps else None

    def _manifest(self, step: int) -> tuple[str, dict]:
        d = os.path.join(self.root, f"step_{step:09d}")
        with open(os.path.join(d, "manifest.json")) as f:
            return d, json.load(f)

    def restore_trees(self, step: int):
        """Restore EVERY tree of a checkpoint, structure from the manifest
        itself (nested dicts of arrays, as the session trees are).  Returns
        ``(trees, extra)`` like :meth:`restore`."""
        _, manifest = self._manifest(step)

        def nest(entry):
            tree = {}
            for key, meta in entry.items():
                node, parts = tree, key.split("/")
                for p in parts[:-1]:
                    node = node.setdefault(p, {})
                node[parts[-1]] = SimpleNamespace(shape=tuple(meta["shape"]))
            return tree

        return self.restore(step, {t: nest(e) for t, e in manifest["trees"].items()})

    def restore(self, step: int, tree_likes: dict):
        """Restore trees shaped like ``tree_likes`` ({name: nested dict of
        arrays or anything with a ``.shape``}) as numpy arrays."""
        reg = obs.get_metrics()
        if reg.enabled:
            reg.counter("ckpt.restore_total").inc()
        with obs.get_tracer().span("ckpt.restore", step=step):
            return self._restore(step, tree_likes)

    def _restore(self, step: int, tree_likes: dict):
        d, manifest = self._manifest(step)
        if not os.path.exists(os.path.join(d, COMMITTED)):
            raise FileNotFoundError(f"torn checkpoint {d}")
        flat_all: dict[str, np.ndarray] = {}
        shards = {}
        try:
            for tname, entry in manifest["trees"].items():
                for key, meta in entry.items():
                    si = meta["shard"]
                    if si not in shards:
                        shards[si] = np.load(os.path.join(d, f"shard_{si:05d}.npz"))
                    raw = shards[si][f"{tname}:{key}"]
                    flat_all[f"{tname}:{key}"] = \
                        raw.view(np.dtype(meta["dtype"])).reshape(meta["shape"])
        finally:
            for z in shards.values():
                z.close()
        out = {}
        for tname, like in tree_likes.items():
            flat = {k.split(":", 1)[1]: v for k, v in flat_all.items()
                    if k.startswith(tname + ":")}
            out[tname] = _unflatten(like, flat)
        return out, manifest["extra"]

    def verify(self, step: int) -> bool:
        """Re-hash every leaf against the manifest digests."""
        d, manifest = self._manifest(step)
        shards = {}
        try:
            for tname, entry in manifest["trees"].items():
                for key, meta in entry.items():
                    si = meta["shard"]
                    if si not in shards:
                        shards[si] = np.load(os.path.join(d, f"shard_{si:05d}.npz"))
                    arr = shards[si][f"{tname}:{key}"]
                    if hashlib.sha1(arr.tobytes()).hexdigest()[:12] != \
                            manifest["digests"][f"{tname}:{key}"]:
                        return False
        finally:
            for z in shards.values():
                z.close()
        return True

    def _gc(self):
        steps = sorted(
            int(n.split("_")[1]) for n in os.listdir(self.root)
            if n.startswith("step_") and not n.endswith(".tmp"))
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.root, f"step_{s:09d}"),
                          ignore_errors=True)
