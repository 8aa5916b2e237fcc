"""Checkpointing: tree save and restore with step resume and retention,
the reference's ``repro.checkpoint.store`` in PyTorch.

The layout is the reference's:

* a checkpoint is a directory ``step_<k>/`` holding one ``.npz`` per
  host shard (``shard_<i>.npz``, leaves ``leaf_0`` ... in tree order) and
  a ``manifest.json`` with the step, the leaf count, each shard's crc32
  and the caller's ``extra``;
* writes go to a temporary directory published with ``os.replace``: a
  writer that dies never corrupts the newest checkpoint;
* :meth:`CheckpointStore.save_async` copies the tree to the host, then
  serializes it on a background thread;
* retention keeps the newest ``keep`` checkpoints.

A tree is a tensor, a numpy array or a number, or a dict (leaves in
sorted key order, as ``jax.tree.flatten`` orders them), list or tuple of
trees, or an ``nn.Module`` (its state dict, sorted by name). Tensors are
stored as numpy arrays, bfloat16 ones widened to float32 (exact);
:meth:`CheckpointStore.restore` casts each leaf to its template's type
and device, as the reference's restore does, and writes a module's
tensors in place."""

from __future__ import annotations

import json
import os
import shutil
import threading
import zlib
from pathlib import Path
from typing import Any

import numpy as np
import torch
from torch import nn


def _items(node) -> list:
    """A container's children in flattening order, or ``None`` for a leaf."""
    if isinstance(node, nn.Module):
        node = node.state_dict(keep_vars=True)
    if isinstance(node, dict):
        return [node[k] for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return list(node)
    return None


def tree_leaves(tree: Any) -> list:
    children = _items(tree)
    if children is None:
        return [tree]
    return [leaf for child in children for leaf in tree_leaves(child)]


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return np.asarray(leaf)


def _host_copy(tree: Any) -> Any:
    """``tree`` with every tensor copied to the host (a module as the dict
    of its state): a copy always, never a view of a CPU tensor, so an
    in-place update after the call cannot reach what is saved."""
    if isinstance(tree, nn.Module):
        tree = tree.state_dict(keep_vars=True)
    if isinstance(tree, dict):
        return {k: _host_copy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_host_copy(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    return np.array(tree, copy=True)


def _restored(template: Any, arrays) -> Any:
    """A tree shaped as ``template`` from the iterator ``arrays``."""
    if isinstance(template, nn.Module):
        with torch.no_grad():
            for (_, t) in sorted(template.state_dict(keep_vars=True).items()):
                t.copy_(torch.from_numpy(next(arrays)))
        return template
    if isinstance(template, dict):
        vals = {k: _restored(template[k], arrays) for k in sorted(template)}
        return {k: vals[k] for k in template}
    if isinstance(template, (list, tuple)):
        return type(template)(_restored(v, arrays) for v in template)
    a = next(arrays)
    if isinstance(template, torch.Tensor):
        return torch.from_numpy(a).to(device=template.device, dtype=template.dtype)
    return a.astype(template.dtype) if hasattr(template, "dtype") else a


def file_crc32(path: Path, block: int = 1 << 24) -> int:
    """crc32 of a file's bytes, read in blocks (a full-width shard is tens
    of GB)."""
    crc = 0
    with open(path, "rb") as f:
        while chunk := f.read(block):
            crc = zlib.crc32(chunk, crc)
    return crc


class CheckpointStore:
    def __init__(self, root: str | Path, keep: int = 3, shard_id: int = 0):
        self.root = Path(root)
        self.keep = keep
        self.shard_id = shard_id
        self.root.mkdir(parents=True, exist_ok=True)
        self._pending: threading.Thread | None = None
        self._error: BaseException | None = None

    # -- write ---------------------------------------------------------------
    def save(self, step: int, tree: Any, extra: dict | None = None) -> Path:
        """Blocking save with atomic publish."""
        arrays = {f"leaf_{i}": _to_numpy(x) for i, x in enumerate(tree_leaves(tree))}
        tmp = self.root / f".tmp_step_{step}_{os.getpid()}"
        final = self.root / f"step_{step}"
        tmp.mkdir(parents=True, exist_ok=True)
        shard_file = tmp / f"shard_{self.shard_id}.npz"
        np.savez(shard_file, **arrays)
        manifest = {
            "step": step,
            "n_leaves": len(arrays),
            "shards": {str(self.shard_id): f"shard_{self.shard_id}.npz"},
            "crc32": {str(self.shard_id): file_crc32(shard_file)},
            "extra": extra or {},
        }
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        if final.exists():
            shutil.rmtree(final)
        os.replace(tmp, final)  # atomic publish
        self._retain()
        return final

    def save_async(self, step: int, tree: Any, extra: dict | None = None) -> None:
        """Copy to the host now, then serialize on a background thread. A
        failure of that thread is raised by the next :meth:`wait`."""
        self.wait()
        host_tree = _host_copy(tree)

        def run():
            try:
                self.save(step, host_tree, extra)
            except BaseException as e:  # noqa: BLE001 -- handed to wait()
                self._error = e

        t = threading.Thread(target=run, daemon=True)
        t.start()
        self._pending = t

    def wait(self) -> None:
        if self._pending is not None:
            self._pending.join()
            self._pending = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    # -- read ----------------------------------------------------------------
    def steps(self) -> list[int]:
        out = []
        for p in self.root.glob("step_*"):
            try:
                out.append(int(p.name.split("_")[1]))
            except ValueError:
                continue
        return sorted(out)

    def latest_step(self) -> int | None:
        s = self.steps()
        return s[-1] if s else None

    def restore(self, template: Any, step: int | None = None) -> tuple[Any, dict]:
        """Restore into the structure of ``template``; returns ``(tree,
        manifest extra)``. Verifies the shard's crc32 (``IOError``) and
        the leaf count (``ValueError``)."""
        self.wait()
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.root}")
        d = self.root / f"step_{step}"
        manifest = json.loads((d / "manifest.json").read_text())
        shard_file = d / manifest["shards"][str(self.shard_id)]
        if file_crc32(shard_file) != manifest["crc32"][str(self.shard_id)]:
            raise IOError(f"checkpoint shard corrupt at step {step}")
        n = len(tree_leaves(template))
        if n != manifest["n_leaves"]:
            raise ValueError(f"tree structure changed: {n} leaves, the checkpoint "
                             f"holds {manifest['n_leaves']}")
        with np.load(shard_file) as arrays:
            tree = _restored(template, (arrays[f"leaf_{i}"] for i in range(n)))
        return tree, manifest.get("extra", {})

    def _retain(self) -> None:
        steps = self.steps()
        for s in steps[: max(0, len(steps) - self.keep)]:
            shutil.rmtree(self.root / f"step_{s}", ignore_errors=True)
