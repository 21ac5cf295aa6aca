"""Checkpointing of training state (counterpart of
``repro.checkpoint.manager``), in the reference's directory format:

  * a checkpoint is a directory ``step_<n>/`` of one ``.npy`` per tree
    leaf plus a ``manifest.json`` (leaf names, shapes, dtypes); leaves go
    in the reference's order (dict keys sorted, tuples in order, None
    skipped), so either package can read the other's checkpoints;
  * writes go to ``step_<n>.tmp`` and are atomically renamed, so a crash
    mid-write never corrupts the latest checkpoint;
  * ``CheckpointManager`` keeps the newest K checkpoints, exposes
    ``latest_step()`` for auto-resume, and removes orphaned ``.tmp``
    directories.

Restore places each leaf on its template leaf's device and dtype, or,
given ``shardings``, in a grid's layout: the same bytes on a new grid,
as the reference's mesh-elastic restore (a job restarted on fewer sites
after a failure reads the checkpoint its old grid wrote).
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.tree import Tree, leaves_with_paths, unflatten

_NUMPY_KEEP = (np.float32, np.float64, np.int32, np.int64, np.int8,
               np.uint8, np.bool_, np.int16, np.uint16, np.uint32,
               np.uint64)


def _to_numpy(leaf: Any) -> tuple[np.ndarray, str]:
    """(array to store, dtype name to record): bf16 widens to fp32."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        name = str(t.dtype).replace("torch.", "")
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy(), name
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def save_pytree(tree: Tree, directory: str) -> None:
    """Atomic checkpoint write (tmp dir + rename)."""
    tmp = directory + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    manifest = {"leaves": []}
    for i, (name, leaf) in enumerate(leaves_with_paths(tree)):
        arr, dtype_str = _to_numpy(leaf)
        if arr.dtype not in _NUMPY_KEEP:
            arr = arr.astype(np.float32)
        fname = f"{i:05d}.npy"
        np.save(os.path.join(tmp, fname), arr)
        manifest["leaves"].append(
            {"name": name, "file": fname, "shape": list(arr.shape),
             "dtype": dtype_str})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(directory):
        shutil.rmtree(directory)
    os.rename(tmp, directory)


def restore_pytree(template: Tree, directory: str,
                   shardings: Optional[dict] = None) -> Tree:
    """Restore into the structure of ``template``: each leaf takes its
    template leaf's dtype and device. ``shardings`` (dotted leaf path ->
    ``distributed.sharding.GridSharding``; a path it lacks stays
    replicated) places each leaf on its grid's device instead, checked
    against its spec: the elastic path, same bytes on a new grid."""
    with open(os.path.join(directory, "manifest.json")) as f:
        manifest = json.load(f)
    flat_t = leaves_with_paths(template)
    assert len(flat_t) == len(manifest["leaves"]), (
        f"checkpoint has {len(manifest['leaves'])} leaves, "
        f"template has {len(flat_t)}")

    def load(meta, path, tleaf):
        arr = np.load(os.path.join(directory, meta["file"]))
        want = tuple(tleaf.shape)
        assert tuple(arr.shape) == want, (
            f"{meta['name']}: ckpt {arr.shape} vs template {want}")
        if not isinstance(tleaf, torch.Tensor):
            return arr.astype(np.asarray(tleaf).dtype)
        dev = tleaf.device
        sh = (shardings or {}).get(path)
        if sh is not None:
            sh.shard_shape(want)
            dev = sh.device
        return torch.from_numpy(arr).to(device=dev, dtype=tleaf.dtype)

    return unflatten(template, (load(m, p, t) for m, (p, t) in
                                zip(manifest["leaves"], flat_t)))


class CheckpointManager:
    """Step-indexed checkpoints with retention + auto-resume."""

    def __init__(self, root: str, keep: int = 3):
        self.root = root
        self.keep = keep
        os.makedirs(root, exist_ok=True)

    def _dir(self, step: int) -> str:
        return os.path.join(self.root, f"step_{step:08d}")

    def steps(self) -> list[int]:
        out = []
        for d in os.listdir(self.root):
            if d.startswith("step_") and not d.endswith(".tmp") and \
                    os.path.exists(os.path.join(self.root, d,
                                                "manifest.json")):
                out.append(int(d[len("step_"):]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, step: int, tree: Tree) -> str:
        d = self._dir(step)
        save_pytree(tree, d)
        self._gc()
        return d

    def restore(self, step: int, template: Tree,
                shardings: Optional[dict] = None) -> Tree:
        return restore_pytree(template, self._dir(step), shardings)

    def restore_latest(self, template: Tree,
                       shardings: Optional[dict] = None
                       ) -> tuple[Optional[int], Tree]:
        step = self.latest_step()
        if step is None:
            return None, template
        return step, self.restore(step, template, shardings)

    def _gc(self) -> None:
        steps = self.steps()
        for s in steps[:-self.keep] if self.keep > 0 else []:
            shutil.rmtree(self._dir(s), ignore_errors=True)
        # clean up orphaned tmp dirs from crashed writes
        for d in os.listdir(self.root):
            if d.endswith(".tmp"):
                shutil.rmtree(os.path.join(self.root, d),
                              ignore_errors=True)
