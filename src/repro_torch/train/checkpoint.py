"""Atomic, resumable checkpoints in the layout of ``src/repro/train/checkpoint.py``.

Layout:  <dir>/step_<N>/
            manifest.json        # step, leaf count, tree structure, shapes, dtypes
            leaf_<i>.npy         # one file per leaf, in JAX's flatten order
         <dir>/LATEST            # atomic pointer file

Leaves are numbered as ``jax.tree.flatten`` numbers them (``tree.py``),
and bfloat16 is stored as a ``uint16`` view tagged ``"bfloat16"``, so a
checkpoint written by one package restores in the other. Writes go to
``step_<N>.tmp`` then ``os.rename`` (atomic on POSIX), so a crash
mid-save never corrupts the restore path; only the newest ``keep_last``
steps are kept.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

from .tree import tree_flatten, tree_map, tree_unflatten


def _to_numpy(leaf):
    """(array, dtype tag) of one leaf; bfloat16 as its uint16 bits."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    if str(arr.dtype) == "bfloat16":             # an ml_dtypes array
        return arr.view(np.uint16), "bfloat16"
    return arr, str(arr.dtype)


def save_checkpoint(ckpt_dir: str, step: int, tree: Any,
                    keep_last: int = 3) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    leaves = tree_flatten(tree)
    manifest = {"step": step, "n_leaves": len(leaves),
                "treedef": repr(tree_map(lambda _: "*", tree)),
                "leaves": []}
    for i, leaf in enumerate(leaves):
        arr, dtype = _to_numpy(leaf)
        np.save(os.path.join(tmp, f"leaf_{i}.npy"), arr)
        manifest["leaves"].append({"dtype": dtype,
                                   "shape": list(arr.shape)})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)                      # atomic publish
    latest_tmp = os.path.join(ckpt_dir, "LATEST.tmp")
    with open(latest_tmp, "w") as f:
        f.write(str(step))
    os.rename(latest_tmp, os.path.join(ckpt_dir, "LATEST"))
    _gc(ckpt_dir, keep_last)
    return final


def _steps(ckpt_dir: str) -> list:
    return sorted(int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
                  if d.startswith("step_") and not d.endswith(".tmp"))


def _gc(ckpt_dir: str, keep_last: int):
    for s in _steps(ckpt_dir)[:-keep_last]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)


def latest_step(ckpt_dir: str) -> Optional[int]:
    path = os.path.join(ckpt_dir, "LATEST")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        s = int(f.read().strip())
    if os.path.isdir(os.path.join(ckpt_dir, f"step_{s:08d}")):
        return s
    # pointer ahead of data (crash between renames): fall back to newest dir
    steps = _steps(ckpt_dir)
    return steps[-1] if steps else None


def restore_checkpoint(ckpt_dir: str, step: int, like: Any) -> Any:
    """Restore into the structure of ``like``, whose leaves give the
    shapes to verify (a mismatch raises ``ValueError``, where the JAX
    package asserts): a tensor leaf comes back as a tensor of the stored
    dtype on that leaf's device, any other leaf as a numpy array."""
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    leaves_like = tree_flatten(like)
    if len(leaves_like) != manifest["n_leaves"]:
        raise ValueError(f"leaf count mismatch: {len(leaves_like)} vs "
                         f"{manifest['n_leaves']}")
    out = []
    for i, (meta, ref) in enumerate(zip(manifest["leaves"], leaves_like)):
        arr = np.load(os.path.join(d, f"leaf_{i}.npy"))
        want = tuple(np.shape(ref))
        if tuple(arr.shape) != want:
            raise ValueError(f"leaf {i}: shape {arr.shape} vs expected "
                             f"{want}")
        if isinstance(ref, torch.Tensor):
            t = torch.from_numpy(arr)
            if meta["dtype"] == "bfloat16":
                t = t.view(torch.int16).view(torch.bfloat16)
            out.append(t.to(ref.device))
        else:
            out.append(arr)
    return tree_unflatten(like, out)


class AsyncCheckpointer:
    """Overlaps checkpoint I/O with training (one in-flight save)."""

    def __init__(self, ckpt_dir: str, keep_last: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep_last = keep_last
        self._thread: Optional[threading.Thread] = None

    def save(self, step: int, tree: Any):
        self.wait()
        host_tree = tree_map(
            lambda x: x.detach().to("cpu", copy=True)
            if isinstance(x, torch.Tensor) else np.asarray(x), tree)
        self._thread = threading.Thread(
            target=save_checkpoint,
            args=(self.ckpt_dir, step, host_tree, self.keep_last),
            daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
