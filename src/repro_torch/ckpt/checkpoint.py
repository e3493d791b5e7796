"""Checkpoints (port of ``repro/ckpt/checkpoint.py``): npz + manifest,
async writer, atomic commit, integrity hashes.

Layout of a checkpoint directory, as the reference's::

    <root>/step_00000120/
        shard_00000.npz      # every leaf, keys leaf_00000, leaf_00001, ...
        MANIFEST.json        # leaf index (name, key, shape, dtype, sha)
    <root>/LATEST            # the newest step, written last by a rename

A tree is nested dicts (keys in sorted order, names joined by "."),
tuples or lists (children named by index), None (no leaf), tensors or
numpy arrays, and every layout of ``core/layouts.py``.  A layout's
children are named by their index in the reference's pytree flattening
(its ``tree_flatten``): ``DenseTensor`` ``data``; ``CsrTensor`` ``data``,
``indices``, ``indptr``; ``CooTensor`` ``data``, ``coords``; ``NMTensor``
``val``, ``idx``; ``FixedMaskTensor`` ``val``, ``mask``;
``GroupedNMTensor`` ``val``, ``blk_idx``, then its ``SpmmPlan`` as a node
(``w.2.0`` its ``cols``, ``w.2.1`` its ``pat_onehot``; a tensor without a
plan has no ``w.2`` leaves).  The static fields (``n``, ``m``, ``g``,
``gr``, ``dense_shape``, ``sparse_dim``, ``origin``) ride in the
template, as in the reference's treedef; a ``GroupedNMTensor``'s cache
of per-layer views is neither saved nor needed.  Each leaf's sha is the
first 16 hex digits of the sha256 of its bytes; bf16 is stored as its
uint16 bits with the logical dtype ``"bfloat16"`` in the manifest and
viewed back with torch (no ``ml_dtypes``).  Checkpoints of either package restore in the other.
The manifest is committed after the data and ``LATEST`` after the
manifest, so a crashed writer never leaves a readable, corrupt
checkpoint; restore checks every hash.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import pathlib
import shutil
import threading
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.core.layouts import CooTensor, CsrTensor, DenseTensor, \
    FixedMaskTensor, GroupedNMTensor, NMTensor, SpmmPlan

__all__ = ["save_pytree", "load_pytree", "CheckpointManager"]

#: each layout's children, in the order of the reference's ``tree_flatten``
_NODE_FIELDS = {
    DenseTensor: ("data",),
    CsrTensor: ("data", "indices", "indptr"),
    CooTensor: ("data", "coords"),
    NMTensor: ("val", "idx"),
    FixedMaskTensor: ("val", "mask"),
    GroupedNMTensor: ("val", "blk_idx", "plan"),
    SpmmPlan: ("cols", "pat_onehot"),
}


def _children(tree) -> list:
    """[(name, child)] of an inner node, in flattening order."""
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if isinstance(tree, (tuple, list)):
        return [(str(i), v) for i, v in enumerate(tree)]
    return [(str(i), getattr(tree, f))
            for i, f in enumerate(_NODE_FIELDS[type(tree)])]


def _is_leaf(tree) -> bool:
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return True
    if tree is None or isinstance(tree, (dict, tuple, list)) \
            or type(tree) in _NODE_FIELDS:
        return False
    raise TypeError(f"cannot checkpoint a {type(tree).__name__} leaf")


def _flatten(tree, prefix: str = "") -> list:
    """[(name, leaf)] in the reference's leaf order."""
    if _is_leaf(tree):
        return [(prefix, tree)]
    if tree is None:
        return []
    return [x for name, child in _children(tree)
            for x in _flatten(child, f"{prefix}.{name}" if prefix else name)]


def _rebuild(template, leaves):
    """``template``'s structure with the next leaves of the iterator
    ``leaves`` in place of its own."""
    if _is_leaf(template):
        return next(leaves)
    if template is None:
        return None
    vals = {name: _rebuild(child, leaves)
            for name, child in _children(template)}
    if isinstance(template, dict):
        return {k: vals[str(k)] for k in template}
    if isinstance(template, (tuple, list)):
        return type(template)(vals[str(i)] for i in range(len(template)))
    # a layout: its static fields from the template
    return dataclasses.replace(template, **{
        f: vals[str(i)] for i, f in enumerate(_NODE_FIELDS[type(template)])})


def _host(leaf) -> tuple:
    """(numpy array as stored, logical dtype name) of one leaf."""
    if isinstance(leaf, np.ndarray):
        return leaf, str(leaf.dtype)
    t = leaf.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def save_pytree(tree, directory: str | pathlib.Path, *,
                meta: Optional[dict] = None) -> dict:
    """Synchronous atomic checkpoint write; returns the manifest."""
    d = pathlib.Path(directory)
    tmp = d.with_name(d.name + ".tmp")
    tmp.mkdir(parents=True, exist_ok=True)
    arrays, index = {}, []
    hasher_all = hashlib.sha256()
    for i, (name, leaf) in enumerate(_flatten(tree)):
        arr, logical_dtype = _host(leaf)
        key = f"leaf_{i:05d}"
        arrays[key] = arr
        h = hashlib.sha256(arr.tobytes()).hexdigest()[:16]
        hasher_all.update(h.encode())
        index.append({"name": name, "key": key, "shape": list(arr.shape),
                      "dtype": logical_dtype, "sha": h})
    np.savez(tmp / "shard_00000.npz", **arrays)
    manifest = {"version": 1, "created": time.time(),
                "num_leaves": len(index), "index": index,
                "tree_hash": hasher_all.hexdigest()[:16],
                "meta": meta or {}}
    (tmp / "MANIFEST.json").write_text(json.dumps(manifest, indent=1))
    if d.exists():
        shutil.rmtree(d)
    tmp.rename(d)  # atomic commit
    return manifest


def _tensor(arr: np.ndarray, dtype: str, device) -> torch.Tensor:
    if dtype == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    elif str(arr.dtype) == dtype:
        t = torch.from_numpy(arr)
    else:
        raise ValueError(f"stored dtype {arr.dtype} for logical {dtype}")
    return t.to(device)


def load_pytree(template, directory: str | pathlib.Path, *, device=None,
                validate: bool = True):
    """Restore into the structure of ``template`` (tensors, ``meta``
    tensors for shape only, or numpy arrays); returns (tree, meta).  Each
    leaf goes to ``device``, else to its template leaf's device (the CPU
    for a ``meta`` tensor or an array), in the dtype stored."""
    d = pathlib.Path(directory)
    manifest = json.loads((d / "MANIFEST.json").read_text())
    leaves_t = _flatten(template)
    if len(manifest["index"]) != len(leaves_t):
        raise ValueError(
            f"checkpoint has {len(manifest['index'])} leaves, template has "
            f"{len(leaves_t)} — structure mismatch")
    out = []
    with np.load(d / "shard_00000.npz") as data:
        for entry, (_, tmpl) in zip(manifest["index"], leaves_t):
            arr = data[entry["key"]]
            if validate:
                h = hashlib.sha256(arr.tobytes()).hexdigest()[:16]
                if h != entry["sha"]:
                    raise IOError(
                        f"checkpoint leaf {entry['name']} hash mismatch")
            if tuple(arr.shape) != tuple(tmpl.shape):
                raise ValueError(
                    f"leaf {entry['name']}: checkpoint shape {arr.shape} != "
                    f"template {tuple(tmpl.shape)}")
            dev = device
            if dev is None:
                dev = (tmpl.device if isinstance(tmpl, torch.Tensor)
                       and tmpl.device.type != "meta" else "cpu")
            out.append(_tensor(arr, entry["dtype"], dev))
    return _rebuild(template, iter(out)), manifest["meta"]


def _host_copy(tree):
    """The tree with every leaf copied to host memory (a copy even for a
    CPU tensor: the trainer updates its params in place)."""
    leaves = [leaf if isinstance(leaf, np.ndarray)
              else leaf.detach().to("cpu", copy=True)
              for _, leaf in _flatten(tree)]
    return _rebuild(tree, iter(leaves))


class CheckpointManager:
    """Async, rotating checkpoint manager with a LATEST pointer."""

    def __init__(self, root: str | pathlib.Path, *, keep: int = 3):
        self.root = pathlib.Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None

    def step_dir(self, step: int) -> pathlib.Path:
        return self.root / f"step_{step:08d}"

    def save(self, step: int, tree, *, meta: Optional[dict] = None,
             blocking: bool = False) -> None:
        """The device-to-host copy runs on the caller's thread (it waits
        for the device, so later in-place updates cannot reach the copy);
        serialization and rotation on a worker thread."""
        self.wait()  # one save in flight at a time
        host_tree = _host_copy(tree)
        meta = dict(meta or {}, step=step)

        def work():
            try:
                save_pytree(host_tree, self.step_dir(step), meta=meta)
                (self.root / "LATEST.tmp").write_text(str(step))
                (self.root / "LATEST.tmp").rename(self.root / "LATEST")
                self._gc()
            except Exception as e:  # surfaced on the next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()
        if blocking:
            self.wait()

    def wait(self) -> None:
        """Join the save in flight; raise its error, if it had one."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            e, self._error = self._error, None
            raise e

    def latest_step(self) -> Optional[int]:
        p = self.root / "LATEST"
        if not p.exists():
            return None
        step = int(p.read_text().strip())
        return step if self.step_dir(step).exists() else None

    def restore_latest(self, template, *, device=None):
        """(step, tree, meta) of the newest checkpoint, or (None, None,
        None) when there is none."""
        step = self.latest_step()
        if step is None:
            return None, None, None
        tree, meta = load_pytree(template, self.step_dir(step),
                                 device=device)
        return step, tree, meta

    def _gc(self) -> None:
        for d in sorted(self.root.glob("step_*"))[: -self.keep]:
            shutil.rmtree(d, ignore_errors=True)
