"""Durable checkpoints in the reference's on-disk format (the reference's
``repro.ckpt.checkpoint``, without JAX).

* A state is a dict (nested dicts, lists and tuples allowed) of arrays:
  numpy arrays, torch tensors on any device, or scalars.  Its leaves are
  saved as host numpy arrays ``a0, a1, ...`` in one ``arrays.npz`` per
  checkpoint, in the order JAX flattens the same dict (keys sorted), and a
  ``manifest.json`` holds ``step``, ``keys``, ``dtypes``, ``shapes`` and
  ``meta``.  A key is the string ``jax.tree_util.keystr`` gives its path:
  ``"['flat']"`` for a dict key, ``"[0]"`` for a list index.  So each
  package reads the other's files.
* Writes are atomic (a tmp dir, then ``os.replace``), so a failure in the
  middle of a write never corrupts the latest checkpoint.
* ``keep`` rotation, and ``latest_step`` for a restart.

Restores give host numpy arrays (:func:`restore_items`), or put them on an
explicit device (:func:`restore`).
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile

import numpy as np
import torch

from repro_torch.device import resolve_device


def _host(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _flatten_with_paths(tree, prefix: str = "") -> list:
    """``[(keystr, leaf)]`` in JAX's flattening order: dict keys sorted,
    list and tuple items in order, None an empty subtree."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _flatten_with_paths(tree[k], f"{prefix}[{k!r}]")
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += _flatten_with_paths(v, f"{prefix}[{i}]")
        return out
    return [(prefix, tree)]


def save(ckpt_dir: str, step: int, state, *, keep: int = 3,
         meta: dict | None = None) -> str:
    """Write ``state`` as checkpoint ``step`` under ``ckpt_dir``; returns
    its directory.  ``meta``: a JSON-serialisable dict stored in the
    manifest (format and version tags, digests, anything a restorer needs
    before it can rebuild the state)."""
    os.makedirs(ckpt_dir, exist_ok=True)
    flat = [(k, _host(v)) for k, v in _flatten_with_paths(state)]
    arrays = {f"a{i}": v for i, (_, v) in enumerate(flat)}
    manifest = {
        "step": int(step),
        "keys": [k for k, _ in flat],
        "dtypes": [str(v.dtype) for _, v in flat],
        "shapes": [list(v.shape) for _, v in flat],
        "meta": meta or {},
    }
    tmp = tempfile.mkdtemp(dir=ckpt_dir, prefix=".tmp_")
    try:
        np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        final = os.path.join(ckpt_dir, f"step_{step:012d}")
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    _rotate(ckpt_dir, keep)
    return final


def _rotate(ckpt_dir: str, keep: int):
    steps = sorted(all_steps(ckpt_dir))
    for s in steps[:-keep] if keep else []:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:012d}"),
                      ignore_errors=True)


def all_steps(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and not name.startswith(".tmp"):
            try:
                out.append(int(name[5:]))
            except ValueError:
                pass
    return sorted(out)


def latest_step(ckpt_dir: str) -> int | None:
    steps = all_steps(ckpt_dir)
    return steps[-1] if steps else None


def load_manifest(ckpt_dir: str, step: int) -> dict:
    """Read a checkpoint's manifest (``meta`` included) without touching
    the arrays, so a restorer can check format and digests first."""
    path = os.path.join(ckpt_dir, f"step_{step:012d}")
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)


def restore_items(ckpt_dir: str, step: int) -> dict[str, np.ndarray]:
    """A checkpoint as a flat ``{keystr: host array}`` dict (the pool
    restore reads the buffer shapes from it)."""
    path = os.path.join(ckpt_dir, f"step_{step:012d}")
    manifest = load_manifest(ckpt_dir, step)
    data = np.load(os.path.join(path, "arrays.npz"))
    return {k: data[f"a{i}"] for i, k in enumerate(manifest["keys"])}


def restore(ckpt_dir: str, step: int, like, *, device):
    """Restore into the structure of ``like`` (a dict of tensors or arrays;
    each leaf gives its shape and dtype) as torch tensors on ``device``,
    which the caller names."""
    items = restore_items(ckpt_dir, step)
    flat_like = _flatten_with_paths(like)
    want = [k for k, _ in flat_like]
    if list(items) != want:
        raise ValueError("checkpoint structure mismatch:\n"
                         f"saved={list(items)[:5]}...\n"
                         f"want={want[:5]}...")
    dev = resolve_device(device)
    leaves = {}
    for (k, l), a in zip(flat_like, items.values()):
        if tuple(a.shape) != tuple(l.shape):
            raise ValueError(f"shape mismatch {a.shape} vs {tuple(l.shape)}")
        t = torch.from_numpy(np.ascontiguousarray(a))
        dtype = l.dtype if isinstance(l, torch.Tensor) else \
            torch.from_numpy(np.zeros(0, np.asarray(l).dtype)).dtype
        leaves[k] = t.to(dtype).to(dev)

    def build(tree, prefix=""):
        if tree is None:
            return None
        if isinstance(tree, dict):
            return {k: build(v, f"{prefix}[{k!r}]") for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(build(v, f"{prefix}[{i}]")
                              for i, v in enumerate(tree))
        return leaves[prefix]
    return build(like)
