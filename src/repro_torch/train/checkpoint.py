"""Step-atomic checkpointing with an async writer (``repro/train/checkpoint.py``).

Layout:  <dir>/step_<N>/
            manifest.json       — step, leaf paths, shapes/dtypes
            shard_0.npz         — flattened leaf arrays
         <dir>/LATEST           — atomically updated pointer file

A tree is a nested dict of tensors; its leaves are flattened in sorted key
order (as ``jax.tree`` flattens dicts) and named by their paths in the
manifest. Writes go to a temporary directory, then ``os.replace`` (atomic on
POSIX), so a crash mid-write never corrupts LATEST. Async mode copies the
leaves to host memory at once and writes them on a thread, so the train loop
only blocks on the previous snapshot (one-deep pipeline). NumPy has no
bfloat16: such a tensor is stored as its int16 bits, viewed back on restore
from the dtype the manifest records (the reference's ``_to_savable``).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from pathlib import Path

import numpy as np
import torch


def _flatten(tree, prefix=()):
    """[(path, leaf)] of a nested dict, keys in sorted order."""
    if isinstance(tree, dict):
        return [item for key in sorted(tree) for item in _flatten(tree[key], prefix + (key,))]
    return [("/".join(prefix), tree)]


def _unflatten(paths, leaves) -> dict:
    tree: dict = {}
    for path, leaf in zip(paths, leaves):
        *parents, last = path.split("/")
        node = tree
        for key in parents:
            node = node.setdefault(key, {})
        node[last] = leaf
    return tree


def _to_savable(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t`` as NumPy (copied even where ``t`` is on the CPU:
    the train loop updates its tensors in place while a writer thread runs);
    a dtype NumPy lacks (bfloat16) as its same-width integer bits."""
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy()


def _from_savable(a: np.ndarray, dtype_str: str) -> torch.Tensor:
    t = torch.from_numpy(np.array(a))  # a writable copy, 0-d kept 0-d
    dtype = getattr(torch, dtype_str)
    return t if t.dtype == dtype else t.view(dtype)


def save(ckpt_dir: str | Path, step: int, tree, *, blocking: bool = True):
    """Write ``tree`` as step ``step`` and point LATEST at it. With
    ``blocking=False`` returns the (started) writer thread."""
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    flat = _flatten(tree)
    paths = [path for path, _ in flat]
    dtypes = [str(leaf.dtype).replace("torch.", "") for _, leaf in flat]
    host_leaves = [_to_savable(leaf) for _, leaf in flat]

    def _write():
        tmp = ckpt_dir / f".tmp_step_{step}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        np.savez(tmp / "shard_0.npz", **{f"leaf_{i}": a for i, a in enumerate(host_leaves)})
        manifest = {
            "step": step,
            "n_leaves": len(host_leaves),
            "paths": paths,
            "shapes": [list(a.shape) for a in host_leaves],
            "dtypes": dtypes,
        }
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        final = ckpt_dir / f"step_{step}"
        if final.exists():
            shutil.rmtree(final)
        os.replace(tmp, final)
        latest_tmp = ckpt_dir / ".LATEST.tmp"
        latest_tmp.write_text(str(step))
        os.replace(latest_tmp, ckpt_dir / "LATEST")

    if blocking:
        _write()
        return None
    t = threading.Thread(target=_write, daemon=True)
    t.start()
    return t


def latest_step(ckpt_dir: str | Path) -> int | None:
    p = Path(ckpt_dir) / "LATEST"
    if not p.exists():
        return None
    return int(p.read_text().strip())


def restore(ckpt_dir: str | Path, tree_like, *, step: int | None = None, device=None):
    """Restore step ``step`` (LATEST by default) into the structure of
    ``tree_like``: new tensors in the saved dtypes, on ``device`` where given,
    else on the device of ``tree_like``'s leaf at the same path. Returns
    (step, tree). Raises ValueError if the saved leaves are not the tree's."""
    ckpt_dir = Path(ckpt_dir)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    step_dir = ckpt_dir / f"step_{step}"
    manifest = json.loads((step_dir / "manifest.json").read_text())
    flat = _flatten(tree_like)
    if [path for path, _ in flat] != manifest["paths"]:
        raise ValueError(f"checkpoint {step_dir}: its leaves are not those of the tree given")
    with np.load(step_dir / "shard_0.npz") as data:
        leaves = [
            _from_savable(data[f"leaf_{i}"], manifest["dtypes"][i]).to(
                device if device is not None else like.device)
            for i, (_, like) in enumerate(flat)
        ]
    return step, _unflatten(manifest["paths"], leaves)
