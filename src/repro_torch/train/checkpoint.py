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

On a device mesh a tree's leaves are ``DTensor``s: ``save`` gathers each
whole on every rank (a collective, so every rank calls it), and rank 0
alone copies them to the host and writes the same files as one device does;
``restore`` into a tree of ``DTensor``s keeps each rank's shards of the whole
values read. A checkpoint written on a mesh so restores on one device, and
the other way round.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from pathlib import Path

import numpy as np
import torch

from repro_torch.models.layers import _is_dtensor, distribute, whole


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
    """A host copy of ``t`` (whole) as NumPy (copied even where ``t`` is on
    the CPU: the train loop updates its tensors in place while a writer
    thread runs); a dtype NumPy lacks (bfloat16) as its same-width integer
    bits."""
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy()


def _from_savable(a: np.ndarray, dtype_str: str) -> torch.Tensor:
    t = torch.from_numpy(np.array(a))  # a writable copy, 0-d kept 0-d
    dtype = getattr(torch, dtype_str)
    return t if t.dtype == dtype else t.view(dtype)


def _writes() -> bool:
    """Whether this process writes checkpoints: rank 0 of a process group,
    or a process without one."""
    import torch.distributed as dist

    return not dist.is_initialized() or dist.get_rank() == 0


def save(ckpt_dir: str | Path, step: int, tree, *, blocking: bool = True):
    """Write ``tree`` as step ``step`` and point LATEST at it. With
    ``blocking=False`` returns the (started) writer thread. In a process
    group every rank calls it (a ``DTensor`` leaf is gathered whole) and
    rank 0 writes; the others return None."""
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    flat = _flatten(tree)
    paths = [path for path, _ in flat]
    dtypes = [str(leaf.dtype).replace("torch.", "") for _, leaf in flat]
    writes = _writes()
    host_leaves = []
    for _, leaf in flat:  # leaf by leaf: one gathered leaf on the device at a time
        if _is_dtensor(leaf):  # a collective every rank joins
            with torch.no_grad():
                leaf = whole(leaf)
        if writes:  # only the writer copies to the host
            host_leaves.append(_to_savable(leaf))
    if not writes:
        return None

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
    else on the device of ``tree_like``'s leaf at the same path; where that
    leaf is a ``DTensor``, a ``DTensor`` in its placements holding this
    rank's shards. Returns (step, tree). Raises ValueError if the saved
    leaves are not the tree's."""
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
        leaves = [_placed(_from_savable(data[f"leaf_{i}"], manifest["dtypes"][i]), like, device)
                  for i, (_, like) in enumerate(flat)]
    return step, _unflatten(manifest["paths"], leaves)


def _placed(value, like, device):
    """A restored whole ``value`` on ``device`` (default: ``like``'s), laid out
    as ``like`` where that is a ``DTensor``."""
    value = value.to(device if device is not None else like.device)
    if not _is_dtensor(like):
        return value
    return distribute(value, like.device_mesh, like.placements)
