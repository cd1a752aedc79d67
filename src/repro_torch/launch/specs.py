"""Input specs and shardings for every (arch x shape x mesh) cell, as the
reference's ``repro/launch/specs.py``: shapes and dtypes without allocation
(meta tensors take the place of ``jax.ShapeDtypeStruct``) and their layouts
(specs, the reference's PartitionSpecs as tuples of axis names; ``placements``
turns one into a mesh's DTensor placements).

``mesh`` is a ``DeviceMesh`` or a {axis: size} mapping of one (the
production meshes need no ranks to be described).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import SHAPES, ModelConfig
from repro_torch.launch.mesh import mesh_shape
from repro_torch.models.layers import Runtime, _maybe
from repro_torch.models.model import LM, cache_spec, init_cache
from repro_torch.sharding.rules import data_axes

INT = torch.int32
BF16 = torch.bfloat16


def make_runtime(cfg: ModelConfig, mesh, compute_dtype=torch.bfloat16,
                 attn_backend: str = "auto", device=None) -> Runtime:
    """The reference's runtime for ``cfg`` on ``mesh``: batch over the data
    axes (and over 'model' too for a pure data-parallel config, which then
    has no model axis), sequence-parallel activations where the config asks
    and a model axis exists. ``mesh`` may be a {axis: size} mapping here (a
    runtime that describes a layout and runs nothing). The port's default
    backend runs its kernels (the reference's runs its jnp oracle)."""
    ms = mesh_shape(mesh)
    axes = data_axes(mesh) if mesh is not None else ("data",)
    model_axis = "model"
    if cfg.pure_dp and mesh is not None and "model" in ms:
        axes = axes + ("model",)
        model_axis = None
    if isinstance(mesh, dict):  # a layout only: no process group, no device
        mesh, device = None, "meta" if device is None else device
    return Runtime(device, compute_dtype, attn_backend, mesh=mesh, data_axes=axes,
                   model_axis=model_axis,
                   seq_shard_acts=cfg.seq_shard_activations and model_axis is not None)


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_specs(cfg: ModelConfig, shape_name: str, mesh, runtime: Runtime | None = None):
    """(batch meta tensors, batch specs) for a cell."""
    seq, gbs, kind = SHAPES[shape_name]
    ms = mesh_shape(mesh)
    axes = runtime.data_axes if runtime is not None else data_axes(mesh)
    bsp = _maybe(axes, gbs, ms)

    if kind == "train":
        batch = {"tokens": _meta((gbs, seq), INT), "labels": _meta((gbs, seq), INT)}
        shard = {"tokens": (bsp, None), "labels": (bsp, None)}
    elif kind == "prefill":
        batch = {"tokens": _meta((gbs, seq), INT)}
        shard = {"tokens": (bsp, None)}
    else:  # decode
        batch = {"tokens": _meta((gbs, 1), INT), "index": _meta((), INT)}
        shard = {"tokens": (bsp, None), "index": ()}

    if cfg.family == "vlm":
        batch["patches"] = _meta((gbs, cfg.n_patches, cfg.d_vision), BF16)
        shard["patches"] = (bsp, None, None)
    if cfg.family == "audio":
        frames = max(seq // cfg.enc_frames_ratio, 8)
        if kind == "decode":
            # serving memoises the encoder output at admission; decode steps
            # take the precomputed memory
            batch["memory"] = _meta((gbs, frames, cfg.d_model), BF16)
            shard["memory"] = (bsp, None, None)
        else:
            batch["frames"] = _meta((gbs, frames, cfg.d_model), BF16)
            shard["frames"] = (bsp, None, None)
    return batch, shard


def param_structs(cfg: ModelConfig, param_dtype=torch.float32):
    """The model's parameters on the meta device (shapes and dtypes, nothing
    allocated)."""
    return LM(cfg, "meta", param_dtype)


def cache_structs(cfg: ModelConfig, runtime: Runtime, batch: int, max_len: int,
                  dtype=torch.bfloat16):
    """The decode cache's leaves as meta tensors of their global shapes."""
    meta = Runtime("meta", runtime.compute_dtype, runtime.attn_backend)
    return init_cache(cfg, meta, batch, max_len, dtype)


def cache_shardings(cache_struct, cfg: ModelConfig, mesh, runtime: Runtime | None = None):
    """KV layout (R, B, KV, T, hd): batch over the data axes (when divisible),
    T over 'model' (flash-decode sequence sharding); the conv state's
    channels and the SSM state's heads over 'model'; the specs of the tree of
    ``cache_structs``."""
    axes = runtime.data_axes if runtime is not None else data_axes(mesh)
    model_n = 1 if (runtime is not None and "model" in axes) else mesh_shape(mesh)["model"]

    def walk(node, name=None):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if node is None:
            return None
        return cache_spec(name, tuple(node.shape), mesh, axes, model_n)

    return walk(cache_struct)
