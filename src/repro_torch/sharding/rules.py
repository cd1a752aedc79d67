"""Parameter/optimizer-state sharding rules (``repro/sharding/rules.py``).

Storage sharding is decoupled from compute sharding: weights are stored
sharded (FSDP-style) and each layer redistributes the ones it needs to the
layout its computation takes (``models.layers.local_weight``).

Rule, as the reference's: for each array, assign the model axis to the
*last* dim divisible by the model-axis size (the *first* under
``prefer_first``, the serving layout), then the data axis to the largest
remaining divisible dim. Leading stage (repeat) dims and 1-D params stay
unsharded; params are replicated over 'pod'.

A spec is the reference's ``PartitionSpec`` as a tuple with one entry per
tensor dim: None, an axis name, or a tuple of axis names. ``param_spec`` and
``tree_specs`` are pure functions of the shapes and the mesh's shape (a
``DeviceMesh`` or a {axis: size} mapping), so the production meshes can be
checked without their ranks; ``placements`` turns a spec into the
``DTensor`` placements of a mesh (one per mesh dim, ``Shard(d)`` or
``Replicate()``), and ``tree_shardings`` does so for a whole tree.
"""
from __future__ import annotations

from repro_torch.launch.mesh import mesh_shape


def param_spec(shape, mesh, *, data_axis="data", model_axis="model",
               skip_leading: int = 0, prefer_first: bool = False) -> tuple:
    ms = mesh_shape(mesh)
    ndims = len(shape)
    if ndims - skip_leading < 2:
        return ()
    data_n = ms[data_axis] if (data_axis and data_axis in ms) else 1
    model_n = ms[model_axis] if (model_axis and model_axis in ms) else 1
    assign = [None] * ndims

    model_dim = None
    # prefer_first (serving/model-only layout): shard the first divisible dim
    # (the contraction or expert dim), so that decode products reduce small
    # activations instead of gathering whole weight matrices
    dim_order = (range(skip_leading, ndims) if prefer_first
                 else range(ndims - 1, skip_leading - 1, -1))
    for i in dim_order:
        if model_n > 1 and shape[i] % model_n == 0 and shape[i] >= model_n:
            model_dim = i
            assign[i] = model_axis
            break
    # data (FSDP) on the largest remaining divisible dim
    cands = [(shape[i], i) for i in range(skip_leading, ndims)
             if i != model_dim and data_n > 1 and shape[i] % data_n == 0
             and shape[i] >= data_n]
    if cands:
        _, i = max(cands)
        assign[i] = data_axis
    return tuple(assign)


def _is_stage_param(path: str) -> bool:
    return "stage" in path or "encoder" in path


def param_sharding(path_parts, arr_shape, mesh, model_axis="model") -> tuple:
    """The spec of one leaf of the reference's tree at ``path_parts``."""
    path = "/".join(str(p) for p in path_parts)
    skip = 1 if _is_stage_param(path) else 0
    return param_spec(arr_shape, mesh, skip_leading=skip, model_axis=model_axis)


def _rebuild(tree, fn, prefix=()):
    if isinstance(tree, dict):
        return {k: _rebuild(v, fn, prefix + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, fn, prefix + (str(i),)) for i, v in enumerate(tree))
    return fn(prefix, tree)


def leaf_spec(path_parts, shape, mesh, *, pure_dp: bool = False, model_only: bool = False):
    """The spec ``tree_shardings`` gives the leaf at ``path_parts``."""
    if model_only and not pure_dp:
        skip = 1 if _is_stage_param("/".join(path_parts)) else 0
        return param_spec(shape, mesh, skip_leading=skip, data_axis=None,
                          model_axis="model", prefer_first=True)
    return param_sharding(path_parts, shape, mesh, model_axis=None if pure_dp else "model")


def tree_specs(tree, mesh, *, pure_dp: bool = False, model_only: bool = False):
    """A tree of leaves with ``.shape`` (arrays, tensors, ShapeDtypeStructs) ->
    the same tree of specs. pure_dp: the model axis carries batch, so params
    shard over 'data' only. model_only: serving layout, sharded over 'model'
    only (replicated across the data axes) so decode steps pay no per-layer
    data-axis gathers."""
    return _rebuild(tree, lambda path, leaf: leaf_spec(
        path, tuple(leaf.shape), mesh, pure_dp=pure_dp, model_only=model_only))


def placements(spec, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh`` (a ``DeviceMesh`` or a
    {axis: size} mapping, in mesh-dim order): ``Shard(d)`` on each mesh dim
    that shards tensor dim d, ``Replicate()`` elsewhere. A tensor dim sharded
    over several axes is split by them in the spec's order, as the
    reference's ``P(("pod", "data"))``; the placements then list them in
    mesh-dim order, which DTensor splits in that order too (the meshes here
    keep "pod" before "data")."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh_shape(mesh))
    out = [Replicate() for _ in names]
    for dim, entry in enumerate(spec):
        for axis in ((entry,) if isinstance(entry, str) else (entry or ())):
            out[names.index(axis)] = Shard(dim)
    return tuple(out)


def tree_shardings(tree, mesh, *, pure_dp: bool = False, model_only: bool = False):
    """Tree of leaves -> the same tree of DTensor placements (one tuple per
    leaf), by ``tree_specs``' rule."""
    return _rebuild(tree, lambda path, leaf: placements(leaf_spec(
        path, tuple(leaf.shape), mesh, pure_dp=pure_dp, model_only=model_only), mesh))


def batch_spec(mesh) -> tuple:
    """Batch dim spec: (("pod", "data"),) on multi-pod meshes, (("data",),)
    otherwise."""
    return (data_axes(mesh),)


def data_axes(mesh) -> tuple:
    ms = mesh_shape(mesh)
    return tuple(a for a in ("pod", "data") if a in ms)
