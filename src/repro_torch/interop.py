"""Carrying state into and out of the port as plain values.

The allocator has no weights: its state is the app set, the server caps and
the allocation. These helpers build the port's objects from NumPy arrays or
Python numbers (whatever produced them) and flatten an Allocation back into
arrays, so two implementations can be compared on the same instance. For the
model substrate, ``numpy_params`` draws a parameter tree in the reference's
layout, ``params_from_jax`` loads such a tree into the port's ``LM`` and
``params_to_jax`` turns an ``LM``'s parameters back into that layout, and
``place_params`` lays an ``LM`` out on a device mesh by the sharding rules.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.core.power import PowerModel
from repro_torch.core.problem import Allocation, App, ServerCaps

COUNTERS = ("refine_iters", "accepted_moves", "p1_calls", "p1_rescued_rows",
            "p1_masked_rows", "warm_start", "rollout_calls", "rollout_accepted")


def apps_from_arrays(names: Sequence[str], kappa, lam, xbar, r_min, r_max, cpu_min,
                     cpu_max) -> list[App]:
    """One App per row: ``kappa`` is (M, 3), the other fields (M,)."""
    kappa = np.asarray(kappa, dtype=float).reshape(len(names), 3)
    fields = [np.asarray(v, dtype=float).reshape(len(names))
              for v in (lam, xbar, r_min, r_max, cpu_min, cpu_max)]
    return [
        App(name=str(name), lam=float(la), xbar=float(xb),
            kappa=tuple(float(k) for k in kap), r_min=float(lo), r_max=float(hi),
            cpu_min=float(cmin), cpu_max=float(cmax))
        for name, kap, la, xb, lo, hi, cmin, cmax in zip(names, kappa, *fields)
    ]


def caps_from_values(r_cpu: float, r_mem: float, p_idle: float, p_full: float) -> ServerCaps:
    return ServerCaps(r_cpu=float(r_cpu), r_mem=float(r_mem),
                      power=PowerModel(p_idle=float(p_idle), p_full=float(p_full)))


def allocation_to_arrays(alloc: Allocation) -> dict:
    """{"n", "r_cpu", "r_mem", "utility"} plus the solver's diagnostics
    counters (those it recorded) — plain NumPy/Python values."""
    out = {
        "n": np.asarray(alloc.n, dtype=int),
        "r_cpu": np.asarray(alloc.r_cpu, dtype=float),
        "r_mem": np.asarray(alloc.r_mem, dtype=float),
        "utility": float(alloc.utility),
    }
    diag = alloc.meta.get("diagnostics", {})
    out.update({k: diag[k] for k in COUNTERS if k in diag})
    return out


# ----------------------------------------------------------------------------
# Model parameters in the reference's tree layout
# ----------------------------------------------------------------------------
def _block_shapes(kind: str, cfg) -> dict:
    """{group: {name: shape}} of one block's leaves besides its norm, as
    ``repro.models`` lays them out."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    if kind == "mamba":
        m = cfg.mamba
        d_in, nh, N = m.d_inner(d), m.n_heads(d), m.d_state
        ch = d_in + 2 * N
        return {"mamba": {"w_in": (d, 2 * d_in + 2 * N + nh), "conv_w": (m.d_conv, ch),
                          "conv_b": (ch,), "a_log": (nh,), "d_skip": (nh,), "dt_bias": (nh,),
                          "norm_w": (d_in,), "w_out": (d_in, d)}}
    if kind in ("self_attn", "cross_attn"):
        shapes = {"wq": (d, cfg.n_heads, hd), "wk": (d, cfg.kv_heads, hd),
                  "wv": (d, cfg.kv_heads, hd), "wo": (cfg.n_heads, hd, d)}
        if cfg.qkv_bias:
            shapes.update(bq=(cfg.n_heads, hd), bk=(cfg.kv_heads, hd), bv=(cfg.kv_heads, hd))
        return {"attn": shapes}
    if kind == "moe":
        E, f = cfg.moe.n_experts, cfg.moe.d_ff_expert
        return {"moe": {"router": (d, E), "w_gate": (E, d, f), "w_up": (E, d, f),
                        "w_down": (E, f, d)}}
    shapes = {"w_up": (d, cfg.d_ff), "w_down": (cfg.d_ff, d)}
    if cfg.act in ("swiglu", "geglu"):
        shapes["w_gate"] = (d, cfg.d_ff)
    return {"mlp": shapes}


def _weight_scales(cfg) -> dict:
    """{group: {name: scale}} of the weights drawn N(0, scale²): the
    reference's fan-in scales. Keyed by group as well as name, since an
    expert's ``w_down`` has fan-in ``d_ff_expert``, a dense MLP's ``d_ff``."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    attn = {"wq": d**-0.5, "wk": d**-0.5, "wv": d**-0.5, "wo": (cfg.n_heads * hd) ** -0.5}
    scales = {"attn": attn,
              "mlp": {"w_up": d**-0.5, "w_gate": d**-0.5, "w_down": cfg.d_ff**-0.5}}
    if cfg.moe is not None:
        scales["moe"] = {"router": d**-0.5, "w_gate": d**-0.5, "w_up": d**-0.5,
                         "w_down": cfg.moe.d_ff_expert**-0.5}
    if cfg.mamba is not None:
        scales["mamba"] = {"w_in": d**-0.5, "w_out": cfg.mamba.d_inner(d) ** -0.5}
    return scales


def numpy_params(cfg, seed: int) -> dict:
    """A parameter tree in the reference's layout (stage leaves stacked
    ``(repeat, ...)``; the audio family's ``encoder`` and ``enc_norm``, the
    vlm family's ``vision_proj``) as float32 NumPy arrays from
    ``np.random.default_rng(seed)``: normal weights with the reference's
    fan-in scales (the Mamba conv 0.1); norm weights, qkv biases and the
    Mamba constants (``conv_b``, ``a_log``, ``dt_bias`` around 0, ``d_skip``
    and ``norm_w`` around 1) at their reference init plus 0.1·N(0, 1), so
    that tests exercise each of them. The reference takes it as
    ``jax.tree.map(jnp.asarray, tree)``, the port by ``params_from_jax``."""
    from repro_torch.models.model import encoder_stage

    rng = np.random.default_rng(seed)
    d = cfg.d_model
    norm0 = 0.0 if cfg.norm_plus_one else 1.0
    scales = _weight_scales(cfg)
    stages = [(f"stage{si}", stage) for si, stage in enumerate(cfg.stages())]
    if cfg.family == "audio":
        stages.append(("encoder", encoder_stage(cfg)))
    means = {"d_skip": 1.0, "norm_w": 1.0}  # the rest start at 0

    def draw(shape, scale, mean=0.0):
        return (mean + scale * rng.standard_normal(shape)).astype(np.float32)

    tree = {"embed": draw((cfg.vocab, d), d**-0.5),
            "final_norm": {"w": draw((d,), 0.1, norm0)}}
    if not cfg.tie_embeddings:
        tree["lm_head"] = draw((d, cfg.vocab), d**-0.5)
    for key, stage in stages:
        st = {}
        for i, (kind, _) in enumerate(stage.blocks):
            blk = {"norm": {"w": draw((stage.repeat, d), 0.1, norm0)}}
            for group, shapes in _block_shapes(kind, cfg).items():
                blk[group] = {name: draw((stage.repeat, *shape),
                                         scales[group].get(name, 0.1), means.get(name, 0.0))
                              for name, shape in shapes.items()}
            st[f"b{i}"] = blk
        tree[key] = st
    if cfg.family == "audio":
        tree["enc_norm"] = {"w": draw((d,), 0.1, norm0)}
    if cfg.family == "vlm":
        tree["vision_proj"] = draw((cfg.d_vision, d), cfg.d_vision**-0.5)
    return tree


def _leaf_places(lm, cfg):
    """(parameter, path in the reference's tree, stage repeats or None, repeat
    index or None) of every parameter of ``lm``; a stage leaf is the
    parameter's row ``r`` of the tree's stacked ``(repeats, ...)`` leaf."""
    places = [(lm.embed, ("embed",), None, None), (lm.final_norm.w, ("final_norm", "w"), None, None)]
    if not cfg.tie_embeddings:
        places.append((lm.lm_head, ("lm_head",), None, None))
    stage_layers = [(f"stage{si}", r, cfg.stages()[si].repeat, layer)
                    for layer, (si, r) in zip(lm.layers, lm.stage_of)]
    if cfg.family == "audio":
        stage_layers += [("encoder", r, cfg.enc_layers, layer)
                         for r, layer in enumerate(lm.encoder)]
        places.append((lm.enc_norm.w, ("enc_norm", "w"), None, None))
    if cfg.family == "vlm":
        places.append((lm.vision_proj, ("vision_proj",), None, None))
    for tree_key, r, repeats, layer in stage_layers:
        for i, block in enumerate(layer):
            key = (tree_key, f"b{i}")
            places.append((block.norm.w, key + ("norm", "w"), repeats, r))
            for group, shapes in _block_shapes(block.kind, cfg).items():
                for name in shapes:
                    places.append((getattr(getattr(block, group), name), key + (group, name),
                                   repeats, r))
    return places


def params_to_jax(lm, cfg, values=None) -> dict:
    """The parameters of ``lm`` as a tree in the reference's layout (stage
    leaves stacked ``(repeat, ...)``), float32 NumPy arrays: the inverse of
    ``params_from_jax``, so that updated parameters can be compared with the
    reference's leaf by leaf. ``values``, a dict keyed by parameter name
    (``lm.named_parameters()``; an optimizer's moments, say), is laid out in
    their place."""
    tree: dict = {}
    stacks: dict = {}
    names = {id(p): name for name, p in lm.named_parameters()}
    for param, path, repeats, r in _leaf_places(lm, cfg):
        value = param if values is None else values[names[id(param)]]
        arr = value.detach().to("cpu", torch.float32).numpy()
        if repeats is not None:
            stack = stacks.setdefault(path, np.zeros((repeats, *arr.shape), np.float32))
            stack[r] = arr
            arr = stack
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = arr
    return tree


def params_from_jax(tree, cfg, device=None, dtype=torch.float32):
    """An ``LM`` on ``device`` (the CUDA device unless named) holding the
    reference's parameter tree ``tree`` (leaves as NumPy arrays, or anything
    ``np.asarray`` takes), cast to ``dtype`` (the MoE router stays float32).
    Raises ValueError on a missing, extra or misshapen leaf."""
    from repro_torch.models.model import LM

    lm = LM(cfg, device, dtype)
    seen = set()

    def put(param, path, repeats=None, r=None):
        node = tree
        for key in path:
            if not isinstance(node, dict) or key not in node:
                raise ValueError(f"params_from_jax: missing leaf {'/'.join(path)}")
            node = node[key]
        arr = np.asarray(node)
        want = tuple(param.shape) if repeats is None else (repeats, *param.shape)
        if tuple(arr.shape) != want:
            raise ValueError(f"params_from_jax: {'/'.join(path)} has shape {arr.shape}, "
                             f"expected {want}")
        arr = arr if r is None else arr[r]
        with torch.no_grad():
            param.copy_(torch.as_tensor(np.ascontiguousarray(arr), dtype=torch.float32))
        seen.add("/".join(path))

    for param, path, repeats, r in _leaf_places(lm, cfg):
        put(param, path, repeats, r)

    def leaves(node, prefix=()):
        if isinstance(node, dict):
            for k, v in node.items():
                yield from leaves(v, prefix + (k,))
        else:
            yield "/".join(prefix)

    extra = set(leaves(tree)) - seen
    if extra:
        raise ValueError(f"params_from_jax: leaves the model has no place for: "
                         f"{sorted(extra)}")
    return lm


def param_specs(lm, cfg, mesh, *, pure_dp: bool = False, model_only: bool = False) -> dict:
    """{parameter name: spec} of ``lm``'s parameters by the reference's
    ``tree_shardings`` rule on its tree (a stage leaf's spec is its stacked
    ``(repeats, ...)`` leaf's without the leading entry)."""
    from repro_torch.sharding.rules import leaf_spec

    names = {id(p): name for name, p in lm.named_parameters()}
    out = {}
    for param, path, repeats, _ in _leaf_places(lm, cfg):
        shape = tuple(param.shape) if repeats is None else (repeats, *param.shape)
        spec = leaf_spec(path, shape, mesh, pure_dp=pure_dp, model_only=model_only)
        out[names[id(param)]] = spec if repeats is None else spec[1:]
    return out


def place_params(lm, cfg, mesh, *, pure_dp: bool = False, model_only: bool = False):
    """Lay ``lm``'s parameters out on ``mesh`` (a ``DeviceMesh``) by the
    sharding rules (``sharding.rules``; ``pure_dp`` / ``model_only`` as
    ``tree_shardings``), in place, and return ``lm``. A plain parameter (the
    whole value, the same on every rank, e.g. from ``numpy_params`` /
    ``params_from_jax`` or a seeded ``init_params``) becomes a ``DTensor``
    of which this rank keeps only its shards; a parameter already on the
    mesh is redistributed (moving, say, from the 2d to the serving
    layout)."""
    from torch import nn

    from repro_torch.models.layers import _is_dtensor, distribute, redistribute
    from repro_torch.sharding.rules import placements

    specs = param_specs(lm, cfg, mesh, pure_dp=pure_dp, model_only=model_only)
    modules = dict(lm.named_modules())
    for name, spec in specs.items():
        mod_name, _, leaf = name.rpartition(".")
        mod = modules[mod_name]
        param = mod._parameters[leaf]
        pls = placements(spec, mesh)
        with torch.no_grad():
            value = (redistribute(param.data, pls) if _is_dtensor(param.data)
                     else distribute(param.data, mesh, pls))
        mod._parameters[leaf] = nn.Parameter(value, requires_grad=param.requires_grad)
    return lm
