"""The port's sharding rules and cell specs against the reference's, on the
full production meshes without their ranks: the port's functions take a mesh
shape ({axis: size}), and the reference's run in a subprocess with 512
placeholder CPU devices (``--xla_force_host_platform_device_count``, as
``tests/test_sharding.py`` does), from which its specs come back as JSON.

* every leaf of all ten configs' full-size parameters and of their AdamW and
  Adafactor states, on {data 16, model 16}, {pod 2, data 16, model 16} and
  {data 2, model 2}, in the default, ``pure_dp`` and ``model_only`` layouts:
  the port's spec (and its DTensor placements, read back) equals the
  reference's ``tree_shardings`` PartitionSpec;
* ``batch_specs``, ``cache_structs`` and ``cache_shardings`` of every
  runnable (arch x shape) cell on both production meshes: shapes, dtypes and
  specs equal; ``min_traffic_bytes`` exactly equal for every (arch, shape,
  mesh) in both decode layouts;
* the port's ``LM`` placed by ``interop.param_specs`` takes its stage leaves'
  specs from the stacked tree's, as the reference's rule skips the repeat
  dim.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch import interop
from repro_torch.configs import ARCH_IDS, SHAPES, cell_is_runnable, get_config
from repro_torch.launch import specs as S
from repro_torch.launch import traffic
from repro_torch.sharding import rules

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = {"single_pod": {"data": 16, "model": 16},
          "multi_pod": {"pod": 2, "data": 16, "model": 16},
          "smoke": {"data": 2, "model": 2}}
LAYOUTS = {"default": {}, "pure_dp": {"pure_dp": True}, "model_only": {"model_only": True}}

REFERENCE = textwrap.dedent("""
    import json, sys
    import jax, jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh
    from repro.configs import ARCH_IDS, SHAPES, cell_is_runnable, get_config
    from repro.launch import specs as S
    from repro.launch.mesh import make_production_mesh
    from repro.launch.traffic import min_traffic_bytes
    from repro.models.model import init_params, lm_loss
    from repro.models.layers import Runtime
    from repro.sharding.rules import tree_shardings
    from repro.train.optimizer import adafactor, adamw
    from repro_torch import interop

    def spec(s):
        return [list(e) if isinstance(e, tuple) else e for e in s]

    def flat(tree, fn):
        out = {}
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            key = "/".join(str(p.key) if hasattr(p, "key") else str(p.idx) for p in path)
            out[key] = fn(leaf)
        return out

    devs = np.asarray(jax.devices())
    meshes = {"single_pod": make_production_mesh(),
              "multi_pod": make_production_mesh(multi_pod=True),
              "smoke": Mesh(devs[:4].reshape(2, 2), ("data", "model"))}
    layouts = {"default": {}, "pure_dp": {"pure_dp": True}, "model_only": {"model_only": True}}
    out = {"params": {}, "cells": {}, "traffic": {}}
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        params = jax.eval_shape(lambda: init_params(cfg, jax.random.PRNGKey(0)))
        trees = {"params": params, "adamw": jax.eval_shape(adamw().init, params),
                 "adafactor": jax.eval_shape(adafactor().init, params)}
        rec = {}
        for tname, tree in trees.items():
            rec[tname] = {"shapes": flat(tree, lambda l: list(l.shape))}
            for mname, mesh in meshes.items():
                for lname, kw in layouts.items():
                    rec[tname][mname + "/" + lname] = flat(
                        tree_shardings(tree, mesh, **kw), lambda s: spec(s.spec))
        out["params"][arch] = rec
        for shape in SHAPES:
            ok, _ = cell_is_runnable(cfg, shape)
            for mname in ("single_pod", "multi_pod"):
                mesh = meshes[mname]
                for mo in (False, True):
                    out["traffic"][f"{arch}|{shape}|{mname}|{mo}"] = min_traffic_bytes(
                        cfg, shape, dict(mesh.shape), decode_model_only=mo)
                if not ok:
                    continue
                rt = S.make_runtime(cfg, mesh)
                batch, shard = S.batch_specs(cfg, shape, mesh, rt)
                seq, gbs, kind = SHAPES[shape]
                caches = S.cache_structs(cfg, rt, gbs, seq)
                cshard = S.cache_shardings(caches, cfg, mesh, rt)
                out["cells"][f"{arch}|{shape}|{mname}"] = {
                    "runtime": [list(rt.data_axes), rt.model_axis, rt.seq_shard_acts],
                    "batch": {k: [list(v.shape), str(v.dtype), spec(shard[k].spec)]
                              for k, v in batch.items()},
                    "cache": flat(caches, lambda l: [list(l.shape), str(l.dtype)]),
                    "cache_spec": flat(cshard, lambda s: spec(s.spec)),
                }
    # the reference's own 2 x 2 loss on the sharded-test case, numpy_params weights
    cfg = get_config("moonshot-v1-16b-a3b").reduced()
    params = jax.tree.map(jnp.asarray, interop.numpy_params(cfg, 0))
    toks = jnp.asarray(np.random.default_rng(0).integers(0, cfg.vocab, (4, 32)), jnp.int32)
    labels = jnp.asarray(np.random.default_rng(1).integers(0, cfg.vocab, (4, 32)), jnp.int32)
    l1 = float(lm_loss(params, cfg, Runtime(mesh=None, compute_dtype=jnp.float32), toks,
                       labels)[0])
    mesh = meshes["smoke"]
    rt = S.make_runtime(cfg, mesh, compute_dtype=jnp.float32)
    ps = jax.device_put(params, tree_shardings(params, mesh))
    with mesh:
        l2 = float(jax.jit(lambda p: lm_loss(p, cfg, rt, toks, labels)[0])(ps))
    out["loss"] = [l1, l2]
    json.dump(out, sys.stdout)
""")


@pytest.fixture(scope="module")
def ref():
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=512",
               JAX_PLATFORMS="cpu", PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, "-c", REFERENCE], capture_output=True, text=True,
                          env=env, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout)


def _leaves(tree, prefix=()):
    """(path, leaf) of a tree of dicts."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        elif v is not None:
            yield prefix + (k,), v


def _spec_of(pls, mesh, ndim):
    """The spec whose placements are ``pls`` (the inverse of
    ``rules.placements``), one entry per tensor dim."""
    axes = [[] for _ in range(ndim)]
    for name, pl in zip(mesh, pls):
        if pl.is_shard():
            axes[pl.dim].append(name)
    return [None if not a else (a[0] if len(a) == 1 else a) for a in axes]


class _Shape:
    def __init__(self, shape):
        self.shape = tuple(shape)


def _nest(flat):
    """{"a/b/c": leaf} -> {"a": {"b": {"c": leaf}}}."""
    tree = {}
    for key, leaf in flat.items():
        node = tree
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf
    return tree


def _entry(e):
    """A spec entry as JSON: an axis name, a list of several, or None (a
    1-tuple of axes is its one axis, as PartitionSpec shows it)."""
    if isinstance(e, (tuple, list)):
        return e[0] if len(e) == 1 else list(e)
    return e


def _listed(spec):
    return [_entry(e) for e in spec]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_and_optimizer_specs_equal_reference(ref, arch):
    """Every leaf, every mesh, every layout; and each spec's placements map
    back to it."""
    for tname, rec in ref["params"][arch].items():
        tree = _nest({k: _Shape(v) for k, v in rec["shapes"].items()})
        for mname, mesh in MESHES.items():
            for lname, kw in LAYOUTS.items():
                want = rec[f"{mname}/{lname}"]
                got = {"/".join(path): _listed(spec)
                       for path, spec in _leaves(rules.tree_specs(tree, mesh, **kw))}
                assert got == {k: _listed(v) for k, v in want.items()}, (arch, tname, mname,
                                                                       lname)
                for path, leaf in _leaves(tree):
                    s = _listed(rules.leaf_spec(path, leaf.shape, mesh, **kw))
                    back = _spec_of(rules.placements(s, mesh), mesh, len(leaf.shape))
                    assert back == s + [None] * (len(leaf.shape) - len(s))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batch_and_cache_specs_equal_reference(ref, arch):
    cfg = get_config(arch)
    cells = 0
    for shape in SHAPES:
        ok, _ = cell_is_runnable(cfg, shape)
        for mname in ("single_pod", "multi_pod"):
            key = f"{arch}|{shape}|{mname}"
            assert (key in ref["cells"]) == ok
            if not ok:
                continue
            want = ref["cells"][key]
            mesh = MESHES[mname]
            rt = S.make_runtime(cfg, mesh)
            assert [list(rt.data_axes), rt.model_axis, rt.seq_shard_acts] == want["runtime"]
            batch, shard = S.batch_specs(cfg, shape, mesh, rt)
            got = {k: [list(v.shape), str(v.dtype).replace("torch.", ""), _listed(shard[k])]
                   for k, v in batch.items()}
            assert got == {k: [v[0], v[1], _listed(v[2])] for k, v in want["batch"].items()}, key
            seq, gbs, _ = SHAPES[shape]
            caches = S.cache_structs(cfg, rt, gbs, seq)
            flat = {"/".join(p): leaf for p, leaf in _leaves(caches)}
            assert {k: [list(v.shape), str(v.dtype).replace("torch.", "")]
                    for k, v in flat.items()} == want["cache"], key
            cspec = S.cache_shardings(caches, cfg, mesh, rt)
            assert {"/".join(p): _listed(s) for p, s in _leaves(cspec)} == \
                {k: _listed(v) for k, v in want["cache_spec"].items()}, key
            cells += 1
    assert cells >= 2 * (len(SHAPES) - 1)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_min_traffic_bytes_equal_reference(ref, arch):
    cfg = get_config(arch)
    for shape in SHAPES:
        for mname in ("single_pod", "multi_pod"):
            for mo in (False, True):
                got = traffic.min_traffic_bytes(cfg, shape, MESHES[mname], decode_model_only=mo)
                assert got == ref["traffic"][f"{arch}|{shape}|{mname}|{mo}"]


def test_reference_mesh_loss_within_its_own_bar(ref):
    """The reference's own 2 x 2 lm_loss of the reduced moonshot (the port's
    is held to 1e-5 of one device in tests/test_torch_mesh.py): printed, and
    within its tests/test_sharding.py bar of 5e-3."""
    l1, l2 = ref["loss"]
    print(f"reference moonshot reduced lm_loss: one device {l1!r}, 2 x 2 mesh {l2!r}")
    assert abs(l1 - l2) < 5e-3 * max(1.0, abs(l1))


@pytest.mark.parametrize("arch", ["gemma-2b", "jamba-1.5-large-398b", "seamless-m4t-large-v2"])
def test_lm_param_specs_follow_the_stacked_tree(ref, arch):
    """``interop.param_specs`` of the port's per-layer ``LM`` (on the meta
    device) equals the reference tree's specs without their repeat entry."""
    cfg = get_config(arch)
    lm = S.param_structs(cfg)
    want = ref["params"][arch]["params"]["single_pod/default"]
    got = interop.param_specs(lm, cfg, MESHES["single_pod"])
    names = {id(p): n for n, p in lm.named_parameters()}
    for param, path, repeats, _ in interop._leaf_places(lm, cfg):
        spec = want["/".join(path)]
        spec = _listed(spec)
        assert _listed(got[names[id(param)]]) == (spec if repeats is None else spec[1:])


def test_mesh_shape_and_placements():
    from torch.distributed.tensor import Replicate, Shard

    mesh = MESHES["multi_pod"]
    assert rules.batch_spec(mesh) == (("pod", "data"),)
    assert rules.placements((("pod", "data"), None), mesh) == (Shard(0), Shard(0), Replicate())
    assert rules.placements(("model", "data"), MESHES["smoke"]) == (Shard(1), Shard(0))
    assert rules.param_spec((7, 5), MESHES["smoke"]) == (None, None)
    assert rules.param_spec((8,), MESHES["smoke"]) == ()
    tree = {"stage0": {"w": _Shape((2, 8, 6))}, "embed": _Shape((6, 4))}
    assert rules.tree_shardings(tree, MESHES["smoke"]) == {
        "stage0": {"w": (Shard(1), Shard(2))}, "embed": (Shard(0), Shard(1))}
