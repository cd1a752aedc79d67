"""Sharded serving of the port on a device mesh against one device and the
reference: four CPU ranks over gloo (``launch.mesh.spawn``, one group for the
file) on a (2, 2) ("data", "model") mesh, float32, ``interop.numpy_params(cfg,
0)`` weights on both sides. The reference's three ``tests/test_sharding.py``
cases on the port:

* the reduced moonshot-v1-16b-a3b's ``lm_loss`` (the MoE in its ``a2a``
  mode) within 1e-5 relative of the port's single-device loss and 1e-4 of the
  reference's (the reference's own 2 x 2 loss: tests/test_torch_mesh_rules.py);
* the reduced gemma-2b's decode steps over the cache whose T is split over
  'model' (flash-decode): logits within 1e-5 of the single device's and 1e-4
  of the reference's decode steps, relative to the max |logit|;
* the owner-shard write: at every step only the rank whose T-slice holds the
  index writes, that one position, and every other shard is byte-identical;

and the reduced gemma-2b, mamba2-130m (pure data parallel) and moonshot
engines give tests/data/torch_serve_golden.json's tokens; the MoE block's
``a2a`` and ``replicated`` modes on (2, 2) and (1, 4) equal its ``local`` mode
dropless (atol 1e-5 / rtol 1e-4) with the ids given; the mesh branches those
cases do not take (``torch_scripts.BRANCH_CASES``: the attention's heads-on-G
mode and unsplit fallback, cross-attention, the audio encoder, the Mamba
mixer with its states split over 'model') equal one device within 1e-5; the
meshes default to CUDA and refuse a group with fewer ranks than they need.
"""
import json
import os

import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (x64 as in the reference's own test runs)
import jax
import jax.numpy as jnp
from repro.configs import get_config as ref_config
from repro.models import layers as RL
from repro.models.model import apply_decode as ref_apply_decode
from repro.models.model import init_cache as ref_init_cache
from repro.models.model import lm_loss as ref_lm_loss
from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.launch.mesh import make_smoke_mesh, spawn
from repro_torch.models.layers import Runtime
from repro_torch.models.model import apply_decode, init_cache, lm_loss

from torch_scripts import BRANCH_CASES, branch_config, branch_run, mesh_model_cases

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = json.load(open(os.path.join(ROOT, "tests", "data", "torch_serve_golden.json")))
REF_RT = RL.Runtime(mesh=None, data_axes=("data",), compute_dtype=jnp.float32)
RT = Runtime("cpu", torch.float32)
ENGINES = ("gemma-2b", "mamba2-130m", "moonshot-v1-16b-a3b")
DEC_B, DEC_STEPS, MAX_LEN = 4, 6, 64


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    with torch.no_grad():
        yield
    torch.set_num_threads(prev)


def _inputs():
    cfg = get_config("moonshot-v1-16b-a3b").reduced()
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (4, 32)).astype(np.int32)
    labels = np.random.default_rng(1).integers(0, cfg.vocab, (4, 32)).astype(np.int32)
    gcfg = get_config("gemma-2b").reduced()
    dec = np.random.default_rng(2).integers(0, gcfg.vocab, (DEC_B, DEC_STEPS)).astype(np.int32)
    return toks, labels, dec


@pytest.fixture(scope="module")
def ranks():
    toks, labels, dec = _inputs()
    return spawn(mesh_model_cases, 4, args=(toks, labels, dec, GOLDEN["setup"]), timeout=600)


def _rel(got, want):
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(np.asarray(got, np.float64) - want)) / np.max(np.abs(want)))


def test_sharded_lm_loss_equals_single_device(ranks):
    toks, labels, _ = _inputs()
    cfg = get_config("moonshot-v1-16b-a3b").reduced()
    tree = interop.numpy_params(cfg, 0)
    single = float(lm_loss(interop.params_from_jax(tree, cfg, "cpu"), cfg, RT, toks, labels)[0])
    ref = float(ref_lm_loss(jax.tree.map(jnp.asarray, tree), ref_config(cfg.name).reduced(),
                            REF_RT, jnp.asarray(toks), jnp.asarray(labels))[0])
    for rec in ranks:
        assert abs(rec["loss"] - single) <= 1e-5 * abs(single)
        assert abs(rec["loss"] - ref) <= 1e-4 * abs(ref)
    print(f"moonshot reduced lm_loss: mesh {ranks[0]['loss']!r}, one device {single!r}, "
          f"reference {ref!r}")


def _decode_single_and_reference():
    _, _, dec = _inputs()
    cfg = get_config("gemma-2b").reduced()
    tree = interop.numpy_params(cfg, 0)
    lm = interop.params_from_jax(tree, cfg, "cpu")
    cache = init_cache(cfg, RT, DEC_B, MAX_LEN, dtype=torch.float32)
    params = jax.tree.map(jnp.asarray, tree)
    rcfg = ref_config(cfg.name).reduced()
    ref_cache = ref_init_cache(rcfg, REF_RT, DEC_B, max_len=MAX_LEN, dtype=jnp.float32)
    single, ref = [], []
    for t in range(DEC_STEPS):
        lg, cache = apply_decode(lm, cfg, RT, dec[:, t:t + 1], cache, t)
        single.append(lg[:, 0].numpy())
        rl, ref_cache = ref_apply_decode(params, rcfg, REF_RT, jnp.asarray(dec[:, t:t + 1]),
                                         ref_cache, jnp.int32(t))
        ref.append(np.asarray(rl)[:, 0])
    return np.stack(single, axis=1), np.stack(ref, axis=1)


def test_decode_with_sequence_sharded_cache(ranks):
    single, ref = _decode_single_and_reference()
    for rec in ranks:
        assert rec["decode"].shape == single.shape
        assert np.all(np.isfinite(rec["decode"]))
        assert _rel(rec["decode"], single) < 1e-5
        assert _rel(rec["decode"], ref) < 1e-4
    assert ranks[0]["t_shard"] == (MAX_LEN, MAX_LEN // 2)  # T split over 'model'


def test_decode_in_the_serving_layout(ranks):
    """The same steps with the parameters in the serving layout (model axis
    only, on the first divisible dim): the products' partial sums reduced,
    q/k/v and gate/up in one all-reduce each."""
    single, ref = _decode_single_and_reference()
    for rec in ranks:
        assert _rel(rec["decode_model_only"], single) < 1e-5
        assert _rel(rec["decode_model_only"], ref) < 1e-4


def test_redistribute_every_pair_of_placements(ranks):
    """The port's redistribution (gloo's collectives, not DTensor's) between
    every pair of placements on the (2, 2) mesh."""
    for rec in ranks:
        n, bad = rec["redistribute"]
        assert n == 169 and bad == []


def test_owner_shard_write_leaves_other_shards_identical(ranks):
    for t in range(DEC_STEPS):
        owners = [rec["owner"][t] for rec in ranks]
        # the model rank whose T-slice holds t, once per data shard
        assert sum(mine for mine, _, _ in owners) == 2
        for mine, others_same, wrote in owners:
            assert others_same
            assert wrote is (True if mine else None)


@pytest.mark.parametrize("arch", ENGINES)
def test_engine_on_mesh_matches_golden(ranks, arch):
    """Every rank's Engine on the (2, 2) mesh gives the reference's tokens (a
    token may differ only past a top-2 margin below 1e-3, as on one
    device)."""
    entry = GOLDEN["entries"][arch]
    for rec in ranks:
        got = rec["engines"][arch]
        assert got == ranks[0]["engines"][arch]
        for toks, want, margins in zip(got, entry["tokens"], entry["margins"]):
            assert len(toks) == len(want)
            for g, w, m in zip(toks, want, margins):
                if g != w:
                    assert m <= 1e-3, (arch, g, w, m)
                    break


@pytest.mark.parametrize("name", list(BRANCH_CASES))
def test_mesh_branch_equals_single_device(ranks, name):
    """The attention's heads-on-G mode and its unsplit fallback,
    cross-attention with the vlm's patches and the audio encoder's frames
    taken by batch rows, jamba's Mamba mixer with its states split over
    'model', sequence mode with the residual split over S (the configs'
    default) and whole, and attention by query rows with the residual split
    in the audio model's encoder and cross-attention: the forward's and a
    cache-filling prefill's and decode steps' logits within 1e-5 of one
    device's, relative to the max |logit|."""
    cfg, B, S, steps = branch_config(name)
    lm = interop.params_from_jax(interop.numpy_params(cfg, 0), cfg, "cpu")
    forward, decode = branch_run(cfg, lm, RT, B, S, steps)
    assert decode.shape == (B, 1 + steps, cfg.vocab)
    for rec in ranks:
        got_forward, got_decode = rec["branches"][name]
        assert np.all(np.isfinite(got_forward)) and np.all(np.isfinite(got_decode))
        assert _rel(got_forward, forward) < 1e-5
        assert _rel(got_decode, decode) < 1e-5


@pytest.mark.parametrize("shape", [(2, 2), (1, 4)], ids=["2x2", "1x4"])
@pytest.mark.parametrize("mode", ["a2a", "replicated"])
def test_moe_modes_equal_local(ranks, shape, mode):
    for rec in ranks:
        took, got, want = rec["moe"][(shape, mode)]
        assert took == mode
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-4)


def test_meshes_default_to_cuda_and_need_their_ranks(ranks):
    smoke, production = ranks[0]["errors"]
    assert smoke is not None and "CUDA" in smoke
    assert production is not None and "needs 256 ranks" in production
    with pytest.raises(RuntimeError, match="needs 4 ranks but only 0"):
        make_smoke_mesh(2, 2, device_type="cpu")
