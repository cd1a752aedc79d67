"""The port's dry-run (``repro_torch.launch.dryrun``) against the
reference's (``repro/launch/dryrun.py``), the cases of
``tests/test_dryrun_units.py`` on the port: ``model_flops`` for every arch x
shape, the MoE active parameters, the traffic model, the cell-skip, config
and shape tables, and the collectives (the five of the reference's HLO
snippet issued through c10d on a fake (4,) group give the bytes the
reference's ``collective_bytes`` parses from the text, kind by kind). Then
the flash and SSD kernels as operators: their fake versions give the
kernel's shapes (and refuse what the kernel refuses), their FLOP formulas
equal ``FlopCounterMode``'s count of the plain versions, a fake tensor never
reaches the launch, and ``fake_world`` leaves no process group behind."""
import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ARCH_IDS, SHAPES, cell_is_runnable, get_config
from repro_torch.kernels import flash_attention, ops, ref, ssd
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import fake_world

ROOT = pathlib.Path(__file__).resolve().parents[1]
HLO = """
      %ar = f32[1024,16]{1,0} all-reduce(%x), replica_groups={}
      %ag.1 = bf16[512]{0} all-gather(%y), dimensions={0}
      %rs = (f32[256]{0}, f32[256]{0}) reduce-scatter(%a, %b), dimensions={0}
      %a2a = s8[128,64]{1,0} all-to-all(%c)
      %cp-start = bf16[32]{0} collective-permute-start(%d)
      %dot = f32[999]{0} dot(%e, %f)
    """


def reference_dryrun():
    """``repro.launch.dryrun``, imported without leaving its 512-device
    XLA flag set for the rest of this process (it sets the flag at import,
    before JAX's backend starts; the flag is put back right after)."""
    before = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as ref_dryrun
    finally:
        if before is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = before
    return ref_dryrun


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ----------------------------------------------------------------------------
# tests/test_dryrun_units.py on the port
# ----------------------------------------------------------------------------
def test_collectives_match_the_reference_hlo_parser():
    """The snippet's five collectives, issued through the c10d functions on a
    fake (4,) group and recorded, give the reference's bytes kind by kind
    (its reduce-scatter of two f32[256] operands as two calls)."""
    ref_bytes = reference_dryrun().collective_bytes(HLO)
    with fake_world(4, device_type="cpu", shape=(4,), axes=("x",)):
        with dryrun.recording_collectives() as calls:
            dist.all_reduce(torch.zeros(1024, 16))
            dist.all_gather_into_tensor(torch.zeros(512, dtype=torch.bfloat16),
                                        torch.zeros(128, dtype=torch.bfloat16))
            for _ in range(2):
                dist.reduce_scatter_tensor(torch.zeros(256), torch.zeros(1024))
            dist.all_to_all_single(torch.zeros(128, 64, dtype=torch.int8),
                                   torch.zeros(128, 64, dtype=torch.int8))
            dist.recv(torch.zeros(32, dtype=torch.bfloat16), 1)
            dist.barrier()
    got = dryrun.collective_bytes(calls)
    assert got == ref_bytes
    assert got["all-reduce"] == 1024 * 16 * 4 and got["collective-permute"] == 32 * 2
    assert got["total"] == sum(v for k, v in got.items() if k != "total")
    assert calls["barrier"] == [1, 0] and calls["reduce_scatter_tensor"][0] == 2
    assert not dist.is_initialized()


def test_collective_bytes_of_nothing():
    assert dryrun.collective_bytes({}) == {"total": 0}
    assert dryrun.collective_bytes({"barrier": [3, 0]}) == {"total": 0}


def test_model_flops_match_reference_for_every_cell():
    ref_dryrun = reference_dryrun()
    from repro.configs import get_config as ref_config

    for arch in ARCH_IDS:
        for shape in SHAPES:
            assert dryrun.model_flops(get_config(arch), shape) == \
                ref_dryrun.model_flops(ref_config(arch), shape), (arch, shape)


def test_model_flops_kinds():
    cfg = get_config("gemma-2b")
    n = cfg.active_params()
    assert dryrun.model_flops(cfg, "train_4k") == pytest.approx(6.0 * n * 4096 * 256)
    assert dryrun.model_flops(cfg, "prefill_32k") == pytest.approx(2.0 * n * 32768 * 32)
    assert dryrun.model_flops(cfg, "decode_32k") == pytest.approx(2.0 * n * 128)


def test_moe_model_flops_use_active_params():
    from repro.configs import get_config as ref_config

    cfg = get_config("moonshot-v1-16b-a3b")
    assert cfg.active_params() < 0.2 * cfg.total_params()
    assert cfg.active_params() == ref_config("moonshot-v1-16b-a3b").active_params()
    assert dryrun.model_flops(cfg, "train_4k") == pytest.approx(
        6.0 * cfg.active_params() * 4096 * 256)


def test_traffic_model_sanity_and_reference():
    from repro.configs import get_config as ref_config
    from repro.launch.traffic import min_traffic_bytes as ref_traffic
    from repro_torch.launch.traffic import min_traffic_bytes

    mesh = {"data": 16, "model": 16}
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for shape in SHAPES:
            if not cell_is_runnable(cfg, shape)[0]:
                continue
            t = min_traffic_bytes(cfg, shape, mesh)
            assert t > 0, (arch, shape)
            assert t == ref_traffic(ref_config(arch), shape, mesh), (arch, shape)
    cfg = get_config("codeqwen1.5-7b")
    assert min_traffic_bytes(cfg, "decode_32k", mesh) >= 2.0 * cfg.total_params()


def test_cell_skip_table():
    skips = {arch: cell_is_runnable(get_config(arch), "long_500k")[0] for arch in ARCH_IDS}
    assert skips["mamba2-130m"] and skips["jamba-1.5-large-398b"]
    assert not skips["codeqwen1.5-7b"]
    assert not skips["llama-3.2-vision-90b"]
    for arch in ARCH_IDS:
        for shape in ("train_4k", "prefill_32k", "decode_32k"):
            assert cell_is_runnable(get_config(arch), shape)[0]


def test_configs_match_assignment_table():
    dims = {
        "codeqwen1.5-7b": (32, 4096, 32, 32, 13440, 92416),
        "command-r-plus-104b": (64, 12288, 96, 8, 33792, 256000),
        "gemma-2b": (18, 2048, 8, 1, 16384, 256000),
        "minitron-4b": (32, 3072, 24, 8, 9216, 256000),
        "llama4-scout-17b-a16e": (48, 5120, 40, 8, 8192, 202048),
        "moonshot-v1-16b-a3b": (48, 2048, 16, 16, 1408, 163840),
        "jamba-1.5-large-398b": (72, 8192, 64, 8, 24576, 65536),
        "mamba2-130m": (24, 768, 24, 0, 0, 50280),
        "llama-3.2-vision-90b": (100, 8192, 64, 8, 28672, 128256),
        "seamless-m4t-large-v2": (24, 1024, 16, 16, 8192, 256206),
    }
    for arch, (L, d, H, KV, dff, V) in dims.items():
        cfg = get_config(arch)
        assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.kv_heads, cfg.d_ff, cfg.vocab) == (
            L, d, H, KV, dff, V), arch
    assert get_config("llama4-scout-17b-a16e").moe.n_experts == 16
    assert get_config("llama4-scout-17b-a16e").moe.top_k == 1
    assert get_config("moonshot-v1-16b-a3b").moe.top_k == 6
    assert get_config("jamba-1.5-large-398b").moe.top_k == 2
    assert get_config("jamba-1.5-large-398b").attn_every == 8
    assert get_config("mamba2-130m").mamba.d_state == 128
    assert get_config("gemma-2b").resolved_head_dim == 256


def test_shapes_table():
    assert SHAPES["train_4k"] == (4096, 256, "train")
    assert SHAPES["prefill_32k"] == (32768, 32, "prefill")
    assert SHAPES["decode_32k"] == (32768, 128, "decode")
    assert SHAPES["long_500k"] == (524288, 1, "decode")


def test_decode_layout_rule_matches_reference():
    """The decode cells choose the model-only layout where the reference's
    rule does (its 14e9-byte threshold), on both production meshes."""
    for ms in ({"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16}):
        chips = int(np.prod(list(ms.values())))
        for arch in ARCH_IDS:
            cfg = get_config(arch)
            for shape in ("decode_32k", "long_500k"):
                seq, gbs, _ = SHAPES[shape]
                model_n = 1 if cfg.pure_dp else ms["model"]
                want = (not cfg.pure_dp and 2 * cfg.total_params() / model_n
                        + cfg.kv_bytes_per_seq(seq) * gbs / chips < 14e9)
                assert dryrun.decode_model_only(cfg, shape, ms) == want, (arch, shape)
            assert not dryrun.decode_model_only(cfg, "prefill_32k", ms)
    assert dryrun.MODEL_ONLY_RULE_BYTES == 14e9


def test_cli_flags_are_the_reference_flags_and_device():
    """The port's ``main`` takes the reference's flags, each with its
    default, and ``--device`` (default cuda)."""

    def flags(path):
        out = {}
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "add_argument":
                default = next((ast.literal_eval(k.value) for k in node.keywords
                                if k.arg == "default"), None)
                out[node.args[0].value] = default
        return out

    ref = flags(ROOT / "src" / "repro" / "launch" / "dryrun.py")
    got = flags(ROOT / "src" / "repro_torch" / "launch" / "dryrun.py")
    assert got == {**ref, "--device": "cuda"}
    for name in ("SHAPES", "cell_is_runnable", "model_flops", "effective_config",
                 "build_lowerable", "stage_body_metrics", "run_cell", "main",
                 "collective_bytes"):
        assert hasattr(dryrun, name), name


def test_peaks_are_the_card_data_sheet_not_the_tpu():
    assert (dryrun.PEAK_FLOPS, dryrun.HBM_BW, dryrun.LINK_BW) == (989e12, 3.35e12, 450e9)
    assert dryrun.CARD == "NVIDIA H100 80GB HBM3, 700 W"


# ----------------------------------------------------------------------------
# The kernels as operators
# ----------------------------------------------------------------------------
FLASH_SHAPES = [(2, 64, 64, 1, 8, 64), (1, 70, 130, 2, 2, 32), (2, 33, 200, 4, 1, 128)]
SSD_SHAPES = [(2, 256, 4, 16, 16, 64), (1, 128, 2, 32, 16, 64), (2, 8, 4, 16, 32, 8)]


@pytest.mark.parametrize("device", ["cpu", "cuda"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Sq,Skv,KV,G,hd", FLASH_SHAPES)
def test_flash_fake_gives_the_kernel_shape(B, Sq, Skv, KV, G, hd, dtype, device):
    before = flash_attention.launches
    with FakeTensorMode(allow_non_fake_inputs=True):
        q = torch.empty((B, Sq, KV, G, hd), dtype=dtype, device=device)
        k, v = (torch.empty((B, Skv, KV, hd), dtype=dtype, device=device) for _ in range(2))
        for causal in (True, False):
            out = torch.ops.repro_torch.flash_fwd(q, k, v, causal, 3)
            assert (out.shape, out.dtype, out.device) == (q.shape, dtype, q.device)
            # the model's entry point reaches the operator on a fake tensor
            out = ops.flash_attention(q, k, v, causal)
            assert out.shape == q.shape and out.dtype == dtype
    assert flash_attention.launches == before


def test_flash_fake_refuses_what_the_kernel_refuses():
    with FakeTensorMode():
        q = torch.empty((1, 8, 1, 2, 48))
        k = v = torch.empty((1, 8, 1, 48))
        with pytest.raises(ValueError, match="head_dim 48"):
            torch.ops.repro_torch.flash_fwd(q, k, v, True, 0)
        q = torch.empty((1, 8, 1, 2, 64), dtype=torch.float16)
        k = v = torch.empty((1, 8, 1, 64), dtype=torch.float16)
        with pytest.raises(TypeError, match="float32 or bfloat16"):
            torch.ops.repro_torch.flash_fwd(q, k, v, True, 0)
        q = torch.empty((1, 8, 1, 2, 64))
        k, v = torch.empty((1, 8, 1, 64)), torch.empty((1, 9, 1, 64))
        with pytest.raises(ValueError, match="do not match"):
            torch.ops.repro_torch.flash_fwd(q, k, v, True, 0)
        with pytest.raises(ValueError, match="offset must be >= 0"):
            torch.ops.repro_torch.flash_fwd(q, k, k, True, -1)


@pytest.mark.parametrize("device", ["cpu", "cuda"])
@pytest.mark.parametrize("B,S,H,P,N,chunk", SSD_SHAPES)
def test_ssd_fake_gives_the_kernel_shapes(B, S, H, P, N, chunk, device):
    before = ssd.launches
    with FakeTensorMode(allow_non_fake_inputs=True):
        x = torch.empty((B, S, H, P), device=device)
        bmat, cmat = (torch.empty((B, S, N), device=device) for _ in range(2))
        da = torch.empty((B, S, H), device=device)
        y, states, cum = torch.ops.repro_torch.ssd_chunk_fwd(x, bmat, cmat, da, chunk)
        assert y.shape == (B, S, H, P) and states.shape == (B, S // chunk, H, P, N)
        assert cum.shape == (B, S, H)
        assert {t.dtype for t in (y, states, cum)} == {torch.float32}
        assert {t.device for t in (y, states, cum)} == {x.device}
    with FakeTensorMode():
        # the model's entry point (its inter-chunk part indexes a fake tensor,
        # which a build of torch without CUDA can do on the CPU only)
        x, bmat, cmat, da = (torch.empty(t.shape) for t in (x, bmat, cmat, da))
        y, state = ops.ssd_chunks(x, bmat, cmat, da, chunk)
        assert y.shape == (B, S, H, P) and state.shape == (B, H, P, N)
    assert ssd.launches == before


def test_ssd_fake_refuses_what_the_kernel_refuses():
    with FakeTensorMode():
        x = torch.empty((1, 96, 2, 16))
        bmat = cmat = torch.empty((1, 96, 16))
        da = torch.empty((1, 96, 2))
        with pytest.raises(ValueError, match="divide the sequence length"):
            torch.ops.repro_torch.ssd_chunk_fwd(x, bmat, cmat, da, 64)
        with pytest.raises(ValueError, match="head_dim 24"):
            torch.ops.repro_torch.ssd_chunk_fwd(torch.empty((1, 96, 2, 24)), bmat, cmat, da, 32)
        with pytest.raises(TypeError, match="must be float32"):
            torch.ops.repro_torch.ssd_chunk_fwd(x.to(torch.bfloat16), bmat, cmat, da, 32)


def _plain_flops(fn, *args):
    with FlopCounterMode(display=False) as fc:
        fn(*args)
    return fc.get_total_flops()


def _op_flops(op, shapes, *rest):
    with FakeTensorMode():
        args = [torch.empty(s) for s in shapes]
        with FlopCounterMode(display=False) as fc:
            op(*args, *rest)
        return fc.get_flop_counts()["Global"]


@pytest.mark.parametrize("B,Sq,Skv,KV,G,hd", FLASH_SHAPES)
def test_flash_flop_formula_counts_the_naive_attention(B, Sq, Skv, KV, G, hd):
    rng = np.random.default_rng(B * Sq + hd)
    q, k, v = (torch.as_tensor(rng.standard_normal(s), dtype=torch.float32)
               for s in ((B, Sq, KV, G, hd), (B, Skv, KV, hd), (B, Skv, KV, hd)))
    want = _plain_flops(ref.attention_naive, q, k, v, False)
    for causal in (True, False):  # a causal call counts its whole rectangle too
        got = _op_flops(torch.ops.repro_torch.flash_fwd, (q.shape, k.shape, v.shape), causal, 0)
        assert got == {torch.ops.repro_torch.flash_fwd: want}
    assert want == 4 * B * Sq * Skv * KV * G * hd


@pytest.mark.parametrize("B,S,H,P,N,chunk", SSD_SHAPES)
def test_ssd_flop_formula_counts_the_plain_chunk_step(B, S, H, P, N, chunk):
    rng = np.random.default_rng(S + N)
    x, bmat, cmat, da = (torch.as_tensor(rng.standard_normal(s), dtype=torch.float32)
                         for s in ((B, S, H, P), (B, S, N), (B, S, N), (B, S, H)))
    want = _plain_flops(ref.ssd_chunk_plain, x, bmat, cmat, -abs(da), chunk)
    got = _op_flops(torch.ops.repro_torch.ssd_chunk_fwd,
                    (x.shape, bmat.shape, cmat.shape, da.shape), chunk)
    assert got == {torch.ops.repro_torch.ssd_chunk_fwd: want}


def test_real_cpu_tensors_take_the_plain_route_and_the_op_refuses_them():
    """No fallback: the operator on real CPU tensors raises the kernel's
    error; the model's entry points send real CPU tensors to the plain
    versions, as before, without the operator."""
    q = torch.randn(1, 16, 1, 2, 32)
    k = v = torch.randn(1, 16, 1, 32)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        torch.ops.repro_torch.flash_fwd(q, k, v, True, 0)
    x = torch.randn(1, 16, 2, 16)
    bm = torch.randn(1, 16, 16)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        torch.ops.repro_torch.ssd_chunk_fwd(x, bm, bm, torch.randn(1, 16, 2), 8)
    with dryrun.OpBytes() as counted:
        out = ops.flash_attention(q, k, v)
        y, _ = ops.ssd_chunks(x, bm, bm, -torch.rand(1, 16, 2), 8)
    assert counted.kernel_ops == {"flash_fwd": 0, "ssd_chunk_fwd": 0}
    torch.testing.assert_close(out, ref.flash_attention_plain(q, k, v), rtol=0, atol=0)


def test_op_counts_and_bytes_of_a_fake_trace():
    """``OpBytes`` counts the operators' calls and the bytes each operator
    reads and writes, views left out."""
    with FakeTensorMode():
        q = torch.empty((2, 64, 1, 8, 64))
        k = v = torch.empty((2, 64, 1, 64))
        with dryrun.OpBytes() as counted:
            out = torch.ops.repro_torch.flash_fwd(q, k, v, True, 0)
            out.view(-1)
    assert counted.kernel_ops == {"flash_fwd": 1, "ssd_chunk_fwd": 0}
    assert counted.bytes == 4 * (2 * q.numel() + k.numel() + v.numel())


# ----------------------------------------------------------------------------
# The fake world
# ----------------------------------------------------------------------------
def test_fake_world_builds_the_production_meshes_and_leaves_no_group():
    with fake_world(256, device_type="cpu") as mesh:
        assert dist.get_world_size() == 256 and dist.get_rank() == 0
        assert mesh.mesh_dim_names == ("data", "model") and tuple(mesh.shape) == (16, 16)
        with pytest.raises(RuntimeError, match="already initialised"):
            with fake_world(4, device_type="cpu", shape=(4,), axes=("x",)):
                pass
    assert not dist.is_initialized()
    with fake_world(512, device_type="cpu") as mesh:
        assert mesh.mesh_dim_names == ("pod", "data", "model")
        assert tuple(mesh.shape) == (2, 16, 16)
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="no production mesh of 8"):
        with fake_world(8, device_type="cpu"):
            pass
    assert not dist.is_initialized()
    with pytest.raises(KeyError):
        with fake_world(4, device_type="cpu", shape=(2, 2), axes=("data", "model")):
            raise KeyError("the group goes on an exception too")
    assert not dist.is_initialized()


def test_importing_the_dryrun_leaves_jax_and_the_reference_unloaded():
    code = ("import sys, repro_torch.launch.dryrun; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'repro')); "
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
