"""Card-only tests of the port: the hand-written CUDA ``crms_grid``,
flash-attention and SSD chunk kernels against their plain versions, the
launches of the allocator path and of a prefill through them (dense, MoE
and the audio encoder-decoder), and training through them: gradients from
the plain backwards of a kernel forward (flash against autograd through the
naive oracle at the reference's 5e-5 / 5e-4 and 3e-2, SSD against the plain
route within 2e-4 of the max), a train step's launches, the simulation's
scans on the card against their host loop (bit for bit), the smoke
scenario trace on the card against the reference's document, and the fleet
row solve and the search baselines on the card against the CPU.

This file imports no JAX, so it also runs where only the port is installed:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py

Without a CUDA device every test skips (the kernels have no CPU mode).
The plain versions run on the same device, so both sides use CUDA's
expf/logf; tolerances as chip_smoke.py states them: crms_grid rtol 1e-5 on
lanes with ρ <= 0.99, 1e-4 on all stable lanes, sentinel lanes > 1e6; flash
attention atol/rtol 2e-5 in float32 and 3e-2 in bfloat16; the SSD chunk
step atol 2e-5 / rtol 2e-4 (the reference's bars, tests/test_kernels.py).
"""
import numpy as np
import pytest
import torch

from repro_torch.api import AllocRequest, allocate
from repro_torch.configs import get_config
from repro_torch.core.profiler import make_tenant_mix
from repro_torch.kernels import crms_grid as port_kernel
from repro_torch.kernels import flash_attention as flash_kernel
from repro_torch.kernels import ops, ref
from repro_torch.kernels import ssd as ssd_kernel
from repro_torch.models.layers import Runtime
from repro_torch.models.model import init_params
from repro_torch.serve.step import make_prefill_step

KW = dict(caps_cpu=30.0, power_span=150.0, alpha=1.4, beta=0.2)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _inputs(M, B, seed, n_range=(3, 12)):
    rng = np.random.default_rng(seed)
    kappa = np.stack(
        [rng.uniform(20, 120, M), rng.uniform(0.8, 2.5, M), rng.uniform(0.2, 0.5, M)], axis=1
    )
    lam = rng.uniform(4, 12, M)
    xbar = rng.uniform(4, 6, M)
    n = rng.integers(*n_range, (B, M)).astype(float)
    c = rng.uniform(0.5, 3.0, (B, M))
    m = rng.uniform(0.25, 0.5, (B, M))
    return kappa, lam, xbar, n, c, m


def _rho(kappa, lam, xbar, n, c, m):
    d = kappa[:, 0] / (1.0 - np.exp(-kappa[:, 1] * c)) + np.exp(kappa[:, 2] / m)
    return lam / (n * 1000.0 / (xbar * d))


@pytest.mark.gpu
@pytest.mark.parametrize("reduce,M,B,n_range,mixed", [
    ("per_app", 64, 72, (3, 12), False), ("sum", 64, 2000, (8, 20), False),
    ("per_app", 7, 40, (3, 12), False), ("sum", 4, 200, (3, 12), False),
    # warps whose lanes need 2..127 steps of the Erlang head sum: counts of
    # 127, 200 and inf among 3..11, and a NaN count
    ("per_app", 64, 72, (3, 12), True),
])
def test_cuda_kernel_matches_plain(cuda_device, reduce, M, B, n_range, mixed):
    arrays = _inputs(M, B, 5, n_range)
    if mixed:
        n = arrays[3]
        n[0, 5], n[1, 40], n[2, 63], n[3, 0] = 127.0, 200.0, np.inf, np.nan
        n[4, 1:33] = 127.0  # a whole warp of long lanes beside short ones
    before = port_kernel.launches
    out = ops.crms_grid(*(torch.as_tensor(a, device=cuda_device) for a in arrays),
                        reduce=reduce, **KW)
    torch.cuda.synchronize()
    assert port_kernel.launches == before + 1
    assert out.is_cuda and out.dtype == torch.float32
    # the plain version on the same device and inputs
    plain = ref.crms_grid_plain(*(torch.as_tensor(a, device=cuda_device) for a in arrays),
                                reduce=reduce, **KW).cpu().numpy()
    out = out.cpu().numpy()
    rho = _rho(*arrays) if reduce == "per_app" else np.max(_rho(*arrays), axis=1)
    assert np.array_equal(np.isnan(out), np.isnan(plain))  # the NaN and inf counts
    assert np.isnan(plain).any() == mixed
    out, plain, rho = (a[~np.isnan(plain)] for a in (out, plain, rho))
    stable = plain < 1e8
    assert stable.any() and not stable.all()  # both kinds of lane are checked
    tight = stable & (rho <= 0.99)
    np.testing.assert_allclose(out[tight], plain[tight], rtol=1e-5)
    np.testing.assert_allclose(out[stable], plain[stable], rtol=1e-4)
    assert np.all(out[~stable] > 1e6)


@pytest.mark.gpu
def test_main_path_launches_the_kernel(cuda_device):
    apps, caps, _ = make_tenant_mix(8)
    before = port_kernel.launches
    res = allocate("crms", AllocRequest(apps, caps, device=cuda_device.type))
    assert res.feasible and res.stable
    assert port_kernel.launches - before >= res.diagnostics.refine_iters > 0


@pytest.mark.gpu
@pytest.mark.parametrize("B,Sq,Skv,KV,G,hd,causal,dtype", [
    (4, 512, 512, 1, 8, 256, True, torch.bfloat16), (4, 512, 512, 1, 8, 256, True, torch.float32),
    (1, 256, 256, 4, 1, 128, True, torch.float32), (1, 70, 130, 2, 2, 32, False, torch.float32),
    (1, 70, 130, 2, 2, 32, True, torch.bfloat16), (2, 192, 192, 2, 3, 64, True, torch.float32),
    # the bf16 wgmma kernel at every head dim and both tile modes: heads
    # packed per tile (G divides 64) and one head per tile (G 3); ragged
    # Sq != Skv; a tile mostly past Sq
    (1, 64, 64, 1, 8, 32, True, torch.bfloat16), (2, 128, 128, 2, 4, 64, True, torch.bfloat16),
    (2, 192, 192, 2, 3, 64, True, torch.bfloat16), (1, 200, 333, 1, 8, 128, False, torch.bfloat16),
    (1, 17, 17, 1, 8, 256, True, torch.bfloat16),
    # the float32 mma.sync kernel: G 8 packed at hd 32, 64 and 128; one head
    # a tile (G 3) at hd 256; ragged Sq != Skv (causal with Skv < Sq); a tile
    # mostly past Sq; one live position, the tile's other rows fully masked
    (1, 64, 64, 1, 8, 32, True, torch.float32), (2, 128, 128, 1, 8, 64, True, torch.float32),
    (1, 96, 96, 2, 8, 128, True, torch.float32), (1, 130, 130, 1, 3, 256, True, torch.float32),
    (1, 200, 333, 1, 8, 128, False, torch.float32), (1, 100, 37, 2, 4, 32, True, torch.float32),
    (1, 17, 17, 1, 8, 256, True, torch.float32), (1, 1, 40, 1, 8, 64, True, torch.float32),
    # the full-width MoE and audio paths, both dtypes: moonshot-v1-16b-a3b's
    # prefill; seamless-m4t-large-v2's encoder, cross-attention prefill and
    # cross-attention decode (Sq 1: one live row in a tile); codeqwen1.5-7b's
    # full-width prefill (32 kv heads)
    *[(*shape, dtype) for shape in (
        (4, 512, 512, 16, 1, 128, True), (4, 128, 128, 16, 1, 64, False),
        (4, 512, 512, 32, 1, 128, True),
        (4, 512, 128, 16, 1, 64, False), (4, 1, 128, 16, 1, 64, False))
      for dtype in (torch.bfloat16, torch.float32)],
])
def test_flash_kernel_matches_plain(cuda_device, B, Sq, Skv, KV, G, hd, causal, dtype):
    rng = np.random.default_rng(B * Sq + hd)
    q, k, v = (torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32)
               .to(cuda_device, dtype) for shape in
               ((B, Sq, KV, G, hd), (B, Skv, KV, hd), (B, Skv, KV, hd)))
    before = flash_kernel.launches
    out = ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_kernel.launches == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    want = ref.flash_attention_plain(q, k, v, causal)
    tol = 3e-2 if dtype == torch.bfloat16 else 2e-5
    got, want = out.float().cpu().numpy(), want.float().cpu().numpy()
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)
    if dtype == torch.bfloat16:
        # both round float32 results to bf16: within one ulp, and rarely apart
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=2.0 ** -7)
        assert np.mean(got != want) < 0.01


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_takes_views_that_start_off_16_bytes(cuda_device, dtype):
    """q, k and v as contiguous views one element into their storage: the
    wrapper copies them to aligned storage for the kernels' 16-byte copies."""
    B, S, KV, G, hd = 1, 96, 1, 8, 64
    rng = np.random.default_rng(10)
    q, k, v = (torch.as_tensor(rng.standard_normal(1 + int(np.prod(shape))),
                               dtype=torch.float32).to(cuda_device, dtype)[1:].view(shape)
               for shape in ((B, S, KV, G, hd), (B, S, KV, hd), (B, S, KV, hd)))
    assert all(t.is_contiguous() and t.data_ptr() % 16 for t in (q, k, v))
    got = ops.flash_attention(q, k, v, causal=True).float().cpu().numpy()
    want = ref.flash_attention_plain(q, k, v, True).float().cpu().numpy()
    tol = 3e-2 if dtype == torch.bfloat16 else 2e-5
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)


@pytest.mark.gpu
def test_prefill_launches_the_flash_kernel_once_per_layer(cuda_device):
    cfg = get_config("gemma-2b").reduced(n_layers=4)
    lm = init_params(cfg, torch.Generator(device=cuda_device).manual_seed(0),
                     device=cuda_device)
    tokens = torch.as_tensor(np.random.default_rng(0).integers(0, cfg.vocab, (2, 40)),
                             device=cuda_device)
    logits = {}
    for backend in ("auto", "reference"):
        before = flash_kernel.launches
        rt = Runtime(cuda_device, torch.float32, backend)
        logits[backend] = make_prefill_step(cfg, rt)(lm, {"tokens": tokens})
        torch.cuda.synchronize()
        assert flash_kernel.launches - before == (cfg.n_layers if backend == "auto" else 0)
    err = (logits["auto"] - logits["reference"]).abs().max() / logits["reference"].abs().max()
    assert float(err) < 1e-4


def _prefill_launches(cuda_device, cfg, extra_fn, want):
    """A reduced prefill on the card through the kernels and through their
    plain versions: ``want`` flash launches, logits within 1e-4."""
    lm = init_params(cfg, torch.Generator(device=cuda_device).manual_seed(0),
                     device=cuda_device)
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab, (2, 40)), device=cuda_device),
             **extra_fn(rng)}
    logits = {}
    for backend in ("auto", "reference"):
        before = flash_kernel.launches
        rt = Runtime(cuda_device, torch.float32, backend)
        logits[backend] = make_prefill_step(cfg, rt)(lm, batch)
        torch.cuda.synchronize()
        assert flash_kernel.launches - before == (want if backend == "auto" else 0)
    err = (logits["auto"] - logits["reference"]).abs().max() / logits["reference"].abs().max()
    assert float(err) < 1e-4


@pytest.mark.gpu
def test_moe_prefill_launches_the_flash_kernel_once_per_layer(cuda_device):
    cfg = get_config("moonshot-v1-16b-a3b").reduced(n_layers=4)
    _prefill_launches(cuda_device, cfg, lambda rng: {}, cfg.n_layers)


@pytest.mark.gpu
def test_audio_prefill_from_frames_launches_self_cross_and_encoder(cuda_device):
    """seamless-m4t-large-v2 reduced, from frames: one flash launch per
    decoder self-attention, cross-attention and encoder layer."""
    cfg = get_config("seamless-m4t-large-v2").reduced()

    def frames(rng):
        return {"frames": torch.as_tensor(rng.standard_normal((2, 10, cfg.d_model)),
                                          dtype=torch.float32, device=cuda_device)}

    _prefill_launches(cuda_device, cfg, frames, 2 * cfg.n_layers + cfg.enc_layers)


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,H,P,N,chunk", [
    (4, 512, 24, 64, 128, 256), (1, 128, 2, 32, 16, 64), (2, 256, 4, 64, 32, 128),
    (2, 8, 4, 16, 16, 256), (1, 100, 3, 32, 64, 50),
    # H not a multiple of the kernel's head group; one-position chunks; a
    # chunk of 64 at N 128, P 16
    (1, 128, 5, 32, 64, 64), (2, 512, 25, 64, 128, 256), (2, 16, 3, 16, 16, 1),
    (2, 256, 4, 16, 128, 64),
])
def test_ssd_kernel_matches_plain(cuda_device, B, S, H, P, N, chunk):
    rng = np.random.default_rng(B * S + P)
    x, bm, cm, z = (torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32,
                                    device=cuda_device)
                    for shape in ((B, S, H, P), (B, S, N), (B, S, N), (B, S, H)))
    bm, cm, da = 0.5 * bm, 0.5 * cm, -torch.nn.functional.softplus(z)
    Q = min(chunk, S)
    before = ssd_kernel.launches
    got = ssd_kernel.ssd_chunk_fwd(x, bm, cm, da, chunk=Q)
    y, final = ops.ssd_chunks(x, bm, cm, da, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd_kernel.launches == before + 2
    want = ref.ssd_chunk_plain(x, bm, cm, da, Q)
    assert torch.equal(got[2], want[2])  # the cumsum: the same float32 sums in the same order
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(), atol=2e-5, rtol=2e-4)
    # the kernel route against its plain route and against the einsum oracle
    for want_y, want_final in (ops.ssd_chunks(x, bm, cm, da, chunk=chunk, backend="reference"),
                               ref.ssd_chunks_reference(x, bm, cm, da, chunk)):
        np.testing.assert_allclose(y.cpu().numpy(), want_y.cpu().numpy(), atol=2e-5, rtol=2e-4)
        np.testing.assert_allclose(final.cpu().numpy(), want_final.cpu().numpy(), atol=2e-5,
                                   rtol=2e-4)


@pytest.mark.gpu
def test_ssd_kernel_takes_views_that_start_off_16_bytes(cuda_device):
    """x, B and C as contiguous views one float into their storage: the
    wrapper copies them to aligned storage for the kernel's 16-byte loads."""
    B, S, H, P, N, Q = 1, 128, 3, 32, 64, 64
    rng = np.random.default_rng(9)
    views = [torch.as_tensor(scale * rng.standard_normal(1 + int(np.prod(shape))),
                             dtype=torch.float32, device=cuda_device)[1:].view(shape)
             for shape, scale in (((B, S, H, P), 1.0), ((B, S, N), 0.5), ((B, S, N), 0.5))]
    assert all(t.is_contiguous() and t.data_ptr() % 16 for t in views)
    x, bm, cm = views
    da = -torch.nn.functional.softplus(torch.as_tensor(rng.standard_normal((B, S, H)),
                                                       dtype=torch.float32, device=cuda_device))
    got = ssd_kernel.ssd_chunk_fwd(x, bm, cm, da, chunk=Q)
    want = ref.ssd_chunk_plain(x, bm, cm, da, Q)
    assert torch.equal(got[2], want[2])
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(), atol=2e-5, rtol=2e-4)


@pytest.mark.gpu
def test_prefill_launches_the_ssd_kernel_once_per_layer(cuda_device):
    cfg = get_config("mamba2-130m").reduced(n_layers=3)
    lm = init_params(cfg, torch.Generator(device=cuda_device).manual_seed(0),
                     device=cuda_device)
    tokens = torch.as_tensor(np.random.default_rng(0).integers(0, cfg.vocab, (2, 64)),
                             device=cuda_device)
    logits = {}
    for backend in ("auto", "reference"):
        before = ssd_kernel.launches
        rt = Runtime(cuda_device, torch.float32, backend)
        logits[backend] = make_prefill_step(cfg, rt)(lm, {"tokens": tokens})
        torch.cuda.synchronize()
        assert ssd_kernel.launches - before == (cfg.n_layers if backend == "auto" else 0)
    err = (logits["auto"] - logits["reference"]).abs().max() / logits["reference"].abs().max()
    assert float(err) < 1e-4


# --- training: gradients through the kernels ---------------------------------
@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_grads_through_the_kernel_match_naive_autograd(cuda_device, dtype):
    """ops.flash_attention's forward launches the kernel once and its plain
    backward gives autograd's gradients through the naive oracle: atol 5e-5 /
    rtol 5e-4 in float32, 3e-2 in bfloat16 (the reference's bars)."""
    rng = np.random.default_rng(3)
    q, k, v, dout = (torch.as_tensor(rng.standard_normal(s), dtype=torch.float32)
                     .to(cuda_device, dtype) for s in ((2, 128, 1, 8, 256), (2, 128, 1, 256),
                                                       (2, 128, 1, 256), (2, 128, 1, 8, 256)))
    grads = {}
    for name, fn in (("kernel", ops.flash_attention), ("naive", ref.attention_naive)):
        t = [a.clone().requires_grad_() for a in (q, k, v)]
        before = flash_kernel.launches
        fn(*t, causal=True).float().backward(dout.float())
        assert flash_kernel.launches - before == (name == "kernel")
        grads[name] = [a.grad.float().cpu().numpy() for a in t]
    tol = dict(atol=3e-2, rtol=3e-2) if dtype == torch.bfloat16 else dict(atol=5e-5, rtol=5e-4)
    for got, want in zip(grads["kernel"], grads["naive"]):
        np.testing.assert_allclose(got, want, **tol)


@pytest.mark.gpu
def test_ssd_grads_through_the_kernel_match_the_plain_route(cuda_device):
    B, S, H, P, N, Q = 2, 512, 4, 64, 128, 256
    rng = np.random.default_rng(4)
    arrays = [torch.as_tensor(a, dtype=torch.float32, device=cuda_device) for a in (
        rng.standard_normal((B, S, H, P)), 0.5 * rng.standard_normal((B, S, N)),
        0.5 * rng.standard_normal((B, S, N)), -np.logaddexp(rng.standard_normal((B, S, H)), 0))]
    w = torch.as_tensor(rng.standard_normal((B, S, H, P)), dtype=torch.float32, device=cuda_device)
    grads = {}
    for backend in ("auto", "reference"):
        t = [a.clone().requires_grad_() for a in arrays]
        before = ssd_kernel.launches
        y, final = ops.ssd_chunks(*t, chunk=Q, backend=backend)
        ((y * w).sum() + final.sum()).backward()
        assert ssd_kernel.launches - before == (backend == "auto")
        grads[backend] = [a.grad for a in t]
    for got, want in zip(grads["auto"], grads["reference"]):
        assert float((got - want).abs().max() / want.abs().max()) < 2e-4


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["gemma-2b", "mamba2-130m"])
def test_train_step_launches_each_kernel_twice_per_layer(cuda_device, arch):
    """A train step of two microbatches launches each layer's kernel in the
    forward and again in its recompute, and its loss and gradient norm are
    the plain route's within 1e-4."""
    from repro_torch.train.optimizer import adamw
    from repro_torch.train.step import make_train_step

    cfg = get_config(arch).reduced()
    kernel = flash_kernel if arch == "gemma-2b" else ssd_kernel
    batch = {k: torch.as_tensor(np.random.default_rng(5).integers(0, cfg.vocab, (4, 64)),
                                device=cuda_device) for k in ("tokens", "labels")}
    metrics = {}
    for backend in ("auto", "reference"):
        lm = init_params(cfg, torch.Generator(device=cuda_device).manual_seed(0),
                         device=cuda_device)
        opt = adamw(lr=1e-3)
        step = make_train_step(cfg, Runtime(cuda_device, torch.float32, backend), opt, 2)
        before = kernel.launches
        _, _, m = step(lm, opt.init(dict(lm.named_parameters())), batch)
        torch.cuda.synchronize()
        want = 2 * 2 * cfg.n_layers if backend == "auto" else 0
        assert kernel.launches - before == want
        metrics[backend] = {k: float(v) for k, v in m.items()}
    for key in ("loss", "grad_norm"):
        assert metrics["auto"][key] == pytest.approx(metrics["reference"][key], rel=1e-4)


@pytest.mark.gpu
def test_scans_on_the_card_match_the_host_loop(cuda_device):
    """The simulation's Kiefer–Wolfowitz scans on the card against
    ``backend="numpy"``: the segment engine's per-customer logs and a
    rollout's statistics bit for bit (separate multiply and add, no FMA)."""
    from repro_torch.core import des
    from repro_torch.core.des_vector import rollout_candidates

    logs = []
    for kw in ({"device": cuda_device.type}, {"backend": "numpy"}):
        sim = des.FleetSimulator(seed=7, engine="vector", **kw)
        sim.add_app("x", lam=8.0, mu=1.8, n_servers=6)
        sim.add_app("y", lam=15.0, mu=3.3, n_servers=7)
        sim.run_until(100.0)
        sim.configure("x", n_servers=3, lam=11.0)
        sim.run_until(200.0)
        sim.drain()
        logs.append({nm: cl.logs() for nm, cl in sim._clusters.items()})
    for nm, want in logs[1].items():
        for a, b in zip(logs[0][nm], want):
            np.testing.assert_array_equal(a, b)
    mu = np.array([[1.8, 3.3], [2.0, 3.0], [1.5, 3.6]])
    n = np.array([[6, 7], [5, 8], [0, 7]])
    got = rollout_candidates(["x", "y"], [8.0, 15.0], mu, n, 60.0, seed=2, warmup_s=10.0,
                             device=cuda_device.type)
    assert got._raw[0].device.type == "cuda"
    want = rollout_candidates(["x", "y"], [8.0, 15.0], mu, n, 60.0, seed=2, warmup_s=10.0,
                              backend="numpy")
    for k in ("mean_s", "p95_s", "pooled_mean_s", "pooled_p95_s"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k))


@pytest.mark.gpu
def test_smoke_trace_on_the_card_matches_the_reference(cuda_device):
    """The smoke trace (join, cap resize, leave, drift; crms, predictive_crms,
    crms_priority, drf) through ScenarioRunner on the card (device None, des
    backend, vector engine) against the reference's document in
    tests/data/torch_scenario_golden.json, as chip_smoke.py's phase 18 holds
    it: integers, booleans, strings and lists exactly, floats within rtol
    1e-6, the wall clocks left out; at least one crms_grid launch a re-plan
    through CRMS (drf's demands launch none)."""
    import json

    from torch_scripts import chip_smoke as smoke

    golden = json.loads(smoke.SCENARIO_GOLDEN.read_text())
    before = port_kernel.launches
    res = smoke.replay_trace("smoke", golden["traces"]["smoke"], None)
    assert res["replans"] == 12
    assert port_kernel.launches - before >= res["crms_replans"] == 9


@pytest.mark.gpu
def test_fleet_row_solve_on_the_card_matches_the_cpu(cuda_device):
    """FleetPlanner at make_fleet(32, 8) on the card against the same planner
    on the CPU: assignment and counts exactly, node utilities and quotas
    within rtol 1e-9; the incremental re-plan likewise."""
    from repro_torch.core.placement import FleetPlanner, make_fleet

    apps, node_caps = make_fleet(32, 8, seed=4)
    plans = []
    for device in (None, "cpu"):
        planner = FleetPlanner(apps, node_caps, device=device)
        cold = planner.plan()
        incr = planner.replan(lam={apps[0].name: apps[0].lam * 1.2},
                              migrations=[(apps[1].name, 31)])
        plans.append((cold, incr))
    for card, cpu in zip(*plans):
        assert np.array_equal(card.assignment, cpu.assignment)
        assert np.array_equal(card.n, cpu.n)
        np.testing.assert_allclose(card.node_utility, cpu.node_utility, rtol=1e-9)
        np.testing.assert_allclose(card.r_cpu, cpu.r_cpu, rtol=1e-9)
        np.testing.assert_allclose(card.r_mem, cpu.r_mem, rtol=1e-9)


@pytest.mark.gpu
def test_search_baselines_on_the_card_match_the_cpu(cuda_device):
    """random_search, gpbo, tpebo and drf on the card (device None) against
    the CPU on the same draws: counts and flags exactly, floats within rtol
    1e-9."""
    from repro_torch.core.problem import ServerCaps
    from repro_torch.core.profiler import make_paper_apps

    apps, caps = make_paper_apps(lam=(8, 7, 10, 15), fitted=False), ServerCaps(30.0, 10.0)
    calls = (("random_search", {"n_samples": 4000}), ("gpbo", {"n_init": 8, "n_iters": 8}),
             ("tpebo", {"n_init": 8, "n_iters": 8}), ("drf", {}))
    for policy, extra in calls:
        card, cpu = (allocate(policy, AllocRequest(apps, caps, seed=1, extra=extra,
                                                   device=device)).allocation
                     for device in (None, "cpu"))
        assert np.array_equal(card.n, cpu.n), policy
        assert (card.feasible, card.stable) == (cpu.feasible, cpu.stable), policy
        np.testing.assert_allclose(card.r_cpu, cpu.r_cpu, rtol=1e-9, err_msg=policy)
        np.testing.assert_allclose(card.r_mem, cpu.r_mem, rtol=1e-9, err_msg=policy)


@pytest.mark.gpu
def test_fleet_plan_on_the_card_matches_the_cpu(cuda_device, monkeypatch):
    """FleetManager's plan on the reference's κ (tests/data/
    torch_fleet_binding_golden.json, put in instead of the manager's own
    fit) on the card against the same manager on the CPU, and the ×1.03 /
    ×1.6 drift from there, under chip_smoke.py phase 20's bars
    (``check_fleet_record``)."""
    import json

    from repro_torch.core.problem import App
    from repro_torch.serve import fleet as serve_fleet

    from torch_scripts import chip_smoke as smoke

    golden = json.loads(smoke.FLEET_BINDING_GOLDEN.read_text())
    apps = [App(**{**a, "kappa": tuple(a["kappa"])}) for a in golden["apps"]]
    monkeypatch.setattr(serve_fleet, "build_fleet_apps", lambda *_, **__: list(apps))
    records = []
    for device in (None, "cpu"):
        fm = serve_fleet.FleetManager(n_chips=smoke.FLEET_CHIPS, device=device)
        plan, _, _ = smoke.fleet_plan(fm)
        flags, drifted, _, _ = smoke.fleet_binding_drift(fm)
        records.append((plan, flags, drifted))
    (card, card_flags, card_drift), (cpu, cpu_flags, cpu_drift) = records
    smoke.check_fleet_record(cpu, card, "plan", apps, fm.caps)
    assert card_flags == cpu_flags == [False, True]
    smoke.check_fleet_record(cpu_drift, card_drift, "drift", fm.apps, fm.caps)
