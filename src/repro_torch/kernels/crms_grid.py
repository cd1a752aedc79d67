"""Host side of the hand-written CUDA ``crms_grid`` kernel (csrc/crms_grid.cu).

The kernel replaces the Pallas TPU kernel
``repro/kernels/crms_grid.py::crms_grid_eval``: batched Eq. (8) utility of a
(B, M) candidate grid, in float32, with the per-app output that CRMS grid
seeding (``engine.grid_seed_chints``) argmins over and the summed output the
search baselines score with.

The source is compiled with ``nvcc`` for ``sm_90a`` at first use by
``kernels/build.py`` (a plain C launcher, loaded with ``ctypes``); nothing is
compiled or loaded at import time. ``launches`` counts the kernel launches
this process made.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import build_library
from repro_torch.kernels.ref import MAX_N  # noqa: F401  (the counts the kernel's k-sum covers)

F32 = torch.float32

launches = 0  # kernel launches by this process (chip_smoke.py resets and reads it)
_lib = None


def build(force: bool = False) -> dict:
    """Compile the kernel (if its content-hashed library is missing or
    ``force``) and load it. Returns {"seconds", "library", "log"}; the log
    holds ptxas' register/spill report when this call compiled."""
    global _lib
    lib, info = build_library("crms_grid", force)
    fn = lib.crms_grid_launch
    fn.argtypes = [ctypes.c_void_p] * 7 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    _lib = lib
    return info


def _check(name, t, shape, device):
    if t.device != device:
        raise ValueError(f"crms_grid: {name} is on {t.device}, expected {device}")
    if t.dtype != F32:
        raise TypeError(f"crms_grid: {name} must be float32, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"crms_grid: {name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"crms_grid: {name} must be contiguous")


def crms_grid_launch(kappa, lam, xbar, n, c, m, *, caps_cpu, power_span, alpha, beta,
                     per_app: bool):
    """Launch the kernel on float32 contiguous CUDA tensors on the current
    stream; returns the (B, M) per-app terms or the (B,) row sums."""
    global launches
    if not n.is_cuda:
        raise ValueError(f"crms_grid: the CUDA kernel needs CUDA tensors, got {n.device}")
    B, M = n.shape
    dev = n.device
    for name, t, shape in (
        ("kappa", kappa, (M, 3)), ("lam", lam, (M,)), ("xbar", xbar, (M,)),
        ("n", n, (B, M)), ("c", c, (B, M)), ("m", m, (B, M)),
    ):
        _check(name, t, shape, dev)
    if _lib is None:
        build()
    out = torch.empty((B, M) if per_app else (B,), dtype=F32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = _lib.crms_grid_launch(
            kappa.data_ptr(), lam.data_ptr(), xbar.data_ptr(), n.data_ptr(),
            c.data_ptr(), m.data_ptr(), out.data_ptr(), B, M, float(caps_cpu),
            float(power_span), float(alpha), float(beta), int(per_app), stream,
        )
    if status != 0:
        raise RuntimeError(f"crms_grid: kernel launch failed with CUDA error {status}")
    launches += 1
    return out


def crms_grid_eval(kappa, lam, xbar, n, c, m, *, caps_cpu, power_span, alpha, beta,
                   reduce: str = "sum"):
    """kappa (M,3); lam/xbar (M,); n/c/m (B,M) CUDA tensors of any float
    type, cast to float32 as the TPU kernel does. Returns utility (B,) when
    ``reduce="sum"``, per-app utility terms (B, M) when ``reduce="per_app"``."""
    if reduce not in ("sum", "per_app"):
        raise ValueError(f"reduce must be 'sum' or 'per_app', got {reduce!r}")
    f32 = lambda t: t.to(F32).contiguous()  # noqa: E731
    return crms_grid_launch(
        f32(kappa), f32(lam), f32(xbar), f32(n), f32(c), f32(m),
        caps_cpu=caps_cpu, power_span=power_span, alpha=alpha, beta=beta,
        per_app=reduce == "per_app",
    )
