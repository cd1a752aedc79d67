"""Plain float32 pieces shared by the references: the precision switch, the
products in the control's lower precision, norms, RoPE and AdamW.

Nothing here imports the program (``repro_torch``) or JAX. The references
compute in float32 with TF32 off (``float32_products``); the control is the
same code with every product's operands rounded to float8 e4m3 first
(``Precision("fp8")``), the step below the bfloat16 that the configurations
state.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math

import torch

F32 = torch.float32
FP8_MAX = 448.0  # largest finite float8 e4m3fn


@contextlib.contextmanager
def float32_products():
    """TF32 off for the block (matmul and cuDNN), restored after."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
            torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev[:2]
        torch.set_float32_matmul_precision(prev[2])


def fp8_round(t):
    """``t`` rounded to float8 e4m3 under one scale for the tensor (its
    largest magnitude to 448), back in float32. The rounding passes the
    gradient straight through."""
    amax = t.detach().abs().amax().clamp(min=1e-12)
    scale = FP8_MAX / amax
    q = (t.detach() * scale).to(torch.float8_e4m3fn).to(F32) / scale
    return t + (q - t.detach()) if t.requires_grad else q


@dataclasses.dataclass(frozen=True)
class Precision:
    """How the reference multiplies: "fp32" (the reference) or "fp8" (the
    control: both operands of every product rounded to float8 e4m3, the sums
    in float32)."""

    name: str = "fp32"

    def __post_init__(self):
        if self.name not in ("fp32", "fp8"):
            raise ValueError(f"precision must be 'fp32' or 'fp8', got {self.name!r}")

    def op(self, t):
        return fp8_round(t) if self.name == "fp8" else t

    def mm(self, a, b):
        return self.op(a) @ self.op(b)


FP32 = Precision("fp32")


def rmsnorm(x, w, eps: float):
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps) * w


def rope(x, positions, theta: float):
    """Rotary embedding over the last dim of x (..., S, H, hd), its two halves
    rotated as a pair (the NeoX layout)."""
    half = x.shape[-1] // 2
    freqs = 1.0 / (theta ** (torch.arange(0, half, dtype=F32, device=x.device) / half))
    ang = positions.to(F32)[:, None] * freqs  # (S, half)
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def adamw_step(params: dict, grads: dict, state: dict, step: int, *, lr: float, b1: float,
               b2: float, eps: float, weight_decay: float):
    """One AdamW update in float32 (moments, bias correction, decoupled weight
    decay), new tensors in ``params`` and ``state``; ``step`` counts from 1."""
    c1, c2 = 1.0 - b1**step, 1.0 - b2**step
    for name, p in params.items():
        g = grads[name]
        m = b1 * state["m"][name] + (1 - b1) * g
        v = b2 * state["v"][name] + (1 - b2) * g * g
        state["m"][name], state["v"][name] = m, v
        params[name] = p - lr * ((m / c1) / (torch.sqrt(v / c2) + eps) + weight_decay * p)


def blocks(n: int, size: int):
    """Slices that cover range(n) in pieces of ``size``."""
    return [slice(i, min(i + size, n)) for i in range(0, n, max(size, 1))]


def ceil_to(x: float, q: int) -> int:
    return int(math.ceil(x / q) * q)
