"""The benchmark's weights: made on the device from ``--seed``, in the dtype
they are served or trained in, by a few large draws into one flat buffer a
dtype, of which every weight is a view. The same tensors go to the program
(``install``, into its model built on the meta device) and to the plain
reference, so the reference takes no weight that the program made.

A spec is (name, shape, dtype, init), as a reference's ``param_specs``
gives it: init ("normal", std) draws from a standard normal and scales,
("const", value) fills, and ("a_log",) / ("dt_bias",) are Mamba2's
published initialisation of A (uniform in [1, 16], stored as log A) and dt
(log-uniform in [1e-3, 1e-1], stored as the inverse softplus).
"""
from __future__ import annotations

import math

import torch

DRAW = 1 << 30  # elements a draw


def make(specs: list, seed: int, device) -> dict:
    gen = torch.Generator(device=device).manual_seed(int(seed))
    out = {}
    for dtype in sorted({s[2] for s in specs}, key=str):
        mine = sorted((s for s in specs if s[2] == dtype),
                      key=lambda s: (s[3][0] != "normal", s[3][1:]))
        total = sum(math.prod(s[1]) for s in mine)
        flat = torch.empty(total, dtype=dtype, device=device)
        n_normal = sum(math.prod(s[1]) for s in mine if s[3][0] == "normal")
        for a in range(0, n_normal, DRAW):
            flat[a:min(a + DRAW, n_normal)].normal_(generator=gen)
        at, scaled = 0, {}
        for name, shape, _, init in mine:
            n = math.prod(shape)
            view = flat[at:at + n]
            if init[0] == "normal":
                lo, _ = scaled.get(init[1], (at, at))
                scaled[init[1]] = (lo, at + n)
            elif init[0] == "const":
                view.fill_(init[1])
            elif init[0] == "a_log":
                view.copy_(torch.log(torch.empty(n, dtype=torch.float32, device=device)
                                     .uniform_(1.0, 16.0, generator=gen)))
            elif init[0] == "dt_bias":
                dt = torch.exp(torch.empty(n, dtype=torch.float32, device=device)
                               .uniform_(math.log(1e-3), math.log(1e-1), generator=gen))
                view.copy_(dt + torch.log(-torch.expm1(-dt)))
            else:
                raise ValueError(f"weights: unknown init {init!r} of {name}")
            out[name] = view.view(shape)
            at += n
        for std, (lo, hi) in scaled.items():
            flat[lo:hi].mul_(std)
    return out


def install(lm, weights: dict, requires_grad: bool = False):
    """Puts ``weights`` into ``lm`` (a program model built on the meta
    device) as its parameters, by name; every parameter must be given, with
    its shape and dtype."""
    want = dict(lm.named_parameters())
    if set(want) != set(weights):
        missing, extra = sorted(set(want) - set(weights)), sorted(set(weights) - set(want))
        raise ValueError(f"weights: the program's parameters differ: missing {missing[:5]}, "
                         f"extra {extra[:5]}")
    for name, p in want.items():
        t = weights[name]
        if tuple(t.shape) != tuple(p.shape) or t.dtype != p.dtype:
            raise ValueError(f"weights: {name} is {tuple(t.shape)} {t.dtype}, the program "
                             f"wants {tuple(p.shape)} {p.dtype}")
        mod_name, _, leaf = name.rpartition(".")
        mod = lm.get_submodule(mod_name) if mod_name else lm
        mod._parameters[leaf] = torch.nn.Parameter(t, requires_grad=requires_grad)
    return lm
