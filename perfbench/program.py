"""The program under test, as the entries build it: its model configuration
from a configuration file's ``program`` group, its model with the
benchmark's weights, and its runtime. Imports of the program happen here, at
call time."""
from __future__ import annotations

import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def model_config(prog: dict):
    from repro_torch.configs.base import MambaSpec, ModelConfig, MoESpec

    fields = dict(prog)
    if fields.get("moe"):
        fields["moe"] = MoESpec(**fields["moe"])
    if fields.get("mamba"):
        fields["mamba"] = MambaSpec(**fields["mamba"])
    return ModelConfig(**fields)


def model(cfg, weights: dict, dtype, requires_grad: bool):
    """The program's model built on the meta device, its parameters the
    benchmark's ``weights``."""
    from repro_torch.models.model import LM

    from weights import install

    return install(LM(cfg, "meta", dtype), weights, requires_grad=requires_grad)


def runtime(device: str, compute_dtype: str, backend: str):
    from repro_torch.models.layers import Runtime

    return Runtime(device, DTYPES[compute_dtype], backend)
