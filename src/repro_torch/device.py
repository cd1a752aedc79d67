"""Device selection shared by every entry point of the port.

The port runs on the CUDA device unless the caller names another one: a
``device=None`` default resolves to ``"cuda"`` and raises when no card is
present, so a missing GPU never turns into a silent CPU run.
"""
from __future__ import annotations

import numpy as np
import torch

F64 = torch.float64


def resolve_device(device=None) -> torch.device:
    """``None`` -> the CUDA device (RuntimeError without one); anything else
    is passed to ``torch.device`` as given (e.g. ``"cpu"``)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device by default and "
                "torch.cuda.is_available() is False; pass device='cpu' to run "
                "on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)


def f64(x, device) -> torch.Tensor:
    """``x`` (Python number, NumPy array or tensor) as a float64 tensor on
    ``device``. A read-only NumPy view (e.g. from ``np.broadcast_to``) is
    copied, since torch cannot wrap read-only memory."""
    if isinstance(x, np.ndarray) and not x.flags.writeable:
        x = x.copy()
    return torch.as_tensor(x, dtype=F64, device=device)
