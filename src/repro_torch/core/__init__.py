"""The paper's container manager (CRMS) on PyTorch float64 tensors.

Unlike ``repro.core`` this package imports nothing at import time: every
module passes ``dtype=torch.float64`` explicitly instead of switching a
global precision flag.
"""
