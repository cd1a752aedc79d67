"""PyTorch/CUDA port of the sensitivity-aware container manager (CRMS).

The package mirrors ``repro``'s module layout (``core``, ``kernels``,
``api``) and computes the same allocations with plain PyTorch on float64
tensors, plus a hand-written CUDA kernel for the candidate-grid evaluation
(``kernels/csrc/crms_grid.cu``). It imports neither JAX nor ``repro``.

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; with no card and no explicit device they raise
``RuntimeError`` (see ``repro_torch.device.resolve_device``).

    from repro_torch.api import AllocRequest, allocate
    from repro_torch.core.profiler import make_tenant_mix
    apps, caps, _ = make_tenant_mix(8)
    result = allocate("crms", AllocRequest(apps, caps, device="cuda"))
"""
