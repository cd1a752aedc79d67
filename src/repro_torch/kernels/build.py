"""Build of the port's hand-written CUDA kernels: ``nvcc`` for ``sm_90a`` into
a shared library with a plain C interface, loaded with ``ctypes``.

Each source under ``csrc/`` is compiled at first use (never at import) into
``build/repro_torch/lib<name>_<hash>.so`` under the repository root, named by
a hash of the source and of the headers under ``csrc/`` (``*.cuh``), so an
edited source or header is rebuilt and an unchanged one is reused. No fast
math and no contraction of a*b+c by the compiler, so a kernel rounds
operation by operation as its plain torch version does.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "--fmad=false",
    "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
)


def _nvcc(name: str) -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(cuda_home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(f"{name}: nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def source_digest(source: Path) -> str:
    """Hash of a kernel source and of every ``*.cuh`` header beside it (the
    headers it may include), in name order."""
    digest = hashlib.sha256(source.read_bytes())
    for header in sorted(source.parent.glob("*.cuh")):
        digest.update(header.name.encode() + b"\0" + header.read_bytes())
    return digest.hexdigest()[:16]


def build_library(name: str, force: bool = False) -> tuple[ctypes.CDLL, dict]:
    """Compile ``csrc/<name>.cu`` (if its hashed library is missing or
    ``force``) and load it. Returns the library and {"seconds", "library",
    "log"}; the log holds ptxas' register/spill report when this call
    compiled. A failed nvcc raises RuntimeError with its output."""
    source = CSRC / f"{name}.cu"
    lib_path = BUILD_DIR / f"lib{name}_{source_digest(source)}.so"
    t0 = time.perf_counter()
    log = ""
    if force or not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(name), *NVCC_FLAGS, "-o", str(tmp), str(source)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"{name}: nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, lib_path)
        log = proc.stdout + proc.stderr
    lib = ctypes.CDLL(str(lib_path))
    return lib, {"seconds": time.perf_counter() - t0, "library": str(lib_path), "log": log}
