"""Device meshes of the port, and a launcher of ranks that run one program.

The reference runs one process over many devices (``repro/launch/mesh.py``
builds a ``jax.sharding.Mesh``). The port runs one process a rank, joined by
``torch.distributed``; its mesh is a ``DeviceMesh`` with the reference's axis
names over the ranks of the default process group:

  single-pod: (16, 16) ("data", "model")            = 256 ranks
  multi-pod : (2, 16, 16) ("pod", "data", "model")  = 512 ranks

Both are FUNCTIONS: importing this module touches no process group. Every
rank calls them with the same arguments (SPMD). The production backend is
``nccl``, one rank a card; ``gloo`` runs the same collectives on CPU tensors
(the tests) and on ranks that share one card, which NCCL refuses.

``fake_world`` stands one process in for rank 0 of a production deployment
(the dry-run, ``launch/dryrun.py``): torch's "fake" backend answers every
collective at once and moves nothing, so the mesh's code runs without its
ranks; with fake tensors (``FakeTensorMode``) nothing is allocated either.

``spawn`` starts ``world_size`` ranks on this host, each with one torch
thread, and joins them through a ``FileStore`` in a fresh temporary directory
(no TCP port, so parallel test workers never collide) with gloo on the
loopback interface. A failure in any rank is raised in the caller with that
rank's traceback.
"""
from __future__ import annotations

import contextlib
import math
import os
import shutil
import tempfile
import traceback

import torch
import torch.distributed as dist

PRODUCTION_AXES = ("data", "model")
MULTI_POD_AXES = ("pod", "data", "model")


def _mesh(shape: tuple, axes: tuple, device_type: str):
    from torch.distributed.device_mesh import init_device_mesh

    n = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have < n:
        raise RuntimeError(
            f"mesh {shape} needs {n} ranks but only {have} present; start them with "
            "repro_torch.launch.mesh.spawn (or torchrun) and init_process_group first"
        )
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a mesh on device_type 'cuda' needs a CUDA device and "
                           "torch.cuda.is_available() is False; pass device_type='cpu'")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    return _mesh(shape, MULTI_POD_AXES if multi_pod else PRODUCTION_AXES, device_type)


def make_smoke_mesh(data: int = 2, model: int = 2, device_type: str = "cuda"):
    """Small (data, model) mesh over the first data·model ranks."""
    return _mesh((data, model), PRODUCTION_AXES, device_type)


def make_mesh(shape: tuple, axes: tuple, device_type: str = "cuda"):
    """Any mesh of the given shape and axis names over the first ranks (the
    fleet's row solve takes a 1-D ("nodes",) mesh)."""
    return _mesh(tuple(shape), tuple(axes), device_type)


@contextlib.contextmanager
def fake_world(world_size: int, *, device_type: str = "cuda", shape: tuple | None = None,
               axes: tuple | None = None):
    """This process as rank 0 of ``world_size`` ranks joined by torch's
    "fake" process group (over a ``FakeStore``: no rank beside this one
    exists, and every collective returns at once with its buffers as they
    were). Yields the mesh on ``device_type``: the production mesh of the
    world (256 ranks: (16, 16) ("data", "model"); 512: (2, 16, 16) ("pod",
    "data", "model")), or ``shape`` with ``axes``. The group is destroyed on
    exit, so none outlives the block; refuses to start (RuntimeError) where
    a process group is already up."""
    if dist.is_initialized():
        raise RuntimeError("fake_world: a process group is already initialised in this "
                           "process; a fake world needs a process without one")
    # importing the module registers the "fake" backend (and its store)
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if shape is None:
        production = {256: ((16, 16), PRODUCTION_AXES), 512: ((2, 16, 16), MULTI_POD_AXES)}
        if world_size not in production:
            raise ValueError(f"fake_world: no production mesh of {world_size} ranks; "
                             "give shape and axes")
        shape, axes = production[world_size]
    if math.prod(shape) != world_size:
        raise ValueError(f"fake_world: mesh {tuple(shape)} is not {world_size} ranks")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)
    try:
        yield _mesh(tuple(shape), tuple(axes), device_type)
    finally:
        dist.destroy_process_group()


def mesh_shape(mesh) -> dict:
    """{axis: size} of a ``DeviceMesh``, or of a mapping that already is one
    (the pure sharding functions take either, so the production meshes can
    be described without 256 ranks)."""
    if mesh is None:
        return {}
    if isinstance(mesh, dict):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


# ----------------------------------------------------------------------------
# Rank launcher
# ----------------------------------------------------------------------------
def _fn_ref(fn):
    """How a rank finds ``fn``: its module's name and file, and its name."""
    import inspect

    return fn.__module__, inspect.getsourcefile(fn), fn.__qualname__


def _resolve(ref):
    """The function ``_fn_ref`` names: from its module if importable, else
    from its file (a script loaded by path, e.g. ``chip_smoke.py``)."""
    import importlib
    import importlib.util
    import sys

    module_name, path, qualname = ref
    module = sys.modules.get(module_name)
    if module is None:
        try:
            module = importlib.import_module(module_name)
        except ImportError:
            spec = importlib.util.spec_from_file_location(module_name, path)
            module = importlib.util.module_from_spec(spec)
            sys.modules[module_name] = module
            spec.loader.exec_module(module)
    obj = module
    for part in qualname.split("."):
        obj = getattr(obj, part)
    return obj


RANK_TIMES: dict = {}  # a spawned rank's wall clock at its start-up steps


def _rank_main(rank, world_size, backend, device, store_path, args_path, results):
    import datetime
    import faulthandler
    import time

    RANK_TIMES["started"] = time.time()
    # the ranks share this host: gloo's sockets on the loopback interface, not
    # on an address looked up from the host name (which a machine without a
    # network may take many seconds to refuse)
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    faulthandler.enable()  # a crash in a collective prints this rank's stack
    torch.set_num_threads(1)
    try:
        fn_ref, args = torch.load(args_path, weights_only=False)
        fn = _resolve(fn_ref)
        RANK_TIMES["resolved"] = time.time()
        if device == "cuda":
            torch.cuda.set_device(0 if torch.cuda.device_count() == 1 else rank)
            torch.cuda.init()
        RANK_TIMES["device"] = time.time()
        store = dist.FileStore(store_path, world_size)
        dist.init_process_group(backend, store=store, rank=rank, world_size=world_size,
                                timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
        RANK_TIMES["joined"] = time.time()
        try:
            out = fn(rank, world_size, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:  # reported to the caller, who raises it
        results.put((rank, False, traceback.format_exc()))


GRACE_S = 30.0  # how long ranks may wait in a collective for one that failed
COLLECTIVE_TIMEOUT_S = 300.0  # the process group's limit on one collective


def spawn(fn, world_size: int, *, backend: str = "gloo", device: str = "cpu", args=(),
          timeout: float | None = None):
    """Run ``fn(rank, world_size, *args)`` in ``world_size`` new processes
    joined in one default process group (``backend``); returns the ranks'
    return values in rank order. ``fn`` must be a module-level function of an
    importable module or of a script file (loaded by its path), and its
    return value picklable. With ``device="cuda"`` each
    rank takes the card of its rank, or card 0 when there is only one. Any
    rank's exception, a rank that dies, or a run past ``timeout`` seconds
    raises RuntimeError here with every failing rank's traceback; ranks still
    running GRACE_S seconds after another failed (waiting in a collective for
    it) are killed; a collective waits at most COLLECTIVE_TIMEOUT_S."""
    import time

    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.SimpleQueue()
    tmp = tempfile.mkdtemp(prefix="repro_torch_mesh_")
    procs = []
    try:
        # the ranks read fn and args from a file: passed through the start-up
        # pipe, a large argument would hold each start until the rank before
        # had imported its modules, so that the ranks start one after another
        args_path = os.path.join(tmp, "args.pt")
        torch.save((_fn_ref(fn), tuple(args)), args_path)
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(rank, world_size, backend, device,
                                   os.path.join(tmp, "store"), args_path, results))
                 for rank in range(world_size)]
        for p in procs:
            p.start()
        got, failed = {}, {}
        deadline = None if timeout is None else time.monotonic() + timeout
        while len(got) + len(failed) < world_size:
            if not results.empty():
                rank, ok, out = results.get()
                if ok:
                    got[rank] = out
                else:
                    failed[rank] = out
                    end = time.monotonic() + GRACE_S
                    deadline = end if deadline is None else min(deadline, end)
                continue
            if not any(p.is_alive() for p in procs) and results.empty():
                break
            if deadline is not None and time.monotonic() > deadline:
                break
            time.sleep(0.02)
        lost = [r for r in range(world_size) if r not in got and r not in failed]
        if failed or lost:
            detail = "\n".join(f"--- rank {r} ---\n{tb}" for r, tb in sorted(failed.items()))
            codes = {r: procs[r].exitcode for r in lost}
            raise RuntimeError(f"spawn: rank(s) {sorted(failed)} raised, rank(s) {lost} gave no "
                               f"result (exit codes {codes}; None: killed while running)\n"
                               f"{detail}")
        return [got[r] for r in range(world_size)]
    finally:
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(tmp, ignore_errors=True)
