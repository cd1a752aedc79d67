"""The port covers the reference name by name: every module of
``src/repro/`` has its file in ``src/repro_torch/``, and every public
top-level name (functions, classes, constants) and every public method of
the reference's module exists in the port's counterpart, but for the
exceptions below, each with its reason: JAX or Pallas internals with no
role in eager PyTorch, and the stated deviations of ROADMAP.md. The sources
are parsed with ``ast``; neither package is imported. A name the port binds
by import counts (a re-export)."""
import ast
from pathlib import Path

import pytest

SRC = Path(__file__).resolve().parents[1] / "src"
REF, PORT = SRC / "repro", SRC / "repro_torch"
MODULES = sorted(str(p.relative_to(REF)) for p in REF.rglob("*.py"))

# (reference module, name) -> why the port has no such name
EXCEPTIONS = {
    ("core/engine.py", "PackedApps.jax_dict"):
        "the jitted kernels' pytree of jnp arrays; the port's as_dict(device) gives the tensors",
    ("kernels/ref.py", "flash_attention"):
        "stated deviation: the 'reference' attention backend is the flash kernel's plain "
        "version (kernels/ops), not the jnp oracle",
    ("kernels/ref.py", "ssd_chunks"):
        "stated deviation: the 'reference' SSD backend is the chunk kernel's plain version "
        "(kernels/ops), not the jnp oracle",
    ("models/layers.py", "constrain"):
        "with_sharding_constraint for GSPMD; the port's collectives are explicit "
        "(layers.redistribute, seq_runtime)",
    ("models/layers.py", "init_attention"):
        "functional init of a jax pytree; the port's nn.Modules make their parameters "
        "(model.init_params)",
    ("models/layers.py", "init_mlp"): "functional init of a jax pytree (as init_attention)",
    ("models/layers.py", "init_norm"): "functional init of a jax pytree (as init_attention)",
    ("models/mamba.py", "init_mamba"): "functional init of a jax pytree (as init_attention)",
    ("models/moe.py", "init_moe"): "functional init of a jax pytree (as init_attention)",
    ("models/model.py", "stage_body"):
        "the jax.lax.scan body over a stage's repeated layers; the port loops over its "
        "layers (_apply_layers)",
    ("models/model.py", "apply_stage"): "the scan over a stage's layers (as stage_body)",
}


def _bodies(body):
    """Top-level statements, those under a top-level ``if`` / ``try`` too."""
    for node in body:
        if isinstance(node, ast.If):
            yield from _bodies(node.body + node.orelse)
        elif isinstance(node, ast.Try):
            yield from _bodies(node.body + node.orelse + node.finalbody)
        else:
            yield node


def names(path: Path, imports: bool = False) -> set:
    """The public names a module defines at top level and its classes' public
    methods as "Class.method"; with ``imports`` also the names it imports."""
    out = set()
    for node in _bodies(ast.parse(path.read_text()).body):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out.add(node.name)
        elif isinstance(node, ast.ClassDef):
            out.add(node.name)
            out |= {f"{node.name}.{m.name}" for m in node.body
                    if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))}
        elif isinstance(node, ast.Assign):
            out |= {t.id for t in node.targets if isinstance(t, ast.Name)}
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            out.add(node.target.id)
        elif imports and isinstance(node, (ast.Import, ast.ImportFrom)):
            out |= {(a.asname or a.name).split(".")[0] for a in node.names}
    return {n for n in out if not any(part.startswith("_") for part in n.split("."))}


@pytest.mark.parametrize("module", MODULES)
def test_reference_module_is_ported_name_by_name(module):
    port = PORT / module
    assert port.exists(), f"{module}: no port file {port.relative_to(SRC)}"
    missing = names(REF / module) - names(port, imports=True)
    missing -= {name for (mod, name) in EXCEPTIONS if mod == module}
    assert not missing, f"{module}: the port lacks {sorted(missing)}"


@pytest.mark.parametrize("key", sorted(EXCEPTIONS), ids="::".join)
def test_exception_is_still_needed(key):
    """Each exception names a public name of the reference that the port
    still lacks (a name since ported, or gone from the reference, leaves)."""
    module, name = key
    assert name in names(REF / module), f"{module}: the reference has no {name}"
    assert name not in names(PORT / module, imports=True), f"{module}: the port has {name}"
    assert EXCEPTIONS[key]
