"""Every name the JAX package exports has a counterpart in the port.

The JAX package's ``__init__.py`` files and the ``__all__`` of its modules
are read with ``ast`` (no JAX is imported); each name must resolve in the
port's module of the same path.  The recorded exceptions are the modules
and names that have no counterpart by design: the Pallas kernels (ported as
``ops/cuda``), JAX's persistent compile cache, and the solvers that run the
JAX package itself.  Also the two host helpers of ``ops/host_dual``.
"""

import ast
import importlib
from pathlib import Path

import numpy as np
import pytest
import torch

JAX_ROOT = Path(__file__).resolve().parents[1] / "lapgnn_tpu"

# (module path under the package, name or None for the whole module)
EXCEPTIONS = {
    ("ops/pallas", None),
    ("ops/pallas/colmin", None),
    ("ops/pallas/features", None),
    ("ops/pallas/twomin", None),
    ("utils/compile_cache", None),
    ("solver/api", "JAXSolver"),
    ("solver/api", "SeededJAXSolver"),
}


def _exported(path: Path):
    """The names of ``__all__``, else (an ``__init__``) its relative imports."""
    tree = ast.parse(path.read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "__all__" for t in node.targets):
            return [ast.literal_eval(e) for e in node.value.elts]
    if path.name == "__init__.py":
        return [a.asname or a.name for node in tree.body
                if isinstance(node, ast.ImportFrom) and node.level >= 1 for a in node.names]
    return None


def _modules():
    out = []
    for path in sorted(JAX_ROOT.rglob("*.py")):
        names = _exported(path)
        if names is None:
            continue
        rel = path.relative_to(JAX_ROOT).with_suffix("")
        parts = [p for p in rel.parts if p != "__init__"]
        out.append(("/".join(parts), names))
    return out


ALL_MODULES = _modules()
MODULES = [(m, names) for m, names in ALL_MODULES if (m, None) not in EXCEPTIONS]


def test_exceptions_are_few_and_none_is_parallel():
    assert len(EXCEPTIONS) <= 8
    assert not any(mod.startswith("parallel") for mod, _ in EXCEPTIONS)
    known = dict(ALL_MODULES)
    for mod, name in EXCEPTIONS:
        assert mod in known and (name is None or name in known[mod])


@pytest.mark.parametrize("mod,names", MODULES, ids=[m or "package" for m, _ in MODULES])
def test_port_exports_what_jax_exports(mod, names):
    module = importlib.import_module(".".join(["lapgnn_tpu_torch"] + [p for p in mod.split("/") if p]))
    missing = [n for n in names if (mod, n) not in EXCEPTIONS and not hasattr(module, n)]
    assert not missing, f"lapgnn_tpu_torch/{mod} lacks {missing}"


def test_synthetic_families_alias():
    from lapgnn_tpu_torch.data import FAMILIES, SYNTHETIC_FAMILIES

    assert SYNTHETIC_FAMILIES is FAMILIES


@pytest.mark.parametrize("solver", ["SciPySolver", "LAPSolver", "TorchSolver"])
def test_affine_invariance_check_all_solvers(solver):
    from lapgnn_tpu_torch.ops.host_dual import affine_invariance_check
    from lapgnn_tpu_torch.solver import api

    cls = getattr(api, solver)
    # the check's tolerance is 1e-9 relative: the device solver in float64
    inst = cls(dtype=torch.float64, device="cpu") if solver == "TorchSolver" else cls()
    assert affine_invariance_check(inst.solve, n=32)


def test_affine_invariance_check_catches_a_wrong_solver():
    from lapgnn_tpu_torch.ops.host_dual import affine_invariance_check
    from lapgnn_tpu_torch.solver.api import SciPySolver

    def wrong(C):
        rows, cols, cost = SciPySolver().solve(C)
        return rows, cols, cost + float(np.abs(C).max()) * 1e-3
    assert not affine_invariance_check(wrong, n=16)


def test_print_env_summary_names_the_ports_variables(capsys, monkeypatch):
    from lapgnn_tpu.ops.host_dual import print_env_summary as jax_summary
    from lapgnn_tpu_torch.ops.host_dual import print_env_summary

    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0")
    info = print_env_summary()
    assert info["env"]["CUDA_VISIBLE_DEVICES"] == "0"
    assert "PYTORCH_CUDA_ALLOC_CONF" in info["env"] and "JAX_PLATFORMS" not in info["env"]
    assert "[env]" in capsys.readouterr().out
    want = jax_summary()
    assert set(info) == set(want)
    assert set(want["env"]) - {"JAX_PLATFORMS"} <= set(info["env"])
