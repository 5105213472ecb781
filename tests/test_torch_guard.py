"""Guards of the port: it imports neither JAX nor the JAX package, its
entry points default to the card and refuse to run without one, and its
kernel wrappers never compute a CUDA request on the CPU."""

import ast
import pathlib

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + \
    [REPO / "chip_smoke.py"]


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.module
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "id", getattr(node.func, "attr", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_neither_jax_nor_the_reference(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), \
            f"{path.relative_to(REPO)} imports {mod}"


def test_guard_sees_the_whole_port():
    names = {p.name for p in PORT_FILES}
    assert {"driver.py", "ops.py", "dso_sparse.py", "dso_update.py",
            "swa_attention.py", "ssd_scan.py", "build.py", "format.py",
            "chip_smoke.py"} <= names
    for src in ("dso_sparse.cu", "dso_update.cu", "dso_common.cuh",
                "dso_twopass.cu", "swa_attention.cu", "ssd_scan.cu",
                "float_io.cuh"):
        assert (REPO / "src/repro_torch/csrc" / src).exists()
    from repro_torch.kernels import build
    assert {"dso_twopass_primal", "dso_twopass_dual", "swa_attention_fwd",
            "ssd_scan_fwd"} <= set(build.SIGNATURES)
    assert "repro" != "repro_torch".split(".")[0]


def test_entry_points_default_to_the_card_and_raise_without_one():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from repro_torch.core.saddle import make_problem
    from repro_torch.data.synthetic import make_classification
    from repro_torch.engine import make_csr_primal_eval, solve
    from repro_torch.sparse import CSRMatrix, make_sparse_grid_data
    X = np.eye(8, dtype=np.float32)
    y = np.ones(8, np.float32)
    with pytest.raises(RuntimeError, match="cuda"):
        make_problem(X, y, 1e-3)
    with pytest.raises(RuntimeError, match="cuda"):
        make_classification(m=8, d=8, density=0.25)
    prob = make_problem(X, y, 1e-3, device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        solve(prob)
    with pytest.raises(RuntimeError, match="cuda"):
        make_sparse_grid_data(prob, 2)
    with pytest.raises(RuntimeError, match="cuda"):
        make_csr_primal_eval(CSRMatrix.from_dense(X), y, 1e-3)
    grid = make_sparse_grid_data(prob, 2, device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        solve(grid, loss_name="hinge", reg_name="l2", lam=1e-3, m=8, d=8)
    with pytest.raises(ValueError, match="'cuda' or 'cpu'"):
        solve(prob, device="meta")
    assert solve(prob, backend="sparse_jnp", device="cpu",
                 epochs=1).w.device.type == "cpu"
