"""DSO — Distributed Stochastic Optimization of the saddle objective (Alg. 1).

API-compatibility surface over :mod:`repro_torch.engine` (the layered
backend/schedule/driver implementation — see
``repro_torch/engine/__init__.py``).  Two execution modes, both sharing the
Eq.-(8) update math:

1. ``run_dso_serial``  — the paper-exact pointwise algorithm: one (i,j)
   nonzero per update, in order (``engine.solve_serial``; one kernel
   launch per epoch on the card).  Ground truth for faithfulness.
2. ``run_dso_grid``    — a single-device simulator of the p-processor
   block-cyclic schedule with *tile* (minibatch) updates: every
   anti-diagonal block of the p x p grid is updated simultaneously, exactly
   as the p devices would (``engine.solve``).

``run_dso_grid_from_data`` is the out-of-core entry: pre-built grid data
(e.g. ``sparse.ingest.ingest_libsvm`` + ``sparse_grid_from_csr``), no
dense ``Problem``.  ``impl`` selects a registered engine backend — the
canonical names (``engine.registered_backends()``) or the legacy selectors
below; unknown names raise ``ValueError``.  ``device`` (default the card)
must be where the data lives, as for ``engine.solve``.
"""

from __future__ import annotations

from repro_torch.core.saddle import Problem
from repro_torch.engine.backends import (LEGACY_IMPLS,  # noqa: F401
                                         resolve_backend,
                                         resolve_backend_for_layout)
# re-exports: the legacy flat-module surface of the layered engine
from repro_torch.engine.data import (DSOState, GridData,  # noqa: F401
                                     as_tile_data, check_tile_stats,
                                     gather_alpha, gather_w, init_state,
                                     init_state_data, make_grid_data,
                                     tile_dims)
from repro_torch.engine.data import eta_schedule as _eta_schedule  # noqa
from repro_torch.engine.data import prob_meta as _prob_meta  # noqa: F401
from repro_torch.engine.driver import (SolveResult, run_epoch,  # noqa: F401
                                       run_epochs, solve, solve_serial)
from repro_torch.engine.schedules import cyclic_perms
from repro_torch.engine.update import (block_tile_step,  # noqa: F401
                                       sparse_tile_step)
from repro_torch.engine.update import eq8_apply as _eq8_apply  # noqa: F401

#: run_dso_grid layout-and-kernel selectors: dense plain tile steps, the
#: dense CUDA kernel, sparse (block-ELL) plain tile steps, the sparse CUDA
#: kernel, and density-based automatic choice.  Canonical engine backend
#: names are accepted everywhere too.
IMPLS = ("jnp", "pallas", "sparse", "sparse_pallas", "auto")


def resolve_impl(impl: str, density: float) -> tuple[str, str]:
    """(layout, kernel) for an ``impl`` selector, as the reference names
    them: kernel "pallas" for a CUDA-kernel backend, "jnp" for a plain
    one.

    ``auto`` picks the sparse layout when the problem density is below
    ``sparse.format.SPARSE_DENSITY_THRESHOLD`` (with the plain kernel, as
    the reference's ``auto`` does for data it has not seen; ``solve``
    picks the kernel by the data's device).  Unknown selectors raise
    ``ValueError`` naming the registered backends.
    """
    backend = resolve_backend(impl, density)
    return backend.layout, ("pallas" if "pallas" in backend.name else "jnp")


def run_dso_serial(prob: Problem, epochs: int = 10, eta0: float = 0.1,
                   seed: int = 0, use_adagrad: bool = True,
                   alpha0: float = 0.0, eval_every: int = 1, *,
                   device="cuda"):
    """Paper-exact Algorithm 1 with p=1 (sequential pointwise updates)."""
    res = solve_serial(prob, epochs=epochs, eta0=eta0, seed=seed,
                       use_adagrad=use_adagrad, alpha0=alpha0,
                       eval_every=eval_every, device=device)
    return res.w, res.alpha, res.history


def run_dso_grid(prob: Problem, p: int = 4, epochs: int = 10,
                 eta0: float = 0.1, use_adagrad: bool = True,
                 row_batches: int = 1, alpha0: float = 0.0,
                 eval_every: int = 1, impl: str = "jnp",
                 scan_epochs: bool = True, schedule: str = "cyclic", *,
                 device="cuda"):
    """Single-device simulation of Algorithm 1 with p processors.

    ``impl`` selects layout and kernel (see ``IMPLS`` / the engine backend
    registry): dense ``"jnp"`` / ``"pallas"``, nnz-proportional
    ``"sparse"`` / ``"sparse_pallas"`` (block-ELL tiles, same trajectory
    to float32 reduction order), or ``"auto"`` picking the layout from the
    density and the tile-K skew.  ``schedule`` is any registered engine
    schedule ("cyclic" is Algorithm 1).  ``scan_epochs=False`` runs one
    ``run_epoch`` call per epoch (the reference's benchmark baseline);
    identical math.
    """
    res = solve(prob, backend=impl, schedule=schedule, p=p, epochs=epochs,
                eta0=eta0, use_adagrad=use_adagrad, row_batches=row_batches,
                alpha0=alpha0, eval_every=eval_every,
                scan_epochs=scan_epochs, device=device)
    return res.w, res.alpha, res.history


def run_dso_grid_from_data(data, *, loss_name: str, reg_name: str,
                           lam: float, m: int, d: int, epochs: int = 10,
                           eta0: float = 0.1, use_adagrad: bool = True,
                           row_batches: int = 1, alpha0: float = 0.0,
                           impl: str = "jnp", eval_every: int | None = None,
                           eval_hook=None, device="cuda"):
    """Algorithm 1 on pre-built grid data — the out-of-core entry point.

    Takes dense ``GridData``, ``SparseGridData`` or ``BucketedGridData``
    directly (e.g. from ``sparse.ingest.ingest_libsvm`` +
    ``sparse_grid_from_csr`` / ``bucketed_grid_from_csr``), so no dense
    ``Problem`` — and no (m, d) dense matrix — ever exists.  ``m``/``d``
    are the real (unpadded) problem sizes; ``impl`` is the *kernel*
    ("jnp"/"pallas"/"auto", or a canonical backend name matching the
    data's layout), the layout being fixed by the data's type.

    Returns (w, alpha) — or, when an ``eval_hook`` is supplied (e.g.
    ``engine.make_csr_primal_eval``: a chunked CSR matvec on the device),
    (w, alpha, history) with the hook called every ``eval_every`` epochs.
    """
    res = solve(data, backend=impl, schedule="cyclic", epochs=epochs,
                eta0=eta0, use_adagrad=use_adagrad, row_batches=row_batches,
                alpha0=alpha0,
                eval_every=epochs if eval_every is None else eval_every,
                eval_hook=eval_hook if eval_hook is not None else "auto",
                loss_name=loss_name, reg_name=reg_name, lam=lam, m=m, d=d,
                device=device)
    if eval_hook is not None:
        return res.w, res.alpha, res.history
    return res.w, res.alpha


# ------------------------------------------------------------------------
# legacy one-call epoch shims (the reference's benchmarks time these)
# ------------------------------------------------------------------------


def _impl_kw(data, impl, kw):
    """The backend for ``impl`` on the data's layout and device, and the
    epoch keywords: ``backend`` set, the reference's ``p``/``db`` (which
    the port reads from the data) dropped."""
    tile = as_tile_data(data)
    backend = resolve_backend_for_layout(impl, tile.layout,
                                         device_type=tile.yg.device.type)
    out = {k: v for k, v in kw.items() if k not in ("p", "db")}
    out["backend"] = backend.name
    return backend, out


def _grid_epoch(data, state, eta_t, lam, m, w_lo, w_hi, *, impl="jnp",
                **kw):
    """One cyclic epoch, one call (legacy path; see ``_grid_epochs``)."""
    _, kw2 = _impl_kw(data, impl, kw)
    perm = cyclic_perms(1, tile_dims(data)[0])[0]
    return run_epoch(as_tile_data(data), state, perm, eta_t, lam, m, w_lo,
                     w_hi, **kw2)


def _grid_epochs(data, state, etas, lam, m, w_lo, w_hi, *, impl="jnp",
                 **kw):
    """``len(etas)`` cyclic epochs in one ``run_epochs`` call."""
    _, kw2 = _impl_kw(data, impl, kw)
    perms = cyclic_perms(len(etas), tile_dims(data)[0])
    return run_epochs(as_tile_data(data), state, perms, etas, lam, m, w_lo,
                      w_hi, **kw2)
