#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one NVIDIA card and check them.

    python3 chip_smoke.py            # needs one CUDA card and nvcc

Phases, one line per result:

1. device: ``nvidia-smi`` name and power limit, torch and CUDA versions.
2. build: nvcc builds every ``src/repro_torch/csrc/*.cu`` (one nvcc per
   source, started together) into one library in ``build/`` (seconds,
   ptxas registers / shared memory).
3. sparse kernels vs plain versions on the card: the probe, then both
   sparse block-step kernels against their plain PyTorch versions on the
   same inputs for six (loss, reg) pairs x row_batches {1, 3}, bound 1e-5
   (rtol and atol; atomics reorder the scatter's sum).
3d. dense kernel vs plain versions on the card: the dense launch A + B
   through ``ops.dso_block_step`` for row_batches {1, 2, 3} x the six
   pairs on a narrow grid (db 289, rows and columns padded, a trailing row
   at row_batches 2 and 3) and a wide one (db 12,375: the column partial
   no longer fits in shared memory), and through ``ops.dso_tile_step`` at
   M 999, D 1,155 (contiguous and a row-strided view); bound 1e-5.
4. main path, block-ELL: ``solve(grid, backend="auto")`` on the
   svm-real-sim configuration (hinge, l2, lam 1e-4, eta0 0.5, p 4) at
   LIBSVM real-sim's size (m 72,309, d 20,958, ~51 nnz per row), 10
   epochs with the device CSR primal every 2; the launch counts must equal
   the design's, the primal must be finite and fall at every evaluation,
   and the plain twin run on the card must agree at every evaluation to
   1e-5 relative.  Then s/epoch of ``run_epochs`` alone (median, min, max
   over 5 repeats) for the kernel backend and its plain twin, and a
   profiled 2-epoch ``run_epochs`` for the device's busy and idle time.
5. main path, K-bucketed: the logistic-real-sim configuration (logistic,
   l2, lam 1e-4, alpha0 5e-4) on power-law columns (alpha 1.3); same
   checks.
5d. main path, dense: ``solve(problem, backend="auto")`` on the svm-ocr
   configuration (hinge, l2, lam 1e-4, eta0 0.5, p 4) at ocr's width
   (d 1,156) with m 1,000,000 rows drawn on the card; ``auto`` must pick
   ``dense_pallas_block``; then the same run on ``dense_pallas_fused``
   (the per-tile path, ``ops.dso_tile_step``), each in its own launch
   count window; same checks against ``dense_jnp``, plus the peak device
   memory.
3t. the two-pass tile step (``ops.dso_tile_step(twopass=True)``) against
   its plain version and against the fused ``ops.dso_tile_step`` on the
   same inputs, six pairs at M 999, D 1,155, contiguous and row-strided;
   bound 1e-5.
3l. ``ops.swa_attention`` and ``ops.ssd_scan`` against their plain
   versions in float32 and bf16: the shapes of the reference's kernel
   tests, a decode offset (Tq 8, Tk 4,096), ``causal=False`` (ragged Tk
   too), ragged T, Dh 40, 112 and 128, n 128, dh 128, total decay; and
   shapes past the kernels' limits must raise.  Bounds: float32 as the
   reference's tests (swa rtol = atol = 2e-5; ssd rtol 2e-4, atol 2e-5);
   bf16 one bf16 ulp (2^-7 relative) more, since kernel and plain version
   each round float32 sums that differ in order to bf16.
6. times at the phase-4/5/5d shapes with CUDA events: each kernel's ms per
   call beside its bound (bytes over 3.35 TB/s, operations over 67
   TFLOP/s float32), its plain version's ms and, for the dense kernel,
   the cuBLAS mat-vecs computing the same two products (``torch.mv``,
   never called by the port).
7. the LM kernels at zamba2-7b's widths (bf16, 32 heads of 112, SSD 112
   heads of 64 with state 64, chunk 128), each case driven once through
   ``ops`` with the counts set to 0 just before and read just after:
   attention at T 16,384 with a window past T (full causal; beside
   ``F.scaled_dot_product_attention(is_causal=True)``, never called by
   the port) and at T 73,728 with the 8,192 sliding window; the SSD scan
   at t 16,384, and at mamba2-370m's 32 heads with state 128 (timed in
   the order kernel, plain, plain, kernel, 5 calls each).  Then the
   two-pass tile step at svm-ocr's tile (processor 0's active block of
   phase 5d, 250,000 x 289) beside the fused step.  Each: ms per call
   (CUDA events), bound, plain ms, max|d| against the plain version.

Prints the kernel table as one JSON line, the card's ``nvidia-smi`` line,
and last ``{"ok": true, "device": {...}}``.  Any failure raises and exits
non-zero; without a CUDA card it exits 2 before printing any result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_S = 3.35e12      # H100 SXM device memory rate (data sheet)
F32_OPS_S = 67e12          # H100 SXM float32 outside the tensor cores
BF16_OPS_S = 989e12        # H100 SXM bf16 tensor cores, dense
BF16_ULP = 2.0 ** -7       # bf16 spacing relative to the value
TOL = 1e-5
P = 4
LOSS_REG_PAIRS = [("hinge", "l2"), ("hinge", "l1"), ("logistic", "l2"),
                  ("logistic", "l1"), ("square", "l2"), ("square", "l1")]
REALSIM_M, REALSIM_D, REALSIM_K = 72309, 20958, 51
OCR_M, OCR_D = 1_000_000, 1156   # ocr's published width; rows cut
EPOCHS, EVAL_EVERY = 10, 2
EPOCH_REPS = 5             # timed repeats of run_epochs(EPOCHS) per backend


class SmokeFailure(AssertionError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def say(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def max_rel_err(got, want):
    import torch
    d = (got - want).abs()
    return float(d.max()), bool(torch.all(d <= TOL + TOL * want.abs()))


def cuda_ms(fn, n, warm=3):
    """Mean ms per call of ``fn`` over ``n`` calls, CUDA events around the
    run, after ``warm`` calls."""
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def device_split(fn):
    """Wall seconds of ``fn()`` (synchronised) and the device time of every
    kernel it ran, from a ``torch.profiler`` trace: (wall_s, busy_s,
    [(kernel, us), ...] largest first)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    kernels = [(e.key, e.self_device_time_total)
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    kernels.sort(key=lambda kv: -kv[1])
    return wall, sum(us for _, us in kernels) / 1e6, kernels


def epoch_runner(grid, backend, *, loss, lam, m, alpha0):
    """``(fresh, run)`` for timing ``run_epochs`` alone: ``fresh()`` makes
    a new state, ``run(state, n)`` runs ``n`` <= EPOCHS epochs on it with
    the cyclic schedule and step sizes made here, once."""
    import numpy as np
    import torch
    from repro_torch.core.losses import w_bounds
    from repro_torch.engine import (eta_schedule, get_schedule,
                                    init_state_data, run_epochs)
    _, perms = get_schedule("cyclic").draw(torch.Generator().manual_seed(0),
                                           0, EPOCHS, P)
    perms = torch.as_tensor(perms).to(device=grid.yg.device,
                                      dtype=torch.int32)
    etas = eta_schedule(0.5, 0, EPOCHS, True)
    lo, hi = w_bounds(loss, lam)
    args = (float(np.float32(lam)), float(np.float32(m)), lo, hi)

    def fresh():
        return init_state_data(loss, grid, alpha0)

    def run(state, n):
        run_epochs(grid, state, perms[:n], etas[:n], *args, backend=backend,
                   loss_name=loss, reg_name="l2")

    return fresh, run


def epoch_seconds(fresh, run):
    """s/epoch of ``run_epochs`` alone, sorted over ``EPOCH_REPS`` repeats
    of EPOCHS epochs from a fresh state, host clock around the
    synchronised call (state set-up, schedule draw, evaluation and gathers
    excluded), after one unrecorded warm-up epoch."""
    import torch
    run(fresh(), 1)
    out = []
    for _ in range(EPOCH_REPS):
        st = fresh()
        torch.cuda.synchronize()
        t = time.perf_counter()
        run(st, EPOCHS)
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t) / EPOCHS)
    return sorted(out)


# ------------------------------------------------------------------ data --


def realsim_csr(m, d, k, alpha, seed):
    """real-sim-shaped CSR by the ``make_classification`` recipe, drawn
    vectorised: one ``rng.choice`` of shape (m, k) (power-law column
    popularity when ``alpha``), sorted and deduplicated per row, normal
    values on unit-norm rows, labels from a planted w* with noise 0.1.
    Never densified."""
    import numpy as np
    from repro_torch.sparse import CSRMatrix
    rng = np.random.default_rng(seed)
    pop = None
    if alpha:
        pop = np.arange(1, d + 1, dtype=np.float64) ** (-alpha)
        pop /= pop.sum()
    cols = np.sort(rng.choice(d, size=(m, k), replace=True, p=pop), axis=1)
    keep = np.ones((m, k), bool)
    keep[:, 1:] = cols[:, 1:] != cols[:, :-1]
    indptr = np.zeros(m + 1, np.int64)
    np.cumsum(keep.sum(axis=1), out=indptr[1:])
    indices = cols[keep].astype(np.int32)
    vals = rng.normal(0, 1, indices.size).astype(np.float32)
    rows = np.repeat(np.arange(m), np.diff(indptr))
    norms = np.sqrt(np.bincount(rows, weights=vals.astype(np.float64) ** 2,
                                minlength=m))
    vals = (vals / np.maximum(norms, 1e-8)[rows]).astype(np.float32)
    csr = CSRMatrix(indptr, indices, vals, (m, d))
    w_star = rng.normal(0, 1, d).astype(np.float32)
    margin = csr.matvec(w_star) + 0.1 * rng.normal(0, 1, m).astype(np.float32)
    y = np.where(margin >= 0, 1.0, -1.0).astype(np.float32)
    return csr, y


def ocr_problem(m, d, lam, seed, dev):
    """svm-ocr-shaped dense ``Problem`` by the ``make_dense_classification``
    recipe (features N(0, 1/sqrt(d)), labels from a planted w* with noise
    0.1), drawn on the card with a CUDA ``torch.Generator`` in chunks of
    rows; X never exists on the host."""
    import torch
    from repro_torch.core.saddle import Problem
    g = torch.Generator(device=dev).manual_seed(seed)
    X = torch.empty((m, d), dtype=torch.float32, device=dev)
    for r in range(0, m, 1 << 16):
        X[r:r + (1 << 16)].normal_(0.0, 1.0 / d ** 0.5, generator=g)
    w_star = torch.randn(d, generator=g, device=dev)
    noise = torch.randn(m, generator=g, device=dev)
    y = torch.where(X @ w_star + 0.1 * noise >= 0, 1.0, -1.0)
    row_nnz = torch.zeros(m, dtype=torch.float32, device=dev)
    col_nnz = torch.zeros(d, dtype=torch.float32, device=dev)
    for r in range(0, m, 1 << 16):
        nz = X[r:r + (1 << 16)] != 0
        row_nnz[r:r + (1 << 16)] = nz.sum(dim=1).float()
        col_nnz += nz.sum(dim=0).float()
    return Problem(X=X, y=y, lam=lam, row_nnz=row_nnz.clamp(min=1.0),
                   col_nnz=col_nnz.clamp(min=1.0), nnz=float(row_nnz.sum()),
                   loss_name="hinge", reg_name="l2")


def random_state(grid, loss, seed):
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    dev = grid.yg.device
    p, mb, db = grid.p, grid.mb, grid.db
    y = grid.yg.cpu().numpy()
    alpha = y * rng.uniform(0.05, 0.95, (p, mb))
    if loss == "square":
        alpha = rng.normal(0, 0.5, (p, mb))
    t = lambda a: torch.tensor(np.asarray(a, np.float32), device=dev)  # noqa
    return dict(w_grid=t(rng.normal(0, 0.1, (p, db))),
                gw_grid=t(np.abs(rng.normal(0, 0.01, (p, db)))),
                alpha=t(alpha), ga=t(np.abs(rng.normal(0, 0.01, (p, mb)))))


def step_args(grid, st):
    return (grid.yg, st["w_grid"], st["alpha"], st["gw_grid"], st["ga"],
            grid.tile_row_nnz_g, grid.tile_col_nnz_g, grid.row_nnz_g,
            grid.col_nnz)


def scalars(loss, lam, m):
    import numpy as np
    from repro_torch.core.losses import w_bounds
    lo, hi = w_bounds(loss, lam)
    return (0.5, float(np.float32(lam)), float(np.float32(m)), lo, hi)


def run_step(kind, grid, st, blk, scal, rb, loss, reg, plain):
    """One block step of every processor, in place on ``st``: the kernel
    wrapper, or (``plain``) the kernel's plain version."""
    from repro_torch.kernels import dso_sparse, dso_update, ops
    if kind == "dense":
        fn = dso_update.dso_block_step_plain if plain else ops.dso_block_step
        fn(grid.Xg, blk, *step_args(grid, st), scal, row_batches=rb,
           loss_name=loss, reg_name=reg)
    elif kind == "sparse":
        fn = dso_sparse.dso_sparse_block_step_plain if plain \
            else ops.dso_sparse_block_step
        fn(grid.cols_g, grid.vals_g, blk, *step_args(grid, st), scal,
           row_batches=rb, loss_name=loss, reg_name=reg)
    else:
        fn = dso_sparse.dso_bucketed_block_step_plain if plain \
            else ops.dso_bucketed_block_step
        fn(grid.cols_fl, grid.vals_fl, grid.chunk_lut, grid.chunk_cnt, blk,
           *step_args(grid, st), scal, row_batches=rb, loss_name=loss,
           reg_name=reg)


def compare_step(kind, grid, st, blk, scal, rb, loss, reg):
    """Kernel vs plain version on clones of the same state: max|d| and
    whether every field is within the bound."""
    import torch
    a = {k: v.clone() for k, v in st.items()}
    b = {k: v.clone() for k, v in st.items()}
    run_step(kind, grid, a, blk, scal, rb, loss, reg, plain=False)
    run_step(kind, grid, b, blk, scal, rb, loss, reg, plain=True)
    torch.cuda.synchronize()
    errs = [max_rel_err(a[k], b[k]) for k in st]
    return max(e for e, _ in errs), all(ok for _, ok in errs)


# ---------------------------------------------------------------- phases --


def phase_kernels(dev):
    """Phase 3: probe, then both block steps against their plain versions
    at small shapes with trailing rows (mb = 250, 250 % 3 = 1)."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    from repro_torch.sparse import (CSRMatrix, bucketed_grid_from_csr,
                                    sparse_grid_from_csr)
    err = ops.sparse_kernel_error(dev)
    check(err is None, f"probe failed: {err}")
    say(3, "probe: gather + atomicAdd scatter matches its plain version")
    rng = np.random.default_rng(5)
    m, d = 1000, 512
    pop = np.arange(1, d + 1, dtype=np.float64) ** -1.3
    pop /= pop.sum()
    ks = rng.integers(2, 60, m)
    cols = np.concatenate([np.sort(rng.choice(d, size=k, replace=False,
                                              p=pop)) for k in ks])
    indptr = np.zeros(m + 1, np.int64)
    np.cumsum(ks, out=indptr[1:])
    csr = CSRMatrix(indptr, cols.astype(np.int32),
                    rng.normal(0, 1, indptr[-1]).astype(np.float32), (m, d))
    y = np.where(rng.random(m) < 0.5, 1.0, -1.0).astype(np.float32)
    blk = torch.tensor([1, 3, 0, 2], dtype=torch.int32, device=dev)
    worst = 0.0
    for rb in (1, 3):
        grids = {"sparse": sparse_grid_from_csr(csr, y, P, rb, device=dev),
                 "bucketed": bucketed_grid_from_csr(csr, y, P, rb,
                                                    device=dev)}
        check(len(grids["bucketed"].bucket_ks) >= 3,
              f"bucketed case has {grids['bucketed'].bucket_ks}")
        for loss, reg in LOSS_REG_PAIRS:
            for kind, grid in grids.items():
                st = random_state(grid, loss, seed=rb)
                e, ok = compare_step(kind, grid, st, blk,
                                     scalars(loss, 1e-3, m), rb, loss, reg)
                worst = max(worst, e)
                say(3, f"{kind:8s} {loss}/{reg} row_batches={rb} "
                       f"mb={grid.mb} "
                       f"buckets={getattr(grid, 'bucket_ks', '-')} "
                       f"max|d|={e:.3e} {'ok' if ok else 'FAIL'}")
                check(ok, f"{kind} {loss}/{reg} rb={rb}: kernel disagrees "
                          f"with its plain version (max|d| {e:.3e})")
    return worst


def phase_main(phase, dev, *, loss, lam, alpha0, powerlaw, expect):
    """Phases 4/5: the main path at real-sim size through ``solve``."""
    import numpy as np
    import torch
    from repro_torch.engine import (make_csr_primal_eval, resolve_backend,
                                    resolve_backend_for_layout, solve)
    from repro_torch.kernels import ops
    from repro_torch.sparse import (bucketed_grid_from_csr, csr_k_per_tile,
                                    grid_nbytes, sparse_grid_from_csr,
                                    tile_k_skew)
    t0 = time.perf_counter()
    csr, y = realsim_csr(REALSIM_M, REALSIM_D, REALSIM_K, powerlaw,
                         seed=phase)
    skew = tile_k_skew(csr_k_per_tile(csr, P))
    be = resolve_backend("auto", csr.density, k_skew=skew,
                         device_type=dev.type)
    say(phase, f"data m={csr.m} d={csr.d} nnz={csr.nnz} "
               f"nnz/row={csr.nnz / csr.m:.2f} density={csr.density:.3e} "
               f"tile-K skew={skew:.2f} -> auto resolves {be.name}")
    check(be.name == expect, f"auto picked {be.name}, expected {expect}")
    build = {"sparse": sparse_grid_from_csr,
             "bucketed": bucketed_grid_from_csr}[be.layout]
    grid = build(csr, y, P, 1, device=dev)
    check(resolve_backend_for_layout("auto", be.layout,
                                     device_type=dev.type).name == expect,
          "auto on the pre-built grid resolves another backend")
    hook = make_csr_primal_eval(csr, y, lam, loss, "l2", device=dev)
    torch.cuda.synchronize()
    say(phase, f"layout {be.layout}: grid_nbytes={grid_nbytes(grid)} "
               f"K={getattr(grid, 'K', getattr(grid, 'bucket_ks', None))} "
               f"mb={grid.mb} db={grid.db} "
               f"set-up {time.perf_counter() - t0:.1f} s")
    kw = dict(p=P, epochs=EPOCHS, eta0=0.5, eval_every=EVAL_EVERY,
              eval_hook=hook, loss_name=loss, reg_name="l2", lam=lam,
              m=csr.m, d=csr.d, alpha0=alpha0, device=dev)

    # the main path: counts set to 0 just before, read just after
    ops.sparse_kernel_error.cache_clear()
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    res = solve(grid, backend="auto", **kw)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    n_step = EPOCHS * P * 1          # epochs x inner iterations x row tiles
    want = dict({k: 0 for k in counts}, sparse_probe=1,
                dso_primal_update=n_step,
                dso_sparse_block_step=n_step if be.layout == "sparse" else 0,
                dso_bucketed_block_step=n_step
                if be.layout == "bucketed" else 0)
    say(phase, f"launch counts {counts} (design: {want})")
    check(counts == want, f"launch counts {counts} != design {want}")
    primal = [h["primal"] for h in res.history]
    say(phase, "primal per eval " + " ".join(
        f"e{h['epoch']}={h['primal']:.6f}" for h in res.history))
    check(all(np.isfinite(primal)), "non-finite primal")
    check(all(b < a for a, b in zip(primal, primal[1:])),
          f"primal did not fall at every evaluation: {primal}")
    say(phase, f"primal falls at every evaluation; "
               f"max_memory_allocated={peak} B")

    plain_name = {"sparse": "sparse_jnp",
                  "bucketed": "sparse_bucketed_jnp"}[be.layout]
    twin = solve(grid, backend=plain_name, **kw)
    rel = [abs(a["primal"] - b["primal"]) / abs(b["primal"])
           for a, b in zip(res.history, twin.history)]
    say(phase, f"plain twin {plain_name} on the card: max rel primal "
               f"diff {max(rel):.3e} over {len(rel)} evals")
    check(len(rel) == len(primal) and max(rel) <= TOL,
          f"kernel and plain twin disagree: {rel}")

    runners = {name: epoch_runner(grid, name, loss=loss, lam=lam,
                                  m=csr.m, alpha0=alpha0)
               for name in (be.name, plain_name)}
    for name, (fresh, run) in runners.items():
        t = epoch_seconds(fresh, run)
        med = t[len(t) // 2]
        say(phase, f"run_epochs s/epoch {name}: median {med:.6f} min "
                   f"{t[0]:.6f} max {t[-1]:.6f} over {len(t)} x {EPOCHS} "
                   f"epochs; nnz/s at the median {csr.nnz / med:.4e}")
    fresh, run = runners[be.name]
    st = fresh()
    wall, busy, kernels = device_split(lambda: run(st, 2))
    say(phase, f"profiled run_epochs(2) of {be.name}: wall {wall:.6f} s, "
               f"device busy {busy:.6f} s, idle share "
               f"{1 - busy / wall:.3f}; top kernels (us): "
               + ", ".join(f"{k[:48]}={us:.1f}" for k, us in kernels[:6]))
    return dict(grid=grid, layout=be.layout, counts=counts, loss=loss,
                lam=lam, m=csr.m, state=res.state)


def tile_cases(dev):
    """The tile-step cases of phases 3d and 3t: (name, X, y) for an
    M 999 x D 1,155 problem and a row-strided view of one processor's
    block of its p = 4 grid."""
    from repro_torch.data.synthetic import make_classification
    from repro_torch.engine import make_grid_data
    prob = make_classification(m=999, d=1155, density=0.7, seed=3,
                               device=dev)
    grid = make_grid_data(prob, P, 1)
    return (("contiguous", prob.X, prob.y),
            ("strided", grid.Xg[2, :, grid.db:2 * grid.db], grid.yg[2]))


def tile_step_args(X, y, loss, rng):
    """Random (y, w, alpha, gw, ga, row_nnz, col_nnz, scalars) for a tile
    step over X, drawn from ``rng`` on X's device."""
    import numpy as np
    import torch
    M, D = X.shape
    t = lambda a: torch.tensor(np.asarray(a, np.float32),  # noqa: E731
                               device=X.device)
    alpha = y * t(rng.uniform(0.05, 0.95, M))
    if loss == "square":
        alpha = t(rng.normal(0, 0.5, M))
    return (y, t(rng.normal(0, 0.1, D)), alpha,
            t(np.abs(rng.normal(0, 0.01, D))),
            t(np.abs(rng.normal(0, 0.01, M))),
            t(rng.integers(1, 50, M)), t(rng.integers(1, 50, D)),
            scalars(loss, 1e-3, M))


def phase_dense_kernels(dev):
    """Phase 3d: the dense launch A + B against the plain versions at
    small shapes: ``ops.dso_block_step`` for row_batches {1, 2, 3} on a
    narrow grid (m 999, d 1,155: rows and a column padded, db 289) and
    {1, 3} on a wide one (m 64, d 49,500: db 12,375, past the kernel's
    shared-memory partial), x six pairs; ``ops.dso_tile_step`` at M 999,
    D 1,155 and on a row-strided view of one processor's block."""
    import numpy as np
    import torch
    from repro_torch.data.synthetic import make_classification
    from repro_torch.engine import make_grid_data
    from repro_torch.kernels import dso_update, ops
    worst = 0.0
    blk = torch.tensor([1, 3, 0, 2], dtype=torch.int32, device=dev)
    cases = [(999, 1155, 0.7, (1, 2, 3)), (64, 49500, 0.5, (1, 3))]
    for m, d, density, rbs in cases:
        prob = make_classification(m=m, d=d, density=density, seed=m,
                                   device=dev)
        for rb in rbs:
            grid = make_grid_data(prob, P, rb)
            for loss, reg in LOSS_REG_PAIRS:
                st = random_state(grid, loss, seed=rb)
                e, ok = compare_step("dense", grid, st, blk,
                                     scalars(loss, 1e-3, m), rb, loss, reg)
                worst = max(worst, e)
                say("3d", f"dense block step {loss}/{reg} row_batches={rb} "
                          f"mb={grid.mb} db={grid.db} max|d|={e:.3e} "
                          f"{'ok' if ok else 'FAIL'}")
                check(ok, f"dense {loss}/{reg} rb={rb} db={grid.db}: "
                          f"kernel disagrees with its plain version "
                          f"(max|d| {e:.3e})")
    rng = np.random.default_rng(9)
    for name, X, y in tile_cases(dev):
        for loss, reg in LOSS_REG_PAIRS:
            args = tile_step_args(X, y, loss, rng)
            M, D = X.shape
            kw = dict(loss_name=loss, reg_name=reg,
                      tile_row_nnz=(X != 0).sum(1).float(),
                      tile_col_nnz=(X != 0).sum(0).float())
            got = ops.dso_tile_step(X, *args, **kw)
            want = dso_update.dso_tile_step_plain(X, *args, **kw)
            torch.cuda.synchronize()
            errs = [max_rel_err(g, w) for g, w in zip(got, want)]
            e = max(x for x, _ in errs)
            worst = max(worst, e)
            say("3d", f"dense tile step {name} {loss}/{reg} M={M} D={D} "
                      f"max|d|={e:.3e}")
            check(all(ok for _, ok in errs),
                  f"dense tile step {name} {loss}/{reg}: kernel disagrees "
                  f"with its plain version (max|d| {e:.3e})")
    return worst


def compare_tile_steps(got, wants):
    """max|d| of a tile step's four outputs against each of ``wants`` and
    whether all are within the bound."""
    errs = [max_rel_err(g, w) for want in wants for g, w in zip(got, want)]
    return max(e for e, _ in errs), all(ok for _, ok in errs)


def phase_twopass_kernels(dev):
    """Phase 3t: the two-pass tile step against its plain version and the
    fused step on the same inputs, six pairs on the cases of phase 3d."""
    import numpy as np
    import torch
    from repro_torch.kernels import dso_update, ops
    worst = 0.0
    rng = np.random.default_rng(11)
    for name, X, y in tile_cases(dev):
        M, D = X.shape
        for loss, reg in LOSS_REG_PAIRS:
            args = tile_step_args(X, y, loss, rng)
            kw = dict(loss_name=loss, reg_name=reg)
            got = ops.dso_tile_step(X, *args, twopass=True, **kw)
            plain = dso_update.dso_tile_step_twopass_plain(X, *args, **kw)
            fused = ops.dso_tile_step(X, *args, **kw)
            torch.cuda.synchronize()
            e, ok = compare_tile_steps(got, (plain, fused))
            worst = max(worst, e)
            say("3t", f"two-pass tile step {name} {loss}/{reg} M={M} D={D} "
                      f"max|d| vs plain and fused {e:.3e}")
            check(ok, f"two-pass tile step {name} {loss}/{reg}: disagrees "
                      f"with its plain version or the fused step "
                      f"(max|d| {e:.3e})")
    return worst


# (B, Hq, Hkv, Tq, Tk, Dh, window, causal, q_offset)
SWA_CASES = [(1, 2, 2, 256, 256, 64, 128, True, 0),
             (2, 4, 2, 256, 256, 64, 64, True, 0),
             (1, 8, 1, 128, 128, 32, 1024, True, 0),
             (1, 2, 1, 100, 100, 64, 50, True, 0),
             (2, 4, 2, 8, 4096, 64, 256, True, 4088),     # decode offset
             (1, 2, 2, 256, 256, 64, 100, False, 0),
             (1, 2, 1, 100, 100, 64, 50, False, 0),       # ragged Tk
             (1, 4, 2, 300, 300, 112, 128, True, 0),      # ragged, Dh 112
             (1, 2, 2, 130, 130, 40, 64, True, 0),        # Dh 40: not x16
             (1, 2, 1, 200, 200, 128, 100, True, 0)]      # Dh at the limit
# (b, t, h, dh, n, chunk, A fill or None)
SSD_CASES = [(1, 128, 2, 32, 16, 64, None),
             (2, 256, 3, 32, 16, 64, None),
             (1, 100, 2, 16, 8, 32, None),
             (1, 512, 1, 64, 32, 128, None),
             (1, 1000, 4, 64, 64, 128, None),     # ragged t, zamba2 n, dh
             (1, 300, 2, 64, 128, 128, None),     # mamba2-370m's n = 128
             (1, 260, 2, 128, 64, 128, None),     # dh 128
             (1, 128, 1, 16, 8, 64, -1e4)]        # total decay
SWA_TOL = (2e-5, 2e-5)       # (rtol, atol) of the reference's swa tests
SSD_TOL = (2e-4, 2e-5)       # ... and of its ssd tests


def within(got, want, tol, bf16):
    """max|d| and whether |got - want| <= atol + rtol |want| everywhere,
    with one bf16 ulp more rtol when the outputs are bf16."""
    import torch
    rtol, atol = tol
    if bf16:
        rtol += BF16_ULP
    g, w = got.float(), want.float()
    d = (g - w).abs()
    return float(d.max()), bool(torch.all(d <= atol + rtol * w.abs()))


def ssd_inputs(b, t, h, dh, n, gen, dtype):
    """x (in ``dtype``), dt, A, B, C on ``gen``'s device, drawn as the
    reference's kernel tests draw them."""
    import torch
    dev = gen.device
    r = lambda *s: torch.randn(*s, generator=gen, device=dev)  # noqa: E731
    x = r(b, t, h, dh).to(dtype)
    dt = r(b, t, h).abs() * 0.1 + 0.01
    A = -(r(h) * 0.3 + 1.0).abs()
    return x, dt, A, r(b, t, n) / n ** 0.5, r(b, t, n) / n ** 0.5


def phase_lm_kernels(dev):
    """Phase 3l: ``ops.swa_attention`` and ``ops.ssd_scan`` against their
    plain versions on the card, float32 and bf16."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.kernels import swa_attention as swa
    gen = torch.Generator(device=dev).manual_seed(3)
    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        bf16 = dtype == torch.bfloat16
        for B, Hq, Hkv, Tq, Tk, Dh, window, causal, off in SWA_CASES:
            q = torch.randn(B, Hq, Tq, Dh, generator=gen, device=dev)
            k, v = (torch.randn(B, Hkv, Tk, Dh, generator=gen, device=dev)
                    for _ in range(2))
            q, k, v = (a.to(dtype) for a in (q, k, v))
            kw = dict(window=window, causal=causal, q_offset=off)
            got = ops.swa_attention(q, k, v, **kw)
            want = swa.swa_attention_plain(q, k, v, **kw)
            torch.cuda.synchronize()
            e, ok = within(got, want, SWA_TOL, bf16)
            worst["swa", bf16] = max(worst.get(("swa", bf16), 0.0), e)
            say("3l", f"swa_attention {str(dtype)[6:]} B={B} Hq={Hq} "
                      f"Hkv={Hkv} Tq={Tq} Tk={Tk} Dh={Dh} window={window} "
                      f"causal={causal} q_offset={off} max|d|={e:.3e}")
            check(ok and got.dtype == dtype,
                  f"swa_attention disagrees with its plain version "
                  f"(max|d| {e:.3e})")
        for b, t, h, dh, n, chunk, fill in SSD_CASES:
            x, dt, A, Bm, Cm = ssd_inputs(b, t, h, dh, n, gen, dtype)
            if fill is not None:
                A = torch.full_like(A, fill)
            got = ops.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk)
            want = ssd.ssd_scan_plain(x, dt, A, Bm, Cm, chunk=chunk)
            torch.cuda.synchronize()
            e, ok = within(got, want, SSD_TOL, bf16)
            worst["ssd", bf16] = max(worst.get(("ssd", bf16), 0.0), e)
            say("3l", f"ssd_scan {str(dtype)[6:]} b={b} t={t} h={h} dh={dh} "
                      f"n={n} chunk={chunk} A={'-1e4' if fill else 'drawn'} "
                      f"max|d|={e:.3e}")
            check(ok and got.dtype == dtype,
                  f"ssd_scan disagrees with its plain version "
                  f"(max|d| {e:.3e})")
    # shapes the kernels do not take raise on the card, with no fallback
    q = torch.zeros(1, 1, 8, 144, device=dev)
    refused = []
    try:
        ops.swa_attention(q, q, q, window=4)
    except ValueError as e:
        refused.append(str(e))
    x, dt, A, Bm, Cm = ssd_inputs(1, 8, 1, 128, 128, gen, torch.float32)
    try:            # 280,576 B of shared memory: the launch refuses it
        ops.ssd_scan(x, dt, A, Bm, Cm, chunk=128)
    except RuntimeError as e:
        refused.append(str(e))
    say("3l", f"refused on the card: {refused}")
    check(len(refused) == 2, "a shape the kernels do not take was not "
                             "refused")
    return worst


# zamba2-7b (configs/zamba2_7b.py): 32 attention heads of 112 over d_model
# 3,584; SSD 112 heads of 64 (expand 2), state 64; sliding window 8,192
# above full_attn_max 65,536; bf16.  mamba2-370m: 32 SSD heads, state 128.
ZAMBA_HEADS, ZAMBA_HEAD_DIM = 32, 112
SWA_FULL = [("causal, window >= T", 16384, 16384),
            ("sliding window", 73728, 8192)]
SSD_FULL = [("zamba2-7b", 16384, 112, 64, 64),
            ("mamba2-370m", 16384, 32, 64, 128)]
SSD_CHUNK = 128


def swa_bound(B, Hq, Hkv, Tq, Tk, Dh, window, q_offset, elem):
    """(bound ms, bound_by) of causal sliding-window attention: q, k, v
    read once and the output written once; 4 Dh operations per attended
    (query, key) pair at the bf16 tensor-core rate (float32 for 4-byte
    inputs)."""
    import torch
    pos = torch.arange(Tq, dtype=torch.float64) + q_offset
    lo = (pos - window + 1).clamp(min=0)
    hi = pos.clamp(max=Tk - 1)
    pairs = float((hi - lo + 1).clamp(min=0).sum()) * B * Hq
    nbytes = elem * (2 * B * Hq * Tq * Dh + 2 * B * Hkv * Tk * Dh)
    ops_s = 4 * Dh * pairs / (BF16_OPS_S if elem == 2 else F32_OPS_S)
    by = "bytes" if nbytes / HBM_BYTES_S >= ops_s else "operations"
    return max(nbytes / HBM_BYTES_S, ops_s) * 1e3, by


def ssd_bound(x, n):
    """(bound ms, bound_by) of the SSD scan: x, dt, A, B, C read once and y
    written once; ~5 n dh float32 operations per (step, head) of the exact
    recurrence (decay, input outer product, output contraction)."""
    b, t, h, dh = x.shape
    nbytes = 2 * x.numel() * x.element_size() + 4 * (b * t * h + h
                                                       + 2 * b * t * n)
    ops_s = 5 * n * dh * b * t * h / F32_OPS_S
    by = "bytes" if nbytes / HBM_BYTES_S >= ops_s else "operations"
    return max(nbytes / HBM_BYTES_S, ops_s) * 1e3, by


def drive_once(name, fn):
    """The main path of one LM case: the counts set to 0 just before one
    call through ``ops``, read just after; the call must have launched
    ``name``'s kernel exactly once."""
    import torch
    from repro_torch.kernels import ops
    ops.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    check(counts[name] == 1 and sum(counts.values()) == 1,
          f"{name}: launch counts {counts}, expected one {name} launch")
    return out, counts[name]


def phase_lm_full(dev):
    """Phase 7: the LM kernels at zamba2-7b's widths through ``ops``."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.kernels import swa_attention as swa
    gen = torch.Generator(device=dev).manual_seed(17)
    bf = torch.bfloat16
    rows = {}
    B, H, DH = 1, ZAMBA_HEADS, ZAMBA_HEAD_DIM
    for label, T, window in SWA_FULL:
        q, k, v = (torch.randn(B, H, T, DH, generator=gen, device=dev).to(bf)
                   for _ in range(3))
        out, n = drive_once(
            "swa_attention",
            lambda: ops.swa_attention(q, k, v, window=window))
        check(out.shape == q.shape and out.dtype == bf
              and bool(torch.isfinite(out).all()),
              f"swa_attention {label}: bad output")
        want = swa.swa_attention_plain(q, k, v, window=window)
        err, ok = within(out, want, SWA_TOL, True)
        check(ok, f"swa_attention {label}: max|d| {err:.3e} against the "
                  f"plain version")
        del out, want
        ms = cuda_ms(lambda: ops.swa_attention(q, k, v, window=window), 3,
                     warm=1)
        _, busy, _ = device_split(
            lambda: ops.swa_attention(q, k, v, window=window))
        plain_ms = cuda_ms(lambda: swa.swa_attention_plain(
            q, k, v, window=window), 2, warm=0)
        lib_ms = None
        if window >= T:
            lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True), 5, warm=1)
        bound, by = swa_bound(B, H, H, T, T, DH, window, 0, 2)
        rows["swa", label] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound,
                                  bound_by=by, library_ms=lib_ms,
                                  max_abs_err=err, launches=n,
                                  device_ms=busy * 1e3)
        say(7, f"swa_attention bf16 B={B} H={H} T={T} Dh={DH} "
               f"window={window} ({label}): {ms:.4f} ms per call (device "
               f"time {busy * 1e3:.4f} ms under the profiler), bound "
               f"{bound:.4f} ms ({by}), plain {plain_ms:.4f} ms, "
               f"SDPA(is_causal) "
               + (f"{lib_ms:.4f} ms" if lib_ms is not None else "-")
               + f", max|d| {err:.3e}")
        del q, k, v
        torch.cuda.empty_cache()
    for label, t, h, dh, nst in SSD_FULL:
        x, dt, A, Bm, Cm = ssd_inputs(1, t, h, dh, nst, gen, bf)
        y, n = drive_once("ssd_scan", lambda: ops.ssd_scan(
            x, dt, A, Bm, Cm, chunk=SSD_CHUNK))
        check(y.shape == x.shape and y.dtype == bf
              and bool(torch.isfinite(y).all()),
              f"ssd_scan {label}: bad output")
        want = ssd.ssd_scan_plain(x, dt, A, Bm, Cm, chunk=SSD_CHUNK)
        err, ok = within(y, want, SSD_TOL, True)
        check(ok, f"ssd_scan {label}: max|d| {err:.3e} against the plain "
                  f"version")
        del y, want
        kern = lambda: ops.ssd_scan(x, dt, A, Bm, Cm, chunk=SSD_CHUNK)  # noqa
        plain = lambda: ssd.ssd_scan_plain(  # noqa
            x, dt, A, Bm, Cm, chunk=SSD_CHUNK)
        # kernel, plain, plain, kernel: 5 calls each after one warm call
        ms_a, plain_a = cuda_ms(kern, 5, warm=1), cuda_ms(plain, 5, warm=1)
        plain_b, ms_b = cuda_ms(plain, 5, warm=1), cuda_ms(kern, 5, warm=1)
        ms, plain_ms = (ms_a + ms_b) / 2, (plain_a + plain_b) / 2
        _, busy, _ = device_split(kern)
        bound, by = ssd_bound(x, nst)
        rows["ssd", label] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound,
                                  bound_by=by, library_ms=None,
                                  max_abs_err=err, launches=n,
                                  device_ms=busy * 1e3)
        say(7, f"ssd_scan bf16 x ({label}) b=1 t={t} h={h} dh={dh} n={nst} "
               f"chunk={SSD_CHUNK}: {ms:.4f} ms per call ({ms_a:.4f}, "
               f"{ms_b:.4f}; device time {busy * 1e3:.4f} ms under the "
               f"profiler), bound {bound:.4f} ms ({by}), plain "
               f"{plain_ms:.4f} ms ({plain_a:.4f}, {plain_b:.4f}), no "
               f"single PyTorch call computes it, max|d| {err:.3e}")
        del x, dt, A, Bm, Cm
        torch.cuda.empty_cache()
    return rows


def phase_twopass_times(ctx):
    """Phase 7, row 6: the two-pass tile step at svm-ocr's tile (processor
    0's active block of phase 5d, row-strided), driven once with the
    counts set to 0 around it, then held against its plain version and
    the fused step and timed beside the fused step and the cuBLAS mat-vec
    pair."""
    import torch
    from repro_torch.kernels import dso_update, ops
    grid, loss = ctx["grid"], ctx["loss"]
    st0 = ctx["state"]
    db = grid.db
    q, b = 0, 1
    X = grid.Xg[q, :, b * db:(b + 1) * db]
    cols = slice(b * db, (b + 1) * db)
    vec = (grid.yg[q], st0.w_grid[b].clone(), st0.alpha[q].clone(),
           st0.gw_grid[b].clone(), st0.ga[q].clone(), grid.row_nnz_g[q],
           grid.col_nnz[cols], scalars(loss, ctx["lam"], ctx["m"]))
    kw = dict(loss_name=loss, reg_name="l2")
    ops.reset_launch_counts()
    got = ops.dso_tile_step(X, *vec, twopass=True, **kw)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    check(counts["dso_tile_step_twopass"] == 2
          and counts["dso_primal_update"] == 1
          and sum(counts.values()) == 3,
          f"two-pass tile step: launch counts {counts}, expected 2 passes "
          f"and one launch B")
    # the fused step as the main path runs it: the grid's tile statistics
    stats = dict(tile_row_nnz=grid.tile_row_nnz_g[q, b],
                 tile_col_nnz=grid.tile_col_nnz_g[q, 0, cols])
    plain = dso_update.dso_tile_step_twopass_plain(X, *vec, **kw)
    fused = ops.dso_tile_step(X, *vec, **kw, **stats)
    torch.cuda.synchronize()
    err, ok = compare_tile_steps(got, (plain, fused))
    check(ok, f"two-pass tile step at svm-ocr's tile: max|d| {err:.3e}")
    two = lambda: ops.dso_tile_step(X, *vec, twopass=True, **kw)  # noqa
    one = lambda: ops.dso_tile_step(X, *vec, **kw, **stats)       # noqa
    ms_a, fused_a = cuda_ms(two, 50), cuda_ms(one, 50)
    fused_b, ms_b = cuda_ms(one, 50), cuda_ms(two, 50)
    n_prof = 20
    _, busy, kern = device_split(lambda: [two() for _ in range(n_prof)])
    plain_ms = cuda_ms(lambda: dso_update.dso_tile_step_twopass_plain(
        X, *vec, **kw), 20)
    lib_ms = cuda_ms(lambda: (torch.mv(X, vec[1]), torch.mv(X.t(), vec[2])),
                     50)
    bound, by = dense_bound(grid.mb, db, 1)
    ms, fused_ms = (ms_a + ms_b) / 2, (fused_a + fused_b) / 2
    say(7, f"dso_tile_step_twopass at svm-ocr's tile ({grid.mb}x{db}, "
           f"row-strided): {ms:.4f} ms per call ({ms_a:.4f}, {ms_b:.4f}; "
           f"device time {busy / n_prof * 1e3:.4f} ms per call: "
           + ", ".join(f"{k[:40]}={us / n_prof:.1f}us" for k, us in kern[:4])
           + ") "
           f"beside the fused step {fused_ms:.4f} ms ({fused_a:.4f}, "
           f"{fused_b:.4f}); bound {bound:.4f} ms ({by}, one read of X; the "
           f"two passes read it twice), plain {plain_ms:.4f} ms, cuBLAS mv "
           f"pair {lib_ms:.4f} ms, max|d| {err:.3e}")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                library_ms=lib_ms, max_abs_err=err,
                launches=counts["dso_tile_step_twopass"],
                device_ms=busy / n_prof * 1e3)


def phase_dense_main(dev):
    """Phase 5d: svm-ocr through ``solve`` on a Problem drawn on the card:
    ``auto`` (must be ``dense_pallas_block``), then ``dense_pallas_fused``,
    each in its own launch-count window, both against ``dense_jnp``."""
    import numpy as np
    import torch
    from repro_torch.engine import make_grid_data, resolve_backend, solve
    from repro_torch.kernels import ops
    from repro_torch.sparse import density
    t0 = time.perf_counter()
    lam = 1e-4
    prob = ocr_problem(OCR_M, OCR_D, lam, seed=13, dev=dev)
    be = resolve_backend("auto", density(prob), device_type=dev.type)
    torch.cuda.synchronize()
    say("5d", f"data m={prob.m} d={prob.d} nnz={prob.nnz:.0f} density="
              f"{density(prob):.4f} X={prob.X.numel() * 4} B on the card "
              f"-> auto resolves {be.name}; set-up "
              f"{time.perf_counter() - t0:.1f} s")
    check(be.name == "dense_pallas_block",
          f"auto picked {be.name}, expected dense_pallas_block")
    kw = dict(p=P, epochs=EPOCHS, eta0=0.5, eval_every=EVAL_EVERY,
              device=dev)
    n_step = EPOCHS * P * 1          # epochs x inner iterations x row tiles
    zero = {k: 0 for k in ops.launch_counts()}
    runs = {}
    for backend, want in (
            ("auto", dict(zero, dso_block_step=n_step,
                          dso_primal_update=n_step)),
            ("dense_pallas_fused", dict(zero, dso_tile_step=n_step * P,
                                        dso_primal_update=n_step * P))):
        torch.cuda.reset_peak_memory_stats(dev)
        ops.reset_launch_counts()
        res = solve(prob, backend=backend, **kw)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated(dev)
        say("5d", f"{backend}: launch counts {counts} (design: {want})")
        check(counts == want, f"launch counts {counts} != design {want}")
        primal = [h["primal"] for h in res.history]
        say("5d", f"{backend}: primal per eval " + " ".join(
            f"e{h['epoch']}={h['primal']:.6f}" for h in res.history)
            + f"; gap at the end {res.history[-1]['gap']:.6f}")
        check(all(np.isfinite(primal)), "non-finite primal")
        check(all(b < a for a, b in zip(primal, primal[1:])),
              f"primal did not fall at every evaluation: {primal}")
        say("5d", f"{backend}: primal falls at every evaluation; "
                  f"max_memory_allocated={peak} B")
        runs[backend] = (res, counts)
    twin = solve(prob, backend="dense_jnp", **kw)
    for backend, (res, _) in runs.items():
        rel = [abs(a["primal"] - b["primal"]) / abs(b["primal"])
               for a, b in zip(res.history, twin.history)]
        say("5d", f"{backend} vs plain twin dense_jnp on the card: max rel "
                  f"primal diff {max(rel):.3e} over {len(rel)} evals")
        check(len(rel) == len(res.history) and max(rel) <= TOL,
              f"{backend} and the plain twin disagree: {rel}")

    grid = make_grid_data(prob, P, 1)
    runners = {name: epoch_runner(grid, name, loss="hinge", lam=lam,
                                  m=prob.m, alpha0=0.0)
               for name in ("dense_pallas_block", "dense_jnp")}
    for name, (fresh, run) in runners.items():
        ts = epoch_seconds(fresh, run)
        med = ts[len(ts) // 2]
        say("5d", f"run_epochs s/epoch {name}: median {med:.6f} min "
                  f"{ts[0]:.6f} max {ts[-1]:.6f} over {len(ts)} x {EPOCHS} "
                  f"epochs; X bytes/s at the median "
                  f"{prob.X.numel() * 4 / med:.4e}")
    fresh, run = runners["dense_pallas_block"]
    st = fresh()
    wall, busy, kernels = device_split(lambda: run(st, 2))
    say("5d", f"profiled run_epochs(2) of dense_pallas_block: wall "
              f"{wall:.6f} s, device busy {busy:.6f} s, idle share "
              f"{1 - busy / wall:.3f}; top kernels (us): "
              + ", ".join(f"{k[:48]}={us:.1f}" for k, us in kernels[:6]))
    return dict(grid=grid, layout="dense", loss="hinge", lam=lam, m=prob.m,
                state=runs["auto"][0].state,
                counts={k: runs["auto"][1][k] + runs["dense_pallas_fused"][1]
                        [k] for k in zero})


def dense_bound(rows, cols, procs):
    """(bound ms, bound_by) of a dense tile step: X read once, the row and
    column vectors read and written once, 4 flops per element."""
    nbytes = 4 * procs * rows * cols + 28 * procs * rows + 24 * procs * cols
    ops_n = 4 * procs * rows * cols + 20 * procs * rows + 12 * procs * cols
    by = "bytes" if nbytes / HBM_BYTES_S >= ops_n / F32_OPS_S \
        else "operations"
    return max(nbytes / HBM_BYTES_S, ops_n / F32_OPS_S) * 1e3, by


def phase_dense_times(ctx):
    """Phase 6 at the svm-ocr shape: the dense block step (row 4, p = 4
    active blocks) and the tile step on one processor's block (row 5),
    each beside its bound, its plain version and the cuBLAS mat-vecs of
    the same two products."""
    import torch
    from repro_torch.kernels import dso_update, ops
    grid, loss = ctx["grid"], ctx["loss"]
    dev = grid.yg.device
    p, mb, db = grid.p, grid.mb, grid.db
    st0 = {k: getattr(ctx["state"], k).clone()
           for k in ("w_grid", "gw_grid", "alpha", "ga")}
    blk_list = [1, 2, 3, 0]
    blk = torch.tensor(blk_list, dtype=torch.int32, device=dev)
    scal = scalars(loss, ctx["lam"], ctx["m"])
    slabs = [grid.Xg[q, :, b * db:(b + 1) * db]
             for q, b in enumerate(blk_list)]
    rows = {}

    err, ok = compare_step("dense", grid, st0, blk, scal, 1, loss, "l2")
    check(ok, f"dense block step disagrees at the svm-ocr shape: {err}")
    st = {k: v.clone() for k, v in st0.items()}
    ms = cuda_ms(lambda: run_step("dense", grid, st, blk, scal, 1, loss,
                                  "l2", plain=False), 50)
    n_prof = 20
    _, busy, kern = device_split(lambda: [run_step(
        "dense", grid, st, blk, scal, 1, loss, "l2", plain=False)
        for _ in range(n_prof)])
    st = {k: v.clone() for k, v in st0.items()}
    plain_ms = cuda_ms(lambda: run_step("dense", grid, st, blk, scal, 1,
                                        loss, "l2", plain=True), 5, warm=1)
    lib_ms = cuda_ms(lambda: [(torch.mv(x, st0["w_grid"][b]),
                               torch.mv(x.t(), st0["alpha"][q]))
                              for q, (x, b) in enumerate(zip(slabs,
                                                             blk_list))], 50)
    bound, by = dense_bound(mb, db, p)
    rows["block"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound,
                         bound_by=by, library_ms=lib_ms, max_abs_err=err,
                         device_ms=busy / n_prof * 1e3)
    say(6, f"dso_block_step: {ms:.4f} ms per call (A+B, {p} processors, "
           f"{p * mb * db * 4} B of X; device time {busy / n_prof * 1e3:.4f}"
           f" ms per call under the profiler: "
           + ", ".join(f"{k[:40]}={us / n_prof:.1f}us" for k, us in kern[:3])
           + f") bound {bound:.4f} ms ({by}) plain {plain_ms:.4f} ms "
             f"cuBLAS mv pair {lib_ms:.4f} ms max|d| {err:.3e}")

    q, b = 0, blk_list[0]
    X = slabs[q]
    cols = slice(b * db, (b + 1) * db)
    vec = (grid.yg[q], st0["w_grid"][b], st0["alpha"][q], st0["gw_grid"][b],
           st0["ga"][q], grid.row_nnz_g[q], grid.col_nnz[cols], scal)
    kw = dict(loss_name=loss, reg_name="l2",
              tile_row_nnz=grid.tile_row_nnz_g[q, b],
              tile_col_nnz=grid.tile_col_nnz_g[q, 0, cols])
    got = ops.dso_tile_step(X, *vec, **kw)
    want = dso_update.dso_tile_step_plain(X, *vec, **kw)
    torch.cuda.synchronize()
    errs = [max_rel_err(g, w) for g, w in zip(got, want)]
    t_err = max(e for e, _ in errs)
    check(all(ok for _, ok in errs),
          f"dense tile step disagrees at the svm-ocr shape: {t_err}")
    t_ms = cuda_ms(lambda: ops.dso_tile_step(X, *vec, **kw), 50)
    _, t_busy, _ = device_split(lambda: [ops.dso_tile_step(X, *vec, **kw)
                                         for _ in range(n_prof)])
    t_plain = cuda_ms(lambda: dso_update.dso_tile_step_plain(X, *vec, **kw),
                      20)
    t_lib = cuda_ms(lambda: (torch.mv(X, vec[1]), torch.mv(X.t(), vec[2])),
                    50)
    t_bound, t_by = dense_bound(mb, db, 1)
    rows["tile"] = dict(ms=t_ms, plain_ms=t_plain, bound_ms=t_bound,
                        bound_by=t_by, library_ms=t_lib, max_abs_err=t_err,
                        device_ms=t_busy / n_prof * 1e3)
    say(6, f"dso_tile_step: {t_ms:.4f} ms per call (A+B, one processor, "
           f"{mb}x{db} row-strided block; device time "
           f"{t_busy / n_prof * 1e3:.4f} ms per call) bound {t_bound:.4f} ms "
           f"({t_by}) plain {t_plain:.4f} ms cuBLAS mv pair {t_lib:.4f} ms "
           f"max|d| {t_err:.3e}")
    return rows


def packed_bytes(ctx, blk):
    """Bytes of the active tiles' packed slots read by one block step."""
    import torch
    grid = ctx["grid"]
    if ctx["layout"] == "sparse":
        return grid.p * grid.mb * grid.K * 8
    q = torch.arange(grid.p, device=blk.device)
    live = int(grid.chunk_cnt[q, blk.long()].sum())
    return live * grid.mb * 8 * 8


def phase_times(ctx):
    """Phase 6 for one main-path layout: the block-step kernel and the
    primal kernel at that shape, each beside its bound and plain version;
    the comparison at this shape gives max_abs_err."""
    import torch
    from repro_torch.kernels import dso_sparse, ops
    grid, layout, loss = ctx["grid"], ctx["layout"], ctx["loss"]
    dev = grid.yg.device
    st0 = {k: getattr(ctx["state"], k).clone()
           for k in ("w_grid", "gw_grid", "alpha", "ga")}
    blk = torch.tensor([1, 2, 3, 0], dtype=torch.int32, device=dev)
    scal = scalars(loss, ctx["lam"], ctx["m"])
    err, ok = compare_step(layout, grid, st0, blk, scal, 1, loss, "l2")
    check(ok, f"{layout} kernel disagrees at the main-path shape: {err}")
    st = {k: v.clone() for k, v in st0.items()}
    ms = cuda_ms(lambda: run_step(layout, grid, st, blk, scal, 1, loss,
                                  "l2", plain=False), 200)
    n_prof = 50
    _, busy, _ = device_split(lambda: [run_step(
        layout, grid, st, blk, scal, 1, loss, "l2", plain=False)
        for _ in range(n_prof)])
    st = {k: v.clone() for k, v in st0.items()}
    plain_ms = cuda_ms(lambda: run_step(layout, grid, st, blk, scal, 1,
                                        loss, "l2", plain=True), 20)
    p, mb, db = grid.p, grid.mb, grid.db
    slots = packed_bytes(ctx, blk) // 8
    nbytes = slots * 8 + 28 * p * mb + 24 * p * db
    ops_n = 4 * slots + 20 * p * mb + 12 * p * db
    bound = max(nbytes / HBM_BYTES_S, ops_n / F32_OPS_S) * 1e3
    name = {"sparse": "dso_sparse_block_step",
            "bucketed": "dso_bucketed_block_step"}[layout]
    step = dict(name=name, route="cuda",
                source="src/repro_torch/csrc/dso_sparse.cu",
                replaces={"sparse": "src/repro/kernels/dso_sparse.py:116",
                          "bucketed": "src/repro/kernels/dso_sparse.py:304"}
                [layout],
                launches=ctx["counts"][name], max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=bound,
                bound_by="bytes" if nbytes / HBM_BYTES_S
                >= ops_n / F32_OPS_S else "operations", library_ms=None)
    say(6, f"{name}: {ms:.4f} ms per call (A+B, {p} processors, "
           f"{slots} packed slots; device time {busy / n_prof * 1e3:.4f} ms "
           f"per call under the profiler) bound {bound:.4f} ms plain "
           f"{plain_ms:.4f} ms max|d| {err:.3e}")

    acc = torch.randn(p, db, device=dev, generator=torch.Generator(
        device=dev).manual_seed(1)) * 1e-2
    a = {k: v.clone() for k, v in st0.items()}
    b = {k: v.clone() for k, v in st0.items()}
    ops.dso_primal_update(blk, a["w_grid"], a["gw_grid"], acc.clone(),
                          grid.tile_col_nnz_g, grid.col_nnz, 0, scal,
                          reg_name="l2")
    dso_sparse.primal_update_plain(blk, b["w_grid"], b["gw_grid"],
                                   acc.clone(), grid.tile_col_nnz_g,
                                   grid.col_nnz, 0, scal, "l2")
    torch.cuda.synchronize()
    errs = [max_rel_err(a[k], b[k]) for k in ("w_grid", "gw_grid")]
    p_err, p_ok = max(e for e, _ in errs), all(ok for _, ok in errs)
    check(p_ok, f"primal kernel disagrees: {p_err}")
    acc_t = acc.clone()
    p_ms = cuda_ms(lambda: ops.dso_primal_update(
        blk, a["w_grid"], a["gw_grid"], acc_t, grid.tile_col_nnz_g,
        grid.col_nnz, 0, scal, reg_name="l2"), 200)
    p_plain = cuda_ms(lambda: dso_sparse.primal_update_plain(
        blk, b["w_grid"], b["gw_grid"], acc_t, grid.tile_col_nnz_g,
        grid.col_nnz, 0, scal, "l2"), 50)
    p_bytes = 32 * p * db
    p_bound = max(p_bytes / HBM_BYTES_S, 12 * p * db / F32_OPS_S) * 1e3
    say(6, f"dso_primal_update ({layout} shape): {p_ms:.4f} ms bound "
           f"{p_bound:.5f} ms plain {p_plain:.4f} ms max|d| {p_err:.3e}")
    primal = dict(ms=p_ms, plain_ms=p_plain, bound_ms=p_bound,
                  max_abs_err=p_err)
    return step, primal


def probe_times(dev):
    import torch
    from repro_torch.kernels import dso_sparse, ops
    cols, w = ops._probe_inputs(dev)
    err = float((ops.sparse_probe(cols, w)
                 - dso_sparse.probe_plain(cols, w)).abs().max())
    ms = cuda_ms(lambda: ops.sparse_probe(cols, w), 200)
    plain_ms = cuda_ms(lambda: dso_sparse.probe_plain(cols, w), 200)
    nbytes = cols.numel() * 4 + 2 * w.numel() * 4
    torch.cuda.synchronize()
    say(6, f"sparse_probe: {ms:.4f} ms bound "
           f"{nbytes / HBM_BYTES_S * 1e3:.2e} ms plain {plain_ms:.4f} ms")
    return dict(ms=ms, plain_ms=plain_ms, max_abs_err=err,
                bound_ms=nbytes / HBM_BYTES_S * 1e3)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs one CUDA card", file=sys.stderr)
        return 2
    from repro_torch.device import resolve_device
    from repro_torch.kernels import build

    dev = resolve_device("cuda")
    smi = smi_line()
    say(1, f"nvidia-smi: {smi}")
    say(1, f"torch {torch.__version__} cuda {torch.version.cuda} "
           f"device {torch.cuda.get_device_name(0)} "
           f"count {torch.cuda.device_count()} "
           f"python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    lib = build.library()
    say(2, f"built {lib.path} from {[f.name for f in build.sources()]} in "
           f"{lib.build_s:.2f} s")
    for line in lib.log.splitlines():
        if "registers" in line or "Compiling entry" in line or "smem" in line:
            say(2, line.strip())

    worst = phase_kernels(dev)
    say(3, f"all block-step cases within {TOL}: worst max|d| {worst:.3e}")
    worst_d = phase_dense_kernels(dev)
    say("3d", f"all dense cases within {TOL}: worst max|d| {worst_d:.3e}")
    worst_t = phase_twopass_kernels(dev)
    say("3t", f"all two-pass cases within {TOL}: worst max|d| "
              f"{worst_t:.3e}")
    worst_l = phase_lm_kernels(dev)
    say("3l", "all LM kernel cases within their bounds: worst max|d| "
              + ", ".join(f"{k} {'bf16' if bf else 'float32'} {e:.3e}"
                          for (k, bf), e in worst_l.items()))

    uni = phase_main(4, dev, loss="hinge", lam=1e-4, alpha0=0.0,
                     powerlaw=None, expect="sparse_pallas")
    buck = phase_main(5, dev, loss="logistic", lam=1e-4, alpha0=0.0005,
                      powerlaw=1.3, expect="sparse_bucketed_pallas")
    dense = phase_dense_main(dev)

    s_step, s_primal = phase_times(uni)
    b_step, b_primal = phase_times(buck)
    d_rows = phase_dense_times(dense)
    t_row = phase_twopass_times(dense)
    lm = phase_lm_full(dev)
    probe = probe_times(dev)
    primal = dict(name="dso_primal_update", route="cuda",
                  source="src/repro_torch/csrc/dso_sparse.cu",
                  replaces="src/repro/kernels/dso_sparse.py:116",
                  launches=sum(ctx["counts"]["dso_primal_update"]
                               for ctx in (uni, buck, dense)),
                  max_abs_err=max(s_primal["max_abs_err"],
                                  b_primal["max_abs_err"]),
                  ms=s_primal["ms"], plain_ms=s_primal["plain_ms"],
                  bound_ms=s_primal["bound_ms"], bound_by="bytes",
                  library_ms=None)
    say(6, f"dso_primal_update at the bucketed shape: {b_primal}")
    probe_row = dict(name="sparse_probe", route="cuda",
                     source="src/repro_torch/csrc/dso_sparse.cu",
                     replaces="src/repro/kernels/ops.py:223",
                     launches=uni["counts"]["sparse_probe"]
                     + buck["counts"]["sparse_probe"],
                     bound_by="bytes", library_ms=None, **probe)
    dense_rows = []
    for key, name, line in (("block", "dso_block_step", 354),
                            ("tile", "dso_tile_step", 314)):
        r = dict(d_rows[key])
        r.pop("device_ms")
        dense_rows.append(dict(
            name=name, route="cuda",
            source="src/repro_torch/csrc/dso_update.cu",
            replaces=f"src/repro/kernels/dso_update.py:{line}",
            launches=dense["counts"][name], **r))
    t_row.pop("device_ms")
    lm_rows = [
        dict(name="dso_tile_step_twopass", route="cuda",
             source="src/repro_torch/csrc/dso_twopass.cu",
             replaces="src/repro/kernels/dso_update.py:440", **t_row)]
    for kind, name, line, label in (
            ("swa", "swa_attention", 81, SWA_FULL[0][0]),
            ("ssd", "ssd_scan", 70, SSD_FULL[0][0])):
        r = dict(lm[kind, label])
        r.pop("device_ms")
        r["launches"] = sum(v["launches"] for (k, _), v in lm.items()
                            if k == kind)
        lm_rows.append(dict(name=name, route="cuda",
                            source=f"src/repro_torch/csrc/{name}.cu",
                            replaces=f"src/repro/kernels/{name}.py:{line}",
                            **r))
    print(json.dumps({"kernels": [s_step, b_step, primal, probe_row]
                      + dense_rows + lm_rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
