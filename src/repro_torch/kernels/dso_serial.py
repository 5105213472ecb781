"""The paper-exact serial epoch: the CUDA kernels of ``csrc/dso_serial.cu``
and their plain PyTorch version.

Replaces no Pallas kernel: the reference runs its serial epochs as a jnp
``lax.scan`` over the nonzeros (``src/repro/engine/driver.py``
``_serial_epochs``, :669).  One epoch visits the nonzeros in ``order``;
each (i, j, x) takes the Eq.-8 step on (w_j, alpha_i), read together, with
AdaGrad when asked and the App.-B projections, in place on ``w``, ``gw``
(d,) and ``alpha``, ``ga`` (m,).  On the card the whole epoch is ONE
launch of ``serial_rounds_kernel`` (``launch_serial_epoch``): one block
(the state in shared memory) or one thread-block cluster (the state in
global memory) that takes the order in windows of ``plan.window`` steps
and runs each window in dependency rounds (``serial_rounds`` is the CPU
model of its schedule); ``serial_plan`` picks the window, the threads,
the cluster and where the state sits.  The one-thread kernel, the design before,
stays reachable as ``launch_serial_epoch_one_thread``, for
``chip_smoke.py``'s A/B only.

Arithmetic: the reference's, as its compiled scan runs it on the CPU
(the JAX package's tests run there): ``x / m`` as ``x * (1 / m)``
(``serial_inv_m``) and a fused multiply-add wherever XLA contracts one
(``fma``: each gradient's ``... - (v * x) / m``, each AdaGrad sum, each
update of w and alpha); AdaGrad's rsqrt is 1 / sqrt, each IEEE-rounded
(XLA's is within one ulp of it), and logistic's logs are float64 ones
rounded to float32 (``dual_grad``).  The kernels compute the same, so
they agree with this version bit for bit but for a rare double rounding.

The plain version walks the same loop in *waves*: step k joins the wave
after the latest earlier step that shares its row or its column, so the
steps of one wave touch distinct rows and distinct columns, and one
vectorised step per wave gives every coordinate the same reads and writes,
in the same order and with the same arithmetic, as the loop itself — the
loop's result bit for bit, in as many PyTorch steps as the epoch's
dependency graph is deep (hundreds, not one per nonzero).  The kernel's
rounds are the same argument window by window.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.losses import get_loss
from repro_torch.core.regularizers import get_regularizer
from repro_torch.kernels.build import check as _check
from repro_torch.kernels.build import library
from repro_torch.kernels.build import stream as _stream
from repro_torch.kernels.dso_update import LOSS_IDS, REG_IDS

_ADA_EPS = 1e-8
_LOG_EPS = 1e-6     # logistic's alpha box, core.losses._EPS


# csrc/dso_serial.cu's constants
SLOTS = (1, 2, 4, 8, 16)        # steps per thread of a window (S)
MAX_CLUSTER = 16                # blocks of the global kernel's cluster


def max_threads(slots: int) -> int:
    """Most threads a block of ``serial_rounds_kernel<S>`` may have
    (``rounds_max_threads`` in the source)."""
    return 1024 if slots <= 4 else 4096 // slots


class SerialPlan(NamedTuple):
    """How ``serial_rounds_kernel`` walks an epoch: ``cluster`` blocks of
    ``threads`` threads, ``slots`` steps per thread, so windows of
    ``window`` = slots x threads x cluster steps; ``staged``: one block,
    the state and the tags in its shared memory, else a thread-block
    cluster with both in global memory; ``smem``: dynamic shared bytes per
    block."""

    window: int
    threads: int
    slots: int
    cluster: int
    staged: bool
    smem: int


# The plan's choices (threads, slots[, cluster]), the fastest of chip_smoke
# phase 3s's sweep on an H100 (PERF.md §6): staged, one block of 1,024
# threads, 2 steps each; global, a cluster of (up to) 16 such blocks.
STAGED_PLAN = (1024, 2)
GLOBAL_PLAN = (1024, 2, MAX_CLUSTER)


def serial_smem(m: int, d: int, slots: int, threads: int,
                staged: bool) -> int:
    """Dynamic shared bytes of a block (``rounds_smem`` in the source):
    the queue of a round's ready steps (12 bytes per slot) and its two
    counters; staged, also the m + d tags, w, gw and the column counts (d
    floats) and alpha, ga, y and the row counts (m floats)."""
    n = 12 * slots * threads + 16
    if staged:
        n += 4 * (m + d) + 4 * (3 * d + 4 * m)
    return n


def serial_scratch(m: int, d: int) -> int:
    """Bytes of the global kernel's scratch (``rounds_scratch``): a
    16-byte record per row and per column, the m + d tags, two round
    counters."""
    return 20 * (m + d) + 16


def serial_plan(m: int, d: int, nnz: int, *, smem_limit: int,
                max_cluster: int, threads: int | None = None,
                slots: int | None = None, cluster: int | None = None,
                staged: bool | None = None) -> SerialPlan:
    """The plan of one serial epoch over nnz nonzeros of an (m, d) problem
    on a card whose block may take ``smem_limit`` bytes of shared memory
    and whose largest cluster of the global kernel is ``max_cluster``:
    staged (``STAGED_PLAN``) when the state, the tags and the queue fit
    ``smem_limit``, else global (``GLOBAL_PLAN``, the cluster cut to
    ``max_cluster``).  ``threads``, ``slots``, ``cluster`` and ``staged``
    override the choice (an A/B).  Raises ``ValueError`` on what no kernel
    takes or the card cannot hold."""
    if m < 0 or d < 0 or nnz < 0:
        raise ValueError(f"need m, d, nnz >= 0, got {m}, {d}, {nnz}")
    if staged is None:
        staged = serial_smem(m, d, STAGED_PLAN[1], STAGED_PLAN[0],
                             True) <= smem_limit
    t0, s0, c0 = (*STAGED_PLAN, 1) if staged else GLOBAL_PLAN
    threads = t0 if threads is None else int(threads)
    slots = s0 if slots is None else int(slots)
    cluster = min(c0, max_cluster) if cluster is None else int(cluster)
    if slots not in SLOTS or threads < 32 or threads % 32 \
            or threads > max_threads(slots):
        raise ValueError(f"no serial kernel takes {slots} steps on each of "
                         f"{threads} threads")
    if not 1 <= cluster <= min(MAX_CLUSTER, max_cluster) \
            or (staged and cluster != 1):
        raise ValueError(f"no serial kernel takes a cluster of {cluster} "
                         f"({'staged' if staged else 'global'}; the card's "
                         f"largest is {max_cluster})")
    smem = serial_smem(m, d, slots, threads, staged)
    if smem > smem_limit:
        raise ValueError(f"the serial epoch needs {smem} bytes of shared "
                         f"memory per block, past the card's {smem_limit}")
    return SerialPlan(slots * threads * cluster, threads, slots, cluster,
                      staged, smem)


def kernel_smem(m: int, d: int, slots: int, threads: int,
                staged: bool) -> int:
    """The C entry's own count of ``serial_smem`` (chip_smoke holds the two
    equal)."""
    n = ctypes.c_int(0)
    _check("dso_serial_smem", library().lib.dso_serial_smem(
        m, d, slots, threads, int(staged), ctypes.byref(n)))
    return n.value


def max_cluster(slots: int = GLOBAL_PLAN[1],
                threads: int = GLOBAL_PLAN[0]) -> int:
    """The largest cluster of the global kernel at (slots, threads) the
    current card can hold (the C entry ``dso_serial_max_cluster``, which
    asks ``cudaOccupancyMaxActiveClusters``)."""
    c = ctypes.c_int(0)
    _check("dso_serial_max_cluster", library().lib.dso_serial_max_cluster(
        slots, threads, ctypes.byref(c)))
    return c.value


def launch_serial_epoch(ii, jj, vv, order, w, alpha, gw, ga, y, row_nnz,
                        col_nnz, scal, loss_name: str, reg_name: str,
                        use_adagrad: bool, *, plan: SerialPlan,
                        rounds=None):
    """One launch of ``serial_rounds_kernel`` on the current stream, on
    tensors ``ops.dso_serial_epoch`` has checked; ``scal`` = (eta, lam, m,
    w_lo, w_hi).  Off the staged plan the state, the tags and the round
    counters live in a scratch of ``serial_scratch(m, d)`` bytes allocated
    here.  ``rounds`` (an int32 tensor of one, on the card) receives the
    rounds the epoch took."""
    m, d = alpha.numel(), w.numel()
    scratch = None if plan.staged else torch.empty(
        serial_scratch(m, d), dtype=torch.uint8, device=w.device)
    _check("dso_serial_epoch", library().lib.dso_serial_epoch(
        ii.data_ptr(), jj.data_ptr(), vv.data_ptr(), order.data_ptr(),
        order.numel(), w.data_ptr(), alpha.data_ptr(), gw.data_ptr(),
        ga.data_ptr(), y.data_ptr(), row_nnz.data_ptr(), col_nnz.data_ptr(),
        m, d, None if scratch is None else scratch.data_ptr(),
        0 if scratch is None else scratch.numel(),
        None if rounds is None else rounds.data_ptr(),
        *scal, LOSS_IDS[loss_name], REG_IDS[reg_name], int(use_adagrad),
        plan.threads, plan.slots, plan.cluster, int(plan.staged),
        _stream(w)))


def launch_serial_epoch_one_thread(ii, jj, vv, order, w, alpha, gw, ga, y,
                                   row_nnz, col_nnz, scal, loss_name: str,
                                   reg_name: str, use_adagrad: bool):
    """One launch of the one-thread ``serial_epoch_kernel`` (the design
    before the rounds), as ``launch_serial_epoch``'s; for the A/B only."""
    _check("dso_serial_epoch_one_thread",
           library().lib.dso_serial_epoch_one_thread(
               ii.data_ptr(), jj.data_ptr(), vv.data_ptr(),
               order.data_ptr(), order.numel(), w.data_ptr(),
               alpha.data_ptr(), gw.data_ptr(), ga.data_ptr(), y.data_ptr(),
               row_nnz.data_ptr(), col_nnz.data_ptr(), *scal,
               LOSS_IDS[loss_name], REG_IDS[reg_name], int(use_adagrad),
               _stream(w)))


def launch_step_latency(nsteps: int, operands, scal, loss_name: str,
                        reg_name: str, use_adagrad: bool, out):
    """One launch of ``step_latency_kernel``: ``nsteps`` Eq.-8 steps
    chained on one thread, from and into ``out`` (4 float32 on the card:
    w_j, alpha_i, gw_j, ga_i); ``operands`` = (x, y_i, rn_i, cn_j)."""
    _check("dso_serial_step_latency",
           library().lib.dso_serial_step_latency(
               nsteps, *operands, *scal, LOSS_IDS[loss_name],
               REG_IDS[reg_name], int(use_adagrad), out.data_ptr(),
               _stream(out)))


def serial_inv_m(m: float) -> float:
    """float32(1 / m): the serial step divides by m as a multiplication by
    this reciprocal, which is what the reference's compiled scan computes
    (its m is a compile-time constant there, and XLA's CPU compiler turns
    ``x / m`` into ``x * (1 / m)``)."""
    return float(np.float32(1.0) / np.float32(m))


def fma(a, b, c):
    """``a * b + c`` rounded once to float32, elementwise: a fused
    multiply-add (the float64 product of float32 values is exact).  ``b``
    may be a Python float holding a float32 value."""
    b = b.double() if isinstance(b, torch.Tensor) else b
    return (a.double() * b + c.double()).float()


def dual_grad(loss_name: str, a, y):
    """The loss's ``dual_grad`` with logistic's log and log1p taken in
    float64 and rounded to float32 — correctly rounded but for a rare
    tie, on the CPU and on the card alike, so the kernel and this plain
    version agree bit for bit (float32 logs differ by an ulp between
    libraries)."""
    if loss_name != "logistic":
        return get_loss(loss_name).dual_grad(a, y)
    b = torch.clamp(y * a, _LOG_EPS, 1.0 - _LOG_EPS).double()
    return y * (torch.log(b).float() - torch.log1p(-b).float())


def serial_waves(rows, cols, m: int, d: int) -> list[int]:
    """The wave of each step of a visit sequence whose k-th step touches
    row ``rows[k]`` and column ``cols[k]``: one more than the latest wave
    of an earlier step on the same row or column.  The number of waves is
    the depth of the epoch's dependency graph."""
    last_row, last_col = [-1] * m, [-1] * d
    waves = []
    for i, j in zip(rows, cols):
        wave = max(last_row[i], last_col[j]) + 1
        last_row[i] = last_col[j] = wave
        waves.append(wave)
    return waves


def serial_rounds(rows, cols, window: int) -> list[int]:
    """The round of each step that ``serial_rounds_kernel`` gives a visit
    sequence whose k-th step touches row ``rows[k]`` and column
    ``cols[k]``, in windows of ``window`` steps: within a window, one more
    than the latest round of an earlier step of the window on the same
    row or column; each window's rounds follow the last of the window
    before.  With ``window >= len(rows)`` these are ``serial_waves``."""
    if window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    rounds, base = [], 0
    for start in range(0, len(rows), window):
        last_row, last_col, top = {}, {}, -1
        for i, j in zip(rows[start:start + window],
                        cols[start:start + window]):
            r = max(last_row.get(i, -1), last_col.get(j, -1)) + 1
            last_row[i] = last_col[j] = r
            top = max(top, r)
            rounds.append(base + r)
        base += top + 1
    return rounds


def serial_epoch_plain(ii, jj, vv, order, w, alpha, gw, ga, y, row_nnz,
                       col_nnz, scal, loss_name: str, reg_name: str,
                       use_adagrad: bool):
    """Plain version of the serial epoch kernel, in place, one vectorised
    Eq.-8 step per wave (``serial_waves``)."""
    eta, lam, m, w_lo, w_hi = scal
    inv_m = serial_inv_m(m)
    loss, reg = get_loss(loss_name), get_regularizer(reg_name)
    steps = order.long()
    rows, cols, vals = ii.long()[steps], jj.long()[steps], vv[steps]
    waves = torch.tensor(serial_waves(rows.tolist(), cols.tolist(),
                                      alpha.numel(), w.numel()),
                         dtype=torch.long)
    by_wave = torch.argsort(waves, stable=True).to(rows.device)
    sizes = torch.bincount(waves).tolist() if waves.numel() else []
    for sel in torch.split(by_wave, sizes):
        i, j, x = rows[sel], cols[sel], vals[sel]
        wj, ai, yi = w[j], alpha[i], y[i]
        # Eq. (8), simultaneous read of (w_j, alpha_i) — the Lemma 2 form
        g_w = fma(-(ai * x), inv_m, lam * reg.grad(wj) / col_nnz[j])
        g_a = fma(-(wj * x), inv_m,
                  -dual_grad(loss_name, ai, yi) / (m * row_nnz[i]))
        if use_adagrad:
            gw_i = fma(g_w, g_w, gw[j])
            ga_i = fma(g_a, g_a, ga[i])
            w_new = fma(-(eta * g_w), torch.rsqrt(gw_i + _ADA_EPS), wj)
            a_new = fma(eta * g_a, torch.rsqrt(ga_i + _ADA_EPS), ai)
            gw[j] = gw_i
            ga[i] = ga_i
        else:
            w_new, a_new = fma(g_w, -eta, wj), fma(g_a, eta, ai)
        # App. B projections, applied to the touched coordinates
        w[j] = torch.clamp(w_new, w_lo, w_hi)
        alpha[i] = loss.project_alpha(a_new, yi)
