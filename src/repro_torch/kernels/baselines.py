"""The epochs of two Sec.-5 baselines: the CUDA kernels of
``csrc/baselines.cu`` and their plain PyTorch versions.

Replace no Pallas kernel: the reference runs these epochs as jitted
``lax.scan``s (``src/repro/baselines/sgd.py:25`` ``_sgd_epoch``, which
PSGD vmaps over its workers, and ``src/repro/baselines/dcd.py:22``
``_dcd_epoch``).  On the card each epoch is ONE launch
(``launch_sgd_epoch``, ``launch_dcd_epoch``; the source note says why):
each worker a thread-block cluster of ``plan.cluster`` blocks, each block
a slice of ``plan.width`` columns, the margins' partial sums exchanged
through the cluster's shared memory once per step.  ``epoch_plan`` is the
host plan that picks the cluster and the slices; ``kernels/ops.py``'s
``sgd_epoch_route`` and ``dcd_epoch_route`` call it with the card's
limits.  The one-block kernels, the design before the clusters, stay
reachable as
``launch_sgd_epoch_one_block`` and ``launch_dcd_epoch_one_block``, for
``chip_smoke.py``'s A/B only.

``sgd_epoch_plain`` and ``dcd_epoch_plain`` are the reference's step
loops, step for step, in torch: the CPU tests hold them against the
reference and ``chip_smoke.py`` holds the kernels against them.  Both
update their state in place, as the kernels do.

Arithmetic, the kernels' too: every dot product (a margin, a column of
X_b^T lg) is summed in float64 and rounded once to float32, the loss
gradient is taken in float64 from the float32 margin and rounded, and
every other operation is one float32 operation in the reference's order,
AdaGrad's rsqrt as 1 / sqrt.  So kernel and plain version agree bit for
bit, whatever order each sums in (but for a double-rounding tie), and an
l1 ``sign(w)`` near 0 cannot part them; against the reference's float32
sums they stay within 1e-5 (``tests/test_torch_baselines.py``).

Rows: an SGD epoch takes, per worker, the row ids it visits in order
(``rows``, (n_workers, nsteps * batch) int32); -1 marks a padding row,
whose x and y are 0 (PSGD's last shard), so PSGD never copies X.
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

# csrc/baselines.cu's constants
CLUSTER_THREADS = 512       # threads per block of the cluster kernels
MAX_CLUSTER = 16            # blocks per cluster (non-portable past 8)
RING = 3                    # stages of X's rows in shared memory
CHUNK_ROWS = 512            # row ids per refill of the id buffer
# a block takes at least two columns per thread: narrower d, fewer blocks
MIN_WIDTH = 2 * CLUSTER_THREADS


class EpochPlan(NamedTuple):
    """How an epoch kernel splits a worker's d columns: ``cluster`` blocks
    (one thread-block cluster), block r owning the columns
    ``[r * width, min(d, (r + 1) * width))``; ``staged``: w (SGD: and acc)
    and a ring of X's rows in shared memory, else all in global memory;
    ``smem``: dynamic shared bytes per block."""

    cluster: int
    width: int
    staged: bool
    smem: int


def chunk_steps(batch: int) -> int:
    """Steps per chunk of row ids the kernels buffer (``chunk_steps`` in
    the source)."""
    return max(4, CHUNK_ROWS // batch)


def _align16(n: int) -> int:
    return (n + 15) // 16 * 16


def epoch_smem(kind: str, batch: int, width: int, staged: bool) -> int:
    """Dynamic shared bytes per block of the SGD (``kind`` "sgd") or DCD
    ("dcd", batch 1) cluster kernel: ``layout`` in the source."""
    if kind == "dcd":
        batch = 1
    warps = CLUSTER_THREADS // 32
    info = 3 * chunk_steps(batch) * batch
    n = 16 + _align16(16 * batch * MAX_CLUSTER) + _align16(8 * warps * batch)
    if kind == "sgd":
        n += _align16(4 * warps * batch)
    n += _align16(4 * info) * (2 if kind == "sgd" else 3)
    if staged:
        n += _align16(4 * width) * (2 if kind == "sgd" else 1)
        n += _align16(4 * RING * batch * width)
    return n


def slice_width(d: int, cluster: int) -> int:
    """Columns per slice when ``cluster`` blocks split d: ceil(d / C)
    rounded up to even, so every slice starts at an even column."""
    w = -(-d // cluster)
    return w + (w & 1)


def epoch_plan(kind: str, d: int, batch: int = 1, *, smem_limit: int,
               max_cluster: int, cluster: int | None = None) -> EpochPlan:
    """The plan of one worker's epoch on a card whose blocks may take
    ``smem_limit`` bytes of shared memory and whose largest schedulable
    cluster is ``max_cluster`` blocks.

    The cluster: ``ceil(d / MIN_WIDTH)`` blocks (at least 1, at most
    ``min(16, max_cluster)``), or ``cluster`` when given (an A/B); fewer
    when that many slices would leave one empty.  Staged when w (and
    acc) and the ring fit ``smem_limit`` at some cluster up to the
    largest; else the global body at the largest.  Raises ``ValueError``
    when no plan fits: there is no quieter fallback."""
    if kind not in ("sgd", "dcd"):
        raise ValueError(f"kind must be 'sgd' or 'dcd', got {kind!r}")
    if d < 1 or batch < 1:
        raise ValueError(f"need d >= 1 and batch >= 1, got d {d}, batch "
                         f"{batch}")
    cmax = min(MAX_CLUSTER, int(max_cluster))
    if cmax < 1:
        raise ValueError("the card cannot hold a cluster of the epoch "
                         "kernels")
    if cluster is not None:
        if not 1 <= cluster <= cmax:
            raise ValueError(f"cluster {cluster} is not in 1 .. {cmax}")
        tries = [cluster]
    else:
        tries = range(min(cmax, -(-d // MIN_WIDTH)), cmax + 1)
    for c in tries:
        width = slice_width(d, c)
        smem = epoch_smem(kind, batch, width, True)
        if smem <= smem_limit:
            return EpochPlan(-(-d // width), width, True, smem)
    c = tries[-1]
    width = slice_width(d, c)
    smem = epoch_smem(kind, batch, width, False)
    if smem > smem_limit:
        raise ValueError(f"{kind} epoch at batch {batch}: {smem} bytes of "
                         f"shared memory per block, past the card's "
                         f"{smem_limit}")
    return EpochPlan(-(-d // width), width, False, smem)


def max_cluster() -> int:
    """The largest cluster of the epoch kernels the current card can hold
    at its opt-in shared memory (the C entry ``baselines_max_cluster``,
    which asks ``cudaOccupancyMaxActiveClusters``)."""
    c = ctypes.c_int(0)
    _check("baselines_max_cluster",
           library().lib.baselines_max_cluster(ctypes.byref(c)))
    return c.value


def kernel_smem(kind: str, batch: int, width: int, staged: bool) -> int:
    """The C entry's own count of ``epoch_smem`` (chip_smoke holds the two
    equal)."""
    n = ctypes.c_int(0)
    _check("baselines_smem", library().lib.baselines_smem(
        0 if kind == "sgd" else 1, batch, width, int(staged),
        ctypes.byref(n)))
    return n.value


def launch_exchange_floor(cluster: int, n_clusters: int, nsteps: int, out):
    """One launch of the exchange alone (``exchange_floor_kernel``, batch
    1): ``n_clusters`` clusters of ``cluster`` blocks, ``nsteps`` steps, on
    ``out``'s stream (float32, one per block)."""
    _check("baselines_exchange_floor",
           library().lib.baselines_exchange_floor(
               cluster, n_clusters, nsteps, out.data_ptr(), _stream(out)))


def dcd_scalars(lam: float, m: int) -> tuple[float, float, float]:
    """(lam, m, scale = 1 / (2 lam m)), each rounded to float32 as the
    reference's traced float32 computes them (dcd.py:24)."""
    lam32, m32 = np.float32(lam), np.float32(m)
    scale = np.float32(1.0) / (np.float32(2.0) * lam32 * m32)
    return float(lam32), float(m32), float(scale)


def launch_sgd_epoch(X, y, rows, w, acc, eta0: float, lam: float,
                     loss_name: str, reg_name: str, batch: int, *,
                     plan: EpochPlan):
    """One launch of ``sgd_cluster_kernel`` (one cluster per worker, as
    ``plan`` splits d) on the current stream, on tensors ``ops.sgd_epoch``
    has checked."""
    n_workers, n_rows = rows.shape
    _check("sgd_epoch", library().lib.sgd_epoch(
        X.data_ptr(), X.stride(0), y.data_ptr(), rows.data_ptr(), n_workers,
        n_rows, w.data_ptr(), acc.data_ptr(), w.shape[1], batch, eta0, lam,
        LOSS_IDS[loss_name], REG_IDS[reg_name], plan.cluster, plan.width,
        int(plan.staged), _stream(w)))


def launch_dcd_epoch(X, y, perm, w, beta, lam: float, xnorm2, *,
                     plan: EpochPlan):
    """One launch of ``dcd_cluster_kernel`` (one cluster, as ``plan``
    splits d) on the current stream, on tensors ``ops.dcd_epoch`` has
    checked."""
    lam32, m32, scale = dcd_scalars(lam, X.shape[0])
    _check("dcd_epoch", library().lib.dcd_epoch(
        X.data_ptr(), X.stride(0), y.data_ptr(), perm.data_ptr(),
        perm.numel(), w.data_ptr(), beta.data_ptr(), xnorm2.data_ptr(),
        w.numel(), lam32, m32, scale, plan.cluster, plan.width,
        int(plan.staged), _stream(w)))


def launch_sgd_epoch_one_block(X, y, rows, w, acc, eta0: float, lam: float,
                               loss_name: str, reg_name: str, batch: int):
    """The one-block kernel, 1,024 threads per worker: the A/B's
    baseline (no wrapper launches it)."""
    n_workers, n_rows = rows.shape
    _check("sgd_epoch_one_block", library().lib.sgd_epoch_one_block(
        X.data_ptr(), X.stride(0), y.data_ptr(), rows.data_ptr(), n_workers,
        n_rows, w.data_ptr(), acc.data_ptr(), w.shape[1], batch, eta0, lam,
        LOSS_IDS[loss_name], REG_IDS[reg_name], _stream(w)))


def launch_dcd_epoch_one_block(X, y, perm, w, beta, lam: float, xnorm2):
    """The one-block DCD kernel: the A/B's baseline."""
    lam32, m32, scale = dcd_scalars(lam, X.shape[0])
    _check("dcd_epoch_one_block", library().lib.dcd_epoch_one_block(
        X.data_ptr(), X.stride(0), y.data_ptr(), perm.data_ptr(),
        perm.numel(), w.data_ptr(), beta.data_ptr(), xnorm2.data_ptr(),
        w.numel(), lam32, m32, scale, _stream(w)))


def sgd_epoch_plain(X, y, rows, w, acc, eta0: float, lam: float,
                    loss_name: str, reg_name: str, batch: int):
    """Plain version of the SGD epoch kernel, in place on ``w``, ``acc``
    (n_workers, d): the reference's scan body (sgd.py:30-39) once per step,
    all workers at once (the reference's vmap)."""
    loss, reg = get_loss(loss_name), get_regularizer(reg_name)
    valid = rows >= 0
    safe = rows.clamp(min=0).long()
    for s in range(rows.shape[1] // batch):
        cut = slice(s * batch, (s + 1) * batch)
        ok = valid[:, cut]
        Xb = torch.where(ok[..., None], X[safe[:, cut]], 0.0).double()
        yb = torch.where(ok, y[safe[:, cut]], 0.0)
        u = torch.bmm(Xb, w.double()[..., None])[..., 0].float()
        lg = loss.grad(u.double(), yb.double())
        xs = torch.bmm(Xb.transpose(1, 2), lg.float().double()[..., None])
        g = lam * reg.grad(w) + xs[..., 0].float() / batch
        acc.add_(g * g)
        w.sub_(eta0 * g * torch.sqrt(acc + _ADA_EPS).reciprocal())


def dcd_epoch_plain(X, y, perm, w, beta, lam: float, xnorm2):
    """Plain version of the DCD epoch kernel, in place on ``w`` (d,) and
    ``beta`` (m,): the reference's scan body (dcd.py:27-35) once per
    step."""
    lam32, m32, scale = dcd_scalars(lam, X.shape[0])
    for i in perm.tolist():
        xi, yi = X[i], y[i]
        g = 1.0 - yi * torch.dot(w.double(), xi.double()).float()
        step = g * 2.0 * lam32 * m32 / torch.clamp(xnorm2[i], min=1e-12)
        b_old = beta[i].clone()
        b_new = torch.clamp(b_old + step, 0.0, 1.0)
        w.add_((b_new - b_old) * yi * scale * xi)
        beta[i] = b_new
