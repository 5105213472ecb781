"""The epochs of two Sec.-5 baselines: the CUDA kernels of
``csrc/baselines.cu`` and their plain PyTorch versions.

Replace no Pallas kernel: the reference runs these epochs as jitted
``lax.scan``s (``src/repro/baselines/sgd.py:25`` ``_sgd_epoch``, which
PSGD vmaps over its workers, and ``src/repro/baselines/dcd.py:22``
``_dcd_epoch``).  On the card each epoch is ONE launch
(``launch_sgd_epoch``, ``launch_dcd_epoch``; the source note says why).

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

import numpy as np
import torch

from repro_torch.core.losses import get_loss
from repro_torch.core.regularizers import get_regularizer
from repro_torch.kernels.build import check as _check
from repro_torch.kernels.build import library
from repro_torch.kernels.build import stream as _stream
from repro_torch.kernels.dso_update import LOSS_IDS, REG_IDS

_ADA_EPS = 1e-8


def dcd_scalars(lam: float, m: int) -> tuple[float, float, float]:
    """(lam, m, scale = 1 / (2 lam m)), each rounded to float32 as the
    reference's traced float32 computes them (dcd.py:24)."""
    lam32, m32 = np.float32(lam), np.float32(m)
    scale = np.float32(1.0) / (np.float32(2.0) * lam32 * m32)
    return float(lam32), float(m32), float(scale)


def launch_sgd_epoch(X, y, rows, w, acc, eta0: float, lam: float,
                     loss_name: str, reg_name: str, batch: int):
    """One launch of ``sgd_epoch_kernel`` (one block per worker) on the
    current stream, on tensors ``ops.sgd_epoch`` has checked."""
    n_workers, n_rows = rows.shape
    _check("sgd_epoch", library().lib.sgd_epoch(
        X.data_ptr(), X.stride(0), y.data_ptr(), rows.data_ptr(), n_workers,
        n_rows, w.data_ptr(), acc.data_ptr(), w.shape[1], batch, eta0, lam,
        LOSS_IDS[loss_name], REG_IDS[reg_name], _stream(w)))


def launch_dcd_epoch(X, y, perm, w, beta, lam: float, xnorm2):
    """One launch of ``dcd_epoch_kernel`` (one block) on the current
    stream, on tensors ``ops.dcd_epoch`` has checked."""
    lam32, m32, scale = dcd_scalars(lam, X.shape[0])
    _check("dcd_epoch", library().lib.dcd_epoch(
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
