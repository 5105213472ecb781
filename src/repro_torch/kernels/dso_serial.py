"""The paper-exact serial epoch: the CUDA kernel of ``csrc/dso_serial.cu``
and its plain PyTorch version.

Replaces no Pallas kernel: the reference runs its serial epochs as a jnp
``lax.scan`` over the nonzeros (``src/repro/engine/driver.py``
``_serial_epochs``, :669).  One epoch visits the nonzeros in ``order``;
each (i, j, x) takes the Eq.-8 step on (w_j, alpha_i), read together, with
AdaGrad when asked and the App.-B projections, in place on ``w``, ``gw``
(d,) and ``alpha``, ``ga`` (m,).  On the card the whole epoch is ONE
launch of a one-thread kernel (``launch_serial_epoch``; the source note
says why).

Arithmetic: the reference's, as its compiled scan runs it on the CPU
(the JAX package's tests run there): ``x / m`` as ``x * (1 / m)``
(``serial_inv_m``) and a fused multiply-add wherever XLA contracts one
(``fma``: each gradient's ``... - (v * x) / m``, each AdaGrad sum, each
update of w and alpha); AdaGrad's rsqrt is 1 / sqrt, each IEEE-rounded
(XLA's is within one ulp of it), and logistic's logs are float64 ones
rounded to float32 (``dual_grad``).  The kernel computes the same, so the
two agree bit for bit but for a rare double rounding.

The plain version walks the same loop in *waves*: step k joins the wave
after the latest earlier step that shares its row or its column, so the
steps of one wave touch distinct rows and distinct columns, and one
vectorised step per wave gives every coordinate the same reads and writes,
in the same order and with the same arithmetic, as the loop itself — the
loop's result bit for bit, in as many PyTorch steps as the epoch's
dependency graph is deep (hundreds, not one per nonzero).
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
_LOG_EPS = 1e-6     # logistic's alpha box, core.losses._EPS


def launch_serial_epoch(ii, jj, vv, order, w, alpha, gw, ga, y, row_nnz,
                        col_nnz, scal, loss_name: str, reg_name: str,
                        use_adagrad: bool):
    """One launch of ``serial_epoch_kernel`` on the current stream, on
    tensors ``ops.dso_serial_epoch`` has checked; ``scal`` = (eta, lam, m,
    w_lo, w_hi)."""
    _check("dso_serial_epoch", library().lib.dso_serial_epoch(
        ii.data_ptr(), jj.data_ptr(), vv.data_ptr(), order.data_ptr(),
        order.numel(), w.data_ptr(), alpha.data_ptr(), gw.data_ptr(),
        ga.data_ptr(), y.data_ptr(), row_nnz.data_ptr(), col_nnz.data_ptr(),
        *scal, LOSS_IDS[loss_name], REG_IDS[reg_name], int(use_adagrad),
        _stream(w)))


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
