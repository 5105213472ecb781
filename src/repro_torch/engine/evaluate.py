"""Evaluation hooks for the epoch driver.

A hook is ``hook(t, w, alpha) -> dict`` called once per evaluation chunk
with the gathered (unpadded) iterates; the driver appends its dicts to the
``SolveResult`` history.

  ``problem_eval_hook``    — dense ``Problem`` objectives (primal, duality
                             gap, optionally the saddle value);
  ``pd_gap_eval_hook``     — P(w), D(alpha) and the gap P(w) - D(alpha);
  ``make_csr_primal_eval`` — out-of-core P(w): a chunked CSR matvec on the
                             device that never densifies (``index_add_``
                             into an (m+1,)-slot accumulator whose slot m
                             swallows the padding).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.losses import get_loss
from repro_torch.core.regularizers import get_regularizer
from repro_torch.core.saddle import (dual_objective, duality_gap,
                                     primal_objective, saddle_objective)
from repro_torch.device import resolve_device

#: default nnz chunk of the out-of-core evaluation (float32 + 2 x int32)
DEFAULT_CHUNK_NNZ = 1 << 20


def problem_eval_hook(prob, *, saddle: bool = True):
    """History hook computing the dense ``Problem`` objectives."""

    def hook(t, w, alpha):
        h = dict(epoch=t, primal=float(primal_objective(prob, w)),
                 gap=float(duality_gap(prob, w, alpha)))
        if saddle:
            h["saddle"] = float(saddle_objective(prob, w, alpha))
        return h

    return hook


def pd_gap_eval_hook(prob):
    """History hook reporting P(w), D(alpha) and the gap P(w) - D(alpha)."""

    def hook(t, w, alpha):
        p = float(primal_objective(prob, w))
        d = float(dual_objective(prob, alpha))
        return dict(epoch=t, primal=p, dual=d, pd_gap=p - d)

    return hook


def make_csr_primal_eval(csr, y, lam: float, loss_name: str = "hinge",
                         reg_name: str = "l2",
                         chunk_nnz: int = DEFAULT_CHUNK_NNZ, *,
                         device="cuda"):
    """Device-side P(w) evaluation hook for a ``CSRMatrix``.

    Returns ``hook(t, w, alpha) -> {"epoch", "primal"}``; the scalar
    function is ``hook.primal(w)``.  The CSR stream moves to ``device``
    once, here, cut into fixed-size nnz chunks.
    """
    dev = resolve_device(device)
    nnz = max(csr.nnz, 1)
    chunk = max(1, min(int(chunk_nnz), nnz))
    n_chunks = -(-nnz // chunk)
    pad = n_chunks * chunk - csr.nnz
    idx = np.concatenate([csr.indices.astype(np.int64),
                          np.zeros(pad, np.int64)]).reshape(n_chunks, chunk)
    rid = np.concatenate([csr.row_ids(), np.full(pad, csr.m, np.int64)]) \
        .reshape(n_chunks, chunk)
    val = np.concatenate([csr.values,
                          np.zeros(pad, np.float32)]).reshape(n_chunks, chunk)
    idx_d = torch.as_tensor(idx, device=dev)
    rid_d = torch.as_tensor(rid, device=dev)
    val_d = torch.as_tensor(val, device=dev)
    y_d = torch.as_tensor(np.asarray(y, np.float32), device=dev)
    m = csr.m
    loss = get_loss(loss_name)
    reg = get_regularizer(reg_name)
    lam_f = float(np.float32(lam))

    def primal(w) -> torch.Tensor:
        w = torch.as_tensor(w, dtype=torch.float32, device=dev)
        acc = torch.zeros(m + 1, dtype=torch.float32, device=dev)
        for c in range(n_chunks):
            acc.index_add_(0, rid_d[c], val_d[c] * w[idx_d[c]])
        u = acc[:m]
        return lam_f * torch.sum(reg.value(w)) + torch.mean(loss.value(u, y_d))

    def hook(t, w, alpha):
        return dict(epoch=t, primal=float(primal(w)))

    hook.primal = primal
    return hook
