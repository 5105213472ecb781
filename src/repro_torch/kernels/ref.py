"""Independent oracles for the sparse block-step kernels (tests only).

Counterparts of the reference's ``dso_sparse_block_step_ref`` and
``dso_bucketed_block_step_ref`` (``src/repro/kernels/ref.py:53``, ``:79``):
one processor, one active block, a plain Python loop of
``engine.update.sparse_tile_step`` over the row tiles — code that shares
nothing with the kernels' staged math.  Tile statistics are derived from
``vals != 0`` here.  Returns new ``(w, alpha, gw, ga)`` tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.engine.update import sparse_tile_step


def dso_sparse_block_step_ref(cols, vals, y, w, alpha, gw, ga, row_nnz,
                              col_nnz, scalars, *, row_batches: int,
                              loss_name: str, reg_name: str):
    """cols/vals (M, K) block-local; w/gw/col_nnz (db,); y/alpha/ga/row_nnz
    (M,); scalars = (eta, lam, m, w_lo, w_hi).  Trailing rows beyond
    ``row_batches * (M // row_batches)`` are left untouched."""
    eta, lam, m, w_lo, w_hi = (float(s) for s in scalars)
    M = cols.shape[0]
    rb = M // row_batches
    alpha_new, ga_new = alpha.clone(), ga.clone()
    for s in range(row_batches):
        sl = slice(s * rb, (s + 1) * rb)
        w, a_s, gw, ga_s = sparse_tile_step(
            cols=cols[sl], vals=vals[sl], y_tile=y[sl], w_blk=w,
            alpha_blk=alpha_new[sl], gw_blk=gw, ga_blk=ga_new[sl],
            row_nnz_tile=row_nnz[sl], col_nnz_blk=col_nnz, eta_t=eta,
            lam=lam, m=m, loss_name=loss_name, reg_name=reg_name,
            use_adagrad=True, w_lo=w_lo, w_hi=w_hi)
        alpha_new[sl] = a_s
        ga_new[sl] = ga_s
    return w, alpha_new, gw, ga_new


def dso_bucketed_block_step_ref(cols_fl, vals_fl, lut, cnt, y, w, alpha, gw,
                                ga, row_nnz, col_nnz, scalars, *,
                                row_batches: int, loss_name: str,
                                reg_name: str):
    """Reassemble the tile's (M, cnt * K_CHUNK) rectangle from its flat
    chunks (cols_fl/vals_fl (n_chunks, M, K_CHUNK), lut (n_kc,), cnt ())
    at the exact bucket width and delegate to the uniform oracle."""
    lut = np.asarray(lut.cpu() if isinstance(lut, torch.Tensor) else lut)
    n = int(cnt)
    c = torch.cat([cols_fl[int(lut[j])] for j in range(n)], dim=1)
    v = torch.cat([vals_fl[int(lut[j])] for j in range(n)], dim=1)
    return dso_sparse_block_step_ref(
        c, v, y, w, alpha, gw, ga, row_nnz, col_nnz, scalars,
        row_batches=row_batches, loss_name=loss_name, reg_name=reg_name)
