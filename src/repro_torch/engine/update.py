"""The Eq.-(8) saddle-point tile update.

``block_tile_step`` is the dense form of the reference's tile step (two
mat-vecs), ``sparse_tile_step`` the gather form on a packed block-ELL tile;
``eq8_apply`` is their shared tail (AdaGrad scaling, step, App.-B
projections).  All take any number of leading batch dimensions, so the
``dense_jnp`` and ``sparse_jnp`` backends run all p processors of an inner
iteration in one call, and the oracles of ``kernels/ref.py`` run one
processor at a time.  Scalars are Python floats.
"""

from __future__ import annotations

import torch

from repro_torch.core.losses import get_loss
from repro_torch.core.regularizers import get_regularizer


def eq8_apply(loss, w_blk, alpha_blk, gw_blk, ga_blk, y_tile, g_w, g_a,
              eta_t, use_adagrad, w_lo, w_hi):
    """Shared Eq.-(8) update tail: AdaGrad scaling, step, App. B
    projection.  Returns new (w, alpha, gw, ga) tensors."""
    if use_adagrad:
        gw_blk = gw_blk + g_w * g_w
        ga_blk = ga_blk + g_a * g_a
        dw = eta_t * g_w * torch.rsqrt(gw_blk + 1e-8)
        da = eta_t * g_a * torch.rsqrt(ga_blk + 1e-8)
    else:
        dw, da = eta_t * g_w, eta_t * g_a
    w_blk = torch.clamp(w_blk - dw, w_lo, w_hi)
    alpha_blk = loss.project_alpha(alpha_blk + da, y_tile)
    return w_blk, alpha_blk, gw_blk, ga_blk


def block_tile_step(*, X_tile, y_tile, w_blk, alpha_blk, gw_blk, ga_blk,
                    row_nnz_tile, col_nnz_blk, eta_t, lam, m,
                    loss_name: str, reg_name: str, use_adagrad: bool,
                    w_lo, w_hi, tile_row_nnz=None, tile_col_nnz=None):
    """One Jacobi tile step on a dense tile ``X_tile`` (..., rows, db); w
    vectors (..., db), row vectors (..., rows).  Both mat-vecs read the
    pre-update (w, alpha).  The tile statistics default to being derived
    from ``X_tile != 0``."""
    loss = get_loss(loss_name)
    reg = get_regularizer(reg_name)
    if tile_row_nnz is None or tile_col_nnz is None:
        nz = (X_tile != 0).to(X_tile.dtype)
        tile_col_nnz = nz.sum(dim=-2)
        tile_row_nnz = nz.sum(dim=-1)
    xta = (alpha_blk.unsqueeze(-2) @ X_tile).squeeze(-2)
    xw = (X_tile @ w_blk.unsqueeze(-1)).squeeze(-1)
    g_w = lam * reg.grad(w_blk) * tile_col_nnz / col_nnz_blk - xta / m
    g_a = (-loss.dual_grad(alpha_blk, y_tile) * tile_row_nnz
           / (m * row_nnz_tile)
           - xw / m)
    return eq8_apply(loss, w_blk, alpha_blk, gw_blk, ga_blk, y_tile,
                     g_w, g_a, eta_t, use_adagrad, w_lo, w_hi)


def sparse_tile_step(*, cols, vals, y_tile, w_blk, alpha_blk, gw_blk, ga_blk,
                     row_nnz_tile, col_nnz_blk, eta_t, lam, m,
                     loss_name: str, reg_name: str, use_adagrad: bool,
                     w_lo, w_hi, tile_row_nnz=None, tile_col_nnz=None):
    """One Jacobi tile step on a packed block-ELL tile.

    ``cols``/``vals`` (..., rows, K) with block-local column indices; w
    vectors (..., db); row vectors (..., rows).  Both mat-vecs read the
    pre-update (w, alpha):

        X w       -> sum_k vals[i, k] * w[cols[i, k]]          (gather)
        X^T alpha -> scatter-add of vals[i, k] * alpha[i]      (segment sum)

    Padding slots (val 0 at col 0) add exact zeros.  The tile statistics
    default to being derived from ``vals != 0`` (oracle use).
    """
    loss = get_loss(loss_name)
    reg = get_regularizer(reg_name)
    flat_c = cols.flatten(-2).long()
    if tile_row_nnz is None:
        tile_row_nnz = (vals != 0).to(vals.dtype).sum(dim=-1)
    if tile_col_nnz is None:
        tile_col_nnz = torch.zeros_like(w_blk).scatter_add_(
            -1, flat_c, (vals != 0).to(vals.dtype).flatten(-2))
    xw = (vals * torch.gather(w_blk, -1, flat_c).reshape(vals.shape)) \
        .sum(dim=-1)
    xta = torch.zeros_like(w_blk).scatter_add_(
        -1, flat_c, (vals * alpha_blk[..., None]).flatten(-2))
    g_w = lam * reg.grad(w_blk) * tile_col_nnz / col_nnz_blk - xta / m
    g_a = (-loss.dual_grad(alpha_blk, y_tile) * tile_row_nnz
           / (m * row_nnz_tile)
           - xw / m)
    return eq8_apply(loss, w_blk, alpha_blk, gw_blk, ga_blk, y_tile,
                     g_w, g_a, eta_t, use_adagrad, w_lo, w_hi)
