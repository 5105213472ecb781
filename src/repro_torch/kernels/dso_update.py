"""The dense DSO tile step: the launch of the CUDA kernel of
``csrc/dso_update.cu``, its plain PyTorch versions, and the Eq.-(8) update
tail that every kernel's plain version shares (the torch counterpart of
the reference's ``kernels/dso_update.py``).

    g_w = lam * phi'(w) * n_j / |Omega-bar_j| - X^T alpha / m      (primal)
    g_a = -l*'(-alpha) * n_i / (m |Omega_i|)  - X w / m            (dual)

then AdaGrad-scale, step, and project (App. B).  The CUDA kernels write
the same arithmetic in the same order of operations.  Scalars arrive as
Python floats (float32 values); tensors are float32 on any device.

Replaces the reference's Pallas kernels ``dso_block_step_pallas``
(``src/repro/kernels/dso_update.py:354``) and ``dso_tile_step_pallas``
(:314), both through the pallas_call of ``_fused_call`` (:274).  On the
card both are the dense launch A (one Jacobi tile step's two mat-vecs and
the dual step, X read once) followed by the shared launch B
(``csrc/dso_sparse.cu`` ``primal_update_kernel``) once per row tile; the
note in ``csrc/dso_update.cu`` gives the design.

Also replaces the legacy two-pass tile step ``dso_tile_step_pallas_twopass``
(:440; pallas_calls :460 and :484): on the card a primal pass (X^T alpha and
the column counts, ``csrc/dso_twopass.cu``), launch B fed those counts, and
a dual pass (X w, the row counts and the dual step), each pass reading all
of X.

The plain versions:

  ``dso_block_step_plain`` — all ``row_batches`` sequential row tiles of
      every processor's active block, each a Jacobi step on the current w,
      batched over the p processors and in place, like the sparse plain
      versions; rows past ``(mb // row_batches) * row_batches`` pass
      through unchanged.
  ``dso_tile_step_plain`` — one Jacobi step over a whole (M, D) X,
      returning new (w, alpha, gw, ga).
  ``dso_tile_step_twopass_plain`` — the same step as the two passes
      compute it: each derives its nonzero counts from X itself.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.build import check, library, stream

LOSS_IDS = {"hinge": 0, "logistic": 1, "square": 2}
REG_IDS = {"l2": 0, "l1": 1}
_ADA_EPS = 1e-8


def _reg_grad(reg_name: str, w):
    if reg_name == "l2":
        return 2.0 * w
    if reg_name == "l1":
        return torch.sign(w)
    raise ValueError(reg_name)


def _dual_grad(loss_name: str, a, y):
    if loss_name == "hinge":
        return -y
    if loss_name == "logistic":
        b = torch.clamp(y * a, 1e-6, 1.0 - 1e-6)
        return y * (torch.log(b) - torch.log1p(-b))
    if loss_name == "square":
        return a - y
    raise ValueError(loss_name)


def _project_alpha(loss_name: str, a, y):
    if loss_name == "hinge":
        return y * torch.clamp(y * a, 0.0, 1.0)
    if loss_name == "logistic":
        return y * torch.clamp(y * a, 1e-6, 1.0 - 1e-6)
    return a


def _primal_update(reg_name: str, w, gw, acc, tcn, cn, scal):
    """Eq. (8) primal side + AdaGrad + App. B box projection.
    ``scal`` = (eta, lam, m, w_lo, w_hi)."""
    eta, lam, m, w_lo, w_hi = scal
    g_w = lam * _reg_grad(reg_name, w) * tcn / cn - acc / m
    gw_new = gw + g_w * g_w
    dw = eta * g_w * torch.rsqrt(gw_new + _ADA_EPS)
    return torch.clamp(w - dw, w_lo, w_hi), gw_new


def _dual_update(loss_name: str, a, ga, y, acc, trn, rn, scal):
    """Eq. (8) dual side + AdaGrad + App. B domain projection."""
    eta, m = scal[0], scal[2]
    g_a = -_dual_grad(loss_name, a, y) * trn / (m * rn) - acc / m
    ga_new = ga + g_a * g_a
    da = eta * g_a * torch.rsqrt(ga_new + _ADA_EPS)
    return _project_alpha(loss_name, a + da, y), ga_new


def active_block_stats(trn_g, tcn_g, col_nnz, b):
    """The active blocks' statistics for processors q = 0..p-1 with
    blocks ``b`` (int64): |Omega-bar_j| (p, db), the tile row counts
    (p, mb) and the per-row-batch tile column counts (p, n_rb, db)."""
    p = trn_g.shape[0]
    db = col_nnz.shape[0] // p
    qi = torch.arange(p, device=trn_g.device)
    return (col_nnz.reshape(p, db)[b], trn_g[qi, b],
            tcn_g.reshape(p, tcn_g.shape[1], p, db)[qi, :, b])


def active_slab(Xg, b, rows: slice):
    """Rows ``rows`` of every processor's active block of the dense grid
    ``Xg`` (p, mb, d_pad): a (p, rows, db) copy, processor q's block
    ``b[q]`` (int64)."""
    p, mb, d_pad = Xg.shape
    qi = torch.arange(p, device=Xg.device)
    return Xg.reshape(p, mb, p, d_pad // p)[qi, rows, b]


# ------------------------------------------------------------- launch --


def launch_dense_dual_scatter(X, ld: int, proc_stride: int, blk_ids, yg,
                              w_grid, alpha, ga, trn_g, rn_g, acc, r0: int,
                              rb: int, eta: float, m: float, loss_name: str):
    """Launch A on the dense layout for rows [r0, r0 + rb) of every
    processor: row i of processor q starts ``q * proc_stride + i * ld``
    floats past ``X``'s first element, its active block ``blk_ids[q] *
    db`` floats further.  Vectors (p, mb), ``trn_g`` (p, p, mb), ``acc``
    (p, db)."""
    p, mb = yg.shape
    db = w_grid.shape[1]
    check("dso_dense_dual_scatter", library().lib.dso_dense_dual_scatter(
        X.data_ptr(), ld, proc_stride, blk_ids.data_ptr(), yg.data_ptr(),
        w_grid.data_ptr(), alpha.data_ptr(), ga.data_ptr(), trn_g.data_ptr(),
        rn_g.data_ptr(), acc.data_ptr(), p, mb, db, r0, rb, eta, m,
        LOSS_IDS[loss_name], stream(acc)))


def twopass_route(X) -> str:
    """The kernels the two-pass step runs for X (M, D) (unit column
    stride), as ``dso_twopass.cu``'s entry points choose them: ``"span"``
    (whole row spans in 16-byte loads; row stride a multiple of 4 floats
    and 0 < D <= 381) or ``"rows"`` (4-byte loads, any stride); ``"plain"``
    for a tensor off the card, which takes the plain version."""
    if not X.is_cuda:
        return "plain"
    span = library().lib.dso_twopass_route(X.data_ptr(), X.stride(0),
                                           X.shape[1])
    return "span" if span else "rows"


def launch_twopass_primal(X, alpha, acc, cnt):
    """The two-pass step's primal pass over X (M, D) (unit column stride,
    row stride ``X.stride(0)``): adds X^T alpha into ``acc`` (D,) and the
    column nonzero counts into ``cnt`` (D,), both zero on entry."""
    M, D = X.shape
    check("dso_twopass_primal", library().lib.dso_twopass_primal(
        X.data_ptr(), X.stride(0), M, D, alpha.data_ptr(), acc.data_ptr(),
        cnt.data_ptr(), stream(acc)))


def launch_twopass_dual(X, w, alpha, alpha_out, ga, ga_out, y, row_nnz,
                        eta: float, m: float, loss_name: str):
    """The two-pass step's dual pass: X w from the input ``w`` and the row
    counts, then the dual step of every row from the input ``alpha`` and
    ``ga`` into ``alpha_out`` and ``ga_out``, which it writes in full."""
    M, D = X.shape
    check("dso_twopass_dual", library().lib.dso_twopass_dual(
        X.data_ptr(), X.stride(0), M, D, w.data_ptr(), alpha.data_ptr(),
        alpha_out.data_ptr(), ga.data_ptr(), ga_out.data_ptr(), y.data_ptr(),
        row_nnz.data_ptr(), eta, m, LOSS_IDS[loss_name], stream(ga_out)))


# ------------------------------------------------------ plain versions --


def _tile_math(X, y, w, a, gw, ga, trn, rn, tcn, cn, scal, loss_name: str,
               reg_name: str):
    """One Jacobi tile step on X (..., rows, db), any leading batch dims;
    both mat-vecs read the pre-update (w, a)."""
    xw = (X @ w.unsqueeze(-1)).squeeze(-1)
    xta = (a.unsqueeze(-2) @ X).squeeze(-2)
    a_new, ga_new = _dual_update(loss_name, a, ga, y, xw, trn, rn, scal)
    w_new, gw_new = _primal_update(reg_name, w, gw, xta, tcn, cn, scal)
    return w_new, a_new, gw_new, ga_new


def dso_block_step_plain(Xg, blk_ids, yg, w_grid, alpha, gw_grid, ga, trn_g,
                         tcn_g, rn_g, col_nnz, scal, *, row_batches: int,
                         loss_name: str, reg_name: str):
    """Plain version of the dense block step (in place).

    Xg (p, mb, p * db); blk_ids (p,) int32; yg/alpha/ga/rn_g (p, mb);
    w_grid/gw_grid (p, db); trn_g (p, p, mb); tcn_g (p, n_rb, p * db);
    col_nnz (p * db,); ``scal`` = (eta, lam, m, w_lo, w_hi) Python floats.
    """
    p, mb = yg.shape
    rb = mb // row_batches
    b = blk_ids.long()
    w, gw = w_grid[b], gw_grid[b]                        # (p, db) copies
    cn, trn, tcn = active_block_stats(trn_g, tcn_g, col_nnz, b)
    for s in range(row_batches):
        sl = slice(s * rb, (s + 1) * rb)
        w, a_new, gw, ga_new = _tile_math(
            active_slab(Xg, b, sl), yg[:, sl], w, alpha[:, sl], gw, ga[:, sl],
            trn[:, sl], rn_g[:, sl], tcn[:, s], cn, scal, loss_name,
            reg_name)
        alpha[:, sl] = a_new
        ga[:, sl] = ga_new
    w_grid[b] = w
    gw_grid[b] = gw


def dso_tile_step_plain(X, y, w, alpha, gw, ga, row_nnz, col_nnz, scal, *,
                        loss_name: str, reg_name: str, tile_row_nnz,
                        tile_col_nnz):
    """Plain version of one dense tile step over the whole X (M, D):
    y/alpha/ga/row_nnz/tile_row_nnz (M,), w/gw/col_nnz/tile_col_nnz (D,).
    Returns new (w, alpha, gw, ga)."""
    return _tile_math(X, y, w, alpha, gw, ga, tile_row_nnz, row_nnz,
                      tile_col_nnz, col_nnz, scal, loss_name, reg_name)


def dso_tile_step_twopass_plain(X, y, w, alpha, gw, ga, row_nnz, col_nnz,
                                scal, *, loss_name: str, reg_name: str):
    """Plain version of the legacy two-pass tile step over X (M, D): the
    primal pass (X^T alpha, column counts, primal step) and the dual pass
    (X w, row counts, dual step), both from the pre-update (w, alpha):
    the fused step's arithmetic with the counts taken from X.  Returns new
    (w, alpha, gw, ga)."""
    nz = (X != 0).to(X.dtype)
    return _tile_math(X, y, w, alpha, gw, ga, nz.sum(dim=1), row_nnz,
                      nz.sum(dim=0), col_nnz, scal, loss_name, reg_name)
