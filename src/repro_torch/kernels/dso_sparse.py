"""Sparse DSO block step: the CUDA kernels of ``csrc/dso_sparse.cu`` and
their plain PyTorch versions.

Replaces the reference's Pallas kernels ``dso_sparse_block_step_pallas``
(``src/repro/kernels/dso_sparse.py:94``, pallas_call :116) and
``dso_bucketed_block_step_pallas`` (:247, pallas_call :304).  The source
note in ``csrc/dso_sparse.cu`` says what bounds them on the card (bytes:
the packed tile is streamed once) and how the design splits the step into
a dual/scatter launch and a primal launch per row tile.

Every function here is *batched over the p processors* of one inner
iteration: processor q runs its active block ``blk_ids[q]``, reading its
tile in place from the grid and writing its alpha/ga slice and the
``w_grid``/``gw_grid`` row ``blk_ids[q]`` in place (the reference donates
this state; the port updates it where it lies).  ``blk_ids`` must be a
permutation, so the blocks are disjoint (Lemma 2).

The plain versions (``*_plain``) run the reference's exact staged math:
both mat-vecs read the pre-update (w, alpha) of each row tile; rows past
``(mb // row_batches) * row_batches`` pass through unchanged.  The
``launch_*`` functions launch one CUDA kernel each on the current stream
and raise when ``cudaGetLastError`` reports a refused launch; ``ops``
checks shapes, types and devices before calling them.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import check as _check
from repro_torch.kernels.build import library
from repro_torch.kernels.build import stream as _stream
from repro_torch.kernels.dso_update import (LOSS_IDS, REG_IDS, _dual_update,
                                            _primal_update,
                                            active_block_stats)


# Launch A of the K-bucketed step has three routes, two kernels:
#   "shared": each CTA sums X^T alpha for its rows in a db-wide float32
#             accumulator in shared memory, then adds each nonzero entry to
#             acc[q] with one global atomic (hot columns meet in shared
#             atomics, contended only inside one SM);
#   "hot":    the same kernel for blocks past the shared budget: each CTA
#             sums the block's hottest columns (``hot_table``) in shared
#             memory and every other column by a global atomic;
#   "global": one global atomic per nonzero into acc[q], for any db;
#             ``bucketed_route`` never picks it (the hot route's baseline).
_BUCKETED_ENTRIES = {"shared": "dso_bucketed_dual_scatter_shared",
                     "hot": "dso_bucketed_dual_scatter_hot",
                     "global": "dso_bucketed_dual_scatter"}
BUCKETED_ROUTES = tuple(_BUCKETED_ENTRIES)
# The hot route's slots per CTA: the float32 sums that fit the SM's shared
# memory split this many ways (the C entry ``dso_bucketed_hot_slots``:
# 11,417 on an H100; its kernel runs 2 CTAs per SM, as its registers
# allow).  Every slot is zeroed and read once per CTA, so fewer cost less
# until too many columns go to global atomics; chosen by measurement
# (``chip_smoke.py`` phase 6 times shares 1 to 8 at news20's shape: 5 to 8
# are level, 5 keeps the most slots).
HOT_SMEM_SHARE = 5


def bucketed_route(db: int, smem_limit: int) -> str:
    """The route of the bucketed launch A for column blocks of ``db``
    columns on a card whose CTAs may take ``smem_limit`` bytes of shared
    memory: ``"shared"`` when the db float32 sums fit, else ``"hot"``."""
    return "shared" if 4 * db <= smem_limit else "hot"


def hot_table(col_nnz, p: int, db: int, slots: int):
    """The hot route's table for a grid of p blocks of ``db`` columns whose
    column counts are ``col_nnz`` (p * db,), on col_nnz's device: ``hot``
    (p, db) int32 maps column c of block b to its slot in [0, h) when c is
    among block b's h = min(slots, db) columns of largest count (ties to
    the lower column index), else to -1; ``hot_cols`` (p, h) int32 is slot
    -> column, hottest first.  Derived state: the grid's layout arrays are
    not touched."""
    h = min(int(slots), db)
    order = torch.sort(col_nnz.reshape(p, db), dim=1, descending=True,
                       stable=True).indices[:, :h]
    hot = torch.full((p, db), -1, dtype=torch.int32, device=col_nnz.device)
    hot.scatter_(1, order, torch.arange(h, dtype=torch.int32,
                                        device=col_nnz.device).expand(p, h))
    return hot, order.to(torch.int32).contiguous()


def hot_slots(share: int = HOT_SMEM_SHARE) -> tuple[int, int]:
    """The hot route's slots per CTA on the current card with the SM's
    shared memory split ``share`` (1 to 8) ways, and the CTAs per SM its
    kernel then reaches (registers included), from the C entry
    ``dso_bucketed_hot_slots``."""
    n, got = ctypes.c_int(0), ctypes.c_int(0)
    _check("dso_bucketed_hot_slots", library().lib.dso_bucketed_hot_slots(
        int(share), ctypes.byref(n), ctypes.byref(got)))
    return n.value, got.value


def _ptr(t: torch.Tensor) -> int:
    return t.data_ptr()


# ------------------------------------------------------------- launches --


def launch_sparse_dual_scatter(cols_g, vals_g, blk_ids, yg, w_grid, alpha,
                               ga, trn_g, rn_g, acc, r0: int, rb: int,
                               eta: float, m: float, loss_name: str):
    """Launch A on the uniform grid for rows [r0, r0 + rb) of every
    processor."""
    p, _, mb, K = cols_g.shape
    db = w_grid.shape[1]
    _check("dso_sparse_dual_scatter", library().lib.dso_sparse_dual_scatter(
        _ptr(cols_g), _ptr(vals_g), _ptr(blk_ids), _ptr(yg), _ptr(w_grid),
        _ptr(alpha), _ptr(ga), _ptr(trn_g), _ptr(rn_g), _ptr(acc),
        p, mb, K, db, r0, rb, eta, m, LOSS_IDS[loss_name], _stream(acc)))


def launch_bucketed_dual_scatter(cols_fl, vals_fl, lut, cnt, blk_ids, yg,
                                 w_grid, alpha, ga, trn_g, rn_g, acc,
                                 r0: int, rb: int, eta: float, m: float,
                                 loss_name: str, *, route: str, hot=None):
    """Launch A on the flat chunk view for rows [r0, r0 + rb), by the
    kernel of ``route`` (``BUCKETED_ROUTES``); the hot route takes the
    grid's ``hot_table`` as ``hot``."""
    if route not in _BUCKETED_ENTRIES:
        raise ValueError(f"no bucketed route {route!r}; the routes are "
                         f"{BUCKETED_ROUTES}")
    if (route == "hot") != (hot is not None):
        raise ValueError("the hot route, and only it, takes a hot table")
    p, n_chunks, mb, _ = cols_fl.shape
    n_kc = lut.shape[2]
    db = w_grid.shape[1]
    entry = _BUCKETED_ENTRIES[route]
    extra = ()
    if hot is not None:
        table, cols = hot
        if tuple(table.shape) != (p, db) or cols.dim() != 2 \
                or cols.shape[0] != p or table.dtype != torch.int32 \
                or cols.dtype != torch.int32:
            raise ValueError(f"hot table must be int32 ({p}, {db}) and "
                             f"({p}, slots), got {tuple(table.shape)} and "
                             f"{tuple(cols.shape)}")
        extra = (_ptr(table), _ptr(cols), cols.shape[1])
    _check(entry, getattr(library().lib, entry)(
        _ptr(cols_fl), _ptr(vals_fl), _ptr(lut), _ptr(cnt), _ptr(blk_ids),
        _ptr(yg), _ptr(w_grid), _ptr(alpha), _ptr(ga), _ptr(trn_g),
        _ptr(rn_g), _ptr(acc), p, mb, n_chunks, n_kc, db, r0, rb, eta, m,
        LOSS_IDS[loss_name], *extra, _stream(acc)))


def launch_primal_update(blk_ids, w_grid, gw_grid, acc, tcn_g, col_nnz,
                         s: int, scal, reg_name: str):
    """Launch B: primal step of row tile ``s`` for every processor; zeroes
    ``acc``."""
    p, db = w_grid.shape
    n_rb = tcn_g.shape[1]
    eta, lam, m, w_lo, w_hi = scal
    _check("dso_primal_update", library().lib.dso_primal_update(
        _ptr(blk_ids), _ptr(w_grid), _ptr(gw_grid), _ptr(acc), _ptr(tcn_g),
        _ptr(col_nnz), p, db, n_rb, s, eta, lam, m, w_lo, w_hi,
        REG_IDS[reg_name], _stream(acc)))


def launch_probe(cols, w, out):
    """The capability probe: gather w[cols] and scatter-add it into
    ``out`` (zeroed by the kernel)."""
    _check("dso_sparse_probe", library().lib.dso_sparse_probe(
        _ptr(cols), _ptr(w), _ptr(out), cols.numel(), w.numel(),
        _stream(out)))


# -------------------------------------------------------- plain versions --


def probe_plain(cols, w):
    """Plain version of the probe kernel."""
    idx = cols.reshape(-1).long()
    return torch.zeros_like(w).index_add_(0, idx, w[idx])


def primal_update_plain(blk_ids, w_grid, gw_grid, acc, tcn_g, col_nnz,
                        s: int, scal, reg_name: str):
    """Plain version of launch B (in place on w_grid, gw_grid, acc)."""
    p, db = w_grid.shape
    b = blk_ids.long()
    qi = torch.arange(p, device=w_grid.device)
    tcn = tcn_g[:, s].reshape(p, p, db)[qi, b]
    cn = col_nnz.reshape(p, db)[b]
    w_new, gw_new = _primal_update(reg_name, w_grid[b], gw_grid[b], acc,
                                   tcn, cn, scal)
    w_grid[b] = w_new
    gw_grid[b] = gw_new
    acc.zero_()


def _block_step_plain(cols, vals, b, yg, w_grid, alpha, gw_grid, ga, trn_g,
                      tcn_g, rn_g, col_nnz, scal, *, row_batches: int,
                      loss_name: str, reg_name: str):
    """All ``row_batches`` sequential tile steps of every processor's
    active block, given its staged (p, mb, K) ``cols``/``vals``."""
    p, mb = yg.shape
    K = cols.shape[2]
    rb = mb // row_batches
    w, gw = w_grid[b], gw_grid[b]                        # (p, db) copies
    cn, trn, tcn = active_block_stats(trn_g, tcn_g, col_nnz, b)
    for s in range(row_batches):
        sl = slice(s * rb, (s + 1) * rb)
        c = cols[:, sl].reshape(p, rb * K).long()
        v = vals[:, sl]
        a = alpha[:, sl]
        xw = (v * torch.gather(w, 1, c).reshape(p, rb, K)).sum(dim=-1)
        a_new, ga_new = _dual_update(loss_name, a, ga[:, sl], yg[:, sl], xw,
                                     trn[:, sl], rn_g[:, sl], scal)
        acc = torch.zeros_like(w).scatter_add_(
            1, c, (v * a[..., None]).reshape(p, rb * K))
        w, gw = _primal_update(reg_name, w, gw, acc, tcn[:, s], cn, scal)
        alpha[:, sl] = a_new
        ga[:, sl] = ga_new
    w_grid[b] = w
    gw_grid[b] = gw


def dso_sparse_block_step_plain(cols_g, vals_g, blk_ids, yg, w_grid, alpha,
                                gw_grid, ga, trn_g, tcn_g, rn_g, col_nnz,
                                scal, *, row_batches: int, loss_name: str,
                                reg_name: str):
    """Plain version of the uniform-grid block step (in place).

    cols_g/vals_g (p, p, mb, K); blk_ids (p,) int32; yg/alpha/ga/rn_g
    (p, mb); w_grid/gw_grid (p, db); trn_g (p, p, mb); tcn_g
    (p, n_rb, p * db); col_nnz (p * db,); ``scal`` = (eta, lam, m, w_lo,
    w_hi) Python floats.
    """
    b = blk_ids.long()
    qi = torch.arange(cols_g.shape[0], device=cols_g.device)
    _block_step_plain(cols_g[qi, b], vals_g[qi, b], b, yg, w_grid, alpha,
                      gw_grid, ga, trn_g, tcn_g, rn_g, col_nnz, scal,
                      row_batches=row_batches, loss_name=loss_name,
                      reg_name=reg_name)


def stage_bucketed(cols_fl, vals_fl, lut, cnt, b):
    """Each processor's active tile from the flat chunk view as a (p, mb,
    n_kc * K_CHUNK) rectangle; chunk slots past the tile's live count are
    zeroed (col 0, val 0.0: exact no-ops), as the reference stages them."""
    p, _, mb, kc = cols_fl.shape
    qi = torch.arange(p, device=cols_fl.device)
    lut_b = lut[qi, b].long()                            # (p, n_kc)
    n_kc = lut_b.shape[1]
    live = (torch.arange(n_kc, device=cols_fl.device)[None]
            < cnt[qi, b][:, None])[..., None, None]      # (p, n_kc, 1, 1)
    c = torch.where(live, cols_fl[qi[:, None], lut_b], 0)
    v = torch.where(live, vals_fl[qi[:, None], lut_b], 0.0)
    return (c.permute(0, 2, 1, 3).reshape(p, mb, n_kc * kc),
            v.permute(0, 2, 1, 3).reshape(p, mb, n_kc * kc))


def dso_bucketed_block_step_plain(cols_fl, vals_fl, lut, cnt, blk_ids, yg,
                                  w_grid, alpha, gw_grid, ga, trn_g, tcn_g,
                                  rn_g, col_nnz, scal, *, row_batches: int,
                                  loss_name: str, reg_name: str):
    """Plain version of the bucketed block step (in place), the counterpart
    of the reference's ``dso_bucketed_block_step_jnp``
    (``src/repro/kernels/dso_sparse.py:325``): stage the chunks through the
    tile's lut, then the same staged math.  cols_fl/vals_fl
    (p, n_chunks, mb, K_CHUNK); lut (p, p, n_kc); cnt (p, p); the rest as
    in ``dso_sparse_block_step_plain``."""
    b = blk_ids.long()
    cols, vals = stage_bucketed(cols_fl, vals_fl, lut, cnt, b)
    _block_step_plain(cols, vals, b, yg, w_grid, alpha, gw_grid, ga, trn_g,
                      tcn_g, rn_g, col_nnz, scal, row_batches=row_batches,
                      loss_name=loss_name, reg_name=reg_name)
