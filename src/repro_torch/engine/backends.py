"""TileBackend registry: one ``block_step`` contract, nine implementations.

A backend pairs a *layout* (dense row shards "dense", uniform block-ELL
"sparse" or K-bucketed "bucketed") with a *kernel*.  Its ``block_step(meta,
data, state, blk_ids, eta_t, row_batches)`` runs all ``row_batches``
sequential tile steps of every processor's active block ``blk_ids[q]`` and
updates ``state`` IN PLACE (the w_grid/gw_grid rows ``blk_ids`` and all of
alpha/ga).

The registry keeps the reference's names, which snapshot configs record:
``*_jnp`` is the plain PyTorch twin and ``*_pallas*`` the hand-written CUDA
kernel (``csrc/*.cu`` through ``kernels/ops.py``; on CPU tensors the
wrapper runs the kernel's plain version).

  dense_jnp              — mat-vec tile steps (engine/update.py
                           ``block_tile_step``), all processors batched
  dense_pallas_block     — the dense block-step CUDA kernel
                           (``ops.dso_block_step``): launch A + B per row
                           tile, all p processors in each launch
  dense_pallas_fused     — one ``ops.dso_tile_step`` call per processor
                           and row batch (the reference's ``force_scan``
                           path), so 2 * p launches per row tile
  sparse_jnp             — gather/scatter tile steps (engine/update.py
                           ``sparse_tile_step``) on block-ELL tiles
  sparse_pallas          — the sparse block-step CUDA kernel
  sparse_bucketed_jnp    — the flat-chunk staging + staged math in plain
                           PyTorch (kernels/dso_sparse.py)
  sparse_bucketed_pallas — the bucketed block-step CUDA kernel
  sparse_bucketed_jnp_switch / sparse_bucketed_pallas_switch
                         — the legacy bucket dispatch (the reference's
                           ``lax.switch``): each processor's active tile
                           is looked up in the (p, p) bucket maps and its
                           (mb, K_k) bucket rectangle stepped by
                           ``sparse_jnp`` / ``sparse_pallas`` at p = 1, so
                           the CUDA switch makes one block-ELL launch per
                           processor and row tile, ``p * p * row_batches``
                           per epoch (the one-kernel pair: ``p *
                           row_batches``).  Kept for parity, not speed.

``TileBackend.payload`` ("flat" | "buckets") names the bucketed payload a
backend reads; the driver passes it to ``as_tile_data``.

``TileBackend.clamp_step``, where set, is the block step for a state that
may hold w outside its box: the CUDA sparse steps leave a column their
row tile does not hold as it was, where the plain step clamps every
column, so the driver runs a state entering with w outside the box
(``solve(init=)``, a rollback) through ``clamp_step`` for its first epoch
(launch A, then launch B on every column), and ``block_step`` after.

``auto`` keeps the reference's layout rules (``SPARSE_DENSITY_THRESHOLD``,
``BUCKET_SKEW_THRESHOLD``) and then, unlike the reference (which always
picks jnp), picks the layout's kernel backend when the data lives on a
CUDA device and the plain twin on the CPU; it never picks a switch.
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple

import torch

from repro_torch.engine.data import DSOState, TileData
from repro_torch.engine.update import block_tile_step, sparse_tile_step
from repro_torch.kernels import dso_sparse, ops
from repro_torch.kernels.dso_update import active_block_stats, active_slab
from repro_torch.sparse.format import (BUCKET_SKEW_THRESHOLD,
                                       SPARSE_DENSITY_THRESHOLD)


class TileBackend(NamedTuple):
    name: str
    layout: str             # "dense" | "sparse" | "bucketed"
    block_step: Callable    # see module docstring
    payload: str = "flat"   # bucketed payload: "flat" | "buckets"
    clamp_step: Callable | None = None   # see module docstring


def _needs_adagrad(meta, name):
    if not meta[4]:
        raise NotImplementedError(
            f"{name} implements the AdaGrad step; use sparse_jnp for "
            f"use_adagrad=False")


def _stats_args(data, state):
    return (data.yg, state.w_grid, state.alpha, state.gw_grid, state.ga,
            data.tile_row_nnz_g, data.tile_col_nnz_g, data.row_nnz_g,
            data.col_nnz)


def _dense_tile(arrays, b, sl):
    (Xg,) = arrays
    return dict(X_tile=active_slab(Xg, b, sl))


def _sparse_tile(arrays, b, sl):
    cols_g, vals_g = arrays
    qi = torch.arange(b.numel(), device=b.device)
    return dict(cols=cols_g[qi, b, sl], vals=vals_g[qi, b, sl])


def _make_jnp_block_step(slice_tile, tile_step):
    """The plain backends' shared row-batch loop: slice every processor's
    active tile of each row batch (``slice_tile`` yields the layout's
    payload kwargs), run the layout's batched tile step, write alpha/ga
    back in place, then the w/gw blocks."""

    def block_step(meta, data, state, blk_ids, eta_t, row_batches):
        lam, m, loss_name, reg_name, use_adagrad, w_lo, w_hi = meta
        rb = data.yg.shape[1] // row_batches
        b = blk_ids.long()
        cn, trn, tcn = active_block_stats(
            data.tile_row_nnz_g, data.tile_col_nnz_g, data.col_nnz, b)
        w, gw = state.w_grid[b], state.gw_grid[b]
        for s in range(row_batches):
            sl = slice(s * rb, (s + 1) * rb)
            w, a_s, gw, ga_s = tile_step(
                **slice_tile(data.arrays, b, sl), y_tile=data.yg[:, sl],
                w_blk=w, alpha_blk=state.alpha[:, sl], gw_blk=gw,
                ga_blk=state.ga[:, sl], row_nnz_tile=data.row_nnz_g[:, sl],
                col_nnz_blk=cn, eta_t=eta_t, lam=lam, m=m,
                loss_name=loss_name, reg_name=reg_name,
                use_adagrad=use_adagrad, w_lo=w_lo, w_hi=w_hi,
                tile_row_nnz=trn[:, sl], tile_col_nnz=tcn[:, s])
            state.alpha[:, sl] = a_s
            state.ga[:, sl] = ga_s
        state.w_grid[b] = w
        state.gw_grid[b] = gw

    return block_step


def _dense_pallas_block_step(meta, data, state, blk_ids, eta_t,
                             row_batches):
    lam, m, loss_name, reg_name, _, w_lo, w_hi = meta
    _needs_adagrad(meta, "the dense CUDA kernel")
    ops.dso_block_step(
        data.arrays[0], blk_ids, *_stats_args(data, state),
        (eta_t, lam, m, w_lo, w_hi), row_batches=row_batches,
        loss_name=loss_name, reg_name=reg_name)


def _dense_pallas_fused_block_step(meta, data, state, blk_ids, eta_t,
                                   row_batches):
    """One ``ops.dso_tile_step`` per processor and row batch, on views of
    the grid (the block ids come to the host once per inner iteration)."""
    lam, m, loss_name, reg_name, _, w_lo, w_hi = meta
    _needs_adagrad(meta, "the dense CUDA kernel")
    (Xg,) = data.arrays
    p, mb = data.yg.shape
    db = data.col_nnz.shape[0] // p
    rb = mb // row_batches
    scal = (eta_t, lam, m, w_lo, w_hi)
    for q, b in enumerate(blk_ids.tolist()):
        cols = slice(b * db, (b + 1) * db)
        w, gw = state.w_grid[b], state.gw_grid[b]
        for s in range(row_batches):
            sl = slice(s * rb, (s + 1) * rb)
            w, a_s, gw, ga_s = ops.dso_tile_step(
                Xg[q, sl, cols], data.yg[q, sl], w, state.alpha[q, sl], gw,
                state.ga[q, sl], data.row_nnz_g[q, sl], data.col_nnz[cols],
                scal, loss_name=loss_name, reg_name=reg_name,
                tile_row_nnz=data.tile_row_nnz_g[q, b, sl],
                tile_col_nnz=data.tile_col_nnz_g[q, s, cols])
            state.alpha[q, sl] = a_s
            state.ga[q, sl] = ga_s
        state.w_grid[b] = w
        state.gw_grid[b] = gw


def _sparse_pallas_block_step(meta, data, state, blk_ids, eta_t,
                              row_batches, every_column=False):
    lam, m, loss_name, reg_name, _, w_lo, w_hi = meta
    _needs_adagrad(meta, "the sparse CUDA kernel")
    cols_g, vals_g = data.arrays
    ops.dso_sparse_block_step(
        cols_g, vals_g, blk_ids, *_stats_args(data, state),
        (eta_t, lam, m, w_lo, w_hi), row_batches=row_batches,
        loss_name=loss_name, reg_name=reg_name, every_column=every_column)


def _clamping(step):
    """``step`` with launch B on every column (``clamp_step``)."""
    return functools.partial(step, every_column=True)


def _make_bucketed_block_step(step, name):
    def block_step(meta, data, state, blk_ids, eta_t, row_batches, **kw):
        lam, m, loss_name, reg_name, _, w_lo, w_hi = meta
        _needs_adagrad(meta, name)
        step(*data.arrays, blk_ids, *_stats_args(data, state),
             (eta_t, lam, m, w_lo, w_hi), row_batches=row_batches,
             loss_name=loss_name, reg_name=reg_name, **kw)
    return block_step


def _make_switch_block_step(sparse_step):
    """The legacy bucket dispatch over a block-ELL block step: for each
    processor q, look up its active tile's (bucket k, slot s) in the
    ``"buckets"`` payload's maps and step that (mb, K_k) rectangle with
    ``sparse_step`` as a grid of one processor, on views of the state
    (its w/gw block row, its alpha/ga row), so the step writes in place.
    The tile's column statistics are the one copy (a strided slice)."""

    def block_step(meta, data, state, blk_ids, eta_t, row_batches):
        *rects, bucket_id, bucket_pos = data.arrays
        p = data.yg.shape[0]
        db = data.col_nnz.shape[0] // p
        bid, pos = bucket_id.tolist(), bucket_pos.tolist()
        zero = torch.zeros(1, dtype=torch.int32, device=blk_ids.device)
        for q, b in enumerate(blk_ids.tolist()):
            k, s = bid[q][b], pos[q][b]
            cols = slice(b * db, (b + 1) * db)
            tile = TileData(
                arrays=(rects[2 * k][q, s][None, None],
                        rects[2 * k + 1][q, s][None, None]),
                yg=data.yg[q:q + 1], row_nnz_g=data.row_nnz_g[q:q + 1],
                col_nnz=data.col_nnz[cols],
                row_valid=data.row_valid[q:q + 1],
                tile_col_nnz_g=data.tile_col_nnz_g[q:q + 1, :, cols]
                .contiguous(),
                tile_row_nnz_g=data.tile_row_nnz_g[q:q + 1, b:b + 1])
            sub = DSOState(w_grid=state.w_grid[b:b + 1],
                           gw_grid=state.gw_grid[b:b + 1],
                           alpha=state.alpha[q:q + 1],
                           ga=state.ga[q:q + 1], epoch=state.epoch)
            sparse_step(meta, tile, sub, zero, eta_t, row_batches)

    return block_step


_BACKENDS: dict[str, TileBackend] = {}

#: legacy ``impl`` selectors -> canonical backends
LEGACY_IMPLS = {"jnp": "dense_jnp", "pallas": "dense_pallas_block",
                "sparse": "sparse_jnp", "sparse_pallas": "sparse_pallas"}


def register_backend(backend: TileBackend) -> TileBackend:
    if backend.layout not in ("dense", "sparse", "bucketed"):
        raise ValueError(f"backend layout must be dense|sparse|bucketed, "
                         f"got {backend.layout!r}")
    _BACKENDS[backend.name] = backend
    return backend


def registered_backends() -> tuple[str, ...]:
    return tuple(_BACKENDS)


def get_backend(name) -> TileBackend:
    """Canonical-name lookup; pass-through for ``TileBackend`` instances."""
    if isinstance(name, TileBackend):
        return name
    try:
        return _BACKENDS[name]
    except KeyError:
        raise ValueError(
            f"unknown backend/impl {name!r}: registered backends are "
            f"{sorted(_BACKENDS)} (legacy impl selectors: "
            f"{sorted(LEGACY_IMPLS)} and 'auto')") from None


_LAYOUT_KERNELS = {
    "jnp": {"dense": "dense_jnp", "sparse": "sparse_jnp",
            "bucketed": "sparse_bucketed_jnp"},
    "pallas": {"dense": "dense_pallas_block", "sparse": "sparse_pallas",
               "bucketed": "sparse_bucketed_pallas"},
}


def auto_kernel(device_type: str) -> str:
    """``auto``'s kernel choice from the data's device type alone: the
    CUDA kernel for data on the card, the plain twin on the CPU."""
    return "pallas" if device_type == "cuda" else "jnp"


def resolve_backend(impl, density: float | None = None, *,
                    k_skew: float | None = None,
                    device_type: str = "cpu") -> TileBackend:
    """``impl`` selector (canonical or legacy) + problem stats -> backend.

    ``auto``: density at or above ``SPARSE_DENSITY_THRESHOLD`` picks the
    dense layout; below it a tile-K skew at or above
    ``BUCKET_SKEW_THRESHOLD`` picks the bucketed layout, else block-ELL
    (``k_skew=None``: not probed, block-ELL).  The kernel then follows
    ``device_type`` (``auto_kernel``).
    """
    if isinstance(impl, TileBackend):
        return impl
    if impl == "auto":
        if density is None:
            raise ValueError("impl='auto' needs the problem density to pick "
                             "a layout; pass density= or a concrete backend")
        if density >= SPARSE_DENSITY_THRESHOLD:
            layout = "dense"
        elif k_skew is not None and k_skew >= BUCKET_SKEW_THRESHOLD:
            layout = "bucketed"
        else:
            layout = "sparse"
        return _BACKENDS[_LAYOUT_KERNELS[auto_kernel(device_type)][layout]]
    if impl in LEGACY_IMPLS:
        return _BACKENDS[LEGACY_IMPLS[impl]]
    return get_backend(impl)


def resolve_backend_for_layout(impl, layout: str, *,
                               device_type: str = "cpu") -> TileBackend:
    """Backend for pre-built grid data whose layout is already fixed:
    ``auto`` picks the layout's backend of ``auto_kernel(device_type)``,
    ``jnp``/``pallas`` that kernel; canonical names must match the
    layout."""
    if not isinstance(impl, TileBackend) and impl in ("auto", "jnp",
                                                      "pallas"):
        kernel = auto_kernel(device_type) if impl == "auto" else impl
        return _BACKENDS[_LAYOUT_KERNELS[kernel][layout]]
    backend = resolve_backend(impl)
    if backend.layout != layout:
        raise ValueError(
            f"backend {backend.name!r} has layout {backend.layout!r} but the "
            f"grid data is {layout!r}; pass a {layout} backend or the kernel "
            f"selector 'jnp'/'pallas'")
    return backend


_sparse_jnp_block_step = _make_jnp_block_step(_sparse_tile, sparse_tile_step)

register_backend(TileBackend(
    "dense_jnp", "dense", _make_jnp_block_step(_dense_tile, block_tile_step)))
register_backend(TileBackend("dense_pallas_fused", "dense",
                             _dense_pallas_fused_block_step))
register_backend(TileBackend("dense_pallas_block", "dense",
                             _dense_pallas_block_step))
register_backend(TileBackend("sparse_jnp", "sparse", _sparse_jnp_block_step))
register_backend(TileBackend("sparse_pallas", "sparse",
                             _sparse_pallas_block_step,
                             clamp_step=_clamping(_sparse_pallas_block_step)))
register_backend(TileBackend(
    "sparse_bucketed_jnp", "bucketed",
    _make_bucketed_block_step(dso_sparse.dso_bucketed_block_step_plain,
                              "sparse_bucketed_jnp")))
_bucketed_pallas_block_step = _make_bucketed_block_step(
    ops.dso_bucketed_block_step, "the bucketed CUDA kernel")
register_backend(TileBackend(
    "sparse_bucketed_pallas", "bucketed", _bucketed_pallas_block_step,
    clamp_step=_clamping(_bucketed_pallas_block_step)))
register_backend(TileBackend(
    "sparse_bucketed_jnp_switch", "bucketed",
    _make_switch_block_step(_sparse_jnp_block_step), payload="buckets"))
register_backend(TileBackend(
    "sparse_bucketed_pallas_switch", "bucketed",
    _make_switch_block_step(_sparse_pallas_block_step), payload="buckets",
    clamp_step=_make_switch_block_step(
        _clamping(_sparse_pallas_block_step))))
