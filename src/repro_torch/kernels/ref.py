"""Independent oracles for every kernel of the port (tests only).

Counterparts of the reference's ``kernels/ref.py``, each code that shares
nothing with the kernels' staged math:

- ``dso_tile_step_ref`` (reference :18) and ``dso_block_step_ref`` (:30):
  ``engine.update.block_tile_step`` once, or in a plain Python loop over
  the row tiles;
- ``dso_sparse_block_step_ref`` (:53) and ``dso_bucketed_block_step_ref``
  (:79): a loop of ``engine.update.sparse_tile_step`` over the row tiles,
  tile statistics derived from ``vals != 0``;
- ``swa_attention_ref`` (:99): one float32 softmax over all keys, K and V
  repeated per query head;
- ``ssd_scan_ref`` (:126): the exact sequential SSD recurrence, a Python
  loop over t.

The block steps work on one processor and one active block and return new
``(w, alpha, gw, ga)`` tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.engine.update import block_tile_step, sparse_tile_step

_NEG_INF = -1e30


def dso_tile_step_ref(X, y, w, alpha, gw, ga, row_nnz, col_nnz, scalars, *,
                      loss_name: str, reg_name: str):
    """One dense tile step over X (M, D), tile statistics derived from
    ``X != 0``; ``scalars`` = (eta, lam, m, w_lo, w_hi)."""
    eta, lam, m, w_lo, w_hi = (float(s) for s in scalars)
    return block_tile_step(
        X_tile=X, y_tile=y, w_blk=w, alpha_blk=alpha, gw_blk=gw, ga_blk=ga,
        row_nnz_tile=row_nnz, col_nnz_blk=col_nnz, eta_t=eta, lam=lam, m=m,
        loss_name=loss_name, reg_name=reg_name, use_adagrad=True,
        w_lo=w_lo, w_hi=w_hi)


def dso_block_step_ref(X, y, w, alpha, gw, ga, row_nnz, col_nnz, scalars, *,
                       row_batches: int, loss_name: str, reg_name: str):
    """``row_batches`` sequential dense tile steps over the row tiles of X
    (M, D); trailing rows beyond ``row_batches * (M // row_batches)`` are
    left untouched."""
    eta, lam, m, w_lo, w_hi = (float(s) for s in scalars)
    rb = X.shape[0] // row_batches
    alpha_new, ga_new = alpha.clone(), ga.clone()
    for s in range(row_batches):
        sl = slice(s * rb, (s + 1) * rb)
        w, a_s, gw, ga_s = block_tile_step(
            X_tile=X[sl], y_tile=y[sl], w_blk=w, alpha_blk=alpha_new[sl],
            gw_blk=gw, ga_blk=ga_new[sl], row_nnz_tile=row_nnz[sl],
            col_nnz_blk=col_nnz, eta_t=eta, lam=lam, m=m,
            loss_name=loss_name, reg_name=reg_name, use_adagrad=True,
            w_lo=w_lo, w_hi=w_hi)
        alpha_new[sl] = a_s
        ga_new[sl] = ga_s
    return w, alpha_new, gw, ga_new


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


def swa_attention_ref(q, k, v, *, window: int, causal: bool = True,
                      q_offset: int = 0):
    """q (B, Hq, Tq, Dh); k, v (B, Hkv, Tk, Dh), Hq % Hkv == 0.  Query row
    t sits at ``q_offset + t``; it attends to keys in (pos - window, pos]
    when causal, to keys after pos - window otherwise.  Output in q's
    type."""
    Dh = q.shape[-1]
    rep = q.shape[1] // k.shape[1]
    kf = k.float().repeat_interleave(rep, dim=1)
    vf = v.float().repeat_interleave(rep, dim=1)
    scale = 1.0 / torch.sqrt(torch.tensor(float(Dh)))
    logits = (q.float() @ kf.transpose(-1, -2)) * scale
    qpos = q_offset + torch.arange(q.shape[2])[:, None]
    kpos = torch.arange(k.shape[2])[None, :]
    mask = kpos <= qpos if causal else torch.ones_like(kpos > qpos)
    mask = mask & (kpos > qpos - window)
    logits = torch.where(mask.to(q.device), logits, _NEG_INF)
    p = torch.softmax(logits, dim=-1)
    return (p @ vf).to(q.dtype)


def ssd_scan_ref(x, dt, A, B, C, *, chunk: int = 64):
    """Mamba2 SSD, the exact sequential recurrence (``chunk`` is unused,
    as in the reference):

        state_t = exp(A dt_t) state_{t-1} + dt_t B_t x_t^T
        y_t     = C_t . state_t

    x (b, t, h, dh), dt (b, t, h), A (h,), B, C (b, t, n); y like x."""
    b, t, h, dh = x.shape
    n = B.shape[-1]
    xf, dtf, Bf, Cf = (a.float() for a in (x, dt, B, C))
    state = torch.zeros(b, h, n, dh, device=x.device)
    ys = []
    for i in range(t):
        decay = torch.exp(A.float()[None] * dtf[:, i])              # b h
        upd = torch.einsum("bn,bh,bhd->bhnd", Bf[:, i], dtf[:, i], xf[:, i])
        state = state * decay[..., None, None] + upd
        ys.append(torch.einsum("bn,bhnd->bhd", Cf[:, i], state))
    return torch.stack(ys, dim=1).to(x.dtype)
