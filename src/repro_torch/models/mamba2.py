"""Mamba2 (SSD — state-space duality, arXiv:2405.21060) block (the port of
``repro.models.mamba2``).

in_proj produces (z | x | B | C | dt); a short causal conv over (x, B, C);
the SSD scan with per-head scalar decay A; gated RMSNorm; out_proj.  The
scan in ``mamba2_apply`` is one call of ``kernels.ops.ssd_scan`` with the
reference's chunk rule (``mamba2.py:185``): plain PyTorch on CPU tensors,
the CUDA kernels on the card (dt, A, B and C as float32, x and y as bf16
or float32).  ``ssd_chunked`` is the reference's jnp form in PyTorch, for
the chunk-invariance test and the comparison with the reference; it is
not the model's path.

``cfg.ssd_dtype`` keeps its meaning: the scan's intra-chunk products take
x, B and C in that type (float32 by default) and accumulate in float32.
For another type the model rounds x, B and C to it before the scan.

Under tensor parallelism (``tp``, ``dist.tensor_parallel``) in_proj (or
the split layout's projections) and conv_w hold the rank's columns, whose
boundaries fall inside the z | x | B | C | dt parts (at zamba2-7b the
14,576 columns split 3,644 a rank against d_inner 7,168).  The rank
gathers the projection's output, not the weight: B T (2 di + 2 n + h)
elements against d (2 di + 2 n + h), near each other at zamba2-7b's B T
4,096 and d 3,584, and with the output's gather the product stays split
n ways, where with the weight's every rank would compute every column.
When the SSD heads divide the group, the rank takes its heads of x, z
and dt (and of A_log, D and dt_bias, whole leaves whose gradients the
step sums over the group), all of B and C, and runs the scan on them;
y * silu(z) is gathered for the norm over all of d_inner and out_proj,
and the output's columns after.

Decode carries (conv ring buffer, SSD state), O(1) per token, updated in
place; under ``tp`` both are whole on every rank of the group.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.dist.tensor_parallel import SINGLE
from repro_torch.kernels.ops import ssd_scan
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (ParamInit, _dense_init, rmsnorm,
                                       rmsnorm_init, torch_dtype)


def mamba2_init(init: ParamInit, cfg: ModelConfig, dtype):
    d, di, n, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    f32 = torch.float32
    p = {
        "A_log": init.full((h,), 0.0, f32),        # A = -exp(A_log)
        "D": init.full((h,), 1.0, f32),            # skip connection
        "dt_bias": init.full((h,), 0.0, f32),
        "norm": rmsnorm_init(init, di, f32),
        "out_proj": _dense_init(init, (di, d), dtype=dtype),
    }
    conv = lambda c: _dense_init(init, (cfg.ssm_conv, c), scale=0.5,  # noqa
                                 dtype=dtype)
    if cfg.ssm_split_proj:
        p.update({
            "in_z": _dense_init(init, (d, di), dtype=dtype),
            "in_x": _dense_init(init, (d, di), dtype=dtype),
            "in_B": _dense_init(init, (d, n), dtype=dtype),
            "in_C": _dense_init(init, (d, n), dtype=dtype),
            "in_dt": _dense_init(init, (d, h), dtype=dtype),
            "conv_x": conv(di), "conv_x_b": init.full((di,), 0.0, dtype),
            "conv_B": conv(n), "conv_B_b": init.full((n,), 0.0, dtype),
            "conv_C": conv(n), "conv_C_b": init.full((n,), 0.0, dtype),
        })
    else:
        p.update({
            # order: z (di) | x (di) | B (n) | C (n) | dt (h)
            "in_proj": _dense_init(init, (d, 2 * di + 2 * n + h),
                                   dtype=dtype),
            "conv_w": conv(di + 2 * n),
            "conv_b": init.full((di + 2 * n,), 0.0, dtype),
        })
    return p


def split_fused_params(p, cfg: ModelConfig):
    """Slice fused in_proj/conv params into the split layout (for
    equivalence tests and checkpoint migration); works on stacked layers
    too, since only the last axis is sliced."""
    di, n = cfg.d_inner, cfg.ssm_state
    w, cw, cb = p["in_proj"], p["conv_w"], p["conv_b"]
    out = {k: v for k, v in p.items()
           if k not in ("in_proj", "conv_w", "conv_b")}
    out.update({
        "in_z": w[..., :di], "in_x": w[..., di: 2 * di],
        "in_B": w[..., 2 * di: 2 * di + n],
        "in_C": w[..., 2 * di + n: 2 * di + 2 * n],
        "in_dt": w[..., 2 * di + 2 * n:],
        "conv_x": cw[..., :di], "conv_x_b": cb[..., :di],
        "conv_B": cw[..., di: di + n], "conv_B_b": cb[..., di: di + n],
        "conv_C": cw[..., di + n:], "conv_C_b": cb[..., di + n:],
    })
    return out


def _split(cfg: ModelConfig, zxbcdt):
    di, n = cfg.d_inner, cfg.ssm_state
    return (zxbcdt[..., :di], zxbcdt[..., di: 2 * di + 2 * n],
            zxbcdt[..., 2 * di + 2 * n:])


def _causal_conv(xbc, w, b):
    """Depthwise causal conv, window K. xbc: (B, T, C); w: (K, C)."""
    K, T = w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, K - 1, 0))
    out = pad[:, 0:T] * w[0]
    for i in range(1, K):
        out = out + pad[:, i: i + T] * w[i]
    return out + b


def ssd_chunked(x, dt, A, B, C, *, chunk: int = 128,
                compute_dtype=torch.float32):
    """Chunk-parallel SSD, the reference's jnp form (``mamba2.py:106-159``)
    in PyTorch.  x: (b, t, h, dh); dt: (b, t, h); A: (h,); B, C: (b, t, n).
    ``compute_dtype`` is the precision of the big intra-chunk tensors; the
    decay cumsums and the state recurrence stay float32."""
    b, t, h, dh = x.shape
    n = B.shape[-1]
    assert t % chunk == 0, (t, chunk)
    nc, L = t // chunk, chunk
    f32, cd = torch.float32, torch_dtype(compute_dtype)
    xr = x.reshape(b, nc, L, h, dh).to(cd)
    dtr = dt.reshape(b, nc, L, h).to(f32)
    Br = B.reshape(b, nc, L, n).to(cd)
    Cr = C.reshape(b, nc, L, n).to(cd)

    cs = torch.cumsum(A.to(f32) * dtr, dim=2)                # (b,nc,L,h)
    last = cs[:, :, -1]                                      # (b,nc,h)
    diff = cs[:, :, :, None, :] - cs[:, :, None, :, :]       # (b,nc,L,L,h)
    tmask = torch.ones(L, L, dtype=torch.bool, device=x.device).tril()
    decay = torch.where(tmask[:, :, None], torch.exp(diff), 0.0)
    cb = torch.einsum("bcin,bcjn->bcij", Cr.to(f32), Br.to(f32))
    M = (cb[..., None] * decay * dtr[:, :, None, :, :]).to(cd)
    y = torch.einsum("bcijh,bcjhd->bcihd", M.to(f32), xr.to(f32))

    w_in = dtr * torch.exp(last[:, :, None] - cs)            # (b,nc,L,h)
    S = torch.einsum("bcjn,bcjh,bcjhd->bchnd", Br.to(f32), w_in,
                     xr.to(f32))                             # (b,nc,h,n,dh)
    state = torch.zeros(b, h, n, dh, dtype=f32, device=x.device)
    prev = []
    for c in range(nc):                                      # emit previous
        prev.append(state)
        state = state * torch.exp(last[:, c])[..., None, None] + S[:, c]
    prev = torch.stack(prev, dim=1)                          # (b,nc,h,n,dh)
    y = y + torch.einsum("bcin,bchnd,bcih->bcihd", Cr.to(f32), prev,
                         torch.exp(cs))
    return y.reshape(b, t, h, dh).to(x.dtype)


def _in_proj(p, x, cfg: ModelConfig, tp=SINGLE):
    """(z, xBC before the conv, dt_raw, conv_w, conv_b) of either layout,
    each whole (gathered under ``tp``).  The conv is depthwise, so the
    split layout's parts convolved alone (the reference's split path) give
    the same numbers as their concatenation."""
    di, n, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    lin = lambda w, full: tp.whole(x @ p[w], full)  # noqa: E731
    conv = lambda w, full: tp.whole(p[w], full)     # noqa: E731
    if cfg.ssm_split_proj:
        xbc = torch.cat([lin("in_x", di), lin("in_B", n), lin("in_C", n)],
                        dim=-1)
        conv_w = torch.cat([conv("conv_x", di), conv("conv_B", n),
                            conv("conv_C", n)], dim=1)
        conv_b = torch.cat([p["conv_x_b"], p["conv_B_b"], p["conv_C_b"]])
        return lin("in_z", di), xbc, lin("in_dt", h), conv_w, conv_b
    z, xbc, dt_raw = _split(cfg, lin("in_proj", 2 * di + 2 * n + h))
    return z, xbc, dt_raw, conv("conv_w", di + 2 * n), p["conv_b"]


def _gate_out(p, y, z, cfg: ModelConfig, tp=SINGLE):
    y = tp.whole(y * F.silu(z.float()).to(y.dtype), cfg.d_inner)
    return tp.whole(rmsnorm(p["norm"], y) @ p["out_proj"], cfg.d_model)


def mamba2_apply(p, x, cfg: ModelConfig, *, chunk: int = 128, tp=SINGLE):
    """x: (B, T, d) -> (B, T, d); ``tp``: see the module docstring."""
    Bsz, T, _ = x.shape
    di, n, h, dh = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    z, xbc, dt_raw, conv_w, conv_b = _in_proj(p, x, cfg, tp)
    A_log, D, dt_bias = p["A_log"], p["D"], p["dt_bias"]
    if tp.splits(h):                 # the rank's heads; B and C whole
        h //= tp.n
        own = slice(tp.coord * h * dh, (tp.coord + 1) * h * dh)
        z, dt_raw = z[..., own], tp.part(dt_raw, cfg.ssm_heads)
        xbc = torch.cat([xbc[..., own], xbc[..., di:]], dim=-1)
        conv_w = torch.cat([conv_w[:, own], conv_w[:, di:]], dim=1)
        conv_b = torch.cat([conv_b[own], conv_b[di:]])
        A_log, D, dt_bias = (tp.part(t, cfg.ssm_heads)
                             for t in (A_log, D, dt_bias))
        di = h * dh
    xbc = F.silu(_causal_conv(xbc, conv_w, conv_b))
    xs = xbc[..., :di].reshape(Bsz, T, h, dh).contiguous()
    Bc, Cc = xbc[..., di: di + n], xbc[..., di + n:]
    dt = F.softplus(dt_raw.float() + dt_bias)
    A = -torch.exp(A_log)
    ck = min(chunk, T) if T % min(chunk, T) == 0 else T
    sd = torch_dtype(cfg.ssd_dtype)
    xin, Bin, Cin = xs, Bc, Cc
    if sd != torch.float32:
        xin = xs.to(sd).to(xs.dtype)
        Bin, Cin = Bc.to(sd).float(), Cc.to(sd).float()
    y = ssd_scan(xin, dt, A, Bin, Cin, chunk=ck)
    y = y + D[None, None, :, None].to(y.dtype) * xs
    return _gate_out(p, y.reshape(Bsz, T, di), z, cfg, tp)


# ------------------------------------------------------------------ decode --


def init_ssm_cache(cfg: ModelConfig, batch: int, dtype, *, device,
                   stack: tuple = ()):
    di, n, h, dh = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    s = tuple(stack)
    return {
        "conv": torch.zeros(s + (batch, cfg.ssm_conv - 1, di + 2 * n),
                            dtype=dtype, device=device),
        "state": torch.zeros(s + (batch, h, n, dh), dtype=torch.float32,
                             device=device),
    }


def mamba2_decode(p, x, cache, cfg: ModelConfig, tp=SINGLE):
    """One-token step. x: (B, 1, d).  Updates ``cache`` in place and
    returns (out (B,1,d), cache).  Under ``tp`` every rank holds the
    whole conv and SSM states of its rows and updates them alike from
    ``_in_proj``'s gathered outputs; the output's columns are
    gathered."""
    Bsz = x.shape[0]
    di, n, h, dh = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    z, xbc, dt_raw, conv_w, conv_b = _in_proj(p, x, cfg, tp)
    # conv ring: window = cfg.ssm_conv, cache holds the K-1 previous inputs
    hist = torch.cat([cache["conv"], xbc.to(cache["conv"].dtype)], dim=1)
    conv_out = (hist * conv_w[None]).sum(dim=1, keepdim=True)
    xbc1 = F.silu(conv_out + conv_b)
    xs = xbc1[..., :di].reshape(Bsz, h, dh)
    Bc = xbc1[:, 0, di: di + n]
    Cc = xbc1[:, 0, di + n:]
    dt = F.softplus(dt_raw[:, 0].float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    decay = torch.exp(A[None] * dt)                              # (B, h)
    upd = torch.einsum("bn,bh,bhd->bhnd", Bc.float(), dt, xs.float())
    state = cache["state"] * decay[..., None, None] + upd
    y = torch.einsum("bn,bhnd->bhd", Cc.float(), state)
    y = y + p["D"][None, :, None] * xs.float()
    out = _gate_out(p, y.reshape(Bsz, 1, di).to(x.dtype), z, cfg, tp)
    cache["conv"].copy_(hist[:, 1:])
    cache["state"].copy_(state)
    return out, cache
