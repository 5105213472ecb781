"""The Mamba2 SSD chunked scan: the launch of the CUDA kernel of
``csrc/ssd_scan.cu`` and its plain PyTorch version (the torch counterpart
of the reference's ``kernels/ssd_scan.py``).

x (b, t, h, dh); dt (b, t, h) > 0; A (h,) < 0; B, C (b, t, n), shared by
the heads.  Per chunk of ``chunk`` steps, with s = cumsum(A * dt) inside
the chunk and the (n, dh) state carried across chunks:

    y_t    = sum_{tau <= t} (C_t . B_tau) exp(s_t - s_tau) dt_tau x_tau
             + exp(s_t) (C_t . state)
    state' = exp(s_L) state + B^T (x * dt * exp(s_L - s))

in float32; y is in x's type.  A t that ``chunk`` does not divide is
padded with dt = 0, a step that changes nothing (the reference's rule,
``ops.py:349-353``).

Replaces the reference's Pallas kernel ``_ssd_kernel``
(``src/repro/kernels/ssd_scan.py:32``, pallas_call :84) by three launches
(chunk states, state passing, chunk output); the note in
``csrc/ssd_scan.cu`` gives the design.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.build import check, library, stream

DEFAULT_CHUNK = 128
MAX_HEAD_DIM = 256          # the kernels' widest dh (4 tiles of 64)


def launch_ssd_scan(x, dt, A, B, C, y, *, chunk: int):
    """The kernels on contiguous tensors: x and ``y`` float32 or bf16, dt,
    A, B, C float32, dh <= ``MAX_HEAD_DIM``.  Allocates the chunk-state
    workspace (b, h, n_chunks, n, dh) float32 (235 MB at zamba2-7b's t
    16,384, 112 heads, n = dh = 64, chunk 128) and the chunks' total
    decays (b, h, n_chunks) with ``torch.empty`` for the call and returns
    them: after the call they hold the state entering each chunk and
    exp(s_L) of each chunk, which the backward reads."""
    b, t, h, dh = x.shape
    n = B.shape[-1]
    nch = -(-t // chunk)
    ws = torch.empty(b, h, nch, n, dh, dtype=torch.float32, device=x.device)
    decay = torch.empty(b, h, nch, dtype=torch.float32, device=x.device)
    check("ssd_scan_fwd", library().lib.ssd_scan_fwd(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
        C.data_ptr(), y.data_ptr(), ws.data_ptr(), decay.data_ptr(), b, t,
        h, dh, n, chunk, int(x.dtype == torch.bfloat16), stream(y)))
    return ws, decay


def launch_ssd_scan_bwd(x, dt, A, B, C, states, decay, dy, dx, ddt, dBh,
                        dCh, dAp, *, chunk: int):
    """The backward kernels on contiguous tensors: x, dt, A, B, C as
    ``launch_ssd_scan`` takes them, ``states`` and ``decay`` as it returns
    them, ``dy`` like x.  Writes dx (like x), ddt (b, t, h), the per-head
    parts dBh and dCh (b, t, h, n) and dAp (b, h, n_chunks), float32;
    allocates the state adjoint's workspace (like ``states``) with
    ``torch.empty`` for the call."""
    b, t, h, dh = x.shape
    n = B.shape[-1]
    wsz = torch.empty_like(states)
    check("ssd_scan_bwd", library().lib.ssd_scan_bwd(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
        C.data_ptr(), dy.data_ptr(), states.data_ptr(), decay.data_ptr(),
        wsz.data_ptr(), dx.data_ptr(), ddt.data_ptr(), dBh.data_ptr(),
        dCh.data_ptr(), dAp.data_ptr(), b, t, h, dh, n, chunk,
        int(x.dtype == torch.bfloat16), stream(dx)))


def _compute_dtype(x):
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def _plain_chunked(x, dt, A, B, C, chunk):
    """The inputs padded to whole chunks, in float32 (float64 when x is
    float64: a reference for the others), viewed per chunk:
    x (b, h, c, L, dh), dt (b, h, c, L), B and C (b, 1, c, L, n), and the
    cumulative decay s = cumsum(A dt) inside each chunk (b, h, c, L)."""
    b, t, h, dh = x.shape
    n = B.shape[-1]
    pad = (-t) % chunk
    f32 = _compute_dtype(x)
    xf = torch.nn.functional.pad(x.to(f32), (0, 0, 0, 0, 0, pad))
    dtf = torch.nn.functional.pad(dt.to(f32), (0, 0, 0, pad))
    Bf = torch.nn.functional.pad(B.to(f32), (0, 0, 0, pad))
    Cf = torch.nn.functional.pad(C.to(f32), (0, 0, 0, pad))
    nch = (t + pad) // chunk
    xc = xf.view(b, nch, chunk, h, dh).permute(0, 3, 1, 2, 4)  # b h c L dh
    dtc = dtf.view(b, nch, chunk, h).permute(0, 3, 1, 2)       # b h c L
    Bc = Bf.view(b, 1, nch, chunk, n)
    Cc = Cf.view(b, 1, nch, chunk, n)
    cs = torch.cumsum(A.to(f32).view(1, h, 1, 1) * dtc, dim=-1)
    return xc, dtc, Bc, Cc, cs


def _causal_decay(cs):
    """exp(s_t - s_tau) for tau <= t inside each chunk, else 0 (b, h, c,
    L, L).  The mask goes in before the exp: exp(-inf) is the 0 that
    masks, and no exp of a future tau (which can overflow) is taken."""
    L = cs.shape[-1]
    tmask = torch.ones(L, L, dtype=torch.bool, device=cs.device).tril()
    return torch.exp(torch.where(tmask, cs[..., :, None] - cs[..., None, :],
                                 -torch.inf))


def ssd_scan_plain(x, dt, A, B, C, *, chunk: int,
                   return_states: bool = False):
    """Plain version: the chunked form the kernel computes, every chunk's
    intra-chunk masked decay product at once, then the carried state
    chunk by chunk, in float32 (float64 when x is float64).  With
    ``return_states`` it returns (y, states, decay): the state entering
    each chunk (b, h, n_chunks, n, dh) and each chunk's total decay
    exp(s_L) (b, h, n_chunks), what the kernels keep for their
    backward."""
    b, t, h, dh = x.shape
    xc, dtc, Bc, Cc, cs = _plain_chunked(x, dt, A, B, C, chunk)
    nch, n = xc.shape[2], Bc.shape[-1]
    # the masked exp keeps the gradient finite where an unmasked exp(s_t -
    # s_tau) of a future tau would overflow (0 * inf in autograd, the
    # reference's where(mask, exp(diff), 0))
    M = (Cc @ Bc.transpose(-1, -2)) * _causal_decay(cs) * dtc[..., None, :]
    y = M @ xc                                               # b h c L dh
    last = cs[..., -1]                                       # b h c
    w_in = dtc * torch.exp(last[..., None] - cs)
    upd = Bc.transpose(-1, -2) @ (xc * w_in[..., None])      # b h c n dh
    state = torch.zeros(b, h, n, dh, dtype=xc.dtype, device=x.device)
    states = torch.empty(b, h, nch, n, dh, dtype=xc.dtype,
                         device=x.device) if return_states else None
    for c in range(nch):
        if states is not None:
            states[:, :, c] = state
        y[:, :, c] += torch.exp(cs[:, :, c])[..., None] * (Cc[:, :, c]
                                                            @ state)
        state = torch.exp(last[:, :, c])[..., None, None] * state \
            + upd[:, :, c]
    y = y.permute(0, 2, 3, 1, 4).reshape(b, nch * chunk, h, dh)[:, :t]
    y = y.to(x.dtype)
    return (y, states, torch.exp(last)) if return_states else y


def ssd_scan_bwd_plain(x, dt, A, B, C, states, decay, dy, *, chunk: int):
    """Plain version of the backward kernels: the gradients (dx, ddt, dA,
    dB, dC) of ``ssd_scan_plain`` for the upstream gradient ``dy`` (like
    x), from the states entering each chunk and the chunks' total decays
    that it returns with ``return_states``, with no autograd.  Per chunk,
    with G = C B^T, R = dy x^T (L x L), E = exp(s_t - s_tau) for tau <= t
    (else 0), w = dt exp(s_L - s), S the entering state and Z the adjoint
    of the state the chunk leaves:

        Z_c     = exp(s_L) Z_{c+1} + sum_t exp(s_t) C_t dy_t^T   (Z of the
                  last chunk 0; the state adjoint, run backwards)
        dx      = dt (((G E)^T dy) + exp(s_L - s) (B Z))
        ddt     = colsum(G E R) + exp(s_L - s) u + A da   (= x . dx / dt
                  + A da, summed as the kernel sums it)
        dC      = (E R dt) B + exp(s) dy S^T,  dB = (E R dt)^T C + w x Z^T
        ds      = rowsum(W) - colsum(W) + exp(s) dy . (C S) - u w
                  (+ sum(u w) + exp(s_L) <S, Z> at the chunk's last step),
                  W = G E R dt, u = (B Z) . x
        da      = the reversed cumulative sum of ds inside the chunk,
        dA      = sum over (batch, t) of dt da

    in float32; dB and dC sum the heads.  Padded steps (dt = 0) are
    dropped.  Each gradient comes back in its input's type."""
    b, t, h, dh = x.shape
    n = B.shape[-1]
    xc, dtc, Bc, Cc, cs = _plain_chunked(x, dt, A, B, C, chunk)
    nch = xc.shape[2]
    pad = nch * chunk - t
    ct = xc.dtype
    dyc = torch.nn.functional.pad(dy.to(ct), (0, 0, 0, 0, 0, pad)).view(
        b, nch, chunk, h, dh).permute(0, 3, 1, 2, 4)         # b h c L dh
    S = states.to(ct)
    last = cs[..., -1]
    E = _causal_decay(cs)
    G = Cc @ Bc.transpose(-1, -2)                            # b 1 c L L
    R = dyc @ xc.transpose(-1, -2)                           # b h c L L
    V = E * dtc[..., None, :] * R
    W = G * V
    es = torch.exp(cs)
    loc = Cc.transpose(-1, -2) @ (dyc * es[..., None])       # b h c n dh
    Z = torch.empty_like(loc)
    run = torch.zeros_like(loc[:, :, 0])
    for c in reversed(range(nch)):
        Z[:, :, c] = run
        run = decay[:, :, c, None, None].to(ct) * run + loc[:, :, c]
    el = torch.exp(last[..., None] - cs)                     # b h c L
    BZ = Bc @ Z                                              # b h c L dh
    dxt = (G * E).transpose(-1, -2) @ dyc + el[..., None] * BZ
    dx = dtc[..., None] * dxt
    dC = V @ Bc + es[..., None] * (dyc @ S.transpose(-1, -2))
    w = dtc * el
    dB = V.transpose(-1, -2) @ Cc + w[..., None] * (xc @ Z.transpose(-1, -2))
    u = (BZ * xc).sum(-1)
    ddt = (G * E * R).sum(-2) + el * u
    ds = W.sum(-1) - W.sum(-2) + es * (dyc * (Cc @ S)).sum(-1) - u * w
    ds[..., -1] += (u * w).sum(-1) + decay.to(ct) * (S * Z).sum((-1, -2))
    da = ds.flip(-1).cumsum(-1).flip(-1)
    ddt = ddt + A.to(ct).view(1, h, 1, 1) * da
    dA = (dtc * da).sum((0, 2, 3))

    def steps(g, width):            # b h c L [w] -> b t h [w], unpadded
        g = g.permute(0, 2, 3, 1, *range(4, g.dim()))
        return g.reshape(b, nch * chunk, h, *width)[:, :t]
    return (steps(dx, (dh,)).to(x.dtype), steps(ddt, ()).to(dt.dtype),
            dA.to(A.dtype), steps(dB, (n,)).sum(2).to(B.dtype),
            steps(dC, (n,)).sum(2).to(C.dtype))
