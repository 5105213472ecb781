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


def workspace_floats(b: int, t: int, h: int, dh: int, n: int,
                     chunk: int) -> int:
    """float32 elements of the kernels' chunk-state workspace: one (n, dh)
    state per (batch, head, chunk), b * h * ceil(t / chunk) * n * dh (235
    MB at zamba2-7b's t 16,384, 112 heads, n = dh = 64, chunk 128; 134 MB
    at mamba2-370m's 32 heads, n 128)."""
    return b * h * -(-t // chunk) * n * dh


def launch_ssd_scan(x, dt, A, B, C, y, *, chunk: int):
    """The kernels on contiguous tensors: x and ``y`` float32 or bf16, dt,
    A, B, C float32, dh <= ``MAX_HEAD_DIM``.  Allocates the chunk-state
    workspace (``workspace_floats``) and the chunks' total decays with
    ``torch.empty`` for the call."""
    b, t, h, dh = x.shape
    n = B.shape[-1]
    ws = torch.empty(workspace_floats(b, t, h, dh, n, chunk),
                     dtype=torch.float32, device=x.device)
    decay = torch.empty(b * h * -(-t // chunk), dtype=torch.float32,
                        device=x.device)
    check("ssd_scan_fwd", library().lib.ssd_scan_fwd(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
        C.data_ptr(), y.data_ptr(), ws.data_ptr(), decay.data_ptr(), b, t,
        h, dh, n, chunk, int(x.dtype == torch.bfloat16), stream(y)))


def ssd_scan_plain(x, dt, A, B, C, *, chunk: int):
    """Plain version: the chunked form the kernel computes, every chunk's
    intra-chunk masked decay product at once, then the carried state
    chunk by chunk."""
    b, t, h, dh = x.shape
    n = B.shape[-1]
    pad = (-t) % chunk
    f32 = torch.float32
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
    tmask = torch.ones(chunk, chunk, dtype=torch.bool,
                       device=x.device).tril()
    # the mask goes in before the exp: exp(-inf) is the 0 that masks, and
    # the gradient stays finite where an unmasked exp(s_t - s_tau) of a
    # future tau would overflow (0 * inf in autograd, the reference's
    # where(mask, exp(diff), 0))
    decay = torch.exp(torch.where(tmask, cs[..., :, None] - cs[..., None, :],
                                  -torch.inf))
    M = (Cc @ Bc.transpose(-1, -2)) * decay * dtc[..., None, :]
    y = M @ xc                                               # b h c L dh
    last = cs[..., -1]                                       # b h c
    w_in = dtc * torch.exp(last[..., None] - cs)
    upd = Bc.transpose(-1, -2) @ (xc * w_in[..., None])      # b h c n dh
    state = torch.zeros(b, h, n, dh, dtype=f32, device=x.device)
    for c in range(nch):
        y[:, :, c] += torch.exp(cs[:, :, c])[..., None] * (Cc[:, :, c]
                                                            @ state)
        state = torch.exp(last[:, :, c])[..., None, None] * state \
            + upd[:, :, c]
    y = y.permute(0, 2, 3, 1, 4).reshape(b, t + pad, h, dh)[:, :t]
    return y.to(x.dtype)
