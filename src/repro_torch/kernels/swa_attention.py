"""Sliding-window attention: the launch of the CUDA kernel of
``csrc/swa_attention.cu`` and its plain PyTorch version (the torch
counterpart of the reference's ``kernels/swa_attention.py``).

q (B, Hq, Tq, Dh); k, v (B, Hkv, Tk, Dh) with Hq % Hkv == 0 (GQA: query
head h reads kv head ``h // (Hq // Hkv)``).  Query row t sits at position
``q_offset + t``, key j at position j; a query attends to the keys in
``(pos - window, pos]`` when causal, to those after ``pos - window``
otherwise.  Scores are float32 ``(q . k) / sqrt(Dh)``, masked to ``-1e30``
as in the reference (``swa_attention.py:29``), normalised with the
reference's ``max(l, 1e-30)`` floor (:74); the output is in q's type.  A
query with no key in its window gets 0.

Replaces the reference's Pallas kernel ``_swa_kernel``
(``src/repro/kernels/swa_attention.py:32``, pallas_call :102); the note in
``csrc/swa_attention.cu`` gives the design.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.build import check, library, stream

NEG_INF = -1e30
MAX_HEAD_DIM = 128          # the kernel keeps 8 output columns per thread
QUERY_TILE = 64             # query rows per CTA (BQ in the kernel)
# float32 score elements per chunk of queries in the plain version
_PLAIN_CHUNK_ELEMS = 1 << 26


def launch_swa_attention(q, k, v, out, *, window: int, causal: bool,
                         q_offset: int, scale: float):
    """The kernel on contiguous q, k, v and ``out`` (like q), all float32
    or all bf16."""
    B, Hq, Tq, Dh = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    check("swa_attention_fwd", library().lib.swa_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Hq,
        Hkv, Tq, Tk, Dh, window, int(causal), q_offset, scale,
        int(q.dtype == torch.bfloat16), stream(out)))


def swa_attention_plain(q, k, v, *, window: int, causal: bool = True,
                        q_offset: int = 0):
    """Plain version: a float32 masked softmax taken over chunks of
    queries.  Each chunk meets only the keys its window can reach, and the
    query heads of one kv head are stacked as rows of one product, so no
    copy of K or V per query head is made and memory stays bounded at long
    T.  Same masking, mask value and normaliser floor as the kernel."""
    B, Hq, Tq, Dh = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    rep = Hq // Hkv
    scale = 1.0 / Dh ** 0.5
    out = torch.empty_like(q)
    span = min(Tk, window + 1024)       # keys a chunk meets, about
    chunk = max(1, min(Tq, _PLAIN_CHUNK_ELEMS // (B * Hq * span)))
    for c0 in range(0, Tq, chunk):
        c1 = min(Tq, c0 + chunk)
        lo = max(0, q_offset + c0 - window + 1)
        hi = min(Tk, q_offset + c1) if causal else Tk
        if hi <= lo:
            out[:, :, c0:c1] = 0
            continue
        qc = q[:, :, c0:c1].float().reshape(B, Hkv, rep * (c1 - c0), Dh)
        kc = k[:, :, lo:hi].float()
        vc = v[:, :, lo:hi].float()
        s = (qc @ kc.transpose(-1, -2)) * scale
        qpos = torch.arange(q_offset + c0, q_offset + c1,
                            device=q.device)[:, None]
        kpos = torch.arange(lo, hi, device=q.device)[None, :]
        ok = kpos > qpos - window
        if causal:
            ok &= kpos <= qpos
        s = s.view(B, Hkv, rep, c1 - c0, hi - lo).masked_fill(~ok, NEG_INF)
        p = torch.exp(s - s.amax(dim=-1, keepdim=True))
        l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
        o = (p.view(B, Hkv, rep * (c1 - c0), hi - lo) @ vc).view(
            B, Hkv, rep, c1 - c0, Dh) / l
        o = torch.where(ok.any(dim=-1)[:, None], o, 0.0)
        out[:, :, c0:c1] = o.reshape(B, Hq, c1 - c0, Dh).to(q.dtype)
    return out
