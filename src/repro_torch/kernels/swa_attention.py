"""Sliding-window attention: the launches of its CUDA kernels, the choice
between its routes, and its plain PyTorch version (the torch counterpart
of the reference's ``kernels/swa_attention.py``).

q (B, Hq, Tq, Dh); k, v (B, Hkv, Tk, Dh) with Hq % Hkv == 0 (GQA: query
head h reads kv head ``h // (Hq // Hkv)``).  Query row t sits at position
``q_offset + t``, key j at position j; a query attends to the keys in
``(pos - window, pos]`` when causal, to those after ``pos - window``
otherwise.  Scores are float32 ``(q . k) / sqrt(Dh)``, masked to ``-1e30``
as in the reference (``swa_attention.py:29``), normalised with the
reference's ``max(l, 1e-30)`` floor (:74); the output is in q's type.  A
query with no key in its window gets 0.

Replaces the reference's Pallas kernel ``_swa_kernel``
(``src/repro/kernels/swa_attention.py:32``, pallas_call :102) by three
routes (``swa_route``):

- ``"tf32x3"``: float32 q, k, v (any Dh up to 128, any alignment),
  ``csrc/swa_attention_tf32x3.cu`` (split TF32: three mma.sync TF32
  products per float32 product);
- ``"tensor_cores"``: bf16 q, k, v with Dh a multiple of 8 and 16-byte
  aligned data, read in place by ``csrc/swa_attention_tc.cu`` (wgmma
  products, TMA ring);
- ``"packed"``: bf16 with another Dh or alignment:
  ``csrc/swa_attention.cu`` packs q, k, v into a 16-byte-aligned
  workspace of rows of ``packed_row(Dh)`` elements and runs the same
  tensor-core kernel there, with the scale of the true Dh.

Each kernel's note gives its design.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.build import check, library, stream

NEG_INF = -1e30
MAX_HEAD_DIM = 128          # the kernels' widest head
# query rows per CTA of each route's kernel
QUERY_TILES = {"tf32x3": 128, "tensor_cores": 128, "packed": 128}
TC_HEAD_DIM_STEP = 8        # the tensor map's rows are 16-byte multiples
# float32 score elements per chunk of queries in the plain version
_PLAIN_CHUNK_ELEMS = 1 << 26


def swa_route(dtype, head_dim: int, aligned: bool = True) -> str:
    """The route that takes attention of ``dtype`` and head size
    ``head_dim`` on the card: ``"tf32x3"`` for float32 (its copies fall to
    4-byte ones for a Dh that is not a multiple of 4 or unaligned data, so
    ``aligned`` does not matter there); for bf16 ``"tensor_cores"`` with a
    head size that is a multiple of 8 and 16-byte-aligned q, k, v
    (``aligned``), else ``"packed"``.  Raises ``ValueError`` for a head
    size that no kernel takes and ``TypeError`` for another dtype."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the SWA kernels take float32 or bf16, got {dtype}")
    if not 1 <= head_dim <= MAX_HEAD_DIM:
        raise ValueError(f"the SWA kernels take 1 <= Dh <= {MAX_HEAD_DIM}, "
                         f"got {head_dim}")
    if dtype == torch.float32:
        return "tf32x3"
    if head_dim % TC_HEAD_DIM_STEP == 0 and aligned:
        return "tensor_cores"
    return "packed"


def packed_row(head_dim: int) -> int:
    """Elements per row of the packed route's workspace: ``head_dim``
    rounded up to a multiple of 8 (16 bytes of bf16)."""
    return -(-head_dim // TC_HEAD_DIM_STEP) * TC_HEAD_DIM_STEP


def launch_swa_attention(q, k, v, out, *, window: int, causal: bool,
                         q_offset: int, scale: float):
    """The packed route on contiguous bf16 q, k, v (any head size up to
    128, any even address) and ``out`` (like q, 16-byte aligned): one pack
    launch copies q, k, v into a workspace of rows of ``packed_row(Dh)``
    elements that ``torch.empty`` allocates here, then the tensor-core
    kernel runs on it."""
    B, Hq, Tq, Dh = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    ws = torch.empty((B * Hq * Tq + 2 * B * Hkv * Tk) * packed_row(Dh),
                     dtype=q.dtype, device=q.device)
    check("swa_attention_fwd", library().lib.swa_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        ws.data_ptr(), B, Hq, Hkv, Tq, Tk, Dh, window, int(causal),
        q_offset, scale, stream(out)))


def launch_swa_attention_tc(q, k, v, out, *, window: int, causal: bool,
                            q_offset: int, scale: float):
    """The tensor-core kernel on contiguous, 16-byte-aligned bf16 q, k, v
    and ``out`` (like q), Dh a multiple of 8, read in place (row stride
    Dh)."""
    B, Hq, Tq, Dh = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    check("swa_attention_tc_fwd", library().lib.swa_attention_tc_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Hq,
        Hkv, Tq, Tk, Dh, Dh, window, int(causal), q_offset, scale,
        stream(out)))


def launch_swa_attention_tf32x3(q, k, v, out, *, window: int,
                                causal: bool, q_offset: int, scale: float):
    """The split-TF32 tensor-core kernel on contiguous float32 q, k, v and
    ``out`` (like q)."""
    B, Hq, Tq, Dh = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    check("swa_attention_tf32x3_fwd",
          library().lib.swa_attention_tf32x3_fwd(
              q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B,
              Hq, Hkv, Tq, Tk, Dh, window, int(causal), q_offset, scale,
              stream(out)))


def swa_attention_plain(q, k, v, *, window: int, causal: bool = True,
                        q_offset: int = 0, scale: float | None = None):
    """Plain version: a float32 masked softmax taken over chunks of
    queries.  Each chunk meets only the keys its window can reach, and the
    query heads of one kv head are stacked as rows of one product, so no
    copy of K or V per query head is made and memory stays bounded at long
    T.  Same masking, mask value and normaliser floor as the kernel.
    ``scale`` defaults to ``1 / sqrt(Dh)``; the packed route computes this
    call on q, k, v zero-padded to ``packed_row(Dh)`` columns at the scale
    of the true Dh."""
    B, Hq, Tq, Dh = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    rep = Hq // Hkv
    if scale is None:
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
