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


def _ptr(t):
    return None if t is None else t.data_ptr()


def launch_swa_attention(q, k, v, out, *, window: int, causal: bool,
                         q_offset: int, scale: float, lse=None):
    """The packed route on contiguous bf16 q, k, v (any head size up to
    128, any even address) and ``out`` (like q, 16-byte aligned): one pack
    launch copies q, k, v into a workspace of rows of ``packed_row(Dh)``
    elements that ``torch.empty`` allocates here, then the tensor-core
    kernel runs on it.  ``lse``: None, or (B, Hq, Tq) float32 that the
    kernel fills with the rows' logsumexp (for the backward)."""
    B, Hq, Tq, Dh = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    ws = torch.empty((B * Hq * Tq + 2 * B * Hkv * Tk) * packed_row(Dh),
                     dtype=q.dtype, device=q.device)
    check("swa_attention_fwd", library().lib.swa_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        ws.data_ptr(), B, Hq, Hkv, Tq, Tk, Dh, window, int(causal),
        q_offset, scale, _ptr(lse), stream(out)))


def launch_swa_attention_tc(q, k, v, out, *, window: int, causal: bool,
                            q_offset: int, scale: float, lse=None):
    """The tensor-core kernel on contiguous, 16-byte-aligned bf16 q, k, v
    and ``out`` (like q), Dh a multiple of 8, read in place (row stride
    Dh); ``lse`` as ``launch_swa_attention``'s."""
    B, Hq, Tq, Dh = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    check("swa_attention_tc_fwd", library().lib.swa_attention_tc_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Hq,
        Hkv, Tq, Tk, Dh, Dh, window, int(causal), q_offset, scale,
        _ptr(lse), stream(out)))


def launch_swa_attention_tf32x3(q, k, v, out, *, window: int,
                                causal: bool, q_offset: int, scale: float,
                                lse=None):
    """The split-TF32 tensor-core kernel on contiguous float32 q, k, v and
    ``out`` (like q); ``lse`` as ``launch_swa_attention``'s."""
    B, Hq, Tq, Dh = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    check("swa_attention_tf32x3_fwd",
          library().lib.swa_attention_tf32x3_fwd(
              q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B,
              Hq, Hkv, Tq, Tk, Dh, window, int(causal), q_offset, scale,
              _ptr(lse), stream(out)))


def launch_swa_attention_bwd(q, k, v, o, lse, dout, dq, dk, dv, *,
                             window: int, causal: bool, q_offset: int,
                             scale: float):
    """The backward kernels on contiguous q, k, v, the forward's output
    ``o`` and logsumexp ``lse``, the upstream gradient ``dout`` (like q)
    and new dq, dk, dv (like q, k, v), read in place (row stride Dh):
    bf16 (the tensor-core route's data: Dh a multiple of 8, 16-byte
    aligned) on ``csrc/swa_attention_bwd.cu``'s wgmma kernels (three
    launches: D = rowsum(dout o), dq, then dk and dv), float32 on
    ``csrc/swa_attention_bwd_tf32x3.cu``'s split-TF32 ones (two: dq, which
    takes D, then dk and dv).  D goes through a (B, Hq, Tq) float32
    scratch that ``torch.empty`` allocates here."""
    B, Hq, Tq, Dh = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    dsum = torch.empty(B, Hq, Tq, dtype=torch.float32, device=q.device)
    check("swa_attention_bwd", library().lib.swa_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), dsum.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), B, Hq, Hkv, Tq, Tk, Dh, Dh, window,
        int(causal), q_offset, scale, int(q.dtype == torch.bfloat16),
        stream(dq)))


def launch_swa_attention_bwd_packed(q, k, v, o, lse, dout, dq, dk, dv, *,
                                    window: int, causal: bool,
                                    q_offset: int, scale: float):
    """The packed route's backward on contiguous bf16 tensors (any head
    size up to 128, any even address): q, k, v and ``dout`` packed into a
    workspace of rows of ``packed_row(Dh)`` (``torch.empty`` here), the
    bf16 backward kernels on it, the gradients written at Dh."""
    B, Hq, Tq, Dh = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    ws = torch.empty((2 * B * Hq * Tq + 2 * B * Hkv * Tk) * packed_row(Dh),
                     dtype=q.dtype, device=q.device)
    dsum = torch.empty(B, Hq, Tq, dtype=torch.float32, device=q.device)
    check("swa_attention_bwd_packed",
          library().lib.swa_attention_bwd_packed(
              q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
              dout.data_ptr(), lse.data_ptr(), dsum.data_ptr(),
              dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), ws.data_ptr(), B,
              Hq, Hkv, Tq, Tk, Dh, window, int(causal), q_offset, scale,
              stream(dq)))


def _compute_dtype(t):
    """The plain versions' arithmetic for ``t``: float32, or float64 when
    it is float64 (a reference for the float32 and bf16 computations)."""
    return torch.float64 if t.dtype == torch.float64 else torch.float32


def _plain_chunks(B, Hq, Tq, Tk, window):
    """Query chunks of the plain versions: each meets only the keys its
    window can reach, at most ``_PLAIN_CHUNK_ELEMS`` scores a chunk."""
    span = min(Tk, window + 1024)       # keys a chunk meets, about
    chunk = max(1, min(Tq, _PLAIN_CHUNK_ELEMS // (B * Hq * span)))
    return range(0, Tq, chunk), chunk


def _plain_mask(c0, c1, lo, hi, *, window, causal, q_offset, device):
    """(queries c0..c1-1, keys lo..hi-1) -> True where the key is in the
    query's window."""
    qpos = torch.arange(q_offset + c0, q_offset + c1, device=device)[:, None]
    kpos = torch.arange(lo, hi, device=device)[None, :]
    ok = kpos > qpos - window
    if causal:
        ok &= kpos <= qpos
    return ok


def swa_attention_plain(q, k, v, *, window: int, causal: bool = True,
                        q_offset: int = 0, scale: float | None = None,
                        return_lse: bool = False):
    """Plain version: a float32 masked softmax taken over chunks of
    queries.  Each chunk meets only the keys its window can reach, and the
    query heads of one kv head are stacked as rows of one product, so no
    copy of K or V per query head is made and memory stays bounded at long
    T.  Same masking, mask value and normaliser floor as the kernel; in
    float32 (float64 for float64 inputs, a reference for the others).
    ``scale`` defaults to ``1 / sqrt(Dh)``; the packed route computes this
    call on q, k, v zero-padded to ``packed_row(Dh)`` columns at the scale
    of the true Dh.  With ``return_lse`` it returns (out, lse): lse
    (B, Hq, Tq) float32 is each row's logsumexp of its scaled scores, the
    mask value ``NEG_INF`` for a row with no key (what the kernels save
    for their backward)."""
    B, Hq, Tq, Dh = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    rep = Hq // Hkv
    if scale is None:
        scale = 1.0 / Dh ** 0.5
    ct = _compute_dtype(q)
    out = torch.empty_like(q)
    lse = torch.empty(B, Hq, Tq, dtype=ct, device=q.device) \
        if return_lse else None
    starts, chunk = _plain_chunks(B, Hq, Tq, Tk, window)
    for c0 in starts:
        c1 = min(Tq, c0 + chunk)
        lo = max(0, q_offset + c0 - window + 1)
        hi = min(Tk, q_offset + c1) if causal else Tk
        if hi <= lo:
            out[:, :, c0:c1] = 0
            if lse is not None:
                lse[:, :, c0:c1] = NEG_INF
            continue
        qc = q[:, :, c0:c1].to(ct).reshape(B, Hkv, rep * (c1 - c0), Dh)
        kc = k[:, :, lo:hi].to(ct)
        vc = v[:, :, lo:hi].to(ct)
        s = (qc @ kc.transpose(-1, -2)) * scale
        ok = _plain_mask(c0, c1, lo, hi, window=window, causal=causal,
                         q_offset=q_offset, device=q.device)
        s = s.view(B, Hkv, rep, c1 - c0, hi - lo).masked_fill(~ok, NEG_INF)
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - m)
        l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
        o = (p.view(B, Hkv, rep * (c1 - c0), hi - lo) @ vc).view(
            B, Hkv, rep, c1 - c0, Dh) / l
        live = ok.any(dim=-1)
        o = torch.where(live[:, None], o, 0.0)
        out[:, :, c0:c1] = o.reshape(B, Hq, c1 - c0, Dh).to(q.dtype)
        if lse is not None:
            row = torch.where(live, (m + torch.log(l))[..., 0], NEG_INF)
            lse[:, :, c0:c1] = row.reshape(B, Hq, c1 - c0)
    return (out, lse) if return_lse else out


def swa_attention_bwd_plain(q, k, v, o, lse, do, *, window: int,
                            causal: bool = True, q_offset: int = 0,
                            scale: float | None = None):
    """Plain version of the backward kernels: the gradients (dq, dk, dv)
    of ``swa_attention_plain`` for the upstream gradient ``do`` (like q),
    from its output ``o`` and its logsumexp ``lse`` (B, Hq, Tq) float32,
    in the FlashAttention-2 form and with no autograd:

        D  = rowsum(do o)                       (float32, o as saved)
        P  = exp(s - lse) in the window, else 0 (s = scale q k^T)
        dv = P^T do,   dP = do v^T,   dS = P (dP - D)
        dq = scale dS k,   dk = scale dS^T q

    in float32 (float64 for float64 inputs) over the forward's query
    chunks; a kv head's dk and dv sum
    its query heads.  Each gradient comes back in its input's type.  A row
    with no key in its window has P = 0, so its dq is 0 and it adds
    nothing to dk and dv."""
    B, Hq, Tq, Dh = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    rep = Hq // Hkv
    if scale is None:
        scale = 1.0 / Dh ** 0.5
    ct = _compute_dtype(q)
    dq = torch.empty(B, Hq, Tq, Dh, dtype=ct, device=q.device)
    dk = torch.zeros(B, Hkv, Tk, Dh, dtype=ct, device=q.device)
    dv = torch.zeros(B, Hkv, Tk, Dh, dtype=ct, device=q.device)
    D = (do.to(ct) * o.to(ct)).sum(dim=-1)
    starts, chunk = _plain_chunks(B, Hq, Tq, Tk, window)
    for c0 in starts:
        c1 = min(Tq, c0 + chunk)
        n = c1 - c0
        lo = max(0, q_offset + c0 - window + 1)
        hi = min(Tk, q_offset + c1) if causal else Tk
        if hi <= lo:
            dq[:, :, c0:c1] = 0
            continue
        qc = q[:, :, c0:c1].to(ct).reshape(B, Hkv, rep * n, Dh)
        doc = do[:, :, c0:c1].to(ct).reshape(B, Hkv, rep * n, Dh)
        kc = k[:, :, lo:hi].to(ct)
        vc = v[:, :, lo:hi].to(ct)
        ok = _plain_mask(c0, c1, lo, hi, window=window, causal=causal,
                         q_offset=q_offset, device=q.device)
        s = ((qc @ kc.transpose(-1, -2)) * scale).view(B, Hkv, rep, n,
                                                        hi - lo)
        lc = lse[:, :, c0:c1].to(ct).view(B, Hkv, rep, n, 1)
        p = torch.exp((s - lc).masked_fill(~ok, -torch.inf))
        dp = (doc @ vc.transpose(-1, -2)).view(B, Hkv, rep, n, hi - lo)
        ds = p * (dp - D[:, :, c0:c1].view(B, Hkv, rep, n, 1))
        p = p.view(B, Hkv, rep * n, hi - lo)
        ds = ds.view(B, Hkv, rep * n, hi - lo)
        dv[:, :, lo:hi] += p.transpose(-1, -2) @ doc
        dk[:, :, lo:hi] += (ds.transpose(-1, -2) @ qc) * scale
        dq[:, :, c0:c1] = ((ds @ kc) * scale).view(B, Hq, n, Dh)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
