"""The port's LM kernels against the JAX reference (CPU, small sizes).

Inputs are made with numpy from a seed and handed to both packages.  On
CPU tensors ``ops.swa_attention`` and ``ops.ssd_scan`` run their plain
versions, which are held against the reference's Pallas kernels in
interpret mode, at the tolerances of the reference's own kernel tests
(``tests/test_kernels.py``):

- ``swa_attention`` within 2e-5 (3e-2 in bf16) of the reference's
  ``ops.swa_attention(interpret=True, bq=64, bk=64)`` wherever that call
  is right: causal, or Tk a multiple of 64.  With ``causal=False`` and a
  ragged Tk the reference's padded call attends to the zero keys it pads
  on (ROADMAP, faults of the reference), so there the port is held
  against ``swa_attention_ref``;
- ``ssd_scan`` within rtol 2e-4, atol 2e-5 of the reference's
  ``ops.ssd_scan(interpret=True)``;
- the port's oracles ``swa_attention_ref`` and ``ssd_scan_ref`` within
  1e-5 of the reference's;
- ``swa_route``, the choice between the three attention routes on the
  card, by dtype, head size and alignment, or its refusal;
- the packed route's arithmetic: the plain version on q, k, v zero-padded
  to ``packed_row(Dh)`` columns at the scale of the true Dh equals the
  unpadded call and the reference's oracle;
- the float32 kernel's arithmetic (split TF32), emulated here bit for bit
  per operand: within the float32 tolerance of a float64 attention, where
  plain TF32 is not.

The CUDA kernels themselves run only on the card (``chip_smoke.py``,
phases 3l and 7).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import swa_attention as tswa

SWA_TOL = dict(rtol=2e-5, atol=2e-5)
BF16_TOL = dict(rtol=3e-2, atol=3e-2)
SSD_TOL = dict(rtol=2e-4, atol=2e-5)
ORACLE_TOL = dict(rtol=1e-5, atol=1e-5)


def _close(got, want, tol, name=""):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), err_msg=name,
                               **tol)


def _both(*arrays):
    """The same numpy arrays as JAX arrays and as torch tensors."""
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays])


def _attn_inputs(B, Hq, Hkv, Tq, Tk, Dh, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, (B, Hq, Tq, Dh)).astype(np.float32),
            rng.normal(0, 1, (B, Hkv, Tk, Dh)).astype(np.float32),
            rng.normal(0, 1, (B, Hkv, Tk, Dh)).astype(np.float32))


def _ssd_inputs(b, t, h, dh, n, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (b, t, h, dh)).astype(np.float32)
    dt = (np.abs(rng.normal(0, 0.1, (b, t, h))) + 0.01).astype(np.float32)
    A = -np.abs(rng.normal(1, 0.3, (h,))).astype(np.float32)
    B = (rng.normal(0, 1, (b, t, n)) / np.sqrt(n)).astype(np.float32)
    C = (rng.normal(0, 1, (b, t, n)) / np.sqrt(n)).astype(np.float32)
    return x, dt, A, B, C


# --------------------------------------------------------- swa_attention --


@pytest.mark.parametrize("B,Hq,Hkv,Tq,Tk,Dh,window", [
    (1, 2, 2, 256, 256, 64, 128),     # MHA
    (2, 4, 2, 256, 256, 64, 64),      # GQA
    (1, 8, 1, 128, 128, 32, 1024),    # MQA, window > T (= full causal)
    (1, 2, 1, 100, 100, 64, 50),      # ragged
])
def test_swa_matches_reference(B, Hq, Hkv, Tq, Tk, Dh, window):
    j, t = _both(*_attn_inputs(B, Hq, Hkv, Tq, Tk, Dh, seed=Tq))
    want = jops.swa_attention(*j, window=window, interpret=True, bq=64,
                              bk=64)
    got = ops.swa_attention(*t, window=window)
    assert got.dtype == torch.float32 and got.shape == t[0].shape
    _close(got, want, SWA_TOL)


# The shapes at the edges of the tensor-core kernel's tiling (128 queries
# per CTA in two warpgroups of 64, kv tiles of 64): Tq and Tk ragged to
# both, windows narrower and wider than a kv tile, GQA 4, Dh 40 (a wgmma
# depth padded to 48) to 128, an offset with Tq != Tk; chip_smoke phase 3l
# holds the kernel to the plain version at the same shapes.
# (B, Hq, Hkv, Tq, Tk, Dh, window, q_offset)
TILE_EDGES = [(1, 8, 2, 200, 200, 112, 1, 0),
              (1, 4, 1, 200, 200, 64, 63, 0),
              (1, 4, 1, 200, 200, 112, 65, 0),
              (1, 4, 1, 300, 300, 128, 127, 0),
              (1, 4, 1, 257, 321, 40, 1000, 64)]


@pytest.mark.parametrize("B,Hq,Hkv,Tq,Tk,Dh,window,q_offset", TILE_EDGES)
def test_swa_plain_at_tile_edges_matches_reference(B, Hq, Hkv, Tq, Tk, Dh,
                                                   window, q_offset):
    j, t = _both(*_attn_inputs(B, Hq, Hkv, Tq, Tk, Dh, seed=Tq + window))
    kw = dict(window=window, q_offset=q_offset)
    want = jops.swa_attention(*j, **kw, interpret=True, bq=64, bk=64)
    _close(ops.swa_attention(*t, **kw), want, SWA_TOL)


def test_swa_plain_decode_and_ragged_noncausal_at_kernel_shapes():
    """chip_smoke's decode case (Tq 8 at the end of 4,096 keys, Dh 112)
    against the reference's kernel, and its non-causal case with Tq 130 !=
    Tk 190 against the reference's oracle (its padded call attends to the
    zero keys past a ragged Tk)."""
    j, t = _both(*_attn_inputs(2, 8, 2, 8, 4096, 112, seed=11))
    kw = dict(window=4096, q_offset=4088)
    want = jops.swa_attention(*j, **kw, interpret=True, bq=8, bk=512)
    _close(ops.swa_attention(*t, **kw), want, SWA_TOL)
    j, t = _both(*_attn_inputs(1, 4, 1, 130, 190, 112, seed=12))
    kw = dict(window=50, causal=False)
    _close(ops.swa_attention(*t, **kw), jref.swa_attention_ref(*j, **kw),
           SWA_TOL)


def test_swa_plain_rows_without_keys_next_to_rows_with_keys():
    """chip_smoke's all-masked rows: positions 30..45 over 32 keys with a
    window of 4; rows at 35 and later see no key and get 0, the others
    match the reference's kernel."""
    j, t = _both(*_attn_inputs(1, 4, 1, 16, 32, 64, seed=13))
    kw = dict(window=4, q_offset=30)
    got = ops.swa_attention(*t, **kw)
    want = jops.swa_attention(*j, **kw, interpret=True, bq=16, bk=32)
    _close(got[:, :, :5], np.asarray(want)[:, :, :5], SWA_TOL)
    assert torch.equal(got[:, :, 5:], torch.zeros_like(got[:, :, 5:]))


@pytest.mark.parametrize("Dh", [1, 30, 33, 127])
def test_swa_plain_on_packed_rows_matches_unpadded_and_reference(Dh):
    """The packed route's arithmetic: q, k, v zero-padded from Dh to
    ``packed_row(Dh)`` columns (the rows the tensor-core kernel reads,
    its columns past Dh read as zeros) at the scale of the true Dh give
    the unpadded call in the first Dh columns and zeros past them, and
    match the reference's oracle."""
    ld = tswa.packed_row(Dh)
    assert ld % 8 == 0 and Dh <= ld < Dh + 8
    arrays = _attn_inputs(1, 4, 2, 150, 150, Dh, seed=Dh)
    j, t = _both(*arrays)
    kw = dict(window=64, q_offset=0)
    padded = [torch.nn.functional.pad(a, (0, ld - Dh)) for a in t]
    got = tswa.swa_attention_plain(*padded, **kw, scale=1.0 / Dh ** 0.5)
    assert got.shape == (1, 4, 150, ld)
    assert torch.equal(got[..., Dh:], torch.zeros_like(got[..., Dh:]))
    _close(got[..., :Dh], tswa.swa_attention_plain(*t, **kw), ORACLE_TOL)
    _close(got[..., :Dh], jref.swa_attention_ref(*j, **kw), SWA_TOL)


@pytest.mark.parametrize("dtype,head_dim,aligned,route", [
    (torch.bfloat16, 112, True, "tensor_cores"),
    (torch.bfloat16, 128, True, "tensor_cores"),
    (torch.bfloat16, 40, True, "tensor_cores"),
    (torch.bfloat16, 8, True, "tensor_cores"),
    # bf16 off the in-place tensor-core kernel took the CUDA-core kernel
    # until the packed route came; these cases keep the ids they had then
    # (the route they assert is the 4th value)
    pytest.param(torch.bfloat16, 36, True, "packed",     # not a multiple
                 id="dtype4-36-True-cuda_cores"),        # of 8
    pytest.param(torch.bfloat16, 112, False, "packed",   # no 16-byte
                 id="dtype5-112-False-cuda_cores"),      # tensor map
    # float32 took the CUDA-core kernel until the split-TF32 kernel came;
    # these two cases keep the ids they had then, as a test whose check
    # rightly changes keeps its name (the route they assert is the 4th value)
    pytest.param(torch.float32, 112, True, "tf32x3",
                 id="dtype6-112-True-cuda_cores"),
    pytest.param(torch.float32, 1, True, "tf32x3",
                 id="dtype7-1-True-cuda_cores"),
    (torch.bfloat16, 136, True, ValueError),       # past both kernels
    (torch.float32, 0, True, ValueError),
    (torch.float16, 64, True, TypeError),
    # the float32 route's edges: every head size up to 128, any alignment
    (torch.float32, 112, False, "tf32x3"),          # 4-byte copies
    (torch.float32, 36, True, "tf32x3"),            # depth padded to 48
    (torch.float32, 8, True, "tf32x3"),
    (torch.float32, 128, True, "tf32x3"),
    (torch.float32, 129, True, ValueError),
    pytest.param(torch.bfloat16, 8, False, "packed",
                 id="dtype16-8-False-cuda_cores"),
    # the packed route's head sizes: any up to 128, odd ones too
    (torch.bfloat16, 1, True, "packed"),
    (torch.bfloat16, 33, True, "packed"),
    (torch.bfloat16, 127, True, "packed"),
    (torch.bfloat16, 128, False, "packed"),
])
def test_swa_route_picks_the_kernel_or_raises(dtype, head_dim, aligned,
                                              route):
    if isinstance(route, str):
        assert tswa.swa_route(dtype, head_dim, aligned) == route
    else:
        with pytest.raises(route):
            tswa.swa_route(dtype, head_dim, aligned)


def _tf32(x):
    """float32 -> TF32 (10 mantissa bits) rounded to nearest, ties away
    from zero, on the bits as the kernel does it (cvt.rna.tf32)."""
    b = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    b = (b + 0x1000) & 0xFFFFE000
    return torch.where(b >= 2 ** 31, b - 2 ** 32, b).to(torch.int32).view(
        torch.float32)


def _toward_zero(x):
    """float64 -> float32 rounded toward zero."""
    f = x.float()
    return torch.where(f.double().abs() > x.abs(),
                       torch.nextafter(f, torch.zeros_like(f)), f)


def _mm_tf32(a, b, split):
    """a (m, k) @ b (k, n) of float32 as ``swa_attention_tf32x3.cu`` chains
    its mma.sync m16n8k8 steps: per 8-deep step, lo*hi, hi*lo and hi*hi of
    the split operands (plain TF32: hi*hi alone), one after the other into
    one float32 accumulator.  Each mma is modelled as the exact sum of its
    8 products and the accumulator, truncated toward zero to float32, as
    the tensor core's accumulator does not round to nearest.  The finer
    detail of the hardware's sum (how it aligns the addends) is not
    modelled: only the card shows it (chip_smoke.py, phases 3l and 7)."""
    pad = -a.shape[1] % 8
    a = torch.nn.functional.pad(a, (0, pad))
    b = torch.nn.functional.pad(b, (0, 0, 0, pad))
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    terms = [(al, bh), (ah, bl), (ah, bh)] if split else [(ah, bh)]
    acc = torch.zeros(a.shape[0], b.shape[1], dtype=torch.float32)
    for k0 in range(0, a.shape[1], 8):
        for x, y in terms:
            acc = _toward_zero(acc.double() + x[:, k0:k0 + 8].double()
                               @ y[k0:k0 + 8].double())
    return acc


def _attend(q, k, v, qpos, mm):
    """Causal attention of rows at positions ``qpos`` over all of k, v:
    (scores, output), products by ``mm``, the rest in q's type."""
    ok = torch.arange(k.shape[0])[None, :] <= qpos[:, None]
    s = mm(q, k.t()) / q.shape[1] ** 0.5
    p = torch.exp(s.masked_fill(~ok, -1e30)
                  - s.masked_fill(~ok, -1e30).amax(-1, keepdim=True))
    p = p * ok
    return s, mm(p, v) / p.sum(-1, keepdim=True)


@pytest.mark.parametrize("keys", [64, 4096])
@pytest.mark.parametrize("Dh", [112, 36])
def test_split_tf32_holds_the_float32_tolerance(Dh, keys):
    """The float32 kernel's products in split TF32 (three TF32 products per
    float32 product, chained mma steps with a truncating accumulator) give
    Q K^T and the attention output within SWA_TOL of float64, over one
    64-key tile and over a 4,096-key causal row (16 query rows, a warp's
    share, at the end of the keys); plain TF32 (one product) does not, so
    the split is what holds the gate."""
    rng = np.random.default_rng(Dh + keys)
    q, k, v = (torch.from_numpy(rng.normal(0, 1, (n, Dh)).astype(np.float32))
               for n in (16, keys, keys))
    qpos = torch.arange(keys - 16, keys)
    s64, o64 = _attend(q.double(), k.double(), v.double(), qpos,
                       lambda a, b: a @ b)
    s3, o3 = _attend(q, k, v, qpos, lambda a, b: _mm_tf32(a, b, True))
    s1, o1 = _attend(q, k, v, qpos, lambda a, b: _mm_tf32(a, b, False))
    ok = torch.arange(keys)[None, :] <= qpos[:, None]
    _close(s3[ok], s64[ok].numpy(), SWA_TOL, "split TF32 scores")
    _close(o3, o64.numpy(), SWA_TOL, "split TF32 output")
    for got, want in ((s1[ok], s64[ok]), (o1, o64)):
        assert not np.allclose(got.numpy(), want.numpy(), **SWA_TOL)


def test_swa_decode_offset():
    """Decode: 8 query rows at the end of a 512-key cache."""
    j, t = _both(*_attn_inputs(2, 4, 2, 8, 512, 64, seed=5))
    want = jops.swa_attention(*j, window=256, q_offset=504, interpret=True,
                              bq=8, bk=128)
    _close(ops.swa_attention(*t, window=256, q_offset=504), want, SWA_TOL)


def test_swa_bf16():
    q, k, v = _attn_inputs(1, 2, 2, 128, 128, 64, seed=7)
    j = [jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v)]
    t = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)]
    want = jops.swa_attention(*j, window=64, interpret=True, bq=64, bk=64)
    got = ops.swa_attention(*t, window=64)
    assert got.dtype == torch.bfloat16
    _close(got, np.asarray(want, np.float32), BF16_TOL)


@pytest.mark.parametrize("T", [128, 100])
def test_swa_not_causal(T):
    """Where Tk is a multiple of 64 the reference's call is right; where
    it is not, that call attends to its zero padding and the port follows
    the oracle."""
    j, t = _both(*_attn_inputs(1, 2, 2, T, T, 32, seed=T + 1))
    kw = dict(window=50, causal=False)
    got = ops.swa_attention(*t, **kw)
    oracle = jref.swa_attention_ref(*j, **kw)
    _close(got, oracle, SWA_TOL)
    padded = jops.swa_attention(*j, **kw, interpret=True, bq=64, bk=64)
    if T % 64 == 0:
        _close(got, padded, SWA_TOL)
    else:
        assert np.abs(np.asarray(padded) - np.asarray(oracle)).max() > 0.1


@pytest.mark.parametrize("tq_tiles,win_frac,hq", [
    (1, 0.1, 1), (2, 0.5, 2), (3, 2.0, 4), (2, 1.0, 4)])
def test_swa_windows(tq_tiles, win_frac, hq):
    """The reference's property cases (``test_swa_property``) at fixed
    draws."""
    T = 64 * tq_tiles
    window = max(1, int(win_frac * T))
    j, t = _both(*_attn_inputs(1, hq, 1, T, T, 32, seed=T + hq))
    want = jops.swa_attention(*j, window=window, interpret=True, bq=64,
                              bk=64)
    _close(ops.swa_attention(*t, window=window), want,
           dict(rtol=3e-5, atol=3e-5))


def test_swa_plain_chunks_and_empty_windows(monkeypatch):
    """The plain version gives the same result however it chunks the
    queries, and 0 for a query with no key in its window.

    The reference differs on such a query, and in two ways: its oracle
    softmaxes scores that are all -1e30 and so gives the mean of all of V
    (asserted below), while its Pallas kernel gives the mean of V over the
    masked keys of the tiles it visits, which depends on its tile size
    and padding.  The port's 0 follows neither, by design."""
    j, t = _both(*_attn_inputs(1, 4, 2, 40, 48, 16, seed=3))
    whole = ops.swa_attention(*t, window=9, q_offset=8)
    monkeypatch.setattr(tswa, "_PLAIN_CHUNK_ELEMS", 1)   # one query each
    rows = ops.swa_attention(*t, window=9, q_offset=8)
    _close(rows, whole.numpy(), dict(rtol=1e-6, atol=1e-6))
    _close(whole, tref.swa_attention_ref(*t, window=9, q_offset=8).numpy(),
           SWA_TOL)
    late = ops.swa_attention(*t, window=9, q_offset=100)   # all past Tk
    assert torch.equal(late, torch.zeros_like(late))
    v_mean = t[2].mean(dim=2, keepdim=True).repeat_interleave(2, dim=1)
    _close(jref.swa_attention_ref(*j, window=9, q_offset=100),
           v_mean.expand_as(late).numpy(), SWA_TOL)


# -------------------------------------------------------------- ssd_scan --


@pytest.mark.parametrize("b,t,h,dh,n,chunk", [
    (1, 128, 2, 32, 16, 64),
    (2, 256, 3, 32, 16, 64),
    (1, 100, 2, 16, 8, 32),     # ragged -> padding
    (1, 512, 1, 64, 32, 128),
])
def test_ssd_matches_reference(b, t, h, dh, n, chunk):
    j, tt = _both(*_ssd_inputs(b, t, h, dh, n, seed=t))
    want = jops.ssd_scan(*j, chunk=chunk, interpret=True)
    got = ops.ssd_scan(*tt, chunk=chunk)
    assert got.dtype == torch.float32 and got.shape == tt[0].shape
    _close(got, want, SSD_TOL)
    _close(got, jref.ssd_scan_ref(*j), SSD_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_many_chunks_matches_reference(dtype):
    """64 chunks of 64 (t 4,096): the chunk states' recurrence that the
    card's kernels run as a launch of its own, over many chunks; bf16 x
    within the bf16 tolerance."""
    x, dt, A, B, C = _ssd_inputs(1, 4096, 2, 16, 8, seed=41)
    j, tt = _both(x, dt, A, B, C)
    if dtype == "bfloat16":
        j[0], tt[0] = j[0].astype(jnp.bfloat16), tt[0].to(torch.bfloat16)
    want = jops.ssd_scan(*j, chunk=64, interpret=True)
    got = ops.ssd_scan(*tt, chunk=64)
    assert got.dtype == tt[0].dtype and got.shape == tt[0].shape
    _close(got, np.asarray(want, np.float32),
           SSD_TOL if dtype == "float32" else BF16_TOL)


@pytest.mark.parametrize("b,t,h,dh,n,chunk", [
    (1, 250, 2, 48, 24, 100),   # a chunk that 64-row tiles do not divide
    (2, 130, 2, 160, 16, 64),   # dh past two tiles of 64, ragged t, b 2
    (1, 256, 1, 128, 128, 128),  # n = dh = 128
])
def test_ssd_kernel_tile_edges_match_reference(b, t, h, dh, n, chunk):
    """Shapes at the edges of the card's 64 x 64 tiles (chip_smoke phase
    3l holds the kernels to the plain version there)."""
    j, tt = _both(*_ssd_inputs(b, t, h, dh, n, seed=t + dh))
    want = jops.ssd_scan(*j, chunk=chunk, interpret=True)
    _close(ops.ssd_scan(*tt, chunk=chunk), want, SSD_TOL)


@pytest.mark.parametrize("chunks,h,decay", [(1, 1, 0.1), (2, 3, 3.0),
                                            (4, 2, 1.0)])
def test_ssd_decays(chunks, h, decay):
    """The reference's property cases (``test_ssd_property``) at fixed
    draws."""
    t = 64 * chunks
    x, dt, A, B, C = _ssd_inputs(1, t, h, 16, 8, seed=chunks * 7 + h)
    j, tt = _both(x, dt, A * np.float32(decay), B, C)
    want = jops.ssd_scan(*j, chunk=64, interpret=True)
    _close(ops.ssd_scan(*tt, chunk=64), want, dict(rtol=3e-4, atol=3e-5))


def test_ssd_state_decay_invariant():
    """With A -> -inf (total decay) each position only sees itself."""
    x, dt, A, B, C = _ssd_inputs(1, 128, 1, 16, 8, seed=3)
    A = np.full_like(A, -1e4)
    _, tt = _both(x, dt, A, B, C)
    y = ops.ssd_scan(*tt, chunk=64)
    want = np.einsum("btn,bth,btn,bthd->bthd", C, dt, B, x)
    _close(y, want, dict(rtol=1e-4, atol=1e-5))


def test_ssd_default_chunk_and_bf16():
    """``chunk=None`` picks the reference's default; bf16 x gives bf16 y
    within the bf16 tolerance of the reference's call."""
    x, dt, A, B, C = _ssd_inputs(1, 200, 2, 32, 16, seed=8)
    j, tt = _both(x, dt, A, B, C)
    _close(ops.ssd_scan(*tt), jops.ssd_scan(*j, interpret=True), SSD_TOL)
    jb = [j[0].astype(jnp.bfloat16)] + j[1:]
    tb = [tt[0].to(torch.bfloat16)] + tt[1:]
    got = ops.ssd_scan(*tb, chunk=64)
    assert got.dtype == torch.bfloat16
    want = jops.ssd_scan(*jb, chunk=64, interpret=True)
    _close(got, np.asarray(want, np.float32), BF16_TOL)


# --------------------------------------------------------------- oracles --


@pytest.mark.parametrize("causal,q_offset", [(True, 0), (True, 30),
                                             (False, 0)])
def test_swa_oracle_matches_reference(causal, q_offset):
    j, t = _both(*_attn_inputs(2, 4, 2, 24, 56, 16, seed=9))
    kw = dict(window=17, causal=causal, q_offset=q_offset)
    _close(tref.swa_attention_ref(*t, **kw), jref.swa_attention_ref(*j, **kw),
           ORACLE_TOL)


def test_ssd_oracle_matches_reference():
    j, t = _both(*_ssd_inputs(2, 70, 3, 8, 4, seed=10))
    _close(tref.ssd_scan_ref(*t), jref.ssd_scan_ref(*j), ORACLE_TOL)


# -------------------------------------------------------------- wrappers --


def test_lm_wrappers_refuse_bad_inputs_and_launch_nothing_on_cpu():
    _, (q, k, v) = _both(*_attn_inputs(1, 4, 2, 16, 16, 8))
    before = ops.launch_counts()
    with pytest.raises(TypeError, match="float32 or all bf16"):
        ops.swa_attention(q, k.double(), v, window=4)
    with pytest.raises(ValueError, match="Hq % Hkv"):
        ops.swa_attention(q[:, :3], k, v, window=4)
    with pytest.raises(ValueError, match="window"):
        ops.swa_attention(q, k, v, window=0)
    with pytest.raises(ValueError, match="devices"):
        ops.swa_attention(q, k.to("meta"), v, window=4)
    _, (x, dt, A, B, C) = _both(*_ssd_inputs(1, 16, 2, 8, 4))
    with pytest.raises(ValueError, match="dt must be"):
        ops.ssd_scan(x, dt[:, :-1], A, B, C)
    with pytest.raises(TypeError, match="x must be"):
        ops.ssd_scan(x.double(), dt, A, B, C)
    with pytest.raises(ValueError, match="chunk"):
        ops.ssd_scan(x, dt, A, B, C, chunk=-1)
    assert ops.launch_counts() == before
