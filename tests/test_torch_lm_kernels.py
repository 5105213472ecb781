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
  1e-5 of the reference's.

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
