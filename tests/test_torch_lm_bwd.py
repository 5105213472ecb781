"""The plain versions of the LM backward kernels against the JAX reference
(CPU, small sizes, float32 unless stated).

``swa_attention_bwd_plain`` and ``ssd_scan_bwd_plain`` are the explicit
backward algorithms that the CUDA kernels of ``csrc/swa_attention_bwd.cu``
and ``csrc/ssd_scan.cu`` compute (no autograd): they take what the
forwards save (``swa_attention_plain(return_lse=True)``,
``ssd_scan_plain(return_states=True)``).  Inputs are made with numpy from
a seed and handed to both packages.  Tolerances:

- against ``jax.vjp`` of the reference's jnp functions
  (``repro.kernels.ref.swa_attention_ref``, ``repro.models.mamba2.
  ssd_chunked``): within 1e-5 x max(1, max|g|) for every float32
  gradient; a bf16 gradient (B and C given as bf16) within one bf16 ulp
  of its largest element, 2^-7 max|g|, since both sides round the same
  float32 sum to bf16 once;
- against ``torch.autograd`` through the plain forwards: the same bound
  (the two differ only in float32 summation order);
- the logsumexp that the attention forward saves: within 1e-5 of
  ``torch.logsumexp`` of the masked scores, the mask value -1e30 for a
  row with no key;
- past the SSD decay overflow, where the reference's gradient is NaN
  (ROADMAP queue 3), every gradient finite and equal to autograd's.

The kernels run only on the card (``chip_smoke.py``, phases 3l and 7t).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.models import mamba2 as jmamba
from repro_torch.kernels.ssd_scan import ssd_scan_bwd_plain, ssd_scan_plain
from repro_torch.kernels.swa_attention import (NEG_INF,
                                               swa_attention_bwd_plain,
                                               swa_attention_plain)

TOL = 1e-5
BF16_REL = 2.0 ** -7


def _assert_close(got, want, name, tol=TOL):
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    err = float(np.abs(got - want).max()) if got.size else 0.0
    bound = tol * max(1.0, float(np.abs(want).max()) if want.size else 0.0)
    assert err <= bound, (name, err, bound)


def _assert_bf16_close(got, want, name):
    want = np.asarray(want, np.float64)
    err = float(np.abs(got.float().numpy() - want).max())
    assert err <= BF16_REL * float(np.abs(want).max()), (name, err)


def _np(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


# ------------------------------------------------------------- SWA --

# (B, Hq, Hkv, Tq, Tk, Dh, window, causal, q_offset)
SWA_CASES = [
    (2, 4, 2, 40, 40, 16, 40, True, 0),        # GQA 2, full causal
    (1, 4, 1, 37, 37, 8, 9, True, 0),          # GQA 4, window < T
    (2, 2, 2, 5, 29, 16, 12, True, 24),        # a query block at an offset
    (1, 4, 2, 20, 64, 8, 100, False, 0),       # not causal, Tk = 64
    (1, 2, 1, 16, 128, 8, 30, False, 0),       # not causal, window < Tk
    (1, 2, 1, 33, 70, 12, 16, True, 40),       # window < T at an offset
]


def _swa_ids(case):
    return "B{}-Hq{}-Hkv{}-Tq{}-Tk{}-Dh{}-w{}-{}-off{}".format(
        *case[:7], "causal" if case[7] else "full", case[8])


def _swa_inputs(case, seed):
    B, Hq, Hkv, Tq, Tk, Dh = case[:6]
    rng = np.random.default_rng(seed)
    return (_np(rng, B, Hq, Tq, Dh), _np(rng, B, Hkv, Tk, Dh),
            _np(rng, B, Hkv, Tk, Dh), _np(rng, B, Hq, Tq, Dh))


def _swa_plain_bwd(q, k, v, do, kw):
    t = [torch.from_numpy(a) for a in (q, k, v, do)]
    o, lse = swa_attention_plain(*t[:3], **kw, return_lse=True)
    return swa_attention_bwd_plain(*t[:3], o, lse, t[3], **kw)


@pytest.mark.parametrize("case", SWA_CASES, ids=_swa_ids)
def test_swa_bwd_plain_matches_reference_vjp(case):
    window, causal, q_offset = case[6:]
    kw = dict(window=window, causal=causal, q_offset=q_offset)
    q, k, v, do = _swa_inputs(case, 1)
    _, vjp = jax.vjp(lambda a, b, c: jref.swa_attention_ref(a, b, c, **kw),
                     *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(do))
    got = _swa_plain_bwd(q, k, v, do, kw)
    for name, g, w in zip("qkv", got, want):
        assert g.dtype == torch.float32
        _assert_close(g, w, f"d{name}")


def test_swa_bwd_plain_row_without_keys_has_zero_dq():
    """Rows 5.. of a decode block at offset 30 see no key (their windows
    of 4 start past the last of 32 keys): the plain forward's ``where``
    gives them 0 and the backward gives them dq 0 and adds nothing to dk,
    dv; the
    other rows agree with the reference's vjp, whose softmax over an empty
    row (the mask value everywhere) is uniform, so its upstream gradient
    is zeroed there for the comparison."""
    case = (1, 4, 1, 16, 32, 8, 4, True, 30)
    kw = dict(window=4, causal=True, q_offset=30)
    q, k, v, do = _swa_inputs(case, 2)
    rows = 30 + np.arange(16)
    empty = rows - 4 + 1 >= 32                      # window past every key
    assert empty.any() and not empty.all()
    dq, dk, dv = _swa_plain_bwd(q, k, v, do, kw)
    assert torch.all(dq[:, :, torch.from_numpy(empty)] == 0)
    do_live = np.where(empty[None, None, :, None], 0.0, do).astype(
        np.float32)
    _, vjp = jax.vjp(lambda a, b, c: jref.swa_attention_ref(a, b, c, **kw),
                     *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(do_live))
    for name, g, w in zip("qkv", (dq, dk, dv), want):
        _assert_close(g, w, f"d{name}")
    # the empty rows' upstream gradient changes nothing
    again = _swa_plain_bwd(q, k, v, do_live, kw)
    for a, b in zip(again, (dq, dk, dv)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("case", SWA_CASES, ids=_swa_ids)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_swa_bwd_plain_matches_autograd_of_the_plain_forward(case, dtype):
    window, causal, q_offset = case[6:]
    kw = dict(window=window, causal=causal, q_offset=q_offset)
    q, k, v, do = (torch.from_numpy(a).to(dtype)
                   for a in _swa_inputs(case, 3))
    xs = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(swa_attention_plain(*xs, **kw), xs, do)
    o, lse = swa_attention_plain(q, k, v, **kw, return_lse=True)
    got = swa_attention_bwd_plain(q, k, v, o, lse, do, **kw)
    for name, g, w in zip("qkv", got, want):
        assert g.dtype == dtype
        if dtype == torch.bfloat16:
            _assert_bf16_close(g, w.float().numpy(), f"d{name}")
        else:
            _assert_close(g, w.numpy(), f"d{name}")


def test_swa_plain_lse_is_the_masked_logsumexp():
    B, Hq, Hkv, Tq, Tk, Dh = 1, 4, 2, 16, 32, 8
    window, q_offset = 6, 28
    q, k, v, _ = (torch.from_numpy(a) for a in _swa_inputs(
        (B, Hq, Hkv, Tq, Tk, Dh), 4))
    out, lse = swa_attention_plain(q, k, v, window=window,
                                   q_offset=q_offset, return_lse=True)
    assert torch.equal(out, swa_attention_plain(q, k, v, window=window,
                                                q_offset=q_offset))
    kk = k.repeat_interleave(Hq // Hkv, dim=1)
    s = (q @ kk.transpose(-1, -2)) / Dh ** 0.5
    qpos = torch.arange(Tq)[:, None] + q_offset
    kpos = torch.arange(Tk)[None, :]
    ok = (kpos <= qpos) & (kpos > qpos - window)
    live = ok.any(-1)
    assert live.any() and not live.all()
    want = torch.logsumexp(s.masked_fill(~ok, -torch.inf), dim=-1)
    _assert_close(lse[..., live], want[..., live].numpy(), "lse")
    assert torch.all(lse[..., ~live] == NEG_INF)


# ------------------------------------------- the kernels' arithmetic --
#
# A plain-PyTorch emulation of what the backward kernels round where, at
# small shapes (the kernels run only on the card): bf16 as
# ``csrc/swa_attention_bwd.cu`` takes it (float32 accumulators, P and dS
# rounded once to bf16 for the three products that take them, the
# gradients rounded to bf16 once); float32 in split TF32 as
# ``csrc/swa_attention_bwd_tf32x3.cu`` chains its mma.sync steps
# (``_mm_tf32`` of ``test_torch_lm_kernels.py``: S and dP over the whole
# depth, dQ's share of each tile of keys and dK's, dV's of each tile of
# queries of each query head from zero, then added in float32; tiles of 32
# rows for a padded Dh up to 112, else 16).  Held against
# ``jax.vjp`` of the reference: bf16 by phase 7t's gate (a) (at most twice
# the plain backward's distance, plus one bf16 ulp of the largest
# element), float32 by phase 7's ``BWD_TOL`` (2e-5 x max(1, max|g|)).

from test_torch_lm_kernels import _mm_tf32  # noqa: E402

LOG2E = 1.4426950408889634
F32_BWD_TOL = 2e-5


def _kernel_tile(dh):
    """Rows of the float32 kernels' streamed tiles at head size ``dh``."""
    return 32 if -(-dh // 16) * 16 <= 112 else 16

# (B, Hq, Hkv, Tq, Tk, Dh, window, causal, q_offset)
KERNEL_CASES = [
    (1, 4, 1, 256, 256, 112, 256, True, 0),    # GQA 4, causal, Dh 112
    (1, 4, 1, 192, 192, 36, 48, True, 0),      # a window, Dh 36
    (1, 4, 2, 16, 64, 36, 4, True, 60),        # an offset: rows 7.. no key
    (1, 2, 1, 96, 160, 112, 40, False, 0),     # not causal, Tq != Tk
]


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _kernel_bwd(q, k, v, o, lse, do, *, window, causal, q_offset, arith):
    """(dq, dk, dv) float32 as the kernels compute them from float32 q, k,
    v, o, lse, do: ``arith`` "bf16" (P and dS rounded to bf16, the bf16
    kernels'),
    "tf32x3" (split TF32) or "tf32" (one TF32 product per float32
    product, the variant that misses the float32 bound)."""
    B, Hq, Tq, Dh = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    rep = Hq // Hkv
    scale = 1.0 / Dh ** 0.5
    T = _kernel_tile(Dh)

    def mm(a, b):
        if arith == "bf16":
            return a @ b
        return _mm_tf32(a, b, arith == "tf32x3")

    def mm_p(x, b):                     # P or dS (float32) times bf16 b
        return _bf16(x) @ b

    qpos = torch.arange(Tq)[:, None] + q_offset
    kpos = torch.arange(Tk)[None, :]
    ok = (kpos > qpos - window) & ((kpos <= qpos) if causal else True)
    dq = torch.zeros(B, Hq, Tq, Dh)
    dk = torch.zeros(B, Hkv, Tk, Dh)
    dv = torch.zeros(B, Hkv, Tk, Dh)
    for b in range(B):
        for h in range(Hq):
            g = h // rep
            Q, dO, K, V = q[b, h], do[b, h], k[b, g], v[b, g]
            D = (dO * o[b, h]).sum(-1)
            S = mm(Q, K.T)
            dP = mm(dO, V.T)
            P = torch.where(ok, torch.exp2(S * (scale * LOG2E)
                                           - lse[b, h][:, None] * LOG2E),
                            torch.zeros(()))
            dS = P * (dP - D[:, None])
            if arith == "bf16":
                dq[b, h] = mm_p(dS, K)
                dv[b, g] += mm_p(P.T, dO)
                dk[b, g] += mm_p(dS.T, Q)
                continue
            for j in range(0, Tk, T):
                dq[b, h] += mm(dS[:, j:j + T], K[j:j + T])
            for i in range(0, Tq, T):
                dv[b, g] += mm(P[i:i + T].T, dO[i:i + T])
                dk[b, g] += mm(dS[i:i + T].T, Q[i:i + T])
    return dq * scale, dk * scale, dv


def _kernel_case(case, seed, arith):
    """(the emulated kernels' gradients, the plain backward's, the
    reference's vjp) on one case's numpy inputs, bf16-valued for "bf16";
    rows with no key get an upstream gradient of 0 (the reference's
    softmax over an empty row is uniform)."""
    window, causal, q_offset = case[6:]
    kw = dict(window=window, causal=causal, q_offset=q_offset)
    q, k, v, do = _swa_inputs(case, seed)
    if arith == "bf16":
        q, k, v, do = (_bf16(torch.from_numpy(a)).numpy()
                       for a in (q, k, v, do))
    Tq, Tk = case[3], case[4]
    pos = q_offset + np.arange(Tq)
    empty = np.maximum(pos - window + 1, 0) > np.minimum(
        pos if causal else Tk - 1, Tk - 1)
    do = np.where(empty[None, None, :, None], 0.0, do).astype(np.float32)
    dtype = torch.bfloat16 if arith == "bf16" else torch.float32
    t = [torch.from_numpy(a).to(dtype) for a in (q, k, v, do)]
    o, lse = swa_attention_plain(*t[:3], **kw, return_lse=True)
    plain = swa_attention_bwd_plain(*t[:3], o, lse, t[3], **kw)
    got = _kernel_bwd(*(a.float() for a in t[:3]), o.float(), lse,
                      t[3].float(), **kw, arith=arith)
    if arith == "bf16":
        got = [_bf16(g) for g in got]
    _, vjp = jax.vjp(lambda a, b, c: jref.swa_attention_ref(a, b, c, **kw),
                     *map(jnp.asarray, (q, k, v)))
    want = [np.asarray(w, np.float64) for w in vjp(jnp.asarray(do))]
    return got, plain, want


@pytest.mark.parametrize("case", KERNEL_CASES, ids=_swa_ids)
@pytest.mark.parametrize("arith", ["bf16", "tf32x3"])
def test_swa_bwd_kernel_arithmetic_holds_the_gates(case, arith):
    got, plain, want = _kernel_case(case, 9, arith)
    for name, g, p, w in zip("qkv", got, plain, want):
        d_k = float(np.abs(g.double().numpy() - w).max())
        top = float(np.abs(w).max())
        if arith == "bf16":
            d_p = float(np.abs(p.double().numpy() - w).max())
            ulp = 2.0 ** -7 * 2.0 ** np.floor(np.log2(top))
            assert d_k <= 2 * d_p + ulp, (f"d{name}", d_k, d_p, ulp)
        else:
            assert d_k <= F32_BWD_TOL * max(1.0, top), (f"d{name}", d_k, top)


@pytest.mark.parametrize("case", KERNEL_CASES[:2], ids=_swa_ids)
def test_swa_bwd_one_tf32_product_misses_the_float32_bound(case):
    """The float32 kernels' three TF32 products per float32 product are
    what holds ``BWD_TOL``: one TF32 product misses it on some gradient."""
    got, _, want = _kernel_case(case, 9, "tf32")
    assert any(float(np.abs(g.double().numpy() - w).max())
               > F32_BWD_TOL * max(1.0, float(np.abs(w).max()))
               for g, w in zip(got, want))


# ------------------------------------------------------------- SSD --

# (b, t, h, dh, n, chunk)
SSD_CASES = [(2, 32, 3, 8, 4, 8),
             (1, 64, 2, 16, 8, 16),
             (2, 37, 3, 8, 4, 8),          # t that chunk does not divide
             (1, 50, 2, 4, 6, 64)]         # one chunk, ragged


def _ssd_inputs(b, t, h, dh, n, seed):
    rng = np.random.default_rng(seed)
    x = _np(rng, b, t, h, dh)
    dt = (np.abs(rng.standard_normal((b, t, h))) * 0.1 + 0.01).astype(
        np.float32)
    A = (-np.abs(rng.standard_normal(h) * 0.3 + 1.0)).astype(np.float32)
    return (x, dt, A, _np(rng, b, t, n, scale=n ** -0.5),
            _np(rng, b, t, n, scale=n ** -0.5), _np(rng, b, t, h, dh))


def _ssd_ref_vjp(x, dt, A, B, C, dy, chunk):
    """The reference's gradients; a ragged t is padded with dt = 0 steps
    (a step that changes nothing; the kernels' rule) and their upstream
    gradient 0, then cut."""
    t = x.shape[1]
    pad = (-t) % chunk

    def p(a):
        return jnp.pad(a, [(0, 0), (0, pad)] + [(0, 0)] * (a.ndim - 2))
    xs = [p(jnp.asarray(a)) for a in (x, dt)] + [jnp.asarray(A)] + \
        [p(jnp.asarray(a)) for a in (B, C)]
    _, vjp = jax.vjp(lambda *a: jmamba.ssd_chunked(*a, chunk=chunk), *xs)
    g = vjp(p(jnp.asarray(dy)).astype(xs[0].dtype))
    return [g[0][:, :t], g[1][:, :t], g[2], g[3][:, :t], g[4][:, :t]]


def _ssd_plain_bwd(x, dt, A, B, C, dy, chunk):
    t = [torch.from_numpy(np.asarray(a)) for a in (x, dt, A, B, C, dy)]
    _, states, decay = ssd_scan_plain(*t[:5], chunk=chunk,
                                      return_states=True)
    return ssd_scan_bwd_plain(*t[:5], states, decay, t[5], chunk=chunk)


@pytest.mark.parametrize("b,t,h,dh,n,chunk", SSD_CASES)
def test_ssd_bwd_plain_matches_reference_vjp(b, t, h, dh, n, chunk):
    x, dt, A, B, C, dy = _ssd_inputs(b, t, h, dh, n, 5)
    want = _ssd_ref_vjp(x, dt, A, B, C, dy, chunk)
    got = _ssd_plain_bwd(x, dt, A, B, C, dy, chunk)
    for name, g, w in zip(("x", "dt", "A", "B", "C"), got, want):
        assert g.dtype == torch.float32
        _assert_close(g, w, f"d{name}")


def test_ssd_bwd_plain_with_bf16_b_and_c_matches_reference_vjp():
    b, t, h, dh, n, chunk = 2, 40, 2, 8, 4, 16
    x, dt, A, B, C, dy = _ssd_inputs(b, t, h, dh, n, 6)
    Bb, Cb = (jnp.asarray(a).astype(jnp.bfloat16) for a in (B, C))
    want = _ssd_ref_vjp(x, dt, A, Bb, Cb, dy, chunk)
    tb = [torch.from_numpy(a).to(torch.bfloat16) for a in (B, C)]
    tx = [torch.from_numpy(a) for a in (x, dt, A, dy)]
    _, states, decay = ssd_scan_plain(tx[0], tx[1], tx[2], *tb, chunk=chunk,
                                      return_states=True)
    got = ssd_scan_bwd_plain(tx[0], tx[1], tx[2], *tb, states, decay, tx[3],
                             chunk=chunk)
    for name, g, w in zip(("x", "dt", "A"), got[:3], want[:3]):
        _assert_close(g, w, f"d{name}")
    for name, g, w in zip("BC", got[3:], want[3:]):
        assert g.dtype == torch.bfloat16
        _assert_bf16_close(g, np.asarray(w.astype(jnp.float32)), f"d{name}")


@pytest.mark.parametrize("b,t,h,dh,n,chunk", SSD_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_bwd_plain_matches_autograd_of_the_plain_forward(b, t, h, dh, n,
                                                            chunk, dtype):
    arrs = _ssd_inputs(b, t, h, dh, n, 7)
    x, dt, A, B, C, dy = (torch.from_numpy(a) for a in arrs)
    x, dy = x.to(dtype), dy.to(dtype)
    xs = [a.clone().requires_grad_() for a in (x, dt, A, B, C)]
    want = torch.autograd.grad(ssd_scan_plain(*xs, chunk=chunk), xs, dy)
    _, states, decay = ssd_scan_plain(x, dt, A, B, C, chunk=chunk,
                                      return_states=True)
    got = ssd_scan_bwd_plain(x, dt, A, B, C, states, decay, dy, chunk=chunk)
    for name, g, w, src in zip(("x", "dt", "A", "B", "C"), got, want,
                               (x, dt, A, B, C)):
        assert g.dtype == src.dtype
        if g.dtype == torch.bfloat16:
            _assert_bf16_close(g, w.float().numpy(), f"d{name}")
        else:
            _assert_close(g, w.numpy(), f"d{name}")


def test_ssd_plain_states_are_the_recurrence_entering_each_chunk():
    b, t, h, dh, n, chunk = 1, 40, 2, 4, 3, 16
    x, dt, A, B, C, _ = (torch.from_numpy(a) for a in _ssd_inputs(
        b, t, h, dh, n, 8))
    y, states, decay = ssd_scan_plain(x, dt, A, B, C, chunk=chunk,
                                      return_states=True)
    assert torch.equal(y, ssd_scan_plain(x, dt, A, B, C, chunk=chunk))
    state = torch.zeros(b, h, n, dh, dtype=torch.float64)
    for c in range(3):
        _assert_close(states[:, :, c], state.numpy(), f"state {c}")
        tot = torch.zeros(b, h, dtype=torch.float64)
        for s in range(c * chunk, min(t, (c + 1) * chunk)):
            a = torch.exp(A.double() * dt[:, s].double())      # b h
            tot += A.double() * dt[:, s].double()
            state = a[..., None, None] * state + torch.einsum(
                "bn,bhd->bhnd", B[:, s].double(),
                x[:, s].double() * dt[:, s].double()[..., None])
        _assert_close(decay[:, :, c], torch.exp(tot).numpy(), f"decay {c}")


def test_ssd_bwd_plain_stays_finite_past_the_decay_overflow():
    """The case of ``test_plain_ssd_grads_stay_finite_past_the_decay_
    overflow``: exp(s_t - s_tau) of a future tau overflows inside a chunk
    of 128; the explicit backward takes the exponential only for tau <= t,
    so every gradient is finite and equal to autograd's through the plain
    forward (whose masked exp is finite too), while the reference's
    ``where(mask, exp(diff), 0)`` gives NaN."""
    g = torch.Generator().manual_seed(0)
    b, t, h, dh, n = 1, 256, 2, 4, 4
    inputs = (torch.randn(b, t, h, dh, generator=g),
              torch.rand(b, t, h, generator=g) + 0.5,
              -torch.rand(h, generator=g) * 10 - 5,
              torch.randn(b, t, n, generator=g),
              torch.randn(b, t, n, generator=g))
    up = torch.randn(b, t, h, dh, generator=g)
    _, states, decay = ssd_scan_plain(*inputs, chunk=128, return_states=True)
    got = ssd_scan_bwd_plain(*inputs, states, decay, up, chunk=128)
    assert all(torch.isfinite(a).all() for a in got)
    xs = [a.clone().requires_grad_() for a in inputs]
    want = torch.autograd.grad(ssd_scan_plain(*xs, chunk=128), xs, up)
    for name, a, w in zip(("x", "dt", "A", "B", "C"), got, want):
        _assert_close(a, w.numpy(), f"d{name}")
    ref = jax.grad(lambda *a: (jmamba.ssd_chunked(*a, chunk=128)
                               * up.numpy()).sum(), argnums=(1, 2))(
        *[a.numpy() for a in inputs])
    assert not all(np.isfinite(np.asarray(a)).all() for a in ref)


# ------------------------------------------------------- launchers --


class _FailingLibrary:
    """A kernel library whose every entry point records its arguments and
    returns cudaErrorLaunchFailure (719)."""

    def __init__(self):
        self.calls = []
        self.lib = self

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            return 719
        return entry


def _launch_cases():
    from repro_torch.kernels import ssd_scan as tssd
    from repro_torch.kernels import swa_attention as tswa
    q = torch.zeros(1, 2, 8, 8)
    k = torch.zeros(1, 1, 8, 8)
    lse = torch.zeros(1, 2, 8)
    kw = dict(window=4, causal=True, q_offset=0, scale=0.5)
    x = torch.zeros(1, 8, 2, 4)
    dt, A, B = torch.zeros(1, 8, 2), torch.zeros(2), torch.zeros(1, 8, 3)
    states, decay = torch.zeros(1, 2, 1, 3, 4), torch.zeros(1, 2, 1)
    return {
        "swa_attention_fwd": lambda: tswa.launch_swa_attention(
            q, k, k, q.clone(), **kw, lse=lse),
        "swa_attention_tc_fwd": lambda: tswa.launch_swa_attention_tc(
            q, k, k, q.clone(), **kw, lse=lse),
        "swa_attention_tf32x3_fwd": lambda: tswa.launch_swa_attention_tf32x3(
            q, k, k, q.clone(), **kw, lse=lse),
        "swa_attention_bwd": lambda: tswa.launch_swa_attention_bwd(
            q, k, k, q, lse, q, q.clone(), k.clone(), k.clone(), **kw),
        "swa_attention_bwd_packed":
            lambda: tswa.launch_swa_attention_bwd_packed(
                q, k, k, q, lse, q, q.clone(), k.clone(), k.clone(), **kw),
        "ssd_scan_fwd": lambda: tssd.launch_ssd_scan(
            x, dt, A, B, B, x.clone(), chunk=8),
        "ssd_scan_bwd": lambda: tssd.launch_ssd_scan_bwd(
            x, dt, A, B, B, states, decay, x, x.clone(), dt.clone(),
            torch.zeros(1, 8, 2, 3), torch.zeros(1, 8, 2, 3), decay.clone(),
            chunk=8),
    }, lse


@pytest.mark.parametrize("entry", [
    "swa_attention_fwd", "swa_attention_tc_fwd", "swa_attention_tf32x3_fwd",
    "swa_attention_bwd", "swa_attention_bwd_packed", "ssd_scan_fwd",
    "ssd_scan_bwd"])
def test_lm_launchers_raise_on_an_error_from_their_entry(monkeypatch, entry):
    """A refused launch raises through ``build.check``, each launcher
    passes as many arguments as its entry point's signature has, and a
    forward asked for the logsumexp passes its pointer."""
    from repro_torch.kernels import build
    from repro_torch.kernels import ssd_scan as tssd
    from repro_torch.kernels import swa_attention as tswa
    failing = _FailingLibrary()
    for mod in (tswa, tssd):
        monkeypatch.setattr(mod, "library", lambda: failing)
        monkeypatch.setattr(mod, "stream", lambda t: 0)
    cases, lse = _launch_cases()
    with pytest.raises(RuntimeError, match=f"{entry}: CUDA launch failed "
                                           f"with cudaError 719"):
        cases[entry]()
    [(name, args)] = failing.calls
    assert name == entry and len(args) == len(build.SIGNATURES[entry])
    if entry.endswith("_fwd") and entry.startswith("swa"):
        assert args[-2] == lse.data_ptr()
