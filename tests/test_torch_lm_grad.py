"""The port's LM loss and its gradients (``repro_torch.training.train``)
against the JAX reference on the CPU, at the smoke configs in float32, and
the kernels' autograd Functions (``repro_torch.kernels.ops.SWAAttention``
and ``ops.SSDScan``).

The reference's parameters (``init_params(PRNGKey(0), cfg)``) come across
by ``params_from_reference``; batches are made with numpy from a seed and
handed to both.  Tolerances:

- ``lm_loss`` within 1e-4 of ``jax.value_and_grad`` of the reference's;
- every gradient leaf within 2e-4 x max(1, max|g|) of the reference's
  (the models' forward tolerance in ``test_torch_models.py``);
- ``remat`` on and off give bit-identical gradients;
- the Functions driven with the plain pair (the forward that saves the
  logsumexp or the chunk states, and the explicit backward) give the
  forward of the plain version bit for bit and the gradients of autograd
  through it within 1e-5 x max(1, max|g|) in float32, one bf16 ulp of
  the largest element (2^-7 max|g|) for a bf16 gradient: the explicit
  backward sums in another order than autograd;
- a whole ``loss_and_grads`` of the zamba2 smoke config with the model's
  attention and SSD calls through the Functions (plain pair) holds the
  reference's loss and gradients at the tolerances above;
- on CUDA tensors (the launchers replaced by the plain versions, so the
  routing runs on the CPU) ``ops.swa_attention`` and ``ops.ssd_scan``
  under grad take the Functions: the forward's launch count as under
  ``no_grad``, one count of the route's backward, and no plain version
  called.

On the card the Functions run the CUDA kernels (``chip_smoke.py``, phases
3l and 7t).
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import mamba2 as jmamba
from repro.models import model as JM
from repro.training import train as jtrain
from repro_torch.configs import registry as treg
from repro_torch.kernels import ops
from repro_torch.kernels import ssd_scan as tssd
from repro_torch.kernels import swa_attention as tswa
from repro_torch.kernels.ssd_scan import ssd_scan_bwd_plain, ssd_scan_plain
from repro_torch.kernels.swa_attention import (swa_attention_bwd_plain,
                                               swa_attention_plain)
from repro_torch.models import attention as tattention
from repro_torch.models import mamba2 as tmamba
from repro_torch.models.convert import params_from_reference
from repro_torch.training import optimizer as topt
from repro_torch.training import train as ttrain

KEY = jax.random.PRNGKey(0)
LOSS_TOL = 1e-4
GRAD_TOL = 2e-4
B, T = 2, 16

# (arch, config changes, batch extras): the ten smoke configs, and the
# loss's other branches on two of them
CASES = [(a, {}, ()) for a in jreg.ARCH_IDS] + [
    ("granite-3-8b", {"vocab": 500}, ()),           # vocab-padding mask
    ("granite-3-8b", {"loss_impl": "lse"}, ()),
    ("qwen1.5-4b", {}, ("mask",)),
]


def _ids(case):
    arch, over, extra = case
    return "-".join([arch] + [f"{k}={v}" for k, v in over.items()]
                    + list(extra))


def make_batch(cfg, seed, extra=(), b=B, t=T):
    """A numpy batch for ``cfg`` (targets, tokens or embeds, image
    embeds, and a 0/1 ``mask`` when asked)."""
    rng = np.random.default_rng(seed)
    out = {"targets": rng.integers(0, cfg.vocab, (b, t)).astype(np.int32)}
    if cfg.inputs_embeds:
        out["embeds"] = rng.normal(0, 1, (b, t, cfg.d_model)).astype(
            np.float32)
    else:
        out["tokens"] = rng.integers(0, cfg.vocab, (b, t)).astype(np.int32)
    if cfg.arch_type == "vlm":
        out["image_embeds"] = rng.normal(
            0, 1, (b, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)
    if "mask" in extra:
        out["mask"] = (rng.random((b, t)) < 0.7).astype(np.float32)
    return out


def torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def configs(arch, over):
    return (dataclasses.replace(jreg.get_smoke_config(arch), **over),
            dataclasses.replace(treg.get_smoke_config(arch), **over))


def assert_grads_close(jgrads, tgrads, tol=GRAD_TOL):
    """Every leaf within ``tol`` x max(1, max|g|) of the reference's."""
    flat = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    mine = topt.tree_leaves(tgrads)
    assert len(flat) == len(mine)
    for (path, want), got in zip(flat, mine):
        want = np.asarray(want, np.float32)
        got = got.float().numpy()
        assert got.shape == want.shape, jax.tree_util.keystr(path)
        err = float(np.abs(got - want).max())
        bound = tol * max(1.0, float(np.abs(want).max()))
        assert err <= bound, (jax.tree_util.keystr(path), err, bound)


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_lm_loss_and_grads_match_reference(case):
    arch, over, extra = case
    jcfg, tcfg = configs(arch, over)
    jp = JM.init_params(KEY, jcfg)
    tp = params_from_reference(jax.tree.map(np.asarray, jp), tcfg,
                               device="cpu")
    batch = make_batch(jcfg, 1, extra)
    fn = jax.jit(jax.value_and_grad(functools.partial(
        jtrain.lm_loss, cfg=jcfg, remat=False), has_aux=True))
    (jtotal, jm), jgrads = fn(jp, batch)
    total, metrics, grads = ttrain.loss_and_grads(tp, torch_batch(batch),
                                                  tcfg, remat=False)
    for got, want in ((total, jtotal), (metrics["loss"], jm["loss"]),
                      (metrics["aux_loss"], jm["aux_loss"])):
        assert abs(float(got) - float(want)) <= LOSS_TOL, (got, want)
    if tcfg.is_moe:
        assert float(metrics["aux_loss"]) > 0
    assert_grads_close(jgrads, grads)


@pytest.mark.parametrize("arch", ["zamba2-7b", "dbrx-132b",
                                  "llama-3.2-vision-11b"])
def test_remat_gives_the_same_grads(arch):
    cfg = treg.get_smoke_config(arch)
    params = ttrain.init_state(3, cfg, device="cpu").params
    batch = torch_batch(make_batch(cfg, 2))
    off = ttrain.loss_and_grads(params, batch, cfg, remat=False)
    on = ttrain.loss_and_grads(params, batch, cfg, remat=True)
    assert torch.equal(off[0], on[0])
    for a, b in zip(topt.tree_leaves(off[2]), topt.tree_leaves(on[2])):
        assert torch.equal(a, b)


# ------------------------------------------------------ the Functions --

FN_TOL = 1e-5
BF16_REL = 2.0 ** -7


def _assert_grad_close(got, want):
    """Within ``FN_TOL`` x max(1, max|want|) (float32) or one bf16 ulp of
    the largest element (bf16)."""
    err = float((got.double() - want.double()).abs().max())
    top = float(want.double().abs().max())
    bound = BF16_REL * top if got.dtype == torch.bfloat16 else \
        FN_TOL * max(1.0, top)
    assert err <= bound, (got.dtype, err, bound)


def _swa_function(**kw):
    return lambda *a: ops.SWAAttention.apply(
        functools.partial(swa_attention_plain, return_lse=True),
        swa_attention_bwd_plain, kw, *a)


def _ssd_function(**kw):
    return lambda *a: ops.SSDScan.apply(
        functools.partial(ssd_scan_plain, return_states=True),
        ssd_scan_bwd_plain, kw, *a)


def _grads(fn, inputs, upstream):
    xs = [t.detach().clone().requires_grad_(t.is_floating_point())
          for t in inputs]
    out = fn(*xs)
    got = torch.autograd.grad(out, [x for x in xs if x.requires_grad],
                              upstream)
    return out.detach(), got


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Hq,Hkv,Tq,Tk,window,q_offset", [
    (4, 2, 40, 40, 40, 0),        # full causal, GQA 2
    (4, 1, 37, 37, 9, 0),         # window < T, GQA 4 (MQA)
    (2, 2, 5, 29, 12, 24),        # a query block at an offset
])
def test_kernel_grad_swa_matches_plain_autograd(dtype, Hq, Hkv, Tq, Tk,
                                                window, q_offset):
    g = torch.Generator().manual_seed(Hq * 100 + Tq)
    Dh = 16
    q = torch.randn(2, Hq, Tq, Dh, generator=g).to(dtype)
    k = torch.randn(2, Hkv, Tk, Dh, generator=g).to(dtype)
    v = torch.randn(2, Hkv, Tk, Dh, generator=g).to(dtype)
    up = torch.randn(2, Hq, Tq, Dh, generator=g).to(dtype)
    kw = dict(window=window, causal=True, q_offset=q_offset)
    want_out, want = _grads(lambda *a: swa_attention_plain(*a, **kw),
                            (q, k, v), up)
    out, got = _grads(_swa_function(**kw), (q, k, v), up)
    assert torch.equal(out, want_out)
    for a, b in zip(got, want):
        assert a.dtype == dtype
        _assert_grad_close(a, b)


@pytest.mark.parametrize("t,chunk,bc_dtype", [(37, 8, torch.float32),
                                              (64, 16, torch.bfloat16)])
def test_kernel_grad_ssd_matches_plain_autograd(t, chunk, bc_dtype):
    g = torch.Generator().manual_seed(t)
    b, h, dh, n = 2, 3, 8, 4
    x = torch.randn(b, t, h, dh, generator=g)
    dt = torch.rand(b, t, h, generator=g) * 0.5 + 0.05
    A = -torch.rand(h, generator=g) - 0.1
    Bm = torch.randn(b, t, n, generator=g).to(bc_dtype)
    Cm = torch.randn(b, t, n, generator=g).to(bc_dtype)
    up = torch.randn(b, t, h, dh, generator=g)
    kw = dict(chunk=chunk)
    inputs = (x, dt, A, Bm, Cm)
    want_out, want = _grads(lambda *a: ssd_scan_plain(*a, **kw), inputs, up)
    out, got = _grads(_ssd_function(**kw), inputs, up)
    assert torch.equal(out, want_out)
    for a, b_, src in zip(got, want, inputs):
        assert a.dtype == src.dtype
        _assert_grad_close(a, b_)


def test_wrappers_take_the_plain_path_with_grads_on_the_cpu():
    """On CPU tensors the wrappers are the plain versions, gradients
    included, and no launch is counted."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn(1, 2, 9, 8, generator=g, requires_grad=True)
    ops.reset_launch_counts()
    out = ops.swa_attention(q, q.detach(), q.detach(), window=4)
    (dq,) = torch.autograd.grad(out.sum(), [q])
    assert torch.isfinite(dq).all() and dq.abs().sum() > 0
    assert not any(ops.launch_counts().values())


def test_plain_ssd_grads_stay_finite_past_the_decay_overflow():
    """A chunk of 128 steps with |A| dt ~ 5 per step: exp(s_t - s_tau) of
    a future tau overflows.  The plain version masks before its exp, so
    every gradient is finite and the output is that of the masked form.
    The reference's ``ssd_chunked`` takes ``where(mask, exp(diff), 0)``
    and its dt and A gradients are NaN here (``ROADMAP.md`` queue 3)."""
    g = torch.Generator().manual_seed(0)
    b, t, h, dh, n = 1, 256, 2, 4, 4
    inputs = (torch.randn(b, t, h, dh, generator=g),
              torch.rand(b, t, h, generator=g) + 0.5,
              -torch.rand(h, generator=g) * 10 - 5,
              torch.randn(b, t, n, generator=g),
              torch.randn(b, t, n, generator=g))
    up = torch.randn(b, t, h, dh, generator=g)
    out, grads = _grads(lambda *a: ssd_scan_plain(*a, chunk=128), inputs, up)
    assert torch.isfinite(out).all()
    assert all(torch.isfinite(x).all() for x in grads)
    ref = jax.grad(lambda *a: (jmamba.ssd_chunked(*a, chunk=128)
                               * up.numpy()).sum(), argnums=(1, 2))(
        *[x.numpy() for x in inputs])
    assert not all(np.isfinite(np.asarray(x)).all() for x in ref)
    want = jmamba.ssd_chunked(*[x.numpy() for x in inputs], chunk=128)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-5)


def test_zamba2_loss_and_grads_through_the_functions_match_reference(
        monkeypatch):
    """The zamba2 smoke config's whole ``loss_and_grads`` with the model's
    attention and SSD calls through ``ops.SWAAttention`` / ``ops.SSDScan``
    (the plain pair), against the reference's, at the tolerances of
    ``test_lm_loss_and_grads_match_reference``."""
    calls = {"swa": 0, "ssd": 0}

    def swa(q, k, v, **kw):
        calls["swa"] += 1
        return _swa_function(**kw)(q, k, v)

    def ssd(x, dt, A, B, C, *, chunk):
        calls["ssd"] += 1
        return _ssd_function(chunk=chunk)(x, dt, A, B, C)
    monkeypatch.setattr(tattention, "swa_attention", swa)
    monkeypatch.setattr(tmamba, "ssd_scan", ssd)
    jcfg, tcfg = configs("zamba2-7b", {})
    jp = JM.init_params(KEY, jcfg)
    tp = params_from_reference(jax.tree.map(np.asarray, jp), tcfg,
                               device="cpu")
    batch = make_batch(jcfg, 1)
    fn = jax.jit(jax.value_and_grad(functools.partial(
        jtrain.lm_loss, cfg=jcfg, remat=False), has_aux=True))
    (jtotal, jm), jgrads = fn(jp, batch)
    total, metrics, grads = ttrain.loss_and_grads(tp, torch_batch(batch),
                                                  tcfg, remat=False)
    assert calls["swa"] >= 1 and calls["ssd"] == tcfg.n_layers
    assert abs(float(total) - float(jtotal)) <= LOSS_TOL
    assert abs(float(metrics["loss"]) - float(jm["loss"])) <= LOSS_TOL
    assert_grads_close(jgrads, grads)


# the plain versions themselves, before any test replaces the module names
_PLAIN = {"swa": swa_attention_plain, "swa_bwd": swa_attention_bwd_plain,
          "ssd": ssd_scan_plain, "ssd_bwd": ssd_scan_bwd_plain}


class _Plain:
    """Stand-ins for the kernel launchers that compute with the plain
    versions (so the wrappers' routing runs on CPU tensors), and a count
    of calls to the plain versions that the wrappers make themselves."""

    def __init__(self, monkeypatch):
        self.plain_calls = 0
        for mod, name in ((tswa, "swa_attention_plain"),
                          (tswa, "swa_attention_bwd_plain"),
                          (tssd, "ssd_scan_plain"),
                          (tssd, "ssd_scan_bwd_plain")):
            monkeypatch.setattr(mod, name, self._counted(getattr(mod,
                                                                 name)))
        monkeypatch.setattr(ops, "_route", lambda *t: True)
        for name in ("launch_swa_attention", "launch_swa_attention_tc",
                     "launch_swa_attention_tf32x3"):
            monkeypatch.setattr(tswa, name, self.swa_fwd)
        for name in ("launch_swa_attention_bwd",
                     "launch_swa_attention_bwd_packed"):
            monkeypatch.setattr(tswa, name, self.swa_bwd)
        monkeypatch.setattr(tssd, "launch_ssd_scan", self.ssd_fwd)
        monkeypatch.setattr(tssd, "launch_ssd_scan_bwd", self.ssd_bwd)

    def _counted(self, fn):
        def call(*a, **kw):
            self.plain_calls += 1
            return fn(*a, **kw)
        return call

    @staticmethod
    def swa_fwd(q, k, v, out, *, lse=None, **kw):
        o, rows = _PLAIN["swa"](q, k, v, **kw, return_lse=True)
        out.copy_(o)
        if lse is not None:
            lse.copy_(rows)

    @staticmethod
    def swa_bwd(q, k, v, o, lse, do, dq, dk, dv, **kw):
        for dst, g in zip((dq, dk, dv), _PLAIN["swa_bwd"](q, k, v, o, lse,
                                                          do, **kw)):
            dst.copy_(g)

    @staticmethod
    def ssd_fwd(x, dt, A, B, C, y, *, chunk):
        out, states, decay = _PLAIN["ssd"](x, dt, A, B, C, chunk=chunk,
                                           return_states=True)
        y.copy_(out)
        return states, decay

    @staticmethod
    def ssd_bwd(x, dt, A, B, C, states, decay, dy, dx, ddt, dBh, dCh, dAp,
                *, chunk):
        gx, gdt, gA, gB, gC = _PLAIN["ssd_bwd"](x, dt, A, B, C, states,
                                                decay, dy, chunk=chunk)
        dx.copy_(gx)
        ddt.copy_(gdt)
        dBh.zero_()
        dCh.zero_()
        dBh[:, :, 0] = gB               # every head's part on head 0
        dCh[:, :, 0] = gC
        dAp.zero_()
        dAp[0, :, 0] = gA


@pytest.mark.parametrize("dtype,Dh,route", [
    (torch.float32, 16, "swa_attention_bwd_f32"),
    (torch.bfloat16, 16, "swa_attention_bwd"),
    (torch.bfloat16, 12, "swa_attention_bwd_packed")])
def test_swa_wrapper_on_the_card_path_takes_the_function(monkeypatch, dtype,
                                                         Dh, route):
    stub = _Plain(monkeypatch)
    g = torch.Generator().manual_seed(Dh)
    q = torch.randn(1, 4, 20, Dh, generator=g).to(dtype)
    k, v = (torch.randn(1, 2, 20, Dh, generator=g).to(dtype)
            for _ in range(2))
    up = torch.randn(1, 4, 20, Dh, generator=g).to(dtype)
    kw = dict(window=7, causal=True, q_offset=0)
    fwd = {torch.float32: "swa_attention_tf32x3"}.get(
        dtype, "swa_attention_tc" if Dh % 8 == 0 else "swa_attention")
    ops.reset_launch_counts()
    with torch.no_grad():
        ops.swa_attention(q, k, v, **kw)
    assert {n: c for n, c in ops.launch_counts().items() if c} == {fwd: 1}
    ops.reset_launch_counts()
    out, got = _grads(lambda *a: ops.swa_attention(*a, **kw), (q, k, v), up)
    assert {n: c for n, c in ops.launch_counts().items() if c} == \
        {fwd: 1, route: 1}
    assert stub.plain_calls == 0
    want_out, want = _grads(lambda *a: _PLAIN["swa"](*a, **kw), (q, k, v),
                            up)
    assert torch.equal(out, want_out)
    for a, b in zip(got, want):
        assert a.dtype == dtype
        _assert_grad_close(a, b)


def test_ssd_wrapper_on_the_card_path_takes_the_function(monkeypatch):
    stub = _Plain(monkeypatch)
    g = torch.Generator().manual_seed(5)
    b, t, h, dh, n = 2, 37, 3, 8, 4
    x = torch.randn(b, t, h, dh, generator=g)
    dt = torch.rand(b, t, h, generator=g) * 0.5 + 0.05
    A = -torch.rand(h, generator=g) - 0.1
    Bm, Cm = (torch.randn(b, t, n, generator=g).to(torch.bfloat16)
              for _ in range(2))
    up = torch.randn(b, t, h, dh, generator=g)
    inputs = (x, dt, A, Bm, Cm)
    ops.reset_launch_counts()
    with torch.no_grad():
        ops.ssd_scan(*inputs, chunk=8)
    assert {n_: c for n_, c in ops.launch_counts().items() if c} == \
        {"ssd_scan": 1}
    ops.reset_launch_counts()
    out, got = _grads(lambda *a: ops.ssd_scan(*a, chunk=8), inputs, up)
    assert {n_: c for n_, c in ops.launch_counts().items() if c} == \
        {"ssd_scan": 1, "ssd_scan_bwd": 1}
    assert stub.plain_calls == 0
    want_out, want = _grads(lambda *a: _PLAIN["ssd"](*a, chunk=8), inputs,
                            up)
    assert torch.equal(out, want_out)
    for a, b_, src in zip(got, want, inputs):
        assert a.dtype == src.dtype
        _assert_grad_close(a, b_)
