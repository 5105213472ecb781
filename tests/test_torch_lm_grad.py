"""The port's LM loss and its gradients (``repro_torch.training.train``)
against the JAX reference on the CPU, at the smoke configs in float32, and
the kernels' autograd Function (``repro_torch.kernels.ops.KernelGrad``).

The reference's parameters (``init_params(PRNGKey(0), cfg)``) come across
by ``params_from_reference``; batches are made with numpy from a seed and
handed to both.  Tolerances:

- ``lm_loss`` within 1e-4 of ``jax.value_and_grad`` of the reference's;
- every gradient leaf within 2e-4 x max(1, max|g|) of the reference's
  (the models' forward tolerance in ``test_torch_models.py``);
- ``KernelGrad`` driven with the plain forward gives the gradients of
  autograd through the plain version bit for bit (it is the same
  computation), and ``remat`` on and off give bit-identical gradients.

On the card the Function's forward is the CUDA kernel (``chip_smoke.py``,
phase 7t).
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
from repro_torch.kernels.ssd_scan import ssd_scan_plain
from repro_torch.kernels.swa_attention import swa_attention_plain
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


# ------------------------------------------------------- the Function --


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
    out, got = _grads(lambda *a: ops.KernelGrad.apply(
        swa_attention_plain, swa_attention_plain, kw, *a), (q, k, v), up)
    assert torch.equal(out, want_out)
    for a, b in zip(got, want):
        assert a.dtype == dtype and torch.equal(a, b)


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
    out, got = _grads(lambda *a: ops.KernelGrad.apply(
        ssd_scan_plain, ssd_scan_plain, kw, *a), inputs, up)
    assert torch.equal(out, want_out)
    for a, b_, src in zip(got, want, inputs):
        assert a.dtype == src.dtype and torch.equal(a, b_)


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
