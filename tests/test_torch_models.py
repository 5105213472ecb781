"""The port's LM scaffold (``repro_torch.models``, ``repro_torch.configs``)
against the JAX reference on the CPU, at the smoke configs in float32.

The reference's parameters (``init_params(PRNGKey(0), cfg)``) go through
``jax.tree.map(np.asarray, ...)`` and ``params_from_reference``; inputs are
made with numpy from a seed and handed to both packages.  On CPU tensors
the port's attention prefill and Mamba2 scan run the kernels' plain
versions (``kernels.ops``).  Tolerances:

- ``forward`` and ``decode_step`` within rtol = atol = 2e-4 of the
  reference's (all ten architectures, the hybrid with a remainder tail);
- the port's decode against the port's forward within 2e-3, the
  reference's own decode-vs-forward tolerance (``tests/test_models.py``);
- MoE dispatch: ``cumsum`` equal to ``sort`` bit for bit, tied router
  probabilities routed to the lower expert as ``jax.lax.top_k`` does;
- ``param_count`` / ``active_param_count`` equal to the reference's
  integers; the registry equal to the reference's.

The CUDA kernels inside the model run only on the card (``chip_smoke.py``,
phase 7m).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import mamba2 as jmamba
from repro.models import model as JM
from repro.models import moe as jmoe
from repro.models import layers as jlayers
from repro_torch.configs import registry as treg
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import mamba2 as tmamba
from repro_torch.models import model as TM
from repro_torch.models import moe as tmoe
from repro_torch.models.config import ModelConfig
from repro_torch.models.convert import (decode_state_from_reference,
                                        params_from_reference)

KEY = jax.random.PRNGKey(0)
CPU = "cpu"
REF_TOL = dict(rtol=2e-4, atol=2e-4)
DECODE_TOL = dict(rtol=2e-3, atol=2e-3)
MOE_TOL = dict(rtol=2e-4, atol=1e-3)      # outputs of order 10^2
DECODE_ARCHS = ["granite-3-8b", "mamba2-370m", "zamba2-7b", "qwen1.5-4b",
                "hybrid-remainder"]


def _configs(arch):
    """(reference config, port config) of a smoke arch; "hybrid-remainder"
    is zamba2-7b's smoke config at 5 layers with the shared block every 2,
    so a tail of one Mamba2 layer follows the groups."""
    if arch == "hybrid-remainder":
        over = dict(n_layers=5, shared_attn_every=2)
        return (dataclasses.replace(jreg.get_smoke_config("zamba2-7b"),
                                    **over),
                dataclasses.replace(treg.get_smoke_config("zamba2-7b"),
                                    **over))
    return jreg.get_smoke_config(arch), treg.get_smoke_config(arch)


@pytest.fixture(scope="module")
def models():
    """arch -> (ref cfg, port cfg, ref params, port params), made once."""
    cache = {}

    def get(arch):
        if arch not in cache:
            jcfg, tcfg = _configs(arch)
            jp = JM.init_params(KEY, jcfg)
            tp = params_from_reference(jax.tree.map(np.asarray, jp), tcfg,
                                       device=CPU)
            cache[arch] = (jcfg, tcfg, jp, tp)
        return cache[arch]
    return get


def _batch(cfg, B, T, seed=0):
    rng = np.random.default_rng(seed)
    b = {}
    if cfg.inputs_embeds:
        b["embeds"] = rng.normal(0, 1, (B, T, cfg.d_model)).astype(np.float32)
    else:
        b["tokens"] = rng.integers(0, cfg.vocab, (B, T)).astype(np.int32)
    if cfg.arch_type == "vlm":
        b["image_embeds"] = rng.normal(
            0, 1, (B, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)
    return b


def _jbatch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _tbatch(b):
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32
            else torch.from_numpy(v) for k, v in b.items()}


def _close(got, want, tol, msg=""):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), err_msg=msg,
                               **tol)


# ------------------------------------------------------------ forward --


@pytest.mark.parametrize("arch", treg.ARCH_IDS + ["hybrid-remainder"])
def test_forward_matches_reference(models, arch):
    jcfg, tcfg, jp, tp = models(arch)
    b = _batch(jcfg, 2, 64)
    lj, aj = JM.forward(jp, _jbatch(b), jcfg, remat=False)
    lt, at = TM.forward(tp, _tbatch(b), tcfg, remat=False)
    assert lt.shape == (2, 64, tcfg.padded_vocab)
    assert lt.dtype == torch.float32
    _close(lt, lj, REF_TOL, arch)
    _close(at["aux_loss"], aj["aux_loss"], REF_TOL, arch)


@pytest.mark.parametrize("arch", ["granite-3-8b", "zamba2-7b",
                                  "mamba2-370m"])
def test_forward_last_only_is_the_last_row(models, arch):
    _, tcfg, _, tp = models(arch)
    b = _tbatch(_batch(tcfg, 2, 32))
    full, _ = TM.forward(tp, b, tcfg)
    last, _ = TM.forward(tp, b, tcfg, last_only=True)
    assert last.shape == (2, 1, tcfg.padded_vocab)
    _close(last, full[:, -1:].numpy(), dict(rtol=1e-6, atol=1e-6), arch)


def test_remat_unroll_and_q_chunk_change_nothing(models):
    _, tcfg, _, tp = models("zamba2-7b")
    b = _tbatch(_batch(tcfg, 1, 32))
    base, _ = TM.forward(tp, b, tcfg)
    for kw in (dict(remat=False), dict(unroll=True), dict(q_chunk=8)):
        assert torch.equal(TM.forward(tp, b, tcfg, **kw)[0], base), kw


def test_sliding_window_forward_matches_reference(models):
    """T past ``full_attn_max``: the kernel's window is the config's."""
    jcfg, tcfg, jp, tp = models("granite-3-8b")
    over = dict(full_attn_max=32, sliding_window=16)
    jcfg, tcfg = (dataclasses.replace(c, **over) for c in (jcfg, tcfg))
    b = _batch(jcfg, 1, 64)
    lj, _ = JM.forward(jp, _jbatch(b), jcfg, remat=False, q_chunk=32)
    lt, _ = TM.forward(tp, _tbatch(b), tcfg, remat=False, q_chunk=32)
    _close(lt, lj, REF_TOL)


@pytest.mark.parametrize("arch,want", [("zamba2-7b", (1, 2)),
                                       ("hybrid-remainder", (2, 5)),
                                       ("granite-3-8b", (2, 0)),
                                       ("mamba2-370m", (0, 2)),
                                       ("llama-3.2-vision-11b", (2, 0))])
def test_forward_calls_the_kernel_wrappers(models, monkeypatch, arch, want):
    """Every self-attention prefill is one ``swa_attention`` call and every
    Mamba2 scan one ``ssd_scan`` call, the names the model modules call
    (counted here by patching them)."""
    _, tcfg, _, tp = models(arch)
    calls = {"swa": [], "ssd": []}

    def count(key, fn):
        def wrapped(*a, **kw):
            calls[key].append(kw)
            return fn(*a, **kw)
        return wrapped
    monkeypatch.setattr(tattn, "swa_attention",
                        count("swa", tattn.swa_attention))
    monkeypatch.setattr(tmamba, "ssd_scan", count("ssd", tmamba.ssd_scan))
    TM.forward(tp, _tbatch(_batch(tcfg, 1, 32)), tcfg)
    assert (len(calls["swa"]), len(calls["ssd"])) == want
    assert all(kw["window"] >= 32 and kw["causal"] for kw in calls["swa"])
    assert all(kw["chunk"] == 32 for kw in calls["ssd"])


def test_attention_hands_the_kernel_contiguous_bhtd(monkeypatch):
    """q, k, v reach the kernel as contiguous (B, H, T, Dh) tensors, k and
    v with the kv heads only (GQA 8/2: no repeat)."""
    from repro_torch.kernels.swa_attention import swa_attention_plain
    seen = []

    def spy(q, k, v, **kw):
        seen.append([(tuple(t.shape), t.is_contiguous()) for t in (q, k, v)])
        return swa_attention_plain(q, k, v, **kw)
    monkeypatch.setattr(tattn, "swa_attention", spy)
    cfg = treg.get_smoke_config("granite-3-8b")
    p = tattn.attn_init(tlayers.ParamInit(torch.Generator().manual_seed(0),
                                          "cpu"), cfg, torch.float32)
    x = torch.randn(2, 24, cfg.d_model,
                    generator=torch.Generator().manual_seed(1))
    tattn.self_attention(p, x, cfg)
    assert seen == [[((2, 8, 24, 32), True), ((2, 2, 24, 32), True),
                     ((2, 2, 24, 32), True)]]


# ------------------------------------------------------------- decode --


def _ref_decode(jp, jcfg, tokens, seq_len, state=None):
    step = jax.jit(lambda p, s, t, pos: JM.decode_step(
        p, s, t, pos, jcfg, seq_len=seq_len))
    st = state if state is not None else JM.init_decode_state(
        jcfg, tokens.shape[0], seq_len)
    outs = []
    for t in range(tokens.shape[1]):
        lg, st = step(jp, st, jnp.asarray(tokens[:, t: t + 1]), jnp.int32(t))
        outs.append(np.asarray(lg))
    return np.concatenate(outs, axis=1), st


def _port_decode(tp, tcfg, tokens, seq_len, state=None, start=0):
    st = state if state is not None else TM.init_decode_state(
        tcfg, tokens.shape[0], seq_len, device=CPU)
    outs = []
    for t in range(tokens.shape[1]):
        lg, st = TM.decode_step(tp, st, torch.from_numpy(
            tokens[:, t: t + 1]).long(), start + t, tcfg, seq_len=seq_len)
        outs.append(lg)
    return torch.cat(outs, dim=1), st


@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_decode_matches_reference(models, arch):
    jcfg, tcfg, jp, tp = models(arch)
    tokens = _batch(jcfg, 1, 16)["tokens"]
    lj, _ = _ref_decode(jp, jcfg, tokens, 16)
    lt, _ = _port_decode(tp, tcfg, tokens, 16)
    assert lt.shape == (1, 16, tcfg.padded_vocab)
    _close(lt, lj, REF_TOL, arch)


@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_decode_matches_forward(models, arch):
    """Prefilling token-by-token through decode_step reproduces forward()."""
    _, tcfg, _, tp = models(arch)
    b = _batch(tcfg, 1, 16)
    lf, _ = TM.forward(tp, _tbatch(b), tcfg, remat=False)
    ld, _ = _port_decode(tp, tcfg, b["tokens"], 16)
    _close(ld, lf.numpy(), DECODE_TOL, arch)


def test_sliding_window_matches_ring_decode(models):
    """Windowed forward() == ring-buffer decode over a long sequence."""
    _, tcfg, _, tp = models("granite-3-8b")
    cfg = dataclasses.replace(tcfg, full_attn_max=32, sliding_window=16)
    b = _batch(cfg, 1, 64)
    lf, _ = TM.forward(tp, _tbatch(b), cfg, remat=False, q_chunk=32)
    st = TM.init_decode_state(cfg, 1, 64, device=CPU)
    assert st["layers"]["k"].shape[2] == 16      # ring cache = window slots
    ld, _ = _port_decode(tp, cfg, b["tokens"], 64, state=st)
    _close(ld, lf.numpy(), DECODE_TOL)


@pytest.mark.parametrize("arch", ["zamba2-7b", "llama-3.2-vision-11b",
                                  "musicgen-large", "dbrx-132b"])
def test_decode_state_from_reference_continues_the_reference(models, arch):
    """A reference state after 8 steps, converted, carries the port's
    decode to the reference's next 4 logits; the converted empty state
    equals the port's own."""
    jcfg, tcfg, jp, tp = models(arch)
    B, S = 2, 16
    rng = np.random.default_rng(3)
    if jcfg.inputs_embeds:
        inps = rng.normal(0, 1, (B, 12, 1, jcfg.d_model)).astype(np.float32)
    else:
        inps = rng.integers(0, jcfg.vocab, (B, 12, 1)).astype(np.int32)
    kw_j, kw_t = {}, {}
    if jcfg.arch_type == "vlm":
        img = rng.normal(0, 1, (B, jcfg.n_image_tokens, jcfg.d_model)).astype(
            np.float32)
        kw_j["image_embeds"], kw_t["image_embeds"] = jnp.asarray(img), \
            torch.from_numpy(img)
    st0 = JM.init_decode_state(jcfg, B, S)
    mine = TM.init_decode_state(tcfg, B, S, device=CPU)
    conv = decode_state_from_reference(jax.tree.map(np.asarray, st0),
                                       device=CPU)
    assert jax.tree.structure(jax.tree.map(lambda a: 0, conv)) == \
        jax.tree.structure(jax.tree.map(lambda a: 0, mine))
    for a, b in zip(jax.tree.leaves(conv), jax.tree.leaves(mine)):
        assert a.shape == b.shape and a.dtype == b.dtype and not a.any()

    step = jax.jit(lambda p, s, x, pos, **kw: JM.decode_step(
        p, s, x, pos, jcfg, seq_len=S, **kw))
    st, want = st0, []
    for t in range(12):
        lg, st = step(jp, st, jnp.asarray(inps[:, t]), jnp.int32(t), **kw_j)
        want.append(np.asarray(lg))
        if t == 7:
            tst = decode_state_from_reference(jax.tree.map(np.asarray, st),
                                              device=CPU)
    for t in range(8, 12):
        x = torch.from_numpy(inps[:, t])
        lg, tst = TM.decode_step(tp, tst, x.long() if x.dtype == torch.int32
                                 else x, t, tcfg, seq_len=S, **kw_t)
        _close(lg, want[t], REF_TOL, f"{arch} step {t}")


# ------------------------------------------------------------- layers --


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_rope_unembed_match_reference(dtype):
    rng = np.random.default_rng(5)
    x = rng.normal(0, 1, (2, 12, 4, 16)).astype(np.float32)
    scale = rng.normal(1, 0.1, (16,)).astype(np.float32)
    pos = np.arange(100, 112, dtype=np.int32)
    w = rng.normal(0, 0.2, (16, 40)).astype(np.float32)
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    jx, tx = jnp.asarray(x).astype(jd), torch.from_numpy(x).to(td)
    tol = REF_TOL if dtype == "float32" else dict(rtol=1e-2, atol=1e-2)
    got = tlayers.rmsnorm({"scale": torch.from_numpy(scale)}, tx)
    assert got.dtype == td
    _close(got, jlayers.rmsnorm({"scale": jnp.asarray(scale)}, jx), tol)
    got = tlayers.apply_rope(tx, torch.from_numpy(pos).long(), 10_000.0)
    assert got.dtype == td
    _close(got, jlayers.apply_rope(jx, jnp.asarray(pos), 10_000.0), tol)
    for ld in ("float32", "bfloat16"):
        got = tlayers.unembed({"w": torch.from_numpy(w).to(td)}, tx, ld)
        want = jlayers.unembed({"w": jnp.asarray(w).astype(jd)}, jx,
                               jnp.dtype(ld))
        assert got.dtype == getattr(torch, ld)
        _close(got, want, tol if ld == "float32" and dtype == "float32"
               else dict(rtol=2e-2, atol=2e-2))


def test_mlp_and_sinusoidal_match_reference():
    rng = np.random.default_rng(6)
    x = rng.normal(0, 1, (2, 5, 32)).astype(np.float32)
    p = {k: rng.normal(0, 0.2, s).astype(np.float32) for k, s in
         (("w_gate", (32, 48)), ("w_up", (32, 48)), ("w_down", (48, 32)))}
    for kind in ("swiglu", "gelu"):
        _close(tlayers.mlp_apply({k: torch.from_numpy(v)
                                  for k, v in p.items()},
                                 torch.from_numpy(x), kind),
               jlayers.mlp_apply({k: jnp.asarray(v) for k, v in p.items()},
                                 jnp.asarray(x), kind), REF_TOL, kind)
    pos = np.arange(0, 300, 7)
    _close(tlayers.sinusoidal_pos(torch.from_numpy(pos), 64),
           jlayers.sinusoidal_pos(jnp.asarray(pos), 64), REF_TOL)


# ------------------------------------------------------------- mamba2 --


def _ssd_inputs(seed=0, b=2, t=128, h=2, dh=16, n=8):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, (b, t, h, dh)).astype(np.float32),
            np.abs(rng.normal(0, 0.1, (b, t, h))).astype(np.float32),
            -np.abs(rng.normal(1, 0.3, h)).astype(np.float32),
            rng.normal(0, 0.3, (b, t, n)).astype(np.float32),
            rng.normal(0, 0.3, (b, t, n)).astype(np.float32))


def test_ssd_chunk_invariance():
    """ssd_chunked gives the same output for any chunk size."""
    args = [torch.from_numpy(a) for a in _ssd_inputs()]
    y32 = tmamba.ssd_chunked(*args, chunk=32)
    y128 = tmamba.ssd_chunked(*args, chunk=128)
    _close(y32, y128.numpy(), dict(rtol=1e-4, atol=1e-5))


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_ssd_chunked_matches_reference(compute_dtype):
    a = _ssd_inputs(1)
    got = tmamba.ssd_chunked(*(torch.from_numpy(v) for v in a), chunk=32,
                             compute_dtype=getattr(torch, compute_dtype))
    want = jmamba.ssd_chunked(*(jnp.asarray(v) for v in a), chunk=32,
                              compute_dtype=jnp.dtype(compute_dtype))
    tol = dict(rtol=1e-4, atol=1e-5) if compute_dtype == "float32" \
        else dict(rtol=2e-2, atol=2e-2)
    _close(got, want, tol)


def test_ssd_chunked_matches_the_scan_the_model_calls():
    from repro_torch.kernels import ops
    args = [torch.from_numpy(a) for a in _ssd_inputs(2)]
    _close(ops.ssd_scan(*args, chunk=32),
           tmamba.ssd_chunked(*args, chunk=32).numpy(),
           dict(rtol=1e-4, atol=1e-5))


def test_ssd_dtype_rounds_the_scan_inputs(models):
    """``ssd_dtype='bfloat16'`` stays within bf16 rounding of the
    reference's bf16 intra-chunk math."""
    jcfg, tcfg, jp, tp = models("mamba2-370m")
    jcfg, tcfg = (dataclasses.replace(c, ssd_dtype="bfloat16")
                  for c in (jcfg, tcfg))
    b = _batch(jcfg, 1, 32)
    lj, _ = JM.forward(jp, _jbatch(b), jcfg, remat=False)
    lt, _ = TM.forward(tp, _tbatch(b), tcfg, remat=False)
    _close(lt, lj, dict(rtol=3e-2, atol=3e-2))


def test_split_fused_params_same_forward(models):
    """``ssm_split_proj`` with ``split_fused_params``: the same forward
    and decode, and the reference's split of the same weights."""
    jcfg, tcfg, jp, tp = models("zamba2-7b")
    cfg_s = dataclasses.replace(tcfg, ssm_split_proj=True)
    tp_s = dict(tp)
    tp_s["layers"] = {"ln": tp["layers"]["ln"], "mamba":
                      tmamba.split_fused_params(tp["layers"]["mamba"], tcfg)}
    j_split = jmamba.split_fused_params(
        jax.tree.map(lambda a: a[0], jp["layers"]["mamba"]), jcfg)
    for k in ("in_z", "in_x", "in_B", "in_C", "in_dt", "conv_x", "conv_x_b",
              "conv_B", "conv_B_b", "conv_C", "conv_C_b"):
        np.testing.assert_array_equal(
            tp_s["layers"]["mamba"][k][0].numpy(), np.asarray(j_split[k]))
    b = _tbatch(_batch(tcfg, 2, 32))
    _close(TM.forward(tp_s, b, cfg_s)[0], TM.forward(tp, b, tcfg)[0].numpy(),
           dict(rtol=5e-5, atol=5e-5))
    toks = _batch(tcfg, 1, 8)["tokens"]
    _close(_port_decode(tp_s, cfg_s, toks, 8)[0],
           _port_decode(tp, tcfg, toks, 8)[0].numpy(),
           dict(rtol=5e-5, atol=5e-5))


@pytest.mark.parametrize("arch", list(treg.OPTIMIZED_KNOBS))
def test_optimized_forward_matches_baseline(models, arch):
    """The optimized knobs are layout changes, not math changes (the mesh
    knobs are no-ops on one device)."""
    _, tcfg, _, tp = models(arch)
    knobs = dict(treg.OPTIMIZED_KNOBS[arch])
    cfg_opt = dataclasses.replace(tcfg, **knobs)
    tp_opt = tp
    if knobs.get("ssm_split_proj"):
        tp_opt = dict(tp)
        tp_opt["layers"] = {"ln": tp["layers"]["ln"], "mamba":
                            tmamba.split_fused_params(tp["layers"]["mamba"],
                                                      tcfg)}
    b = _tbatch(_batch(tcfg, 2, 32))
    _close(TM.forward(tp_opt, b, cfg_opt, remat=False)[0],
           TM.forward(tp, b, tcfg, remat=False)[0].numpy(),
           dict(rtol=5e-4, atol=5e-4), arch)


# ---------------------------------------------------------------- moe --


def _moe_pair(arch="dbrx-132b"):
    jcfg, tcfg = _configs(arch)
    jp = jmoe.moe_init(KEY, jcfg, jnp.float32)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    return jcfg, tcfg, jp, tp


def test_moe_cumsum_dispatch_equals_sort():
    _, tcfg, _, tp = _moe_pair()
    x = torch.from_numpy(np.random.default_rng(7).normal(
        0, 1, (2, 64, tcfg.d_model)).astype(np.float32))
    o1, a1 = tmoe.moe_apply(tp, x, tcfg)
    o2, a2 = tmoe.moe_apply(tp, x, dataclasses.replace(
        tcfg, moe_dispatch="cumsum"))
    assert torch.equal(o1, o2) and float(a1) == float(a2)


@pytest.mark.parametrize("dispatch", ["sort", "cumsum"])
@pytest.mark.parametrize("capacity_factor", [0.01, 0.5, 1.25, 2.0])
def test_moe_matches_reference(dispatch, capacity_factor):
    """Outputs and aux loss of the reference's ``moe_apply``, drops
    included (capacity 0.01 drops nearly every slot).  The outputs are of
    order 10^2 (the reference draws expert weights at 1/sqrt(n_experts)),
    so float32 sums that cancel differ by ~1e-4 absolute: MOE_TOL."""
    jcfg, tcfg, jp, tp = _moe_pair("phi3.5-moe-42b-a6.6b")
    jcfg, tcfg = (dataclasses.replace(c, moe_dispatch=dispatch)
                  for c in (jcfg, tcfg))
    x = np.random.default_rng(8).normal(0, 1, (2, 16, jcfg.d_model)).astype(
        np.float32)
    oj, aj = jmoe.moe_apply(jp, jnp.asarray(x), jcfg,
                            capacity_factor=capacity_factor)
    ot, at = tmoe.moe_apply(tp, torch.from_numpy(x), tcfg,
                            capacity_factor=capacity_factor)
    _close(ot, oj, MOE_TOL)
    _close(at, aj, REF_TOL)


def test_moe_capacity_drop_passthrough():
    """Dropped tokens pass through the residual stream unchanged."""
    _, tcfg, _, tp = _moe_pair()
    x = torch.from_numpy(np.random.default_rng(9).normal(
        0, 1, (2, 16, tcfg.d_model)).astype(np.float32))
    small, _ = tmoe.moe_apply(tp, x, tcfg, capacity_factor=0.01)
    big, _ = tmoe.moe_apply(tp, x, tcfg, capacity_factor=2.0)
    assert float(small.abs().mean()) < float(big.abs().mean())
    # capacity 1 per expert: all but E * C slots contribute nothing
    N, k = 32, tcfg.top_k
    zero_rows = int((small.reshape(N, -1).abs().sum(-1) == 0).sum())
    assert zero_rows >= N - tcfg.n_experts


def test_top_k_breaks_ties_toward_the_lower_index():
    probs = np.array([[0.2, 0.3, 0.3, 0.2], [0.25, 0.25, 0.25, 0.25],
                      [0.1, 0.4, 0.1, 0.4], [0.4, 0.1, 0.4, 0.1]],
                     np.float32)
    for k in (1, 2, 3):
        jv, ji = jax.lax.top_k(jnp.asarray(probs), k)
        tv, ti = tmoe.top_k(torch.from_numpy(probs), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("dispatch", ["sort", "cumsum"])
def test_moe_tied_router_logits_routed_as_reference(dispatch):
    """Experts with equal router columns tie on every token: the reference
    takes the lower expert, so must the port (same outputs, same drops)."""
    jcfg, tcfg, jp, tp = _moe_pair()
    jcfg, tcfg = (dataclasses.replace(c, moe_dispatch=dispatch)
                  for c in (jcfg, tcfg))
    router = np.array(jp["router"])
    router[:, 1] = router[:, 0]            # experts 0 and 1 always tie
    router[:, 3] = router[:, 2]            # ... and 2 and 3
    jp = dict(jp, router=jnp.asarray(router))
    tp = dict(tp, router=torch.from_numpy(router))
    x = np.random.default_rng(10).normal(0, 1, (2, 16, jcfg.d_model)).astype(
        np.float32)
    oj, aj = jmoe.moe_apply(jp, jnp.asarray(x), jcfg, capacity_factor=0.6)
    ot, at = tmoe.moe_apply(tp, torch.from_numpy(x), tcfg,
                            capacity_factor=0.6)
    _close(ot, oj, MOE_TOL)
    _close(at, aj, REF_TOL)


# ------------------------------------------------------ configs, specs --


def _fields(cfg):
    return dataclasses.asdict(cfg)


@pytest.mark.parametrize("arch", jreg.ARCH_IDS)
def test_configs_equal_the_reference(arch):
    assert treg.ARCH_IDS == jreg.ARCH_IDS
    for opt in (False, True):
        assert _fields(treg.get_config(arch, optimized=opt)) == \
            _fields(jreg.get_config(arch, optimized=opt))
    assert _fields(treg.get_smoke_config(arch)) == \
        _fields(jreg.get_smoke_config(arch))


def test_registry_tables_equal_the_reference():
    assert treg.OPTIMIZED_KNOBS == jreg.OPTIMIZED_KNOBS
    assert treg.SHAPE_IDS == jreg.SHAPE_IDS
    assert {k: dataclasses.asdict(v) for k, v in treg.INPUT_SHAPES.items()} \
        == {k: dataclasses.asdict(v) for k, v in jreg.INPUT_SHAPES.items()}
    assert [f.name for f in dataclasses.fields(ModelConfig)] == \
        [f.name for f in dataclasses.fields(jreg.ModelConfig)]


@pytest.mark.parametrize("arch", jreg.ARCH_IDS)
def test_param_counts_equal_the_reference(arch):
    tcfg, jcfg = treg.get_config(arch), jreg.get_config(arch)
    assert tcfg.param_count() == jcfg.param_count()
    assert tcfg.active_param_count() == jcfg.active_param_count()
    assert (tcfg.padded_vocab, tcfg.d_inner, tcfg.ssm_heads) == \
        (jcfg.padded_vocab, jcfg.d_inner, jcfg.ssm_heads)


@pytest.mark.parametrize("arch", jreg.ARCH_IDS)
def test_param_specs_match_the_reference(arch):
    """The port's parameter tree has the reference's keys, shapes and
    types, on ``meta``, at the full configs."""
    jspec = JM.param_specs(jreg.get_config(arch))
    tspec = TM.param_specs(treg.get_config(arch))
    jl = jax.tree_util.tree_flatten_with_path(jspec)[0]
    tl = jax.tree_util.tree_flatten_with_path(tspec)[0]
    assert [jax.tree_util.keystr(p) for p, _ in jl] == \
        [jax.tree_util.keystr(p) for p, _ in tl]
    for (_, j), (_, t) in zip(jl, tl):
        assert tuple(j.shape) == tuple(t.shape)
        assert str(j.dtype) == str(t.dtype).removeprefix("torch.")
        assert t.is_meta


def test_param_specs_dbrx_allocates_nothing():
    specs = TM.param_specs(treg.get_config("dbrx-132b"))
    leaves = jax.tree.leaves(specs)
    assert all(isinstance(t, torch.Tensor) and t.is_meta for t in leaves)
    assert sum(t.numel() for t in leaves) > 100e9


def test_params_from_reference_refuses_a_wrong_tree(models):
    jcfg, tcfg, jp, _ = models("granite-3-8b")
    tree = jax.tree.map(np.asarray, jp)
    bad = dict(tree, final_norm={"scale": np.ones(7, np.float32)})
    with pytest.raises(ValueError, match="final_norm/scale"):
        params_from_reference(bad, tcfg, device=CPU)
    with pytest.raises(ValueError, match="keys"):
        params_from_reference(dict(tree, extra={}), tcfg, device=CPU)


def test_params_from_reference_takes_bf16(models):
    jcfg, tcfg = _configs("zamba2-7b")
    jcfg, tcfg = (dataclasses.replace(c, dtype="bfloat16")
                  for c in (jcfg, tcfg))
    jp = JM.init_params(KEY, jcfg)
    tp = params_from_reference(jax.tree.map(np.asarray, jp), tcfg,
                               device=CPU)
    w = tp["layers"]["mamba"]["in_proj"]
    assert w.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        w.float().numpy(),
        np.asarray(jp["layers"]["mamba"]["in_proj"]).astype(np.float32))


def test_init_params_is_seeded_and_at_the_reference_scales():
    cfg = treg.get_smoke_config("zamba2-7b")
    a = TM.init_params(3, cfg, device=CPU)
    b = TM.init_params(3, cfg, device=CPU)
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        assert torch.equal(x, y)
    spec = TM.param_specs(cfg)
    for x, s in zip(jax.tree.leaves(a), jax.tree.leaves(spec)):
        assert x.shape == s.shape and x.dtype == s.dtype
    m = a["layers"]["mamba"]
    std = lambda t: float(t.float().std())           # noqa: E731
    assert abs(std(m["in_proj"]) * cfg.d_model ** 0.5 - 1) < 0.05
    assert abs(std(m["conv_w"]) / 0.5 - 1) < 0.05
    assert abs(std(a["embed"]["table"]) / 0.02 - 1) < 0.05
    assert torch.equal(m["D"], torch.ones_like(m["D"]))


@pytest.mark.parametrize("call", ["init_params", "init_decode_state",
                                  "params_from_reference",
                                  "decode_state_from_reference"])
def test_entry_points_default_to_cuda(call):
    """Without ``device=`` the entry points ask for the card and raise
    when it is absent; nothing falls back to the CPU in secret."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    cfg = treg.get_smoke_config("granite-3-8b")
    fn = {"init_params": lambda: TM.init_params(0, cfg),
          "init_decode_state": lambda: TM.init_decode_state(cfg, 1, 8),
          "params_from_reference": lambda: params_from_reference({}, cfg),
          "decode_state_from_reference":
              lambda: decode_state_from_reference({})}[call]
    with pytest.raises(RuntimeError, match="cuda"):
        fn()
