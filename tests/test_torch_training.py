"""The port's training substrate (``repro_torch.training``,
``repro_torch.data.lm_pipeline``, the bf16 leaves of
``repro_torch.runtime.snapshot``) against the JAX reference on the CPU.

Inputs are made with numpy from seeds; the reference's parameters and
optimizer state come across by ``params_from_reference`` and
``opt_state_from_reference``.  Bounds:

- ``optimizer.apply`` within 2 float32 ulps of the reference's (the
  same arithmetic; sums in another order), and ``schedule`` for steps
  0-99 within 2 ulps of the peak lr;
- three ``make_train_step`` steps: loss within 1e-4, and every first
  moment and parameter leaf within 2e-4 x max(1, max|x|) of the
  reference's after each step (``test_torch_lm_grad.py``'s bounds);
- the Markov pipeline's tokens equal to the reference's; a bf16
  checkpoint leaf bit for bit, and the npz members byte for byte.
"""

import dataclasses
import os
import tempfile
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.data import lm_pipeline as jpipe
from repro.runtime import snapshot as jsnap
from repro.training import optimizer as jopt
from repro.training import train as jtrain
from repro_torch.configs import registry as treg
from repro_torch.data import lm_pipeline as tpipe
from repro_torch.models.convert import (opt_state_from_reference,
                                        params_from_reference)
from repro_torch.runtime import snapshot as tsnap
from repro_torch.training import checkpoint as ckpt
from repro_torch.training import optimizer as opt
from repro_torch.training import train as ttrain

KEY = jax.random.PRNGKey(0)
CPU = "cpu"
ULPS = 2


def _t(a):
    return torch.from_numpy(np.array(a))


def _state_leaves(state) -> list:
    """The tensors of a ``TrainState`` in a fixed order."""
    return (opt.tree_leaves(state.params) + opt.tree_leaves(state.opt.mu)
            + opt.tree_leaves(state.opt.nu) + [state.opt.step])


def _ulps(got: np.ndarray, want: np.ndarray) -> float:
    """max |got - want| in float32 ulps of the larger magnitude."""
    got, want = got.astype(np.float32), want.astype(np.float32)
    ulp = np.spacing(np.maximum(np.abs(got), np.abs(want)))
    return float((np.abs(got - want) / ulp).max())


# -------------------------------------------------------------- optimizer --


def _opt_tree(rng, scale):
    return {"w": rng.normal(0, scale, (32, 24)).astype(np.float32),
            "b": rng.normal(0, scale, (24,)).astype(np.float32),
            "blk": {"k": rng.normal(0, scale, (3, 8, 16)).astype(np.float32),
                    "h": rng.normal(0, scale, (40, 16)).astype(np.float32)}}


@pytest.mark.parametrize("clipped", [False, True])
def test_adamw_apply_matches_reference(clipped):
    """One ``apply`` from the same float32 + bf16 state at step 7: the
    moments, the float32 parameters, the grad norm and the lr within 2
    ulps; the bf16 leaves ("blk") equal.  The clipped case's gradients
    are +-0.25 and +-0.5, so the global norm's sum of squares is exact in
    any order and both packages clip by the same factor."""
    rng = np.random.default_rng(11)
    p, g = _opt_tree(rng, 1.0), _opt_tree(rng, 1e-3)
    if clipped:
        g = jax.tree.map(lambda a: rng.choice(
            np.float32([-0.5, -0.25, 0.25, 0.5]), a.shape), g)
    mu, nu = _opt_tree(rng, 0.01), _opt_tree(rng, 0.01)
    nu = jax.tree.map(np.square, nu)
    cfg = dict(lr=1e-2, warmup_steps=3, total_steps=20)

    def as_j(tree, bf):
        return {k: (as_j(v, True) if isinstance(v, dict) else
                    jnp.asarray(v, jnp.bfloat16 if bf else jnp.float32))
                for k, v in tree.items()}

    def as_t(tree, bf):
        return {k: (as_t(v, True) if isinstance(v, dict) else
                    _t(v).to(torch.bfloat16 if bf else torch.float32))
                for k, v in tree.items()}
    jstate = jopt.OptState(mu=jax.tree.map(jnp.asarray, mu),
                           nu=jax.tree.map(jnp.asarray, nu),
                           step=jnp.int32(7))
    tstate = opt.OptState(mu=opt.tree_map(_t, mu), nu=opt.tree_map(_t, nu),
                          step=torch.tensor(7, dtype=torch.int32))
    # op by op: under jit XLA regroups the scalar factors of the moment
    # update (g * scale * (1 - b1)), a third rounding order
    jp, js, jm = jopt.apply(jopt.AdamWConfig(**cfg), as_j(p, False),
                            as_j(g, False), jstate)
    tp, ts, tm = opt.apply(opt.AdamWConfig(**cfg), as_t(p, False),
                           as_t(g, False), tstate)
    assert int(ts.step) == 8 and ts.step.dtype == torch.int32
    for k in ("grad_norm", "lr"):
        assert _ulps(np.float32(tm[k]), np.float32(jm[k])) <= ULPS
    for jt, tt in ((js.mu, ts.mu), (js.nu, ts.nu)):
        for a, b in zip(jax.tree.leaves(jt), opt.tree_leaves(tt)):
            assert b.dtype == torch.float32
            assert _ulps(b.numpy(), np.asarray(a)) <= ULPS
    for a, b in zip(jax.tree.leaves(jp), opt.tree_leaves(tp)):
        if b.dtype == torch.bfloat16:
            want = np.asarray(a.astype(jnp.float32))
            assert np.array_equal(b.float().numpy(), want)
        else:
            assert _ulps(b.numpy(), np.asarray(a)) <= ULPS


def test_schedule_matches_reference():
    """Within 2 float32 ulps of the peak lr: the two libraries' float32
    cosines differ by an ulp, which 1 + cos magnifies near the end of
    the decay."""
    cfg = dict(lr=3e-4, warmup_steps=10, total_steps=90, min_lr_frac=0.1)
    bound = ULPS * float(np.spacing(np.float32(cfg["lr"])))
    for s in range(100):
        want = jopt.schedule(jopt.AdamWConfig(**cfg), jnp.int32(s))
        got = opt.schedule(opt.AdamWConfig(**cfg),
                           torch.tensor(s, dtype=torch.int32))
        assert got.dtype == torch.float32
        assert abs(float(got) - float(want)) <= bound, s


def test_adamw_reduces_quadratic():
    cfg = opt.AdamWConfig(lr=0.1, warmup_steps=1, total_steps=200,
                          weight_decay=0.0)
    params = {"w": torch.tensor([3.0, -2.0, 5.0])}
    state = opt.init(params)
    for _ in range(150):
        grads = {"w": 2 * params["w"]}
        params, state, m = opt.apply(cfg, params, grads, state)
    assert float(params["w"].abs().max()) < 0.2


def test_lr_schedule_warmup_and_decay():
    cfg = opt.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100,
                          min_lr_frac=0.1)
    lrs = [float(opt.schedule(cfg, torch.tensor(s, dtype=torch.int32)))
           for s in range(100)]
    assert lrs[0] < lrs[9] <= 1.0          # warmup
    assert lrs[99] < 0.2                   # decayed
    assert lrs[99] >= 0.099                # floor


def test_grad_clip_applied():
    cfg = opt.AdamWConfig(lr=1e-3, grad_clip=1.0, warmup_steps=1,
                          total_steps=10)
    params = {"w": torch.zeros(4)}
    state = opt.init(params)
    _, _, m = opt.apply(cfg, params, {"w": torch.full((4,), 100.0)}, state)
    assert float(m["grad_norm"]) > 100.0  # raw norm reported


def test_apply_leaves_its_arguments_as_they_were():
    params = {"w": torch.ones(3, 2), "b": torch.ones(2, dtype=torch.bfloat16)}
    state = opt.init(params)
    grads = opt.tree_map(torch.ones_like, params)
    before = [t.clone() for t in opt.tree_leaves(params)
              + opt.tree_leaves(grads)]
    new, st, _ = opt.apply(opt.AdamWConfig(), params, grads, state)
    assert all(torch.equal(a, b) for a, b in
               zip(before, opt.tree_leaves(params) + opt.tree_leaves(grads)))
    assert int(state.step) == 0 and float(state.mu["w"].abs().sum()) == 0
    assert new["b"].dtype == torch.bfloat16 and st.mu["b"].dtype == \
        torch.float32


# ------------------------------------------------------------ train step --


def _batch(cfg, seed, b=2, t=16):
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
    return out


@pytest.mark.parametrize("arch", jreg.ARCH_IDS)
def test_three_train_steps_match_reference(arch):
    jcfg, tcfg = jreg.get_smoke_config(arch), treg.get_smoke_config(arch)
    # eps 1e-3 keeps the update a smooth function of the gradient: at 1e-8
    # an element whose gradient is rounding noise (|g| ~ 1e-9 of a leaf
    # whose max|g| is ~1e-2) moves by about +-lr in either package
    ocfg = dict(lr=1e-3, warmup_steps=2, total_steps=10, eps=1e-3)
    jstate = jtrain.init_state(KEY, jcfg)
    host = jax.tree.map(np.asarray, jstate)
    tstate = ttrain.TrainState(
        params=params_from_reference(host.params, tcfg, device=CPU),
        opt=opt_state_from_reference(host.opt, tcfg, device=CPU))
    jstep = jax.jit(jtrain.make_train_step(jcfg, jopt.AdamWConfig(**ocfg),
                                           remat=False))
    tstep = ttrain.make_train_step(tcfg, opt.AdamWConfig(**ocfg),
                                   remat=False)
    for i in range(3):
        batch = _batch(jcfg, 20 + i)
        jstate, jm = jstep(jstate, batch)
        tstate, tm = tstep(tstate, {k: _t(v) for k, v in batch.items()})
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= 1e-4, i
        assert abs(float(tm["total"]) - float(jm["total"])) <= 1e-4, i
        assert int(tstate.opt.step) == i + 1
        for want, got in zip(jax.tree.leaves(jstate.opt.mu),
                             opt.tree_leaves(tstate.opt.mu)):
            want = np.asarray(want)   # gradients, accumulated
            err = float(np.abs(got.numpy() - want).max())
            assert err <= 2e-4 * max(1.0, float(np.abs(want).max())), i
        flat = jax.tree_util.tree_flatten_with_path(jstate.params)[0]
        for (path, want), got in zip(flat,
                                     opt.tree_leaves(tstate.params)):
            want = np.asarray(want)
            err = float(np.abs(got.numpy() - want).max())
            bound = 2e-4 * max(1.0, float(np.abs(want).max()))
            assert err <= bound, (i, jax.tree_util.keystr(path), err)


def test_training_learns_markov_structure():
    """End-to-end: loss falls well below the uniform-entropy baseline."""
    cfg = treg.get_smoke_config("qwen1.5-4b")
    ocfg = opt.AdamWConfig(lr=2e-3, warmup_steps=10, total_steps=120)
    it = ({"tokens": b["targets"], "targets": b["targets"]}
          for b in tpipe.batches(cfg.vocab, 8, 64, seed=3, device=CPU))
    state, hist = ttrain.train_loop(cfg, ocfg, it, steps=60, log_every=10,
                                    remat=False, device=CPU)
    uniform = np.log(cfg.vocab)
    assert hist[-1]["loss"] < hist[0]["loss"]
    assert hist[-1]["loss"] < uniform - 0.5
    assert set(hist[-1]) == {"loss", "aux_loss", "total", "grad_norm", "lr",
                             "step", "wall"}


def test_train_checkpoint_resume_continuity():
    """A run checkpointed at step 10 restores bit for bit, and its step 11
    from the restored state equals the step 11 of the live state."""
    cfg = treg.get_smoke_config("mamba2-370m")
    ocfg = opt.AdamWConfig(lr=1e-3, warmup_steps=5, total_steps=50)
    it = ({"tokens": b["targets"], "targets": b["targets"]}
          for b in tpipe.batches(cfg.vocab, 4, 32, seed=5, device=CPU))
    with tempfile.TemporaryDirectory() as d:
        state, _ = ttrain.train_loop(cfg, ocfg, it, steps=10,
                                     checkpoint_dir=d, checkpoint_every=10,
                                     remat=False, device=CPU)
        fresh = ttrain.init_state(99, cfg, device=CPU)
        restored, step = ckpt.restore(d, fresh)
        assert step == 10 and ckpt.latest_step(d) == 10
        for a, b in zip(_state_leaves(state),
                        _state_leaves(restored)):
            assert a.dtype == b.dtype and torch.equal(a, b)
        batch = next(it)
        step_fn = ttrain.make_train_step(cfg, ocfg, remat=False)
        live, _ = step_fn(state, batch)
        again, _ = step_fn(restored, batch)
        for a, b in zip(_state_leaves(live),
                        _state_leaves(again)):
            assert torch.equal(a, b)


def test_checkpoint_latest_step():
    state = ttrain.init_state(0, treg.get_smoke_config("granite-3-8b"),
                              device=CPU)
    with tempfile.TemporaryDirectory() as d:
        assert ckpt.latest_step(d) is None
        with pytest.raises(FileNotFoundError):
            ckpt.restore(d, state)
        ckpt.save(d, state, 3)
        ckpt.save(d, state, 12)
        assert ckpt.latest_step(d) == 12
        assert ckpt.restore(d, state, step=3)[1] == 3


# -------------------------------------------------------------- pipeline --


@pytest.mark.parametrize("seed", range(4))
def test_markov_batches_equal_reference(seed):
    kinds = [dict(), dict(embeds_dim=8),
             dict(image_tokens=3, d_model=8)]
    for kw in kinds:
        jit = jpipe.batches(64, 3, 20, seed=seed, **kw)
        tit = tpipe.batches(64, 3, 20, seed=seed, device=CPU, **kw)
        for _ in range(2):
            want, got = next(jit), next(tit)
            assert sorted(want) == sorted(got)
            for k, v in got.items():
                w = np.asarray(want[k])
                assert v.dtype == (torch.int64 if k in ("tokens", "targets")
                                   else torch.float32)
                assert np.array_equal(v.numpy(), w), (kw, k)


def test_markov_corpus_samples_equal_reference():
    a, b = jpipe.MarkovCorpus(64, branching=4, seed=2), \
        tpipe.MarkovCorpus(64, branching=4, seed=2)
    assert np.array_equal(a.sample(500), b.sample(500))


# ------------------------------------------------------ bf16 checkpoints --


def test_bf16_leaf_saved_by_reference_loads_bit_for_bit(tmp_path):
    rng = np.random.default_rng(4)
    vals = rng.normal(0, 3, (5, 7)).astype(np.float32)
    want = jnp.asarray(vals, jnp.bfloat16)
    path = str(tmp_path / "ref.npz")
    jsnap.save_pytree(path, {"w": want, "s": jnp.int32(3)})
    got, _ = tsnap.load_pytree(path, {
        "w": torch.zeros(5, 7, dtype=torch.bfloat16),
        "s": torch.zeros((), dtype=torch.int32)})
    assert got["w"].dtype == torch.bfloat16 and int(got["s"]) == 3
    assert np.array_equal(got["w"].view(torch.int16).numpy(),
                          np.asarray(want).view(np.int16))
    assert tsnap.verify_pytree(path) == "verified"


def test_bf16_checkpoint_members_byte_identical_to_reference(tmp_path):
    """A bf16 train state saved by both packages: every npz member (the
    leaves, their records and digest) byte for byte, and the port
    restores the reference's file bit for bit."""
    jcfg = dataclasses.replace(jreg.get_smoke_config("zamba2-7b"),
                               dtype="bfloat16")
    tcfg = dataclasses.replace(treg.get_smoke_config("zamba2-7b"),
                               dtype="bfloat16")
    jstate = jtrain.init_state(KEY, jcfg)
    host = jax.tree.map(np.asarray, jstate)
    tstate = ttrain.TrainState(
        params=params_from_reference(host.params, tcfg, device=CPU),
        opt=opt_state_from_reference(host.opt, tcfg, device=CPU))
    ref_dir, port_dir = str(tmp_path / "ref"), str(tmp_path / "port")
    os.makedirs(ref_dir)
    from repro.training import checkpoint as jckpt
    jckpt.save(ref_dir, jstate, 5)
    ckpt.save(port_dir, tstate, 5)
    name = "ckpt_00000005.npz"
    with zipfile.ZipFile(os.path.join(ref_dir, name)) as a, \
            zipfile.ZipFile(os.path.join(port_dir, name)) as b:
        assert sorted(a.namelist()) == sorted(b.namelist())
        for member in a.namelist():
            assert a.read(member) == b.read(member), member
    assert any(t.dtype == torch.bfloat16 for t in
               opt.tree_leaves(tstate.params))
    like = ttrain.init_state(1, tcfg, device=CPU)
    restored, step = ckpt.restore(ref_dir, like)
    assert step == 5
    for a, b in zip(_state_leaves(tstate),
                    _state_leaves(restored)):
        assert a.dtype == b.dtype and torch.equal(a, b)


MASKED_MESHES = ((4, 1), (2, 2))

MASKED = """
import os, pickle, sys, tempfile
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

def worker(rank, init, path, out):
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.dist import tensor_parallel as tpm
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.convert import params_from_reference
    from repro_torch.training import optimizer as opt
    from repro_torch.training import train as T
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, world_size=4,
                            rank=rank)
    with open(path, "rb") as f:
        rec = pickle.load(f)
    cfg = get_smoke_config("granite-3-8b")
    params = params_from_reference(rec["params"], cfg, device="cpu")
    data = {k: torch.from_numpy(v) for k, v in rec["batch"].items()}
    for k in ("tokens", "targets"):
        data[k] = data[k].long()
    _, met, grads = T.loss_and_grads(params, data, cfg, remat=False)
    res = {}
    for dims in %(meshes)r:
        mesh = make_host_mesh(*dims)
        meta = {k: torch.empty(v.shape, device="meta")
                for k, v in data.items()}
        fn, ssh, _ = T.make_sharded_train_step(cfg, opt.AdamWConfig(), mesh,
                                               meta, remat=False)
        _, met_dp, g_dp = fn.loss_and_grads(
            tpm.shard_tree(params, mesh, rank), data)
        whole = tpm.gather_tree(g_dp, mesh, ssh.params)
        worst = max(float((a - b).abs().max())
                    / max(float(b.abs().max()), 1e-30)
                    for a, b in zip(opt.tree_leaves(whole),
                                    opt.tree_leaves(grads)))
        res[dims] = (float(met_dp["loss"]), float(met["loss"]), worst)
    dist.destroy_process_group()
    if rank == 0:
        out.put(res)

if __name__ == "__main__":
    ctx = mp.get_context("spawn")
    q = ctx.SimpleQueue()
    with tempfile.TemporaryDirectory() as d:
        init = "file://" + os.path.join(d, "store")
        procs = [ctx.Process(target=worker, args=(r, init, sys.argv[1], q))
                 for r in range(4)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(600)
        assert [p.exitcode for p in procs] == [0, 0, 0, 0]
        print("MASKED", repr(q.get()))
""" % dict(meshes=MASKED_MESHES)


@pytest.fixture(scope="module")
def masked_runs(tmp_path_factory):
    """The reference's one-process masked loss on granite-3-8b's smoke
    config, and the port's data-parallel step on each of
    ``MASKED_MESHES`` (one spawn of 4 gloo processes), from the same
    parameters and a batch whose mask keeps 32, 9, 20 and 5 tokens of its
    four rows."""
    import ast
    import pickle
    import subprocess
    import sys
    jcfg = jreg.get_smoke_config("granite-3-8b")
    params = jtrain.init_state(KEY, jcfg).params
    rng = np.random.default_rng(7)
    b, t = 4, 32
    batch = {k: rng.integers(0, jcfg.vocab, (b, t)).astype(np.int32)
             for k in ("tokens", "targets")}
    batch["mask"] = (np.arange(t)[None, :] < np.array([32, 9, 20, 5])[
        :, None]).astype(np.float32)
    _, metrics = jtrain.lm_loss(params, batch, jcfg, remat=False)
    d = tmp_path_factory.mktemp("masked")
    path = d / "run.pkl"
    with open(path, "wb") as f:
        pickle.dump(dict(params=jax.tree.map(np.asarray, params),
                         batch=batch), f)
    (d / "masked.py").write_text(MASKED)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.path.join(repo, "src"))
    out = subprocess.run([sys.executable, str(d / "masked.py"), str(path)],
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    line = [x for x in out.stdout.splitlines() if x.startswith("MASKED")]
    assert line, out.stdout[-2000:]
    return float(metrics["loss"]), ast.literal_eval(line[0][len("MASKED "):])


@pytest.mark.parametrize("dims", MASKED_MESHES, ids=["4x1", "2x2"])
def test_masked_loss_is_the_whole_batchs_over_the_data_group(masked_runs,
                                                            dims):
    """The data-parallel step's loss with a ``mask`` whose sums differ
    between the data ranks is the whole batch's masked mean, sum(nll
    mask) / sum(mask), not the mean of the ranks' means: within 1e-5 of
    the reference's one-process loss and of the port's, and every
    gradient leaf, gathered, within 1e-5 max|g| of the one-process
    step's."""
    ref_loss, runs = masked_runs
    loss_dp, loss_one, worst = runs[dims]
    assert abs(loss_dp - ref_loss) <= 1e-5 * abs(ref_loss), (loss_dp,
                                                             ref_loss)
    assert abs(loss_dp - loss_one) <= 1e-5 * abs(loss_one)
    assert worst <= 1e-5, worst
