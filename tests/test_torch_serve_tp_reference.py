"""The port's sharded serving steps against the reference's (the jitted
prefill and ``make_serve_step`` of ``repro.launch.dryrun.build``: GSPMD
over the same specs), on the CPU.

One subprocess runs the reference on 4 forced host devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=4``) for the smoke
configs of granite-3-8b, zamba2-7b and phi3.5-moe (its router set so
that slots are dropped at capacity) on ``make_host_mesh(1, 4)`` and
``(2, 2)``: the prefill jitted with the parameters on ``param_shardings``
and the batch on ``data_specs``; the serve step with the caches on
``decode_state_specs_tree``, the input's rows over the data axes and
the caches donated, driven over a prompt of ``PROMPT`` tokens fed one
at a time and ``NEW`` greedy steps.  It writes the initial parameters,
the inputs, the prefill's logits and each decode step's logits and
tokens.  Then one spawn of 4 gloo processes runs the port's
``make_sharded_prefill`` and ``make_sharded_serve_step`` on each mesh
from the same parameters (``models.convert.params_from_reference``, each
rank its shards).  Bounds: the logits within 1e-5 relative (max|d| over
max|ref|) of the reference's, the greedy tokens equal.  Nothing in the
JAX package changes for this.
"""

import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from test_torch_ep import HELPERS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = ((1, 4), (2, 2))
B, T, SEQ, PROMPT, NEW = 4, 16, 32, 4, 4
TOL = 1e-5
CONFIGS = (("granite", "granite-3-8b", {}),
           ("zamba2", "zamba2-7b", {}),
           ("phi3.5", "phi3.5-moe-42b-a6.6b", {}))

REFERENCE = HELPERS + textwrap.dedent("""
    import pickle, sys
    import jax, jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.configs.registry import get_smoke_config
    from repro.dist import sharding as shd
    from repro.launch.mesh import make_host_mesh
    from repro.models import model as M
    from repro.serving.engine import make_serve_step

    B, T, SEQ, PROMPT, NEW = %(b)d, %(t)d, %(seq)d, %(prompt)d, %(new)d
    out = {}
    for name, arch, over in %(configs)r:
        cfg = config(arch, over, get_smoke_config)
        params = M.init_params(jax.random.PRNGKey(0), cfg)
        if cfg.is_moe:
            r = params["layers"]["moe"]["router"]
            params["layers"]["moe"]["router"] = jnp.asarray(
                dropping_router(tuple(r.shape), 2))
        tokens = np.random.default_rng(1).integers(
            0, cfg.vocab, (B, T)).astype(np.int32)
        rec = dict(params=jax.tree.map(np.asarray, params), tokens=tokens)
        p_sds = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape,
                                                            a.dtype), params)
        for dims in %(meshes)r:
            mesh = make_host_mesh(*dims)
            p_sh = shd.param_shardings(mesh, p_sds)
            batch = {"tokens": tokens}
            d_sh = {k: NamedSharding(mesh, s) for k, s in shd.data_specs(
                mesh, {k: jax.ShapeDtypeStruct(v.shape, v.dtype)
                       for k, v in batch.items()}).items()}

            def prefill(params, batch):
                return M.forward(params, batch, cfg, remat=False,
                                 last_only=True)[0]

            with mesh:
                pre = jax.jit(prefill, in_shardings=(p_sh, d_sh))(
                    jax.device_put(params, p_sh),
                    jax.device_put(batch, d_sh))
            state = M.init_decode_state(cfg, B, SEQ)
            st_sh = jax.tree.map(
                lambda s: NamedSharding(mesh, s),
                shd.decode_state_specs_tree(mesh, state, B),
                is_leaf=lambda x: isinstance(x, P))
            bspec = shd.batch_spec(mesh, B)
            inp_sh = NamedSharding(mesh, P(*(tuple(bspec) + (None,))))
            step = jax.jit(make_serve_step(cfg, seq_len=SEQ),
                           in_shardings=(p_sh, st_sh, inp_sh,
                                         NamedSharding(mesh, P())),
                           out_shardings=(None, st_sh), donate_argnums=(1,))
            state = jax.device_put(state, st_sh)
            sharded = jax.device_put(params, p_sh)
            logits, toks = [], []
            inp = tokens[:, :1]
            with mesh:
                for t in range(PROMPT + NEW):
                    if t < PROMPT:
                        inp = tokens[:, t:t + 1]
                    lg, state = step(sharded, state, jnp.asarray(inp),
                                     jnp.int32(t))
                    lg = np.asarray(lg[:, 0])
                    inp = lg[:, :cfg.vocab].argmax(-1)[:, None].astype(
                        np.int32)
                    logits.append(lg)
                    toks.append(inp[:, 0].tolist())
            rec[dims] = dict(prefill=np.asarray(pre), logits=logits,
                             tokens=toks)
        out[name] = rec
    with open(sys.argv[1], "wb") as f:
        pickle.dump(out, f)
""") % dict(configs=CONFIGS, meshes=MESHES, b=B, t=T, seq=SEQ,
            prompt=PROMPT, new=NEW)

PORT = HELPERS + textwrap.dedent("""
    import os, pickle, sys, tempfile
    import torch.distributed as dist
    import torch.multiprocessing as mp

    CONFIGS, MESHES = %(configs)r, %(meshes)r
    B, T, SEQ, PROMPT, NEW = %(b)d, %(t)d, %(seq)d, %(prompt)d, %(new)d

    def worker(rank, init, path, out):
        from repro_torch.configs.registry import get_smoke_config
        from repro_torch.dist.tensor_parallel import shard_tree
        from repro_torch.launch.mesh import make_host_mesh
        from repro_torch.models import model as M
        from repro_torch.models.convert import params_from_reference
        from repro_torch.serving import engine as E
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=init, world_size=4,
                                rank=rank)
        with open(path, "rb") as f:
            ref = pickle.load(f)
        res = {}
        for name, arch, over in CONFIGS:
            rec = ref[name]
            cfg = config(arch, over, get_smoke_config)
            params = params_from_reference(rec["params"], cfg, device="cpu")
            tokens = torch.from_numpy(rec["tokens"]).long()
            for dims in MESHES:
                mesh = make_host_mesh(*dims)
                local = shard_tree(params, mesh, rank)
                pre, _, _ = E.make_sharded_prefill(
                    cfg, mesh, {"tokens": tokens})
                lg = pre(local, {"tokens": tokens})
                prefill = pre.dp.whole(lg, B, 0)
                serve, _, _ = E.make_sharded_serve_step(
                    cfg, mesh, seq_len=SEQ, batch=B)
                state = M.init_decode_state(cfg, B // serve.dp.n, SEQ,
                                            device="cpu")
                logits, toks = [], []
                inp = tokens[:, :1]
                for t in range(PROMPT + NEW):
                    if t < PROMPT:
                        inp = tokens[:, t:t + 1]
                    lg, state = serve(local, state, inp, t)
                    lg = serve.dp.whole(lg[:, 0], B, 0)
                    inp = lg[:, :cfg.vocab].argmax(-1)[:, None]
                    logits.append(lg.numpy())
                    toks.append(inp[:, 0].tolist())
                res[name, dims] = dict(prefill=prefill.numpy(),
                                       logits=logits, tokens=toks)
        dist.destroy_process_group()
        if rank == 0:
            with open(path + ".port", "wb") as f:
                pickle.dump(res, f)
            out.put("done")

    if __name__ == "__main__":
        ctx = mp.get_context("spawn")
        q = ctx.SimpleQueue()
        with tempfile.TemporaryDirectory() as d:
            init = "file://" + os.path.join(d, "store")
            procs = [ctx.Process(target=worker,
                                 args=(r, init, sys.argv[1], q))
                     for r in range(4)]
            for p in procs:
                p.start()
            for p in procs:
                p.join(600)
            codes = [p.exitcode for p in procs]
            assert codes == [0, 0, 0, 0], codes
            print("SERVE_PORT", q.get())
""") % dict(configs=CONFIGS, meshes=MESHES, b=B, t=T, seq=SEQ,
            prompt=PROMPT, new=NEW)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("serve_ref")
    path = d / "ref.pkl"
    (d / "ref.py").write_text(REFERENCE)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    out = subprocess.run([sys.executable, str(d / "ref.py"), str(path)],
                         env=env, capture_output=True, text=True,
                         timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    with open(path, "rb") as f:
        ref = pickle.load(f)
    (d / "port.py").write_text(PORT)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, str(d / "port.py"), str(path)],
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "SERVE_PORT done" in out.stdout, out.stdout[-2000:]
    with open(str(path) + ".port", "rb") as f:
        return ref, pickle.load(f)


def _rel(a, b):
    return float(np.abs(a - b).max()) / max(float(np.abs(b).max()), 1e-30)


@pytest.mark.parametrize("dims", MESHES, ids=["1x4", "2x2"])
def test_sharded_serving_matches_the_reference(runs, dims):
    ref, got = runs
    for name, _, _ in CONFIGS:
        want, mine = ref[name][dims], got[name, dims]
        assert mine["prefill"].shape == want["prefill"].shape, name
        err = _rel(mine["prefill"], want["prefill"])
        assert err <= TOL, (name, "prefill", err)
        for t, (a, b) in enumerate(zip(mine["logits"], want["logits"])):
            err = _rel(a, b)
            assert err <= TOL, (name, t, err)
        assert mine["tokens"] == want["tokens"], (name, mine["tokens"],
                                                   want["tokens"])
