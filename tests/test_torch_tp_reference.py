"""The port's tensor-parallel train step against the reference's sharded
step (``repro.training.train.make_sharded_train_step``: GSPMD over the
same specs), on the CPU.

One subprocess runs the reference on 4 forced host devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=4``, as
``tests/test_sharding.py`` does) for the granite-3-8b, zamba2 and mamba2
smoke configs on the meshes (1, 4) and (2, 2), and writes its initial
parameters, the batch and each step's loss and ``grad_norm``.  Then, per
mesh, 4 gloo processes start from the same parameters
(``models.convert.params_from_reference``), take their shards
(``shard_state``) and run the port's step on the same batch.  Bounds: the
loss within 1e-5 and ``grad_norm`` within 1e-4, relative to the
reference's.  Nothing in the JAX package changes for this.
"""

import ast
import os
import pickle
import subprocess
import sys
import textwrap

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ("granite-3-8b", "zamba2-7b", "mamba2-370m")
MESHES = ((1, 4), (2, 2))
B, SEQ = 4, 32

REFERENCE = textwrap.dedent("""
    import pickle, sys
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs.registry import get_smoke_config
    from repro.launch.mesh import make_host_mesh
    from repro.training.optimizer import AdamWConfig
    from repro.training.train import init_state, make_sharded_train_step

    out = {}
    ocfg = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    B, SEQ = %(b)d, %(seq)d
    shapes = {k: jax.ShapeDtypeStruct((B, SEQ), jnp.int32)
              for k in ("tokens", "targets")}
    for arch in %(archs)r:
        cfg = get_smoke_config(arch)
        state = init_state(jax.random.PRNGKey(0), cfg)
        toks = jax.random.randint(jax.random.PRNGKey(1), (B, SEQ), 0,
                                  cfg.vocab)
        rec = dict(params=jax.tree.map(np.asarray, state.params),
                   tokens=np.asarray(toks))
        for dims in %(meshes)r:
            mesh = make_host_mesh(*dims)
            fn, state_sh, d_sh = make_sharded_train_step(
                cfg, ocfg, mesh, shapes, remat=False)
            # a fresh state each time: the step donates its argument
            st = jax.device_put(init_state(jax.random.PRNGKey(0), cfg),
                                state_sh)
            batch = jax.device_put({"tokens": toks, "targets": toks}, d_sh)
            _, m = fn(st, batch)
            rec[dims] = (float(m["loss"]), float(m["grad_norm"]))
        out[arch] = rec
    with open(sys.argv[1], "wb") as f:
        pickle.dump(out, f)
""") % dict(archs=ARCHS, meshes=MESHES, b=B, seq=SEQ)

PORT = textwrap.dedent("""
    import os, pickle, sys, tempfile
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    def worker(rank, init, dims, path, out):
        from repro_torch.configs.registry import get_smoke_config
        from repro_torch.dist.tensor_parallel import shard_state
        from repro_torch.launch.mesh import make_host_mesh
        from repro_torch.models.convert import params_from_reference
        from repro_torch.training import optimizer as opt
        from repro_torch.training import train as T
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=init, world_size=4,
                                rank=rank)
        with open(path, "rb") as f:
            ref = pickle.load(f)
        mesh = make_host_mesh(*dims)
        res = {}
        for arch, rec in ref.items():
            cfg = get_smoke_config(arch)
            ocfg = opt.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
            toks = torch.from_numpy(rec["tokens"]).long()
            meta = torch.empty(tuple(toks.shape), dtype=torch.int64,
                               device="meta")
            fn, _, _ = T.make_sharded_train_step(
                cfg, ocfg, mesh, {"tokens": meta, "targets": meta},
                remat=False)
            params = params_from_reference(rec["params"], cfg,
                                           device="cpu")
            state = T.TrainState(params=params, opt=opt.init(params))
            _, m = fn(shard_state(state, mesh, rank),
                      {"tokens": toks, "targets": toks})
            res[arch] = (float(m["loss"]), float(m["grad_norm"]))
        dist.destroy_process_group()
        if rank == 0:
            out.put(res)

    if __name__ == "__main__":
        dims = tuple(int(x) for x in sys.argv[1].split("x"))
        ctx = mp.get_context("spawn")
        q = ctx.SimpleQueue()
        with tempfile.TemporaryDirectory() as d:
            init = "file://" + os.path.join(d, "store")
            procs = [ctx.Process(target=worker,
                                 args=(r, init, dims, sys.argv[2], q))
                     for r in range(4)]
            for p in procs:
                p.start()
            for p in procs:
                p.join(600)
            codes = [p.exitcode for p in procs]
            assert codes == [0, 0, 0, 0], codes
            print("TP_PORT", repr(q.get()))
""")


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    d = tmp_path_factory.mktemp("tp_ref")
    path = d / "ref.pkl"
    script = d / "ref.py"
    script.write_text(REFERENCE)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    out = subprocess.run([sys.executable, str(script), str(path)], env=env,
                         capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    with open(path, "rb") as f:
        return path, pickle.load(f)


@pytest.mark.parametrize("dims", MESHES, ids=["1x4", "2x2"])
def test_tp_step_matches_reference_sharded_step(reference, tmp_path, dims):
    path, ref = reference
    script = tmp_path / "port.py"
    script.write_text(PORT)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, str(script),
                          "x".join(map(str, dims)), str(path)], env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    line = [x for x in out.stdout.splitlines() if x.startswith("TP_PORT")]
    assert line, out.stdout[-2000:]
    got = ast.literal_eval(line[0][len("TP_PORT "):])
    for arch in ARCHS:
        loss, gnorm = got[arch]
        r_loss, r_gnorm = ref[arch][dims]
        assert abs(loss - r_loss) <= 1e-5 * abs(r_loss), (arch, loss,
                                                          r_loss)
        assert abs(gnorm - r_gnorm) <= 1e-4 * r_gnorm, (arch, gnorm,
                                                        r_gnorm)
