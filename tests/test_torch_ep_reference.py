"""The port's sharded train step for the ``moe`` and ``vlm`` archs against
the reference's (``repro.training.train.make_sharded_train_step``: GSPMD
over the same specs), on the CPU.

One subprocess runs the reference on 4 forced host devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=4``) for
``tests/test_torch_ep.py``'s configs (dbrx-132b's smoke config with 16
experts and as it is, phi3.5-moe's, llama-3.2-vision's) on the meshes
(1, 4), (2, 2) and (4, 1), with the MoE routers set so that slots are
dropped at capacity and a ``mask`` whose row sums differ between the
data ranks, and writes the initial parameters, the batch and each
step's loss and ``grad_norm``.  Then one spawn of 4 gloo processes runs
the port's step on each mesh from the same parameters
(``models.convert.params_from_reference``, each rank its shards).
Bounds: the loss within 1e-5 and ``grad_norm`` within 1e-4, relative to
the reference's.  On (4, 1) and (2, 2) this holds the routing and the
masked mean over the data group: the capacity, the slots' ranks and the
aux loss of the whole batch, and the whole batch's mask sum.  Nothing in
the JAX package changes for this.
"""

import ast
import os
import pickle
import subprocess
import sys
import textwrap

import pytest

from test_torch_ep import CONFIGS, HELPERS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = ((1, 4), (2, 2), (4, 1))
B, SEQ = 4, 32
LENGTHS = (32, 9, 20, 5)             # each row's unmasked tokens

REFERENCE = HELPERS + textwrap.dedent("""
    import pickle, sys
    import jax, jax.numpy as jnp
    from repro.configs.registry import get_smoke_config
    from repro.launch.mesh import make_host_mesh
    from repro.training.optimizer import AdamWConfig
    from repro.training.train import init_state, make_sharded_train_step

    out = {}
    ocfg = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    B, SEQ, LENGTHS = %(b)d, %(seq)d, %(lengths)r
    for name, arch, over in %(configs)r:
        cfg = config(arch, over, get_smoke_config)

        def state():
            st = init_state(jax.random.PRNGKey(0), cfg)
            if cfg.is_moe:
                r = st.params["layers"]["moe"]["router"]
                st.params["layers"]["moe"]["router"] = jnp.asarray(
                    dropping_router(tuple(r.shape), 2))
            return st

        data = batch(cfg, B, SEQ, 1)
        data["mask"] = (np.arange(SEQ)[None, :]
                        < np.asarray(LENGTHS)[:, None]).astype(np.float32)
        data = {k: v.astype(np.int32) if v.dtype == np.int64 else v
                for k, v in data.items()}
        shapes = {k: jax.ShapeDtypeStruct(v.shape, v.dtype)
                  for k, v in data.items()}
        rec = dict(params=jax.tree.map(np.asarray, state().params),
                   batch=data)
        for dims in %(meshes)r:
            mesh = make_host_mesh(*dims)
            fn, state_sh, d_sh = make_sharded_train_step(
                cfg, ocfg, mesh, shapes, remat=False)
            # a fresh state each time: the step donates its argument
            st = jax.device_put(state(), state_sh)
            _, m = fn(st, jax.device_put(data, d_sh))
            rec[dims] = (float(m["loss"]), float(m["grad_norm"]))
        out[name] = rec
    with open(sys.argv[1], "wb") as f:
        pickle.dump(out, f)
""") % dict(configs=CONFIGS, meshes=MESHES, b=B, seq=SEQ, lengths=LENGTHS)

PORT = HELPERS + textwrap.dedent("""
    import os, pickle, sys, tempfile
    import torch.distributed as dist
    import torch.multiprocessing as mp

    CONFIGS, MESHES = %(configs)r, %(meshes)r

    def worker(rank, init, path, out):
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
        ocfg = opt.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
        res = {}
        for name, arch, over in CONFIGS:
            rec = ref[name]
            cfg = config(arch, over, get_smoke_config)
            data = {k: torch.from_numpy(v) for k, v in rec["batch"].items()}
            for k in ("tokens", "targets"):
                data[k] = data[k].long()
            meta = {k: torch.empty(v.shape, device="meta")
                    for k, v in data.items()}
            params = params_from_reference(rec["params"], cfg, device="cpu")
            state = T.TrainState(params=params, opt=opt.init(params))
            for dims in MESHES:
                mesh = make_host_mesh(*dims)
                fn, _, _ = T.make_sharded_train_step(cfg, ocfg, mesh, meta,
                                                     remat=False)
                _, m = fn(shard_state(state, mesh, rank), data)
                res[name, dims] = (float(m["loss"]), float(m["grad_norm"]))
        dist.destroy_process_group()
        if rank == 0:
            out.put(res)

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
            print("EP_PORT", repr(q.get()))
""") % dict(configs=CONFIGS, meshes=MESHES)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("ep_ref")
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
    line = [x for x in out.stdout.splitlines() if x.startswith("EP_PORT")]
    assert line, out.stdout[-2000:]
    return ref, ast.literal_eval(line[0][len("EP_PORT "):])


@pytest.mark.parametrize("dims", MESHES, ids=["1x4", "2x2", "4x1"])
def test_ep_step_matches_reference_sharded_step(runs, dims):
    ref, got = runs
    for name, _, _ in CONFIGS:
        loss, gnorm = got[name, dims]
        r_loss, r_gnorm = ref[name][dims]
        assert abs(loss - r_loss) <= 1e-5 * abs(r_loss), (name, loss,
                                                          r_loss)
        assert abs(gnorm - r_gnorm) <= 1e-4 * r_gnorm, (name, gnorm,
                                                        r_gnorm)
