"""Expert parallelism and the vlm's cross-attention under the port's
tensor-parallel train step (``models.moe``, ``models.attention``;
``training.train.make_sharded_train_step`` over ``model`` and the data
axes) against its own one-process step, on the CPU.

One spawn of 4 gloo processes per mesh, (1, 4), (2, 2) and (4, 1), runs
in float32:

- dbrx-132b's smoke config with ``n_experts=16``: the expert-split route
  (each rank holds E/n whole experts, the combine summed over ``model``);
- dbrx-132b's smoke config (E 4): the d_ff-split route (each expert's
  h and output gathered, the router's rows of d summed);
- phi3.5-moe's smoke config;
- llama-3.2-vision's smoke config (the cross layers on the rank's heads
  at 2 ranks, from gathered projections at 4).

The MoE configs' routers are set so that slots are dropped at capacity
(``dropping_router``): columns +u and -u and zeros, so that every
token's second choice ties at zero and goes to the lowest zero column,
which overflows.  Which slots are dropped then depends on their rank in
the whole batch's order, which the data group must keep.  Bounds:

- the loss within 1e-5 relative of the one-process step's;
- every gradient leaf, gathered, max|d| <= 1e-5 max|g| (the leaf's);
- the step's ``grad_norm`` within 1e-5 relative;
- each MoE layer's slots per expert and dropped slots equal on every rank
  and to the one-process run's, with slots dropped;
- with ``router_aux_weight`` 1.0 (the aux loss's gradient through the
  router counted once, not n times) the gradients again;
- the step's collectives, counted by ``dist.tensor_parallel`` (the data
  group's included), equal the dry run's ``tp_collectives``.
"""

import ast
import dataclasses
import os
import subprocess
import sys
import textwrap

import pytest

from repro_torch.configs import registry as treg
from repro_torch.dist import sharding as shd
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import model as M

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, SEQ = 4, 32
# (name, arch, overrides of the smoke config)
CONFIGS = (("dbrx-e16", "dbrx-132b", dict(n_experts=16)),
           ("dbrx", "dbrx-132b", {}),
           ("phi3.5", "phi3.5-moe-42b-a6.6b", {}),
           ("llama-vision", "llama-3.2-vision-11b", {}))
AUX = ("dbrx-e16", "dbrx")           # also run at router_aux_weight 1.0

HELPERS = textwrap.dedent("""
    import dataclasses
    import numpy as np
    import torch

    def config(arch, over, get):
        return dataclasses.replace(get(arch), **over)

    def dropping_router(shape, seed):
        # (..., d, E): columns +u, -u, then zeros
        rng = np.random.default_rng(seed)
        d = shape[-2]
        u = rng.normal(0, 1, shape[:-2] + (d,)) / np.sqrt(d)
        out = np.zeros(shape, np.float32)
        out[..., 0], out[..., 1] = u, -u
        return out

    def batch(cfg, b, seq, seed):
        rng = np.random.default_rng(seed)
        out = {"tokens": rng.integers(0, cfg.vocab, (b, seq)),
               "targets": rng.integers(0, cfg.vocab, (b, seq))}
        if cfg.arch_type == "vlm":
            out["image_embeds"] = rng.normal(
                0, 1, (b, cfg.n_image_tokens, cfg.d_model)).astype(
                np.float32)
        return out
""")

WORKER = HELPERS + textwrap.dedent("""
    import os, sys, tempfile
    import torch.distributed as dist
    import torch.multiprocessing as mp

    CONFIGS, AUX = %(configs)r, %(aux)r
    B, SEQ = %(b)d, %(seq)d

    def tensors(b):
        return {k: torch.from_numpy(v) for k, v in b.items()}

    def worker(rank, init, dims, out):
        from repro_torch.configs.registry import get_smoke_config
        from repro_torch.dist import tensor_parallel as tpm
        from repro_torch.launch.mesh import make_host_mesh
        from repro_torch.models import moe
        from repro_torch.training import optimizer as opt
        from repro_torch.training import train as T
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=init, world_size=4,
                                rank=rank)
        mesh = make_host_mesh(*dims)
        ocfg = opt.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
        res = {}
        runs = [(name, arch, over, None) for name, arch, over in CONFIGS]
        runs += [(name + "-aux", arch, over, 1.0)
                 for name, arch, over in CONFIGS if name in AUX]
        for name, arch, over, aux in runs:
            cfg = config(arch, over, get_smoke_config)
            if aux is not None:
                cfg = dataclasses.replace(cfg, router_aux_weight=aux)
            data = tensors(batch(cfg, B, SEQ, 1))
            meta = {k: torch.empty(v.shape, device="meta")
                    for k, v in data.items()}
            fn, ssh, _ = T.make_sharded_train_step(cfg, ocfg, mesh, meta)
            state = T.init_state(0, cfg, device="cpu")
            if cfg.is_moe:
                r = state.params["layers"]["moe"]["router"]
                r.copy_(torch.from_numpy(dropping_router(tuple(r.shape),
                                                         2)))
            with moe.recording() as one:
                total, met, grads = T.loss_and_grads(state.params, data,
                                                     cfg, remat=False)
            gnorm = float(opt.global_norm(grads))
            local = tpm.shard_state(state, mesh, rank)
            with moe.recording() as got:
                _, met_tp, g_tp = fn.loss_and_grads(local.params, data)
            layers = len(one)
            mine = torch.tensor([x for c, dropped in got[:layers]
                                 for x in c.tolist() + [dropped]])
            every = [torch.empty_like(mine) for _ in range(4)]
            dist.all_gather(every, mine)
            whole = tpm.gather_tree(g_tp, mesh, ssh.params)
            worst = max(float((a - b).abs().max())
                        / max(float(b.abs().max()), 1e-30)
                        for a, b in zip(opt.tree_leaves(whole),
                                        opt.tree_leaves(grads)))
            rec = dict(loss=float(met["loss"]), loss_tp=float(met_tp["loss"]),
                       aux=float(met["aux_loss"]),
                       aux_tp=float(met_tp["aux_loss"]), worst=worst,
                       routes=[(c.tolist(), d) for c, d in one],
                       ranks_route=[e.tolist() for e in every],
                       one_route=[x for c, d in one
                                  for x in c.tolist() + [d]])
            if aux is None:
                tpm.reset_counts()
                _, m2 = fn(local, data)
                rec.update(counts=tpm.counts(), gnorm=gnorm,
                           gnorm_tp=float(m2["grad_norm"]))
            res[name] = rec
        dist.destroy_process_group()
        if rank == 0:
            out.put(res)

    if __name__ == "__main__":
        dims = tuple(int(x) for x in sys.argv[1].split("x"))
        ctx = mp.get_context("spawn")
        q = ctx.SimpleQueue()
        with tempfile.TemporaryDirectory() as d:
            init = "file://" + os.path.join(d, "store")
            procs = [ctx.Process(target=worker, args=(r, init, dims, q))
                     for r in range(4)]
            for p in procs:
                p.start()
            for p in procs:
                p.join(600)
            codes = [p.exitcode for p in procs]
            assert codes == [0, 0, 0, 0], codes
            print("EP_RESULT", repr(q.get()))
""") % dict(configs=CONFIGS, aux=AUX, b=B, seq=SEQ)


def _run(tmp_path, dims):
    script = tmp_path / "ep_worker.py"
    script.write_text(WORKER)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, str(script),
                          "x".join(map(str, dims))], env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    line = [x for x in out.stdout.splitlines() if x.startswith("EP_RESULT")]
    assert line, out.stdout[-2000:]
    return ast.literal_eval(line[0][len("EP_RESULT "):])


@pytest.mark.parametrize("dims", [(1, 4), (2, 2), (4, 1)],
                         ids=["1x4", "2x2", "4x1"])
def test_ep_step_matches_one_process(tmp_path, dims):
    res = _run(tmp_path, dims)
    mesh = make_host_mesh(*dims)
    for name, arch, over in CONFIGS:
        for key in (name, name + "-aux") if name in AUX else (name,):
            r = res[key]
            assert abs(r["loss_tp"] - r["loss"]) <= 1e-5 * abs(r["loss"]), \
                (key, r["loss_tp"], r["loss"])
            assert abs(r["aux_tp"] - r["aux"]) <= 1e-5 * abs(r["aux"]), \
                (key, r["aux_tp"], r["aux"])
            assert r["worst"] <= 1e-5, (key, r["worst"])
            assert all(x == r["one_route"] for x in r["ranks_route"]), \
                (key, r["ranks_route"], r["one_route"])
            if arch != "llama-3.2-vision-11b":
                assert r["routes"] and all(d > 0 for _, d in r["routes"]), \
                    (key, r["routes"])
        r = res[name]
        assert abs(r["gnorm_tp"] - r["gnorm"]) <= 1e-5 * r["gnorm"], \
            (name, r["gnorm_tp"], r["gnorm"])
        cfg = dataclasses.replace(treg.get_smoke_config(arch), **over)
        want = dryrun.tp_collectives(
            cfg, mesh, shd.param_shardings(mesh, M.param_specs(cfg)),
            B // dims[0], SEQ, remat=True)
        got = {k: dict(count=v["calls"], result_bytes=v["bytes"])
               for k, v in r["counts"].items()}
        assert got == want, (name, got, want)
