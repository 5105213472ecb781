"""The port's tensor-parallel train step (``dist.tensor_parallel``;
``training.train.make_sharded_train_step`` over ``model``) against its own
one-process step, on the CPU.

One spawn of 4 gloo processes per mesh, (1, 4) and (2, 2), runs the
granite-3-8b smoke config (GQA with 2 KV heads: at 4 ranks the gather
route, at 2 the rank's heads), zamba2's (hybrid: the rank's SSD and
attention heads) and mamba2's (ssm) in float32, each rank holding its
shards by the reference's fitted specs (``shard_state``).  Bounds:

- the loss within 1e-5 relative of the one-process step's;
- every gradient leaf, gathered, max|d| <= 1e-5 max|g| (the leaf's);
- the step's ``grad_norm`` within 1e-5 relative;
- the gathered parameters after the step equal on every rank;
- ``gather_state(shard_state(s))`` is ``s`` bit for bit;
- the step's collectives, counted by ``dist.tensor_parallel``, equal the
  dry run's ``tp_collectives`` (count and bytes, ``remat`` on).

On (1, 4) zamba2's state is checkpointed: ``checkpoint.save(mesh=)``
writes the one-process layout, every npz member byte for byte equal to a
one-process save of the gathered state (the zip's timestamps aside);
``restore(mesh=)`` gives the shards back bit for bit and the next step
from them equals the next step from the live shards.

Without processes: the dry run's all-gathers, reduce-scatters and the
loss's all-reduces equal what the model's forward and backward make at
full width (meta tensors, a group that only counts) for every arch the
step splits (every arch: the MoE layers' router, combine and expert
gathers, the vlm's cross layers too); shard shapes against the fitted
specs for every leaf of the ten full configs' ``meta`` trees on (1, 4),
(2, 2) and (16, 16); shards concatenated back to the whole state bit for
bit; the axis must divide 16.  ``tests/test_torch_ep.py`` holds the
``moe`` and ``vlm`` steps.
"""

import ast
import dataclasses
import os
import subprocess
import sys
import textwrap
import zipfile

import pytest
import torch

from repro_torch.configs import registry as treg
from repro_torch.dist import sharding as shd
from repro_torch.dist import tensor_parallel as tpm
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import Mesh, make_host_mesh
from repro_torch.models import attention, mamba2
from repro_torch.models import model as M
from repro_torch.models.layers import torch_dtype
from repro_torch.training import optimizer as opt
from repro_torch.training import train as T

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ("granite-3-8b", "zamba2-7b", "mamba2-370m")
B, SEQ = 4, 32

WORKER = textwrap.dedent("""
    import os, sys, tempfile
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    ARCHS = %(archs)r
    B, SEQ = %(b)d, %(seq)d

    def flat(tree):
        from repro_torch.training import optimizer as opt
        return torch.cat([t.reshape(-1).float()
                          for t in opt.tree_leaves(tree)])

    def worker(rank, init, dims, base, out):
        from repro_torch.configs.registry import get_smoke_config
        from repro_torch.dist import tensor_parallel as tpm
        from repro_torch.launch.mesh import make_host_mesh
        from repro_torch.training import checkpoint as ckpt
        from repro_torch.training import optimizer as opt
        from repro_torch.training import train as T
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=init, world_size=4,
                                rank=rank)
        mesh = make_host_mesh(*dims)
        res = {}
        for arch in ARCHS:
            cfg = get_smoke_config(arch)
            ocfg = opt.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
            meta = lambda: torch.empty((B, SEQ), dtype=torch.int64,
                                       device="meta")
            fn, ssh, _ = T.make_sharded_train_step(
                cfg, ocfg, mesh, {"tokens": meta(), "targets": meta()})
            toks = torch.randint(0, cfg.vocab, (B, SEQ),
                                 generator=torch.Generator().manual_seed(1))
            batch = {"tokens": toks, "targets": toks}
            state = T.init_state(0, cfg, device="cpu")
            total, met, grads = T.loss_and_grads(state.params, batch, cfg,
                                                 remat=False)
            _, m_one = T.make_train_step(cfg, ocfg, remat=False)(state,
                                                                 batch)
            local = tpm.shard_state(state, mesh, rank)
            back = tpm.gather_state(local, mesh, ssh.params)
            exact = all(torch.equal(a, b) for a, b in zip(
                opt.tree_leaves(back.params) + opt.tree_leaves(back.opt.mu),
                opt.tree_leaves(state.params)
                + opt.tree_leaves(state.opt.mu)))
            _, met_tp, g_tp = fn.loss_and_grads(local.params, batch)
            whole = tpm.gather_tree(g_tp, mesh, ssh.params)
            worst = max(float((a - b).abs().max())
                        / max(float(b.abs().max()), 1e-30)
                        for a, b in zip(opt.tree_leaves(whole),
                                        opt.tree_leaves(grads)))
            tpm.reset_counts()
            s2, m2 = fn(local, batch)
            counts = tpm.counts()
            p2 = flat(tpm.gather_tree(s2.params, mesh, ssh.params))
            every = [torch.empty_like(p2) for _ in range(4)]
            dist.all_gather(every, p2)
            same = all(torch.equal(every[0], x) for x in every)
            rec = dict(loss=float(met["loss"]), loss_tp=float(met_tp["loss"]),
                       worst=worst, gnorm=float(m_one["grad_norm"]),
                       gnorm_tp=float(m2["grad_norm"]), same=same,
                       exact=exact, counts=counts)
            if base and arch == "zamba2-7b":
                tp_dir = os.path.join(base, "tp")
                one_dir = os.path.join(base, "one")
                ckpt.save(tp_dir, s2, 1, mesh=mesh, specs=ssh.params)
                gathered = tpm.gather_state(s2, mesh, ssh.params)
                if rank == 0:
                    ckpt.save(one_dir, gathered, 1)
                dist.barrier()
                got, at = ckpt.restore(tp_dir, s2, mesh=mesh,
                                       specs=ssh.params)
                a = opt.tree_leaves(got.params) + opt.tree_leaves(
                    got.opt.mu) + opt.tree_leaves(got.opt.nu)
                b = opt.tree_leaves(s2.params) + opt.tree_leaves(
                    s2.opt.mu) + opt.tree_leaves(s2.opt.nu)
                s3, _ = fn(s2, batch)
                r3, _ = fn(got, batch)
                rec.update(restored=at == 1 and all(
                    torch.equal(x, y) for x, y in zip(a, b))
                    and torch.equal(got.opt.step, s2.opt.step),
                    resumed=torch.equal(flat(s3.params), flat(r3.params)))
            res[arch] = rec
        dist.destroy_process_group()
        if rank == 0:
            out.put(res)

    if __name__ == "__main__":
        dims = tuple(int(x) for x in sys.argv[1].split("x"))
        base = sys.argv[2] if len(sys.argv) > 2 else ""
        ctx = mp.get_context("spawn")
        q = ctx.SimpleQueue()
        with tempfile.TemporaryDirectory() as d:
            init = "file://" + os.path.join(d, "store")
            procs = [ctx.Process(target=worker,
                                 args=(r, init, dims, base, q))
                     for r in range(4)]
            for p in procs:
                p.start()
            for p in procs:
                p.join(600)
            codes = [p.exitcode for p in procs]
            assert codes == [0, 0, 0, 0], codes
            print("TP_RESULT", repr(q.get()))
""") % dict(archs=ARCHS, b=B, seq=SEQ)


def _run(tmp_path, dims, base=""):
    script = tmp_path / "tp_worker.py"
    script.write_text(WORKER)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run(
        [sys.executable, str(script), "x".join(map(str, dims))]
        + ([base] if base else []), env=env, capture_output=True, text=True,
        timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    line = [x for x in out.stdout.splitlines() if x.startswith("TP_RESULT")]
    assert line, out.stdout[-2000:]
    return ast.literal_eval(line[0][len("TP_RESULT "):])


@pytest.mark.parametrize("dims", [(1, 4), (2, 2)], ids=["1x4", "2x2"])
def test_tp_step_matches_one_process(tmp_path, dims):
    base = str(tmp_path / "ckpt") if dims == (1, 4) else ""
    res = _run(tmp_path, dims, base)
    mesh = make_host_mesh(*dims)
    for arch in ARCHS:
        r = res[arch]
        assert abs(r["loss_tp"] - r["loss"]) <= 1e-5 * abs(r["loss"]), \
            (arch, r)
        assert r["worst"] <= 1e-5, (arch, r["worst"])
        assert abs(r["gnorm_tp"] - r["gnorm"]) <= 1e-5 * r["gnorm"], \
            (arch, r)
        assert r["same"] and r["exact"], (arch, r)
        cfg = treg.get_smoke_config(arch)
        want = dryrun.tp_collectives(
            cfg, mesh, shd.param_shardings(mesh, M.param_specs(cfg)),
            B // dims[0], SEQ, remat=True)
        got = {k: dict(count=v["calls"], result_bytes=v["bytes"])
               for k, v in r["counts"].items()}
        assert got == want, (arch, got, want)
    if base:
        z = res["zamba2-7b"]
        assert z["restored"] and z["resumed"], z
        name = "ckpt_00000001.npz"
        with zipfile.ZipFile(os.path.join(base, "tp", name)) as a, \
                zipfile.ZipFile(os.path.join(base, "one", name)) as b:
            assert sorted(a.namelist()) == sorted(b.namelist())
            for member in a.namelist():
                assert a.read(member) == b.read(member), member


class _ShapeTP(tpm.TensorParallel):
    """Rank 0 of ``n`` with no process group: each collective returns a
    tensor of its result's shape and counts itself as the real one does
    (on meta tensors, nothing is computed)."""

    def all_reduce_(self, t, op=None):
        tpm._note("all-reduce", t, 0.0)
        return t

    def _all_gather(self, t, dim):
        shape = list(t.shape)
        shape[dim] *= self.n
        out = t.new_empty(shape)
        tpm._note("all-gather", out, 0.0)
        return out

    def _reduce_scatter(self, t, dim):
        shape = list(t.shape)
        shape[dim] //= self.n
        tpm._note("reduce-scatter", t, 0.0)
        return t.new_empty(shape)


def _shape_swa(q, k, v, **kw):
    return q + 0 * (k.sum() + v.sum())


def _shape_ssd(x, dt, A, B, C, **kw):
    return x + 0 * (dt.sum() + A.sum() + B.sum() + C.sum()).to(x.dtype)


TP_ARCHS = list(treg.ARCH_IDS)


@pytest.mark.parametrize("arch", TP_ARCHS)
def test_dry_run_prices_the_models_collectives(monkeypatch, arch):
    """``dryrun.tp_collectives`` against the collectives that
    ``loss_and_grads`` makes under tensor parallelism, at the full
    config's widths (depth cut; meta tensors; the kernels replaced by
    shape-only stand-ins): all-gathers and reduce-scatters, count and
    bytes, and the all-reduces (the loss's three, and the MoE layers'
    router sums and combines), on (1, 4) and (1, 16), ``remat`` on and
    off, and on (2, 4) with a data group that counts too (the MoE
    routing's sums over it).  The step's two further all-reduces (the
    whole leaves' gradients, the norm) are held by
    ``test_tp_step_matches_one_process``."""
    monkeypatch.setattr(attention, "swa_attention", _shape_swa)
    monkeypatch.setattr(mamba2, "ssd_scan", _shape_ssd)
    cfg = treg.get_config(arch)
    cfg = dataclasses.replace(cfg, n_layers={
        "hybrid": 2 * cfg.shared_attn_every,
        "vlm": cfg.cross_attn_every}.get(cfg.arch_type, 2))
    rows, seq = 1, 256
    tokens = torch.zeros((rows, seq), dtype=torch.int64, device="meta")
    batch = {"tokens": tokens, "targets": tokens}
    if cfg.inputs_embeds:
        batch["embeds"] = torch.zeros((rows, seq, cfg.d_model),
                                      dtype=torch_dtype(cfg.dtype),
                                      device="meta")
    if cfg.arch_type == "vlm":
        batch["image_embeds"] = torch.zeros(
            (rows, cfg.n_image_tokens, cfg.d_model),
            dtype=torch_dtype(cfg.dtype), device="meta")
    for dims, remat in (((1, 4), True), ((1, 16), True), ((1, 4), False),
                        ((2, 4), True)):
        mesh = make_host_mesh(*dims)
        params = tpm.shard_tree(M.param_specs(cfg), mesh, 0)
        tpm.reset_counts()
        T.loss_and_grads(params, batch, cfg, remat=remat,
                         tp=_ShapeTP(None, dims[1], 0),
                         dp=_ShapeTP(None, dims[0], 0))
        got = {k: dict(count=v["calls"], result_bytes=v["bytes"])
               for k, v in tpm.counts().items()}
        p_specs = shd.param_shardings(mesh, M.param_specs(cfg))
        want = dryrun.tp_collectives(cfg, mesh, p_specs, rows, seq,
                                     remat=remat)
        ar, got_ar = want.pop("all-reduce"), got.pop("all-reduce")
        loss = 3 * rows * (seq - 1) * 4
        if cfg.arch_type != "moe":
            assert got_ar == dict(count=3, result_bytes=loss)
        whole = sum(t.numel() for p, t in shd.leaves_with_paths(
            M.param_specs(cfg)) if tpm.model_dim(dict(
                shd.leaves_with_paths(p_specs))[p]) is None)
        assert ar == dict(count=got_ar["count"] + 2,
                          result_bytes=got_ar["result_bytes"] + 4 * whole
                          + 4), (ar, got_ar)
        assert got == want, (dims, remat, got, want)


def _meta_state(cfg):
    params = M.param_specs(cfg)
    return T.TrainState(params=params, opt=opt.init(params))


@pytest.mark.parametrize("arch", treg.ARCH_IDS)
def test_shard_shapes_follow_fitted_specs(arch):
    cfg = treg.get_config(arch)
    state = _meta_state(cfg)
    for dims in ((1, 4), (2, 2), (16, 16)):
        mesh = Mesh(dims, ("data", "model"))
        specs = dict(shd.leaves_with_paths(
            shd.param_shardings(mesh, state.params)))
        n = dims[1]
        for rank in (0, mesh.size - 1, mesh.size // 2 + 1):
            got = tpm.shard_state(state, mesh, rank)
            for tree in (got.params, got.opt.mu, got.opt.nu):
                for path, t in shd.leaves_with_paths(tree):
                    want = list(dict(shd.leaves_with_paths(
                        state.params))[path].shape)
                    i = tpm.model_dim(specs[path])
                    if i is not None:
                        want[i] //= n
                    assert list(t.shape) == want, (dims, path)


@pytest.mark.parametrize("arch", ARCHS)
def test_shards_concatenate_to_the_state(arch):
    cfg = treg.get_smoke_config(arch)
    state = T.init_state(3, cfg, device="cpu")
    mesh = make_host_mesh(1, 4)
    specs = shd.param_shardings(mesh, state.params)
    cuts = [tpm.shard_state(state, mesh, r) for r in range(4)]
    for path, t in shd.leaves_with_paths(state.params):
        i = tpm.model_dim(dict(shd.leaves_with_paths(specs))[path])
        pieces = [dict(shd.leaves_with_paths(c.params))[path] for c in cuts]
        whole = pieces[0] if i is None else torch.cat(pieces, dim=i)
        assert torch.equal(whole, t), path
        if i is not None:
            assert all(p.is_contiguous() for p in pieces)


def test_model_axis_must_divide_16():
    assert tpm.model_size(make_host_mesh(2, 8)) == 8
    with pytest.raises(ValueError, match="must divide 16"):
        tpm.model_size(make_host_mesh(1, 3))
