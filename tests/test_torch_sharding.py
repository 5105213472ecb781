"""The port's sharding rules (``repro_torch.dist.sharding``) and its
data-parallel train step (``repro_torch.training.train.
make_sharded_train_step``) against the JAX reference on the CPU.

- ``param_specs``: the reference's spec for every leaf of the ten full
  configs (the reference's ``jax.eval_shape`` trees, the port's ``meta``
  trees);
- ``param_shardings`` on meshes (1, 1), (2, 2), (16, 16) and (2, 16, 16):
  the reference's ``_fit_to_mesh`` called with a mesh stub that has the
  two things it reads, ``axis_names`` and ``shape``;
- batch and decode-cache specs likewise;
- the sharded step on a 2 x 2 mesh of 4 gloo processes (a subprocess, as
  the reference's test), each rank holding its shards of the state
  (``dist.tensor_parallel.shard_state``): loss within 1e-3 of the
  single-process step (the reference's bound), the gathered parameters
  equal across ranks.  ``tests/test_torch_tp.py`` holds the tensor-
  parallel step to tighter bounds.
"""

import os
import subprocess
import sys
import textwrap
import types

import jax
import pytest

from repro.configs import registry as jreg
from repro.dist import sharding as jshd
from repro.launch import specs as jspecs
from repro_torch.configs import registry as treg
from repro_torch.dist import sharding as tshd
from repro_torch.launch import specs as tspecs
from repro_torch.launch.mesh import (Mesh, make_host_mesh,
                                     make_production_mesh)
from repro_torch.models import model as TM

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = [((1, 1), ("data", "model")), ((2, 2), ("data", "model")),
          ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]


def _stub(dims, axes):
    return types.SimpleNamespace(axis_names=axes, shape=dict(zip(axes, dims)))


def _ref_flat(tree):
    return {jshd._path_str(p): leaf for p, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_flat(tree, path=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_port_flat(v, f"{path}/{k}" if path else k))
        return out
    return {path: tree}


@pytest.fixture(scope="module")
def ref_trees():
    """arch -> the reference's parameter ShapeDtypeStruct tree, flat."""
    return {a: _ref_flat(jspecs.param_spec_tree(jreg.get_config(a)))
            for a in jreg.ARCH_IDS}


@pytest.mark.parametrize("arch", jreg.ARCH_IDS)
def test_param_specs_equal_reference(arch, ref_trees):
    ref_sds = ref_trees[arch]
    ref = _ref_flat(jshd.param_specs(jspecs.param_spec_tree(
        jreg.get_config(arch))))
    port_tree = TM.param_specs(treg.get_config(arch))
    port = _port_flat(tshd.param_specs(port_tree))
    assert sorted(port) == sorted(ref)
    shapes = _port_flat(port_tree)
    for path, spec in ref.items():
        assert tuple(shapes[path].shape) == tuple(ref_sds[path].shape)
        assert port[path] == tuple(spec), path


@pytest.mark.parametrize("arch", jreg.ARCH_IDS)
def test_fitted_specs_equal_reference(arch, ref_trees):
    ref_specs = _ref_flat(jshd.param_specs(jspecs.param_spec_tree(
        jreg.get_config(arch))))
    port_tree = TM.param_specs(treg.get_config(arch))
    for dims, axes in MESHES:
        fitted = _port_flat(tshd.param_shardings(Mesh(dims, axes),
                                                 port_tree))
        for path, sds in ref_trees[arch].items():
            want = jshd._fit_to_mesh(_stub(dims, axes), ref_specs[path],
                                     tuple(sds.shape))
            assert fitted[path] == tuple(want), (dims, path)


@pytest.mark.parametrize("dims,axes", MESHES)
def test_batch_and_decode_specs_equal_reference(dims, axes):
    mesh, stub = Mesh(dims, axes), _stub(dims, axes)
    for b in (1, 2, 4, 8, 16, 32, 48, 256):
        assert tshd.batch_spec(mesh, b) == tuple(jshd.batch_spec(stub, b))
    for arch in ("zamba2-7b", "llama-3.2-vision-11b", "musicgen-large"):
        jcfg, tcfg = jreg.get_config(arch), treg.get_config(arch)
        for name in ("train_4k", "decode_32k"):
            jshape = jreg.INPUT_SHAPES[name]
            tshape = treg.INPUT_SHAPES[name]
            want = jshd.data_specs(stub, jspecs.batch_specs(jcfg, jshape))
            got = tshd.data_specs(mesh, tspecs.batch_specs(tcfg, tshape))
            assert got == {k: tuple(v) for k, v in want.items()}
        jstate = jspecs.decode_state_specs(jcfg, jreg.INPUT_SHAPES[
            "decode_32k"])
        want = {jshd._path_str(p): tuple(spec) for p, spec in
                jax.tree_util.tree_flatten_with_path(
                    jshd.decode_state_specs_tree(stub, jstate, 128),
                    is_leaf=lambda x: isinstance(
                        x, jax.sharding.PartitionSpec))[0]}
        got = _port_flat(tshd.decode_state_specs_tree(
            mesh, tspecs.decode_state_specs(tcfg, treg.INPUT_SHAPES[
                "decode_32k"]), 128))
        assert got == want


def test_meshes_and_placements():
    pod, multi = make_production_mesh(), make_production_mesh(multi_pod=True)
    assert (pod.dims, pod.axis_names, pod.size) == \
        ((16, 16), ("data", "model"), 256)
    assert (multi.dims, multi.axis_names, multi.size) == \
        ((2, 16, 16), ("pod", "data", "model"), 512)
    host = make_host_mesh(2, 2)
    assert [host.coords(r) for r in range(4)] == [
        {"data": d, "model": m} for d in range(2) for m in range(2)]
    assert multi.coords(511) == {"pod": 1, "data": 15, "model": 15}
    assert multi.coords(16 * 16 + 17) == {"pod": 1, "data": 1, "model": 1}
    from torch.distributed.tensor import Replicate, Shard
    assert tshd.placements(pod, (None, "model")) == (Replicate(), Shard(1))
    assert tshd.placements(multi, (("pod", "data"), None, "model")) == \
        (Shard(0), Shard(0), Shard(2))
    assert tshd.placements(pod, ()) == (Replicate(), Replicate())
    with pytest.raises(RuntimeError, match="process group"):
        host.to_device_mesh("cpu")


SHARDED_TRAIN = textwrap.dedent("""
    import os, sys, tempfile
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    def worker(rank, init, out):
        from repro_torch.configs.registry import get_smoke_config
        from repro_torch.dist.sharding import placements
        from repro_torch.dist.tensor_parallel import (gather_tree,
                                                      shard_state)
        from repro_torch.launch.mesh import make_host_mesh
        from repro_torch.training import optimizer as opt
        from repro_torch.training.train import (
            init_state, make_sharded_train_step, make_train_step)
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=init, world_size=4,
                                rank=rank)
        cfg = get_smoke_config("granite-3-8b")
        ocfg = opt.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
        mesh = make_host_mesh(2, 2)
        B, T = 4, 32
        meta = lambda: torch.empty((B, T), dtype=torch.int64,
                                   device="meta")
        fn, state_sh, d_sh = make_sharded_train_step(
            cfg, ocfg, mesh, {"tokens": meta(), "targets": meta()},
            remat=False)
        assert d_sh == {"tokens": ("data", None),
                        "targets": ("data", None)}, d_sh
        g = torch.Generator().manual_seed(1)
        toks = torch.randint(0, cfg.vocab, (B, T), generator=g)
        batch = {"tokens": toks, "targets": toks}
        state = init_state(0, cfg, device="cpu")
        local = shard_state(state, mesh, rank)
        state2, m = fn(local, batch)
        state2, m2 = fn(state2, batch)
        _, ref = make_train_step(cfg, ocfg, remat=False)(
            init_state(0, cfg, device="cpu"), batch)
        d = abs(float(m["loss"]) - float(ref["loss"]))
        assert d < 1e-3, (float(m["loss"]), float(ref["loss"]))
        leaves = opt.tree_leaves(gather_tree(state2.params, mesh,
                                             state_sh.params))
        flat = torch.cat([t.reshape(-1) for t in leaves])
        every = [torch.empty_like(flat) for _ in range(4)]
        dist.all_gather(every, flat)
        assert all(torch.equal(every[0], x) for x in every), "ranks differ"
        dm = mesh.to_device_mesh("cpu")
        assert dm.mesh_dim_names == ("data", "model")
        from torch.distributed.tensor import distribute_tensor
        w = state.params["layers"]["mlp"]["w_up"]
        spec = state_sh.params["layers"]["mlp"]["w_up"]
        dt = distribute_tensor(w, dm, placements(mesh, spec))
        assert torch.equal(dt.full_tensor(), w)
        dist.destroy_process_group()
        if rank == 0:
            out.put(("SHARDED_MATCH", float(m["loss"]), float(ref["loss"]),
                     float(m2["loss"]), spec))

    if __name__ == "__main__":
        ctx = mp.get_context("spawn")
        q = ctx.SimpleQueue()
        with tempfile.TemporaryDirectory() as d:
            init = "file://" + os.path.join(d, "store")
            procs = [ctx.Process(target=worker, args=(r, init, q))
                     for r in range(4)]
            for p in procs:
                p.start()
            for p in procs:
                p.join(600)
            codes = [p.exitcode for p in procs]
            assert codes == [0, 0, 0, 0], codes
            print(*q.get())
""")


def test_sharded_train_step_matches_single_process(tmp_path):
    script = tmp_path / "sharded_train.py"
    script.write_text(SHARDED_TRAIN)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    out = subprocess.run([sys.executable, str(script)], env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "SHARDED_MATCH" in out.stdout, out.stdout[-2000:]
