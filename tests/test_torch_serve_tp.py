"""The port's sharded serving steps (``serving.engine.make_sharded_prefill``,
``make_sharded_serve_step`` and ``DecodeEngine(mesh=)``: tensor
parallelism over ``model``, rows over the data axes) against its own
one-process steps, on the CPU.

One spawn of 4 gloo processes per mesh, (1, 4) and (2, 2), runs one
smoke config of each family in float32: granite-3-8b (dense; GQA with 2
KV heads: the rank's heads at 2 ranks, every head at 4), phi3.5-moe (moe;
its 4 experts' d_ff split, and with 16 experts E/n whole experts a rank),
mamba2-370m (ssm), zamba2-7b (hybrid), llama-3.2-vision (vlm: the cross
layers on the image tokens' rows) and musicgen-large (audio: embeddings
in).  The MoE routers drop slots at capacity (``dropping_router``), so
the routing must be the whole batch's.  Bounds:

- the prefill's last-position logits within 1e-5 (max|d| over max|ref|)
  of the one-process ``forward(last_only=True)``'s rows;
- each decode step's logits within 1e-5 of the one-process step's, over
  a prompt of ``PROMPT`` tokens fed one at a time and ``NEW`` greedy
  steps; the greedy tokens equal;
- after the run, every rank's caches equal bit for bit to those of the
  ranks of its model group, and within 1e-5 of the one-process caches'
  rows;
- ``DecodeEngine(mesh=)``: every rank returns the same tokens, the greedy
  requests' equal to the one-process engine's; ``obs`` records on rank 0
  only;
- one prefill and one decode step make the collectives
  ``launch.dryrun.serve_collectives`` prices (count and bytes);
- planted faults are caught: each data rank routing its rows alone
  (on (2, 2)), and one rank skipping one cache row.

Without processes: ``serve_collectives`` against the collectives that
the prefill and a decode step make at full width (meta tensors, a group
that only counts, depth cut) for every arch.
"""

import ast
import dataclasses
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from repro_torch.configs import registry as treg
from repro_torch.dist import sharding as shd
from repro_torch.dist import tensor_parallel as tpm
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import attention, mamba2
from repro_torch.models import model as M
from repro_torch.models.layers import torch_dtype
from test_torch_ep import HELPERS
from test_torch_tp import _ShapeTP, _shape_ssd, _shape_swa

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, T, SEQ, PROMPT, NEW = 4, 16, 32, 4, 4
TOL = 1e-5
CONFIGS = (("granite", "granite-3-8b", {}),
           ("phi3.5", "phi3.5-moe-42b-a6.6b", {}),
           ("phi3.5-e16", "phi3.5-moe-42b-a6.6b", dict(n_experts=16)),
           ("mamba2", "mamba2-370m", {}),
           ("zamba2", "zamba2-7b", {}),
           ("vision", "llama-3.2-vision-11b", {}),
           ("musicgen", "musicgen-large", {}))
ENGINE = ("granite", "phi3.5", "mamba2", "zamba2")   # token inputs only
ENGINE_PROMPTS = ([1, 2, 3], [4, 5], [9, 8, 7, 6, 5], [11])
ENGINE_NEW, ENGINE_TEMPS = (5, 3, 6, 4), (0.0, 0.8, 0.0, 0.8)

WORKER = HELPERS + textwrap.dedent("""
    import os, sys, tempfile
    import torch.distributed as dist
    import torch.multiprocessing as mp

    CONFIGS, ENGINE = %(configs)r, %(engine)r
    B, T, SEQ, PROMPT, NEW = %(b)d, %(t)d, %(seq)d, %(prompt)d, %(new)d
    ENGINE_PROMPTS, ENGINE_NEW, ENGINE_TEMPS = %(eprompts)r, %(enew)r, \\
        %(etemps)r

    def rel(a, b):
        return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)

    def inputs(cfg):
        rng = np.random.default_rng(1)
        if cfg.inputs_embeds:
            x = torch.from_numpy(rng.normal(
                0, 1, (B, T, cfg.d_model)).astype(np.float32))
            batch = {"embeds": x}
            steps = [x[:, t:t + 1] for t in range(PROMPT + NEW)]
        else:
            tok = torch.from_numpy(rng.integers(0, cfg.vocab, (B, T)))
            batch = {"tokens": tok}
            steps = [tok[:, t:t + 1] for t in range(PROMPT)]
        if cfg.arch_type == "vlm":
            batch["image_embeds"] = torch.from_numpy(rng.normal(
                0, 1, (B, cfg.n_image_tokens, cfg.d_model)).astype(
                np.float32))
        return batch, steps

    def caches_flat(state):
        from repro_torch.training.optimizer import tree_leaves
        return torch.cat([t.reshape(-1).float() for t in tree_leaves(state)])

    def decode_run(cfg, params, local, mesh, rank, steps, img):
        '''(worst step error, tokens sharded, tokens one process, the
        first step's collectives, caches: equal in the model group, the
        error against the one-process rows)'''
        from repro_torch.dist import tensor_parallel as tpm
        from repro_torch.models import model as M
        from repro_torch.serving import engine as E
        from repro_torch.dist import sharding as shd
        from repro_torch.training.optimizer import tree_leaves
        serve, _, state_sh = E.make_sharded_serve_step(
            cfg, mesh, seq_len=SEQ, batch=B)
        one = E.make_serve_step(cfg, seq_len=SEQ)
        dp = serve.dp
        st = M.init_decode_state(cfg, B // dp.n, SEQ, device="cpu")
        st1 = M.init_decode_state(cfg, B, SEQ, device="cpu")
        # the rank's caches are the shards state_shardings gives
        layout = all(
            t.numel() * t.element_size() == shd.spec_bytes_per_device(
                mesh, spec, w.numel() * w.element_size())
            and t.shape[2:] == w.shape[2:]
            for t, w, spec in zip(tree_leaves(st), tree_leaves(
                M.decode_state_specs(cfg, B, SEQ)), tree_leaves(state_sh)))
        worst, got, want, counts = 0.0, [], [], None
        nxt = nxt1 = None
        for t in range(PROMPT + NEW):
            inp = inp1 = steps[t] if t < len(steps) else None
            if inp is None:
                inp, inp1 = nxt, nxt1
            tpm.reset_counts()
            lg, st = serve(local, st, inp, t, image_embeds=img)
            if t == 0:
                counts = tpm.counts()
            with torch.no_grad():
                lg1, st1 = one(params, st1, inp1, t, image_embeds=img)
            worst = max(worst, rel(lg, dp.part(lg1, B, 0)))
            whole = dp.whole(lg[:, 0], B, 0)[:, :cfg.vocab]
            nxt = whole.argmax(-1)[:, None]
            nxt1 = lg1[:, 0, :cfg.vocab].argmax(-1)[:, None]
            got.append(nxt[:, 0].tolist())
            want.append(nxt1[:, 0].tolist())
        mine = caches_flat(st)
        every = [torch.empty_like(mine) for _ in range(4)]
        dist.all_gather(every, mine)
        rest = lambda r: {a: c for a, c in mesh.coords(r).items()
                          if a != "model"}
        same = all(torch.equal(every[r], mine) for r in range(4)
                   if rest(r) == rest(rank))
        from repro_torch.training.optimizer import tree_leaves, tree_map
        rows1 = tree_map(lambda t: dp.part(t, B, 1), st1)
        cache_err = max(rel(a, b) for a, b in zip(tree_leaves(st),
                                                   tree_leaves(rows1)))
        return dict(worst=worst, tokens=got, tokens_one=want,
                    counts=counts, same=same, cache_err=cache_err,
                    layout=layout)

    def engine_run(cfg, params, local, mesh):
        from repro_torch.obs import RunRecorder
        from repro_torch.serving.engine import DecodeEngine, Request

        def reqs():
            return [Request(prompt=list(p), max_new=m, temperature=tmp)
                    for p, m, tmp in zip(ENGINE_PROMPTS, ENGINE_NEW,
                                         ENGINE_TEMPS)]
        one = DecodeEngine(cfg, params, batch=B, seq_len=SEQ, seed=5,
                           device="cpu").run(reqs())
        rec = RunRecorder()
        eng = DecodeEngine(cfg, local, batch=B, seq_len=SEQ, seed=5,
                           device="cpu", mesh=mesh, obs=rec)
        got = eng.run(reqs())
        return dict(out=[r.out for r in got], one=[r.out for r in one],
                    obs=eng.obs is not None,
                    tokens=rec.metrics.counter("serve.tokens").value)

    def worker(rank, init, dims, out):
        from repro_torch.configs.registry import get_smoke_config
        from repro_torch.dist import tensor_parallel as tpm
        from repro_torch.launch.mesh import make_host_mesh
        from repro_torch.models import attention, moe
        from repro_torch.models import model as M
        from repro_torch.serving import engine as E
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=init, world_size=4,
                                rank=rank)
        mesh = make_host_mesh(*dims)
        res = {}
        models = {}
        for name, arch, over in CONFIGS:
            cfg = config(arch, over, get_smoke_config)
            params = M.init_params(0, cfg, device="cpu")
            if cfg.is_moe:
                r = params["layers"]["moe"]["router"]
                r.copy_(torch.from_numpy(dropping_router(tuple(r.shape),
                                                         2)))
            local = tpm.shard_tree(params, mesh, rank)
            batch, steps = inputs(cfg)
            models[name] = (cfg, params, local, steps,
                            batch.get("image_embeds"))
            shapes = {k: torch.empty(v.shape, device="meta")
                      for k, v in batch.items()}
            pre, _, _ = E.make_sharded_prefill(cfg, mesh, shapes)
            tpm.reset_counts()
            got = pre(local, batch)
            pre_counts = tpm.counts()
            with torch.no_grad():
                want = M.forward(params, batch, cfg, remat=False,
                                 last_only=True)[0]
            rec = decode_run(cfg, params, local, mesh, rank, steps,
                             batch.get("image_embeds"))
            rec.update(prefill=rel(got, pre.dp.part(want, B, 0)),
                       prefill_shape=tuple(got.shape),
                       prefill_counts=pre_counts)
            if name in ENGINE:
                rec["engine"] = engine_run(cfg, params, local, mesh)
            res[name] = rec

        # planted faults: each data rank routing its rows alone
        if dims[0] > 1:
            orig = moe.moe_apply

            def alone(*a, dp=None, **kw):
                return orig(*a, **kw)
            moe.moe_apply = alone
            try:
                cfg, params, local, steps, img = models["phi3.5"]
                res["fault: routing alone"] = decode_run(
                    cfg, params, local, mesh, rank, steps, img)
            finally:
                moe.moe_apply = orig
        # ... and rank 1 leaving one cache row unwritten
        orig_attn = attention.decode_self_attention

        def skipping(p, x, cache, pos, cfg, **kw):
            old = [cache[k][:, pos].clone() for k in ("k", "v")]
            got = orig_attn(p, x, cache, pos, cfg, **kw)
            if rank == 1 and pos == 1:
                cache["k"][:, pos], cache["v"][:, pos] = old
            return got
        attention.decode_self_attention = skipping
        try:
            cfg, params, local, steps, img = models["granite"]
            res["fault: a row skipped"] = decode_run(
                cfg, params, local, mesh, rank, steps, img)
        finally:
            attention.decode_self_attention = orig_attn
        dist.destroy_process_group()
        out.put((rank, res))

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
            got = dict(q.get() for _ in range(4))
            print("SERVE_RESULT", repr(got))
""") % dict(configs=CONFIGS, engine=ENGINE, b=B, t=T, seq=SEQ,
            prompt=PROMPT, new=NEW, eprompts=ENGINE_PROMPTS,
            enew=ENGINE_NEW, etemps=ENGINE_TEMPS)


@pytest.fixture(scope="module", params=[(1, 4), (2, 2)], ids=["1x4", "2x2"])
def runs(request, tmp_path_factory):
    dims = request.param
    script = tmp_path_factory.mktemp("serve_tp") / "serve_worker.py"
    script.write_text(WORKER)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, str(script),
                          "x".join(map(str, dims))], env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    line = [x for x in out.stdout.splitlines()
            if x.startswith("SERVE_RESULT")]
    assert line, out.stdout[-2000:]
    return dims, ast.literal_eval(line[0][len("SERVE_RESULT "):])


def _cfg(arch, over):
    return dataclasses.replace(treg.get_smoke_config(arch), **over)


def _holds(r) -> bool:
    """Whether a decode run passes this file's bounds."""
    return (r["worst"] <= TOL and r["tokens"] == r["tokens_one"]
            and r["same"] and r["cache_err"] <= TOL)


def test_sharded_serving_matches_one_process(runs):
    dims, res = runs
    for rank, got in res.items():
        for name, arch, over in CONFIGS:
            r = got[name]
            cfg = _cfg(arch, over)
            rows = B // dims[0]
            assert r["prefill_shape"] == (rows, 1, cfg.padded_vocab), name
            assert r["prefill"] <= TOL, (rank, name, r["prefill"])
            assert r["worst"] <= TOL, (rank, name, r["worst"])
            assert r["tokens"] == r["tokens_one"], (rank, name, r["tokens"],
                                                    r["tokens_one"])
            assert r["same"], (rank, name, "caches differ in the group")
            assert r["layout"], (rank, name, "caches off state_shardings")
            assert r["cache_err"] <= TOL, (rank, name, r["cache_err"])
            assert _holds(r)
            if name in ENGINE:
                e = r["engine"]
                assert e["out"] == res[0][name]["engine"]["out"], (rank,
                                                                   name)
                for i, tmp in enumerate(ENGINE_TEMPS):
                    assert len(e["out"][i]) == ENGINE_NEW[i]
                    if tmp == 0.0:
                        assert e["out"][i] == e["one"][i], (rank, name, i)
                assert e["obs"] == (rank == 0), (rank, name)
                assert e["tokens"] == (sum(ENGINE_NEW) if rank == 0
                                       else 0), (rank, name)


def test_serving_collectives_match_the_dry_run(runs):
    dims, res = runs
    mesh = make_host_mesh(*dims)
    for name, arch, over in CONFIGS:
        cfg = _cfg(arch, over)
        p_specs = shd.param_shardings(mesh, M.param_specs(cfg))
        for key, decode, seq in (("prefill_counts", False, T),
                                 ("counts", True, SEQ)):
            want = dryrun.serve_collectives(cfg, mesh, p_specs,
                                            B // dims[0], seq,
                                            decode=decode)
            for rank in res:
                got = {k: dict(count=v["calls"], result_bytes=v["bytes"])
                       for k, v in res[rank][name][key].items()}
                assert got == want, (name, key, rank, got, want)
            if dims[1] > 1:
                assert want["all-gather"]["count"] > 0, (name, key)


def test_planted_faults_are_caught(runs):
    dims, res = runs
    faults = ["fault: a row skipped"] + (["fault: routing alone"]
                                         if dims[0] > 1 else [])
    for fault in faults:
        caught = [not _holds(res[rank][fault]) for rank in res]
        assert any(caught), (fault, [res[r][fault] for r in res])
    skipped = res[1]["fault: a row skipped"]
    assert not skipped["same"] and skipped["cache_err"] > TOL, skipped
    if dims[0] > 1:
        alone = res[0]["fault: routing alone"]
        assert alone["worst"] > TOL or alone["tokens"] != \
            alone["tokens_one"], alone


# ------------------------------------------------- at full width on meta --


def meta_serve_counts(cfg, dims, rows, seq, decode):
    """The collectives of the sharded prefill (``rows`` x ``seq`` tokens)
    or of one decode step (``rows`` tokens against a ``seq`` cache) of
    ``cfg`` on a ``dims`` mesh, counted by ``dist.tensor_parallel`` on
    meta tensors through groups that only count (rank 0 of each), with
    the kernels replaced by shape-only stand-ins; as
    ``dryrun.serve_collectives`` gives them."""
    dt = torch_dtype(cfg.dtype)
    mesh = make_host_mesh(*dims)
    tp, dp = _ShapeTP(None, dims[1], 0), _ShapeTP(None, dims[0], 0)
    params = tpm.shard_tree(M.param_specs(cfg), mesh, 0)
    meta = lambda *s, dtype=dt: torch.zeros(s, dtype=dtype,  # noqa: E731
                                            device="meta")
    img = meta(rows, cfg.n_image_tokens, cfg.d_model) \
        if cfg.arch_type == "vlm" else None
    tpm.reset_counts()
    with torch.no_grad():
        if decode:
            inp = meta(rows, 1, cfg.d_model) if cfg.inputs_embeds else \
                meta(rows, 1, dtype=torch.int64)
            state = M.decode_state_specs(cfg, rows, seq)
            lg, _ = M.decode_step(params, state, inp, seq - 1, cfg,
                                  seq_len=seq, image_embeds=img, tp=tp,
                                  dp=dp)
        else:
            batch = {"embeds": meta(rows, seq, cfg.d_model)} \
                if cfg.inputs_embeds else \
                {"tokens": meta(rows, seq, dtype=torch.int64)}
            if img is not None:
                batch["image_embeds"] = img
            lg, _ = M.forward(params, batch, cfg, remat=False,
                              last_only=True, tp=tp, dp=dp)
            lg = tp.whole(lg, cfg.padded_vocab)
    assert tuple(lg.shape) == (rows, 1, cfg.padded_vocab)
    return {k: dict(count=v["calls"], result_bytes=v["bytes"])
            for k, v in tpm.counts().items()}


@pytest.mark.parametrize("arch", list(treg.ARCH_IDS))
def test_dry_run_prices_the_serving_collectives(monkeypatch, arch):
    """``dryrun.serve_collectives`` against the collectives that the
    sharded prefill and a decode step make at the full config's widths
    (depth cut): on (1, 4) and (1, 16), and on (2, 4) with a data group
    that counts too (the MoE routing's sums over it); the decode step
    also against a cache past ``full_attn_max`` (the ring buffer)."""
    monkeypatch.setattr(attention, "swa_attention", _shape_swa)
    monkeypatch.setattr(mamba2, "ssd_scan", _shape_ssd)
    cfg = treg.get_config(arch)
    cfg = dataclasses.replace(cfg, n_layers={
        "hybrid": 2 * cfg.shared_attn_every,
        "vlm": cfg.cross_attn_every}.get(cfg.arch_type, 2))
    rows = 2
    for dims in ((1, 4), (1, 16), (2, 4)):
        mesh = make_host_mesh(*dims)
        p_specs = shd.param_shardings(mesh, M.param_specs(cfg))
        for decode, seq in ((False, 256), (True, 256),
                            (True, cfg.full_attn_max + 1)):
            got = meta_serve_counts(cfg, dims, rows, seq, decode)
            want = dryrun.serve_collectives(cfg, mesh, p_specs, rows, seq,
                                            decode=decode, n_data=dims[0])
            assert got == want, (dims, decode, seq, got, want)
            assert got["reduce-scatter"]["count"] == 0
            assert got["all-gather"]["count"] > 0


def test_one_rank_cache_is_its_rows_whole_over_model():
    """A rank's cache (the rows of its place on the data axes, as
    ``DecodeEngine(mesh=)`` builds it) holds the bytes a device holds
    under the reference's ``decode_state_specs_tree`` layout."""
    cfg = treg.get_smoke_config("zamba2-7b")
    whole = M.decode_state_specs(cfg, 8, 64)
    for dims, rows in (((1, 4), 8), ((2, 2), 4), ((4, 1), 2)):
        mesh = make_host_mesh(*dims)
        ref = dict(shd.leaves_with_paths(shd.decode_state_specs_tree(
            mesh, whole, 8)))
        mine = M.init_decode_state(cfg, 8 // dims[0], 64, device="cpu")
        for path, t in shd.leaves_with_paths(mine):
            w = dict(shd.leaves_with_paths(whole))[path]
            assert t.shape[1] == rows and t.shape[2:] == w.shape[2:] \
                and t.shape[0] == w.shape[0], (dims, path)
            assert t.numel() * t.element_size() == \
                shd.spec_bytes_per_device(
                    mesh, ref[path], w.numel() * w.element_size()), path
            assert not t.any()
