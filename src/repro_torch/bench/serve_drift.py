"""Where the sharded prefill's float32 logits part from one process's,
on the card: the run behind ``chip_smoke.py`` phase 9s's (s1) float32
gate.

Phase 9s compares rank 0's float32 prefill (zamba2-7b's first group at
full width, B 1 x T 4,096 on (1, 4), ``serving.engine.make_sharded_prefill``)
with the one-process ``forward(last_only=True)``.  This script runs the
same two prefills with every intermediate recorded, and a third witness:

* the same forward in float64 (every parameter widened, the plain
  versions of the kernels, each ``.float()`` of the model left at
  float64, ``chip_smoke.float64_kept``), against which both float32
  runs are measured;
* per block (and per ``_in_proj``, ``ssd_scan``, ``_gate_out``,
  ``swa_attention``, ``_finish``, ``mlp_apply`` call in it) rank 0's
  values against the one-process run's: relative L2, max|d| and whether
  the bits are equal (the kernels' outputs on rank 0's heads);
* with the same inputs, each column-split product of the path (a rank's
  columns of in_proj, out_proj, the attention's and the MLP's weights,
  the vocabulary's) against the same columns of the whole product, and
  the SSD and SWA kernels on rank 0's heads against the same heads of
  the kernels on every head: bits equal or not;
* rank 0's values, block by block, against the one-process forward in
  the ranks' blocks (``chip_smoke.rank_blocked``: the same products and
  kernel calls in the same blocks);
* the one-process run's own spread: the same prefill again, with the
  plain versions, with the row twice (B 2), under one float32 rounding
  of input noise;
* in bf16, the sharded prefill against the one-process one, sound and
  with a planted fault (each rank's SSD heads take the next rank's dt),
  beside the one-process run's spread under one bf16 rounding of input
  noise: the two readings that phase 9s's bf16 bound sits between.

    PYTHONPATH=src python -m repro_torch.bench.serve_drift

Prints the card's ``nvidia-smi`` name and power limit and one line per
reading.  About 2 minutes on the card, the kernels' build included;
exits 2 without a card.  ``--smoke`` runs zamba2-7b's smoke config at
T 256 on the CPU (the plain versions; a rehearsal, no reading).
"""

from __future__ import annotations

import argparse
import contextlib
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[3]


@contextlib.contextmanager
def recording(out, heads=None):
    """Within the ``with``: the outputs of the model's blocks and of the
    calls inside them appended to ``out`` as (name, tensor) in call
    order; ``heads`` (a list) gets the inputs of each ``ssd_scan`` and
    ``swa_attention`` call."""
    from repro_torch.models import attention, mamba2
    from repro_torch.models import model as M
    names = [(M, "_mamba_block_apply", "block mamba"),
             (M, "_attn_block_apply", "block attn"),
             (M, "mlp_apply", "mlp"),
             (mamba2, "_in_proj", "in_proj"),
             (mamba2, "ssd_scan", "ssd_scan"),
             (mamba2, "_gate_out", "gate_out"),
             (attention, "swa_attention", "swa"),
             (attention, "_finish", "finish")]
    saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in names]

    def wrap(fn, label):
        def inner(*a, **k):
            got = fn(*a, **k)
            if heads is not None and label in ("ssd_scan", "swa"):
                heads.append((label, a, k))
            outs = got if isinstance(got, tuple) else (got,)
            if label == "in_proj":
                outs = outs[:3]          # z, xBC, dt (the conv's weights)
            elif label == "block attn":
                outs = outs[:1]          # (x, aux)
            for j, t in enumerate(outs):
                out.append((f"{label}[{j}]" if len(outs) > 1 else label,
                            t.detach()))
            return got
        return inner
    for (mod, attr, label), (_, _, fn) in zip(names, saved):
        setattr(mod, attr, wrap(fn, label))
    try:
        yield out
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


def drift_rank(rank, init, job, out):
    """One rank (``chip_smoke.tp_spawn``'s worker contract)."""
    try:
        res = _drift_rank(rank, init, job)
    except BaseException as e:           # the parent stops every rank
        out.put((rank, f"{type(e).__name__}: {e}"))
        raise
    out.put((rank, res))


@contextlib.contextmanager
def planted_fault():
    """Within the ``with``: ``TensorParallel.part`` of a (B, T, h) tensor
    (the SSD's dt) takes the next rank's slice."""
    from repro_torch.dist.tensor_parallel import TensorParallel
    orig = TensorParallel.part

    def part(self, t, full, dim=-1):
        got = orig(self, t, full, dim)
        if t is None or t.dim() != 3 or got is t:
            return got
        s = full // self.n
        return t.narrow(dim, (self.coord + 1) % self.n * s, s)
    TensorParallel.part = part
    try:
        yield
    finally:
        TensorParallel.part = orig


def _drift_rank(rank, init, job):
    import datetime
    import torch.distributed as dist
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    from repro_torch.dist import tensor_parallel as tpm
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model as M
    from repro_torch.serving.engine import make_sharded_prefill
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    dev = torch.device(job["device"])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        build.library()                  # built by the parent: loaded
    dist.init_process_group("gloo", init_method=init,
                            world_size=cs.TP_RANKS, rank=rank,
                            timeout=datetime.timedelta(
                                seconds=cs.TP_TIMEOUT))
    mesh = make_host_mesh(1, cs.TP_RANKS)
    res = {}
    for dt in ("float32", "bfloat16"):
        cfg, tokens = setup(job, dev, dt)
        whole = M.init_params(torch.Generator(device=dev).manual_seed(
            cs.SERVE_SEED), cfg, device=dev)
        local = tpm.shard_tree(whole, mesh, rank)
        del whole
        pre, _, _ = make_sharded_prefill(cfg, mesh, {"tokens": tokens})
        rec = []
        with recording(rec):
            res[dt] = pre(local, {"tokens": tokens}).cpu()
        if dt == "float32":
            res["rec"] = [(k, v.cpu()) for k, v in rec]
        else:
            with planted_fault():
                res["fault"] = pre(local, {"tokens": tokens}).cpu()
        del local, rec
    if rank == 0:
        torch.save(res, job["file"])
    dist.destroy_process_group()
    return {}


def setup(job, dev, dtype="float32", **over):
    """(zamba2-7b's config, the prompt): its first group at full width,
    or (``job["smoke"]``) its smoke config."""
    import dataclasses
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    from repro_torch.configs.registry import get_smoke_config
    if job["smoke"]:
        cfg = dataclasses.replace(get_smoke_config("zamba2-7b"),
                                  dtype=dtype, **over)
    else:
        cfg = cs.model_config("zamba2-7b", dtype=dtype, **cs.TP_GROUP,
                              **over)
    tokens = cs.markov_batches(cfg, 1, job["t"], 1, cs.SERVE_SEED,
                               dev)[0]["tokens"]
    return cfg, tokens


def _cmp(a, b):
    """(relative L2, max|d|, bits equal) of ``a`` against ``b``."""
    a, b = a.detach(), b.detach()
    eq = a.dtype == b.dtype and a.shape == b.shape and bool(
        torch.equal(a, b))
    a64, b64 = a.double(), b.double()
    return (float((a64 - b64).norm() / b64.norm()),
            float((a64 - b64).abs().max()), eq)


def _mine(label, t, like):
    """The one-process value ``t`` cut to rank 0's part of ``like``'s
    shape: heads of an SSD (dim 2) or SWA (dim 1) output."""
    if t.shape == like.shape:
        return t
    dim = 2 if label.startswith("ssd") else 1
    return t.narrow(dim, 0, like.shape[dim])


def op_checks(cfg, params, heads, dev, say):
    """The products and kernels with the same inputs: a rank's columns or
    heads against the same part of the whole."""
    from repro_torch.dist import tensor_parallel as tpm
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model as M
    mesh = make_host_mesh(1, 4)
    trees = {"mamba": M.layer(params["layers"], 0)["mamba"],
             "shared_attn": params["shared_attn"],
             "unembed": params["unembed"]}
    gen = torch.Generator(device=dev).manual_seed(5)
    T = heads[0][1][0].shape[1]
    for name, tree in trees.items():
        flat = dict(_leaves(tree))
        for r in range(4):
            part = dict(_leaves(tpm.shard_tree(tree, mesh, r)))
            for path, w in flat.items():
                p = part[path]
                if w.dim() != 2 or p.shape == w.shape or "conv" in path:
                    continue
                if p.shape[0] != w.shape[0]:
                    say(f"op {name}/{path} rank {r}: split on rows "
                        f"{tuple(p.shape)} of {tuple(w.shape)}, skipped")
                    continue
                m = 1 if name == "unembed" else T
                x = torch.randn((m, w.shape[0]), generator=gen, device=dev,
                                dtype=w.dtype)
                n = p.shape[1]
                rel, mx, eq = _cmp(x @ p, (x @ w)[:, r * n:(r + 1) * n])
                say(f"op {name}/{path} x ({m}, {w.shape[0]}) @ rank {r}'s "
                    f"{n} of {w.shape[1]} columns: rel {rel:.3e} max|d| "
                    f"{mx:.3e} bits equal {eq}")
    from repro_torch.models import attention, mamba2
    for label, a, k in heads:
        fn = mamba2.ssd_scan if label == "ssd_scan" else \
            attention.swa_attention
        if label == "ssd_scan":          # x, dt, A, B, C; heads on dim 2
            x, dt, A, B, C = a
            h = x.shape[2] // 4
            whole = fn(x, dt, A, B, C, **k)
            mine = fn(x[:, :, :h].contiguous(), dt[..., :h].contiguous(),
                      A[:h].contiguous(), B, C, **k)
            rel, mx, eq = _cmp(mine, whole[:, :, :h])
        else:                            # q, k, v (B, H, T, Dh)
            q, kk, v = a
            hq, hk = q.shape[1] // 4, kk.shape[1] // 4
            whole = fn(q, kk, v, **k)
            mine = fn(q[:, :hq].contiguous(), kk[:, :hk].contiguous(),
                      v[:, :hk].contiguous(), **k)
            rel, mx, eq = _cmp(mine, whole[:, :hq])
        say(f"op {label} on rank 0's heads, the same inputs, against the "
            f"same heads of the call on every head: rel {rel:.3e} max|d| "
            f"{mx:.3e} bits equal {eq}")


def _leaves(tree, pre=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{pre}{k}/")
        else:
            yield f"{pre}{k}", v


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--smoke", action="store_true")
    args = ap.parse_args(argv)
    if not args.smoke and not torch.cuda.is_available():
        print("serve_drift: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model as M
    from repro_torch.training import optimizer as opt

    def say(msg):
        print(msg, flush=True)
    dev = torch.device("cpu") if args.smoke else torch.device("cuda", 0)
    job = dict(device=str(dev), smoke=args.smoke,
               t=256 if args.smoke else cs.TP_T)
    if not args.smoke:
        say(cs.smi_line())
        lib = build.library()
        say(f"built {lib.path} in {lib.build_s:.2f} s")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    cfg, tokens = setup(job, dev)
    params = M.init_params(torch.Generator(device=dev).manual_seed(
        cs.SERVE_SEED), cfg, device=dev)
    fwd = lambda p, toks, c=cfg: M.forward(  # noqa: E731
        p, {"tokens": toks}, c, remat=False, last_only=True)[0][:, -1]
    one, heads = [], []
    with torch.no_grad():
        with recording(one, heads):
            lg = fwd(params, tokens)
        again = fwd(params, tokens)
        twice = fwd(params, tokens.repeat(2, 1))[:1]
        with cs.plain_kernels():
            plain = fwd(params, tokens)
        blocked = []
        with cs.rank_blocked(params, make_host_mesh(1, cs.TP_RANKS)), \
                recording(blocked):
            lg_b = fwd(params, tokens)
        x0 = M.embed(params["embed"], tokens)
        noise = torch.randn(x0.shape, device=dev, generator=torch.Generator(
            device=dev).manual_seed(cs.SERVE_SEED + 2))
        x1 = x0 * (1 + 2.0 ** -24 * noise)
        spread = cs.hybrid_walk(params, cfg, x1)[:, -1]
        op_checks(cfg, params, heads, dev, say)
        del heads
        p64 = opt.tree_map(lambda t: t.double() if t.is_floating_point()
                           else t, params)
        del params
        cfg64, _ = setup(job, dev, "float64", logits_dtype="float64")
        w64 = []
        with cs.plain_kernels(), cs.float64_kept(), recording(w64):
            lg64 = fwd(p64, tokens, cfg64)
        del p64
        cfg16, _ = setup(job, dev, "bfloat16")
        p16 = M.init_params(torch.Generator(device=dev).manual_seed(
            cs.SERVE_SEED), cfg16, device=dev)
        lg16 = fwd(p16, tokens, cfg16)
        x0 = M.embed(p16["embed"], tokens)
        x1 = (x0.float() * (1 + cs.SENS_NOISE * noise)).to(x0.dtype)
        spread16 = cs.hybrid_walk(p16, cfg16, x1)[:, -1]
        del p16
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    say(f"one-process runs {time.perf_counter() - t0:.1f} s")
    with tempfile.TemporaryDirectory() as tmp:
        job["file"] = os.path.join(tmp, "rank0.pt")
        t1 = time.perf_counter()
        cs.tp_spawn(job, tmp, drift_rank, "drift")
        got = torch.load(job["file"], weights_only=True)
    say(f"{cs.TP_RANKS} ranks ran in {time.perf_counter() - t1:.1f} s")
    shard = got["float32"][:, -1].to(dev)
    say("logits, relative L2: sharded vs the one-process forward in the "
        f"ranks' blocks {_cmp(shard, lg_b)[0]:.3e} (bits equal "
        f"{_cmp(shard, lg_b)[2]}); the blocked forward vs one process "
        f"{_cmp(lg_b, lg)[0]:.3e}")
    say("logits, relative L2: sharded vs one process "
        f"{_cmp(shard, lg)[0]:.3e}; one process vs float64 "
        f"{_cmp(lg, lg64)[0]:.3e}; sharded vs float64 "
        f"{_cmp(shard, lg64)[0]:.3e}; plain versions vs float64 "
        f"{_cmp(plain, lg64)[0]:.3e}; plain vs one process "
        f"{_cmp(plain, lg)[0]:.3e}; one process again "
        f"{_cmp(again, lg)[0]:.3e} (bits equal {_cmp(again, lg)[2]}); the "
        f"row twice (B 2) {_cmp(twice, lg)[0]:.3e}; input noise 2^-24 "
        f"{_cmp(spread, lg)[0]:.3e}")
    say("bf16 logits, relative L2 from the one-process prefill: sharded "
        f"{_cmp(got['bfloat16'][:, -1].to(dev), lg16)[0]:.3e}, sharded "
        f"with the planted fault {_cmp(got['fault'][:, -1].to(dev), lg16)[0]:.3e}"
        f"; the one-process run under input noise 2^-8 "
        f"{_cmp(spread16, lg16)[0]:.3e}")
    blocks64 = iter(v for k, v in w64 if k.startswith("block"))
    rec = got["rec"]
    if len(rec) != len(one):
        say(f"the ranks recorded {len(rec)} calls, one process {len(one)}")
    for (k, mine), (k1, ref), (_, blk) in zip(rec, one, blocked):
        mine = mine.to(dev)
        rel, mx, eq = _cmp(mine, _mine(k, ref, mine))
        line = (f"{k:>14} {tuple(mine.shape)}: rank 0 vs one process rel "
                f"{rel:.3e} max|d| {mx:.3e} bits equal {eq}; vs the "
                f"blocked forward rel {_cmp(mine, _mine(k, blk, mine))[0]:.3e}"
                f" bits equal {_cmp(mine, _mine(k, blk, mine))[2]}")
        if k.startswith("block"):
            w = next(blocks64)
            line += (f"; vs float64: one process {_cmp(ref, w)[0]:.3e}, "
                     f"rank 0 {_cmp(mine, w)[0]:.3e}")
        if k != k1:
            line += f" (one process recorded {k1})"
        say(line)
    say(f"serve_drift took {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
