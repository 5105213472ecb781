"""Where the hot route's launch A spends its time, on the card.

The hot route of the K-bucketed launch A alone (``csrc/dso_sparse.cu``
``sparse_step_kernel<HOT, false>``: the main path's kernel without its
primal phase) at news20's shape: p 4,
m 19,996, d 1,355,191 (db 338,798), 455 power-law (alpha 1.3) draws per
row, blocks [1, 2, 3, 0].  This script builds copies of ``dso_sparse.cu``
into ``build/``, each with one change, and times launch A alone (CUDA
events around 300 back-to-back launches, after 3) beside the library's
own in turns, forward then backward:

- ``library``: the hot route as built (two passes over a row loaded at
  once, 2 CTAs per SM);
- ``one pass``: one pass over a row's slots loaded at a time;
- ``3 CTAs per SM``: registers capped for 3 CTAs per SM (ptxas spills);
- ``no atomics``: the shared, cold global and flush atomics left out (its
  sums are wrong: the floor set by the rows' load chains and dual steps);
- ``global``: the library's global route, the baseline.

    PYTHONPATH=src python -m repro_torch.bench.hot_route

Prints the card's ``nvidia-smi`` name and power limit, ptxas's report on
each copy's hot kernel, one line per time, and last one JSON object of
them.  Needs a CUDA card; exits 2 without one.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import subprocess
import sys

import numpy as np
import torch

from repro_torch.kernels import build, dso_sparse, ops
from repro_torch.sparse import CSRMatrix, bucketed_grid_from_csr

M, D, K, ALPHA, P = 19996, 1355191, 455, 1.3, 4
SRC = build.CSRC / "dso_sparse.cu"
# (name, [(text in dso_sparse.cu, its replacement)])
VARIANTS = [
    ("one pass", [("constexpr int PASSES = 2;", "constexpr int PASSES = 1;")]),
    ("3 CTAs per SM", [("constexpr int CTAS_PER_SM = 2;",
                        "constexpr int CTAS_PER_SM = 3;")]),
    ("no atomics", [
        ("if (slot >= 0)\n"
         "      atomicAdd(acc_s + slot, v);\n"
         "    else\n"
         "      atomicAdd(acc_q + col, v);",
         "if (slot == -2) acc_s[0] = 1.0f;   // never: keeps the lookup"),
        ("if (v[u] != 0.0f) atomicAdd(acc_q + col[u], v[u]);",
         "if (v[u] != v[u]) atomicAdd(acc_q + col[u], v[u]);")]),
]
HOT_ENTRY = "dso_bucketed_dual_scatter_hot"


def start_builds():
    """nvcc of each variant into ``build/`` (started together, not waited
    for): {name: (process, library path)}."""
    text = SRC.read_text()
    heads = b"".join(f.read_bytes() for f in sorted(build.CSRC.glob("*.cuh")))
    out_dir = build.BUILD_DIR / "bench_hot_route"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, edits in VARIANTS:
        src = text
        for old, new in edits:
            if old not in src:
                raise RuntimeError(f"{name}: the text to change is not in "
                                   f"{SRC.name}: {old!r}")
            src = src.replace(old, new)
        tag = hashlib.sha1(src.encode() + heads
                           + " ".join(build.NVCC_FLAGS).encode())
        cu = out_dir / f"{tag.hexdigest()[:12]}.cu"
        cu.write_text(src)
        lib = cu.with_suffix(".so")
        procs[name] = (subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC),
             "-shared", "-o", str(lib), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    return procs


def load(name, proc, lib):
    log = proc.communicate()[0]
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on the {name!r} copy:\n{log}")
    lines = log.splitlines()
    for i, line in enumerate(lines):
        if "sparse_step_kernelILi2ELb0E" in line:
            print(f"[ptxas] {name}: " + " ".join(
                x.strip() for x in lines[i + 1:i + 3]), flush=True)
    cdll = ctypes.CDLL(str(lib))
    fn = getattr(cdll, HOT_ENTRY)
    fn.argtypes, fn.restype = build.SIGNATURES[HOT_ENTRY], ctypes.c_int
    return fn


def news20_grid(dev):
    """The news20-shaped K-bucketed grid: ``K`` power-law draws per row,
    deduplicated, normal values, labels +-1, from seed 6."""
    rng = np.random.default_rng(6)
    pop = np.arange(1, D + 1, dtype=np.float64) ** -ALPHA
    pop /= pop.sum()
    cols = np.sort(rng.choice(D, size=(M, K), replace=True, p=pop), axis=1)
    keep = np.ones((M, K), bool)
    keep[:, 1:] = cols[:, 1:] != cols[:, :-1]
    indptr = np.zeros(M + 1, np.int64)
    np.cumsum(keep.sum(axis=1), out=indptr[1:])
    csr = CSRMatrix(indptr, cols[keep].astype(np.int32),
                    rng.normal(0, 1, int(indptr[-1])).astype(np.float32),
                    (M, D))
    y = np.where(rng.random(M) < 0.5, 1.0, -1.0).astype(np.float32)
    return bucketed_grid_from_csr(csr, y, P, 1, device=dev)


def events_ms(fn, n=300, warm=3):
    """Mean ms per call of ``fn`` over ``n`` calls, CUDA events around the
    run, after ``warm`` calls."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def main() -> int:
    if not torch.cuda.is_available():
        print("hot_route: needs a CUDA card", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    procs = start_builds()
    lib = build.library().lib
    dev = torch.device("cuda")
    grid = news20_grid(dev)
    slots, reached = dso_sparse.hot_slots()
    hot, hot_cols = ops.grid_hot_table(grid.col_nnz, grid.p, grid.db)
    g = torch.Generator().manual_seed(6)
    alpha = (grid.yg.cpu() * torch.rand(grid.p, grid.mb, generator=g)).to(dev)
    w = (0.1 * torch.randn(grid.p, grid.db, generator=g)).to(dev)
    ga = torch.rand(grid.p, grid.mb, generator=g).to(dev) * 1e-2
    acc = torch.zeros_like(w)
    blk = torch.tensor([1, 2, 3, 0], dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    common = [t.data_ptr() for t in (
        grid.cols_fl, grid.vals_fl, grid.chunk_lut, grid.chunk_cnt, blk,
        grid.yg, w, alpha, ga, grid.tile_row_nnz_g, grid.row_nnz_g, acc)]
    common += [grid.p, grid.mb, grid.cols_fl.shape[1],
               grid.chunk_lut.shape[2], grid.db, 0, grid.mb, 0.5,
               float(M), 1]                         # eta, m, logistic

    def hot_launch(fn):
        def launch():
            build.check(HOT_ENTRY, fn(*common, hot.data_ptr(),
                                      hot_cols.data_ptr(), slots, stream))
        return launch

    def global_launch():
        build.check("dso_bucketed_dual_scatter",
                    lib.dso_bucketed_dual_scatter(*common, stream))

    runs = {"library": hot_launch(getattr(lib, HOT_ENTRY)),
            "global": global_launch}
    for name, (proc, path) in procs.items():
        runs[name] = hot_launch(load(name, proc, path))
    print(f"news20 grid: db {grid.db}, buckets {grid.bucket_ks}; hot route "
          f"{slots} slots per CTA, {reached} CTAs per SM", flush=True)
    order = list(runs)
    times = {}
    for name in order + order[::-1]:
        ms = events_ms(runs[name])
        times.setdefault(name, []).append(ms)
        print(f"launch A alone, {name}: {ms:.4f} ms per launch", flush=True)
    print(json.dumps({"card": smi, "slots": slots, "ctas_per_sm": reached,
                      "ms": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
