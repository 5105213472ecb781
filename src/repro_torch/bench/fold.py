"""Where the folded sparse block step spends its time, on the card.

The sparse block step is one cooperative launch per row tile
(``csrc/dso_sparse.cu`` ``sparse_step_kernel<LAYOUT, true>``): launch A's
rows, the grid's barrier, launch B's columns.  This script builds copies of
``dso_sparse.cu`` into ``build/``, each with one change, and times them
beside the library's own in turns, forward then backward (CUDA events
around 300 launches after 3, queued behind a spin so that they run back
to back on the card; and the device time of 50 of them under
``torch.profiler``):

At svm-real-sim's shape (block-ELL: p 4, m 72,309, d 20,958, 51 uniform
draws per row, K 32, blocks [1, 2, 3, 0]), launch A alone
(``dso_sparse_dual_scatter_live``):

- ``library``: as built (groups of 8 lanes, two passes loaded with the
  row's operands, the next row's loads started before the current row's
  gather is used, 2 CTAs per SM);
- ``3 CTAs per SM``: its registers capped for them (every layout);
- ``groups of 16, one pass``: 16 lanes per row, one pass loaded with the
  row's operands;
- ``no pipelining``: the next row's loads after the current row's step;
- ``no atomics``: the scatter left out (its sums are wrong: the floor set
  by the rows' load chains and dual steps);
- ``1 copies of the sums`` to ``8 ...``: the library with its atomics
  spread over that many copies of the sums (``dso_sparse.ELL_ACC_COPIES``
  on the main path; 1: every atomic straight into acc[q]);
- ``one warp per row``: the library's ``dso_sparse_dual_scatter``, the
  baseline.

The same variants and copies also as the folded step there.

At the three sparse main-path shapes (that one; logistic-real-sim's, power-
law alpha 1.3, on the shared route; logistic-news20's, m 19,996, d
1,355,191, 455 draws per row, on the hot route), the folded step:

- ``library``;
- ``barrier only``: the primal phase left out (acc is not zeroed);
- ``no barrier``: the grid's barrier left out (the primal phase races the
  rows: timing only);
- ``counts only``: the primal phase loads the column counts and steps
  no column (wrong results: the cost of the counts' sweep);
- ``counts first``: a thread with one column also reads its count
  before its operands (as past one column);
- ``4 column loads``, ``32 column loads``: the column counts a thread of
  the primal phase loads at once (16 as built);
- ``primal phase alone``: the library's folded launch with no rows (rb 0):
  the barrier and the primal phase;
- ``launch B alone``: the library's separate launch B (every column);
- ``A alone``: the library's launch A of the same route, alone.

    PYTHONPATH=src python -m repro_torch.bench.fold

Prints the card's ``nvidia-smi`` name and power limit, ptxas's registers
and spills for each copy's ``sparse_step_kernel``s, one line per time,
and last one JSON object of them.  Needs a CUDA card; exits 2 without
one.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import json
import re
import subprocess
import sys

import numpy as np
import torch

from repro_torch.kernels import build, dso_sparse, ops
from repro_torch.sparse import (CSRMatrix, bucketed_grid_from_csr,
                                sparse_grid_from_csr)

P = 4
SRC = build.CSRC / "dso_sparse.cu"
SPIN_CYCLES = 20_000_000     # ~10 ms: longer than the host takes to queue

# (name, [(text in dso_sparse.cu, its replacement)])
ELL_VARIANTS = [
    ("3 CTAs per SM", [("constexpr int CTAS_PER_SM = 2;",
                        "constexpr int CTAS_PER_SM = 3;")]),
    ("groups of 16, one pass", [
        ("return K <= 32 ? 8 : 16;",
         "return K <= 16 ? 8 : (K <= 32 ? 16 : 32);"),
        ("constexpr int H = PASSES;",
         "constexpr int H = LAYOUT == ELL ? 1 : PASSES;")]),
    ("no pipelining", [("constexpr bool PIPE = LAYOUT == ELL;",
                        "constexpr bool PIPE = false;")]),
    ("no atomics", [("  } else {\n    atomicAdd(acc_q + col, v);\n  }",
                     "  } else {\n    if (v != v) atomicAdd(acc_q + col, v);"
                     "   // never\n  }")]),
]
FOLD_VARIANTS = [
    ("barrier only", [("    cg::this_grid().sync();\n    primal_phase(a);",
                       "    cg::this_grid().sync();")]),
    ("no barrier", [("    cg::this_grid().sync();\n    primal_phase(a);",
                     "    primal_phase(a);")]),
    ("counts only", [("    while (live != 0) {",
                       "    while (live == 0xffffffffu) {   // never"),
                      ("  if (tcn == 0.0f) return;",
                       "  if (tcn != -1.0f) return;   // always")]),
    ("counts first", [("  if (n <= stride) {", "  if (n < 0) {   // never")]),
    ("4 column loads", [("constexpr int PRIMAL_LOADS = 16;",
                         "constexpr int PRIMAL_LOADS = 4;")]),
    ("32 column loads", [("constexpr int PRIMAL_LOADS = 16;",
                          "constexpr int PRIMAL_LOADS = 32;")]),
]
# copies of the block-ELL sums timed beside ELL_ACC_COPIES
COPIES = (1, 2, 4, 8)
# (cell, rows, columns, draws per row, power-law alpha or None, seed,
# layout, route)
CELLS = [("svm-real-sim", 72309, 20958, 51, None, 4, "sparse", None),
         ("logistic-real-sim", 72309, 20958, 51, 1.3, 5, "bucketed",
          "shared"),
         ("logistic-news20", 19996, 1355191, 455, 1.3, 6, "bucketed",
          "hot")]


def start_builds():
    """nvcc of each variant into ``build/`` (started together, not waited
    for): {name: (process, library path)}."""
    text = SRC.read_text()
    heads = b"".join(f.read_bytes() for f in sorted(build.CSRC.glob("*.cuh")))
    out_dir = build.BUILD_DIR / "bench_fold"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, edits in ELL_VARIANTS + FOLD_VARIANTS:
        src = text
        for old, new in edits:
            if src.count(old) != 1:
                raise RuntimeError(f"{name}: the text to change is not in "
                                   f"{SRC.name} once: {old!r}")
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


def ptxas_notes(name, log):
    """Print ptxas's registers and spills of each ``sparse_step_kernel``
    in ``log`` (``-Xptxas -v``)."""
    lines = log.splitlines()
    for i, line in enumerate(lines):
        hit = re.search(r"sparse_step_kernelILi(\d)ELb(\d)E", line)
        if hit and "Compiling entry" in line:
            notes = [x.split(":", 1)[-1].strip() for x in lines[i + 1:i + 4]
                     if "registers" in x or "spill" in x]
            print(f"[ptxas] {name}: sparse_step_kernel<{hit[1]}, "
                  f"{'true' if hit[2] == '1' else 'false'}> "
                  + "; ".join(notes), flush=True)


def load(name, proc, path):
    """The variant's library, its entry points typed as the library's."""
    log = proc.communicate()[0]
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on the {name!r} copy:\n{log}")
    ptxas_notes(name, log)
    cdll = ctypes.CDLL(str(path))
    for entry, argtypes in build.SIGNATURES.items():
        if hasattr(cdll, entry):
            fn = getattr(cdll, entry)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return build.Library(cdll, str(path), 0.0, log)


@contextlib.contextmanager
def using(lib):
    """``dso_sparse``'s launchers on the variant ``lib`` (None: the
    library's own build)."""
    own = dso_sparse.library
    if lib is not None:
        dso_sparse.library = lambda: lib
    try:
        yield
    finally:
        dso_sparse.library = own


def draw_grid(m, d, k, alpha, seed, layout, dev):
    """``k`` draws per row over ``d`` columns (power-law popularity when
    ``alpha``), deduplicated, normal values, labels +-1, from ``seed``,
    tiled onto the p x p grid of ``layout``."""
    rng = np.random.default_rng(seed)
    pop = None
    if alpha:
        pop = np.arange(1, d + 1, dtype=np.float64) ** -alpha
        pop /= pop.sum()
    cols = np.sort(rng.choice(d, size=(m, k), replace=True, p=pop), axis=1)
    keep = np.ones((m, k), bool)
    keep[:, 1:] = cols[:, 1:] != cols[:, :-1]
    indptr = np.zeros(m + 1, np.int64)
    np.cumsum(keep.sum(axis=1), out=indptr[1:])
    csr = CSRMatrix(indptr, cols[keep].astype(np.int32),
                    rng.normal(0, 0.2, int(indptr[-1])).astype(np.float32),
                    (m, d))
    y = np.where(rng.random(m) < 0.5, 1.0, -1.0).astype(np.float32)
    tile = sparse_grid_from_csr if layout == "sparse" \
        else bucketed_grid_from_csr
    return tile(csr, y, P, 1, device=dev)


def timed(fn, n=300, warm=3):
    """(ms, device ms) per call of ``fn``: CUDA events around ``n``
    back-to-back calls after ``warm``, queued behind a spin of
    ``SPIN_CYCLES`` so that they run back to back on the card whatever the
    host's time per call; and the device time of the kernels of ``n // 6``
    calls under ``torch.profiler``, over the launches its trace holds."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    k = n // 6
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(k):
            fn()
        torch.cuda.synchronize()
    per = [e.self_device_time_total / e.count for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA and e.count]
    return start.elapsed_time(end) / n, sum(per) / 1e3


def cell_launches(grid, layout, route, m, copies=1):
    """(folded step, launch A alone, launch B alone) of one row tile on
    ``grid`` from a random state made here, by the launchers of whichever
    library ``using`` puts in place; block-ELL into ``copies`` copies of
    the sums (the one-warp-per-row kernel, ``alone("warp")``, into one);
    ``fold(0)``: the folded launch with no rows."""
    dev = grid.yg.device
    g = torch.Generator().manual_seed(6)
    alpha = (grid.yg.cpu() * torch.rand(grid.p, grid.mb, generator=g)).to(dev)
    w = (0.1 * torch.randn(grid.p, grid.db, generator=g)).to(dev)
    gw = torch.rand(grid.p, grid.db, generator=g).to(dev) * 1e-2
    ga = torch.rand(grid.p, grid.mb, generator=g).to(dev) * 1e-2
    acc = torch.zeros(copies * grid.p, grid.db, device=dev)
    one = torch.zeros_like(w)
    blk = torch.tensor([1, 2, 3, 0], dtype=torch.int32, device=dev)
    loss = "hinge" if layout == "sparse" else "logistic"
    scal = (0.5, 1e-4, float(m), -100.0, 100.0)
    hot = ops.grid_hot_table(grid.col_nnz, grid.p, grid.db) \
        if route == "hot" else None
    common = (blk, grid.yg)
    rows = (grid.tile_row_nnz_g, grid.row_nnz_g)
    def launch_b():
        dso_sparse.launch_primal_update(blk, w, gw, one, grid.tile_col_nnz_g,
                                        grid.col_nnz, 0, scal, "l2")

    if layout == "sparse":
        def fold(rb=grid.mb):
            dso_sparse.launch_sparse_block_step(
                grid.cols_g, grid.vals_g, *common, w, gw, alpha, ga, *rows,
                grid.tile_col_nnz_g, grid.col_nnz, acc, 0, rb, scal, loss,
                "l2")

        def alone(kernel="live"):
            dso_sparse.launch_sparse_dual_scatter(
                grid.cols_g, grid.vals_g, *common, w, alpha, ga, *rows,
                acc if kernel == "live" else one, 0, grid.mb, scal[0],
                scal[2], loss, kernel=kernel)
    else:
        chunks = (grid.cols_fl, grid.vals_fl, grid.chunk_lut, grid.chunk_cnt)

        def fold(rb=grid.mb):
            dso_sparse.launch_bucketed_block_step(
                *chunks, *common, w, gw, alpha, ga, *rows,
                grid.tile_col_nnz_g, grid.col_nnz, one, 0, rb, scal, loss,
                "l2", route=route, hot=hot)

        def alone():
            dso_sparse.launch_bucketed_dual_scatter(
                *chunks, *common, w, alpha, ga, *rows, one, 0, grid.mb,
                scal[0], scal[2], loss, route=route, hot=hot)
    return fold, alone, launch_b


def in_turns(runs):
    """Each of ``runs`` ({name: (library or None, fn)}) timed forward then
    backward: {name: [(ms, device ms), (ms, device ms)]}."""
    times = {}
    order = list(runs)
    for name in order + order[::-1]:
        lib, fn = runs[name]
        with using(lib):
            times.setdefault(name, []).append(timed(fn))
    return times


def main() -> int:
    if not torch.cuda.is_available():
        print("fold: needs a CUDA card", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    procs = start_builds()
    ptxas_notes("library", build.library().log)
    dev = torch.device("cuda")
    grids = {c[0]: draw_grid(*c[1:7], dev) for c in CELLS}
    libs = {name: load(name, *proc) for name, proc in procs.items()}
    out = {}
    for cell, m, _, _, _, _, layout, route in CELLS:
        grid = grids[cell]
        copies = dso_sparse.ELL_ACC_COPIES if layout == "sparse" else 1
        fold, alone, launch_b = cell_launches(grid, layout, route, m, copies)
        runs = {"library": (None, fold)}
        runs.update({name: (libs[name], fold) for name, _ in FOLD_VARIANTS})
        runs["A alone"] = (None, alone)
        runs["primal phase alone"] = (None, lambda: fold(0))
        runs["launch B alone"] = (None, launch_b)
        if layout == "sparse":
            runs.update({name: (libs[name], fold)
                         for name, _ in ELL_VARIANTS})
            for n in COPIES:
                runs[f"{n} copies of the sums"] = (
                    None, cell_launches(grid, layout, route, m, n)[0])
        times = in_turns(runs)
        if layout == "sparse":
            a_runs = {"library": (None, alone)}
            a_runs.update({name: (libs[name], alone)
                           for name, _ in ELL_VARIANTS})
            for n in COPIES:
                a_runs[f"{n} copies of the sums"] = (
                    None, cell_launches(grid, layout, route, m, n)[1])
            a_runs["one warp per row"] = (None, lambda: alone("warp"))
            for name, ms in in_turns(a_runs).items():
                times[f"launch A alone, {name}"] = ms
        for name, ms in times.items():
            print(f"{cell}: {name}: " + ", ".join(
                f"{t:.4f}/{d:.4f}" for t, d in ms)
                + " ms/device ms per launch", flush=True)
        out[cell] = times
    print(json.dumps({"card": smi, "ms": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
