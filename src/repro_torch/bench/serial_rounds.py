"""Where a round of the serial epoch kernel spends its time, on the card.

The serial epoch kernel (``csrc/dso_serial.cu`` ``serial_rounds_kernel``)
runs an epoch's visit order in windows, each window in dependency rounds:
every pending step tags its row and its column (phase A), a barrier, the
steps that hold both tags go into the block's queue (B), a barrier, the
first warps run the queued Eq.-8 steps (C), a barrier that also asks
whether any step is pending (a cluster barrier and a counter in global
memory when the kernel is a cluster).  This script times, at phase 3s's
shape (``make_classification(m 2,000, d 500, density 0.05, seed 21)``,
the staged plan: one block, the state in shared memory) and at real-sim's
shape (m 72,309, d 20,958, 51 uniform column draws per row made on the
card, repeats kept; the global plan: a cluster of 16 blocks), hinge/l2
with AdaGrad:

- the library's kernel, the one-thread kernel and copies of
  ``dso_serial.cu`` with one change each: the Eq.-8 arithmetic taken out
  (the loads and stores stay; its results are wrong: timing only) and the
  queue filled with one atomic per warp instead of one per thread;
- a copy that clocks each phase on the kernel's first thread
  (``clock64``; the barriers make its view the slowest thread's), as
  shares of the kernel's cycles and as us per round.

Each timed in turns, forward then backward, by CUDA events queued behind a
spin so that they run back to back on the card.

    PYTHONPATH=src python -m repro_torch.bench.serial_rounds

Prints the card's ``nvidia-smi`` name and power limit, one line per time
and last one JSON object of them.  Needs a CUDA card; exits 2 without
one.  About a minute on an H100.
"""

from __future__ import annotations

import contextlib
import ctypes
import json
import subprocess
import sys

import torch

from repro_torch.bench.epoch_step import _nvcc, spin_ms
from repro_torch.kernels import build, dso_serial, ops

SRC = build.CSRC / "dso_serial.cu"
M, D, NNZ = 72_309, 20_958, 51

_DECL = "constexpr int MAX_CLUSTER = 16;       // blocks of the global kernel\n"
_KSTART = ("  extern __shared__ __align__(16) float smem[];\n"
           "  const int T = blockDim.x, t = threadIdx.x;\n")
_ROUND = "      if (t == 0) qn[par ^ 1] = 0;   // read in the round before\n"
_AFTER_A = "      sync_all<STAGED>();\n      if (!STAGED && g == 0)"
_AFTER_B = ("      __syncthreads();\n      // the ready steps touch distinct "
            "rows and columns: the first warps\n")
_AFTER_C = "      par ^= 1;\n      if (!more) {\n"
_KEND = "  if (rounds_out != nullptr && g == 0) *rounds_out = r;\n"
_PHASES_ENTRY = """
extern "C" int dso_serial_phases(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, g_phase, sizeof(g_phase));
  unsigned long long z[5] = {0, 0, 0, 0, 0};
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_phase, z, sizeof(z));
  return (int)e;
}
"""
PHASES = "phases clocked"
# (name, [(text in dso_serial.cu, its replacement)], text appended)
VARIANTS = [
    ("no Eq.-8 arithmetic",
     [("          eq8_step(p, qx[q], Y[i], RN[i], CN[j], wj, ai, gwj, gai);\n",
       "          wj += qx[q];\n"),
      ("          eq8_step(p, qx[q], row.z, row.w, col.z, wj, ai, gwj, gai);\n",
       "          wj += qx[q];\n")], ""),
    ("one queue atomic per warp",
     [("      if (ready) {\n        int at = atomicAdd(qn + par, "
       "__popc(ready));\n",
       "      {\n        const int lane = t & 31, mine = __popc(ready);\n"
       "        int incl = mine;\n"
       "        for (int o = 1; o < 32; o <<= 1) {\n"
       "          const int v = __shfl_up_sync(0xffffffffu, incl, o);\n"
       "          if (lane >= o) incl += v;\n        }\n"
       "        int at = 0;\n"
       "        if (lane == 31 && incl) at = atomicAdd(qn + par, incl);\n"
       "        at = __shfl_sync(0xffffffffu, at, 31) + incl - mine;\n"),
      ], ""),
    (PHASES,
     [(_DECL, _DECL + "__device__ unsigned long long g_phase[5];\n"),
      (_KSTART, _KSTART + "  const long long k0 = clock64();\n"
                          "  long long cA = 0, cB = 0, cC = 0;\n"),
      (_ROUND, "      const long long c0 = clock64();\n" + _ROUND),
      (_AFTER_A, _AFTER_A.replace(
          "sync_all<STAGED>();\n",
          "sync_all<STAGED>();\n      const long long c1 = clock64();\n")),
      (_AFTER_B, _AFTER_B.replace(
          "__syncthreads();\n",
          "__syncthreads();\n      const long long c2 = clock64();\n")),
      (_AFTER_C, "      par ^= 1;\n      const long long c3 = clock64();\n"
                 "      cA += c1 - c0;\n      cB += c2 - c1;\n"
                 "      cC += c3 - c2;\n      if (!more) {\n"),
      (_KEND, _KEND + "  if (g == 0) {\n    g_phase[0] += clock64() - k0;\n"
                      "    g_phase[1] += cA;\n    g_phase[2] += cB;\n"
                      "    g_phase[3] += cC;\n    g_phase[4] += r;\n"
                      "  }\n")],
     _PHASES_ENTRY),
]


def start_builds():
    """nvcc of each variant of dso_serial.cu into ``build/bench_serial``
    (started together)."""
    out_dir = build.BUILD_DIR / "bench_serial"
    out_dir.mkdir(parents=True, exist_ok=True)
    text = SRC.read_text()
    procs = {}
    for i, (name, edits, tail) in enumerate(VARIANTS):
        src = text
        for old, new in edits:
            if src.count(old) != 1:
                raise RuntimeError(f"{name}: the text to change is not in "
                                   f"{SRC.name} once: {old!r}")
            src = src.replace(old, new)
        procs[name] = _nvcc(src + tail, f"serial{i}", out_dir)
    return procs


def load(name, proc, path):
    log = proc.communicate()[0]
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name!r}:\n{log}")
    cdll = ctypes.CDLL(str(path))
    for entry, argtypes in build.SIGNATURES.items():
        if hasattr(cdll, entry):
            fn = getattr(cdll, entry)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return build.Library(cdll, str(path), 0.0, log)


@contextlib.contextmanager
def using(lib):
    """``kernels/dso_serial.py``'s launchers on the variant ``lib`` (None:
    the library's own build)."""
    own = dso_serial.library
    if lib is not None:
        dso_serial.library = lambda: lib
    try:
        yield
    finally:
        dso_serial.library = own


def phase3s_shape(dev):
    """Phase 3s's coordinates and counts on the card."""
    from repro_torch.data.synthetic import make_classification
    from repro_torch.engine import prob_meta
    from repro_torch.engine.driver import _coords
    prob = make_classification(m=2000, d=500, density=0.05, seed=21,
                               device=dev)
    lam, m_f, _, _, _, lo, hi = prob_meta(prob)
    return (_coords(prob), prob.y, prob.row_nnz, prob.col_nnz,
            (0.5, lam, m_f, lo, hi))


def realsim_shape(dev):
    """real-sim's shape on the card: NNZ uniform column draws per row
    (repeats kept), normal values, labels +-1; lam 1e-4."""
    from repro_torch.engine.data import w_bounds
    g = torch.Generator(device=dev).manual_seed(0)
    ii = torch.arange(M, device=dev, dtype=torch.int32).repeat_interleave(NNZ)
    jj = torch.randint(0, D, (M * NNZ,), generator=g, device=dev,
                       dtype=torch.int32)
    vv = torch.randn(M * NNZ, generator=g, device=dev) / NNZ ** 0.5
    y = torch.where(torch.randn(M, generator=g, device=dev) >= 0, 1.0, -1.0)
    rn = torch.bincount(ii.long(), minlength=M).float()
    cn = torch.bincount(jj.long(), minlength=D).float().clamp(min=1.0)
    return ((ii, jj, vv), y, rn, cn,
            (0.5, 1e-4, float(M), *w_bounds("hinge", 1e-4)))


def main() -> int:
    if not torch.cuda.is_available():
        print("serial_rounds: needs a CUDA card", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    procs = start_builds()
    build.library()
    dev = torch.device("cuda")
    libs = {name: load(name, *p) for name, p in procs.items()}
    lim = dict(smem_limit=ops.shared_memory_limit(dev),
               max_cluster=ops.serial_max_cluster(dev))
    result = {"card": smi}
    for shape, make in (("phase 3s", phase3s_shape),
                        ("real-sim", realsim_shape)):
        coords, y, rn, cn, scal = make(dev)
        m, d, nnz = y.numel(), cn.numel(), coords[0].numel()
        order = torch.randperm(nnz, generator=torch.Generator()
                               .manual_seed(0)).to(dev, torch.int32)
        plan = ops.serial_epoch_route(m, d, nnz, **lim)
        st = [torch.zeros(d, device=dev), torch.zeros(m, device=dev),
              torch.zeros(d, device=dev), torch.zeros(m, device=dev)]
        args = (*coords, order, *st, y, rn, cn, scal, "hinge", "l2", True)
        rounds = torch.zeros(1, dtype=torch.int32, device=dev)
        dso_serial.launch_serial_epoch(*args, plan=plan, rounds=rounds)
        n_rounds = int(rounds.item())
        print(f"{shape}: m {m}, d {d}, nnz {nnz}, plan {plan}, {n_rounds} "
              f"rounds", flush=True)
        kernels = {"library": lambda: dso_serial.launch_serial_epoch(
            *args, plan=plan)}
        kernels.update({name: kernels["library"] for name in libs})
        if shape == "phase 3s":
            kernels["one thread"] = lambda: \
                dso_serial.launch_serial_epoch_one_thread(*args)
        times = {}
        names = list(kernels)
        for name in names + names[::-1]:
            with using(libs.get(name)):
                times.setdefault(name, []).append(spin_ms(kernels[name], 5))
        for name, ms in times.items():
            print(f"{shape}: {name}: " + ", ".join(f"{t:.4f}" for t in ms)
                  + f" ms per epoch ({sum(ms) / len(ms) * 1e3 / n_rounds:.3f}"
                    f" us per round)", flush=True)
        out = (ctypes.c_ulonglong * 5)()
        fn = libs[PHASES].lib.dso_serial_phases
        fn.argtypes, fn.restype = [ctypes.c_void_p], ctypes.c_int
        torch.cuda.synchronize()
        build.check("dso_serial_phases", fn(ctypes.addressof(out)))  # reset
        with using(libs[PHASES]):
            for _ in range(5):
                kernels[PHASES]()
        torch.cuda.synchronize()
        build.check("dso_serial_phases", fn(ctypes.addressof(out)))
        total, a, b, c, r = (int(v) for v in out)
        split = {"A: tags + barrier": a / total, "B: queue + barrier": b / total,
                 "C: steps + barrier": c / total,
                 "windows, staging": (total - a - b - c) / total}
        ms = sum(times[PHASES]) / len(times[PHASES])
        us = ms * 1e3 / (r / 5)
        print(f"{shape}: phases clocked on the first thread ({r // 5} rounds "
              f"an epoch, {ms:.4f} ms): " + ", ".join(
                  f"{k} {v:.3f} ({v * us:.3f} us per round)"
                  for k, v in split.items()), flush=True)
        result[shape] = dict(plan=plan._asdict(), rounds=n_rounds,
                             epoch_ms=times, phase_share=split,
                             us_per_round=us)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
