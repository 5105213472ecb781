"""Where a step of the baselines' epoch kernels spends its time, on the card.

The SGD and DCD epoch kernels (``csrc/baselines.cu``) walk a chain of
steps, one thread-block cluster per worker; a step is the margins'
partial sums, their exchange among the cluster's C blocks, and the
column updates.  This script measures two things:

1. The exchange alone, in the forms it could take (``bench/
   cluster_exchange.cu``): a ``__syncthreads``, a ``cluster.sync()``, the
   same barrier relaxed, the block's sum of a double per thread, the pull
   exchange (partials in each block's shared memory, a ``cluster.sync()``,
   the peers' partials read through ``map_shared_rank``) and the push
   exchange the kernels use (``st.async`` into every rank's slot, a wait
   on the block's own mbarrier), at 256, 512 and 1,024 threads a block
   and clusters of 1 to 16; ns per step over 20,000 steps.
2. The library's epochs at real-sim's full shape (m 72,309, d 20,958,
   ~51 nonzeros a row drawn on the card; SGD hinge/l2 at batch 1 and DCD,
   both at the plan's cluster of 16) beside copies of ``baselines.cu``
   with one part of the step taken out each (their results are wrong:
   timing only): the column updates (SGD), the axpy (DCD), the rows'
   copies into the ring, the margins; and with 256 or 1,024 threads a
   block; and the library's exchange-only floor (``launch_exchange_floor``).
   Each timed in turns, forward then backward, by CUDA events queued
   behind a spin so that they run back to back on the card.

    PYTHONPATH=src python -m repro_torch.bench.epoch_step

Prints the card's ``nvidia-smi`` name and power limit, one line per time
and last one JSON object of them.  Needs a CUDA card; exits 2 without
one.  About a minute on an H100.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import json
import subprocess
import sys

import torch

from repro_torch.kernels import baselines as kb
from repro_torch.kernels import build

SRC = build.CSRC / "baselines.cu"
EXCHANGE_SRC = build.CSRC.parent / "bench" / "cluster_exchange.cu"
SPIN_CYCLES = 20_000_000     # ~10 ms: longer than the host takes to queue
M, D, NNZ = 72_309, 20_958, 51
EXCHANGE_STEPS = 20_000
EXCHANGES = ["loop only", "__syncthreads", "cluster.sync()",
             "relaxed cluster barrier", "block sum",
             "block sum + pull (cluster.sync)",
             "block sum + push (st.async, mbarrier)"]

_UPDATE = ("    // 4. this thread's columns, their chains side by side\n"
           "    for (int j0 = 2 * tid; j0 < wr; j0 += STRIDE) {")
# (name, [(text in baselines.cu, its replacement)])
VARIANTS = [
    ("no column updates (SGD)",
     [(_UPDATE, _UPDATE.replace("j0 < wr;", "j0 < 0;"))]),
    ("no axpy (DCD)",
     [("    if (c != 0.0f)\n      for (int j0",
       "    if (c != c)\n      for (int j0")]),
    ("no copies into the ring",
     [("      if (s + RING - 1 < nsteps) prefetch(RING - 1);", ""),
      ("      if (s + RING - 1 < n) prefetch(RING - 1);", "")]),
    ("no margins",
     [("            if (j[k] < wr) p += (double)x[j[k]] * (double)ws[j[k]];",
       "            (void)j;"),
      ("        if (j[k] < wr) p += (double)ws[j[k]] * (double)x[j[k]];",
       "        (void)j;")]),
    ("256 threads a block",
     [("constexpr int CL_THREADS = 512;", "constexpr int CL_THREADS = 256;")]),
    ("1,024 threads a block",
     [("constexpr int CL_THREADS = 512;",
       "constexpr int CL_THREADS = 1024;")]),
]


def _nvcc(src_text: str, name: str, out_dir):
    """Start nvcc on ``src_text`` into ``out_dir`` (not waited for)."""
    tag = hashlib.sha1(src_text.encode() + " ".join(build.NVCC_FLAGS).encode()
                       + b"".join(f.read_bytes()
                                  for f in sorted(build.CSRC.glob("*.cuh"))))
    cu = out_dir / f"{name}_{tag.hexdigest()[:12]}.cu"
    cu.write_text(src_text)
    lib = cu.with_suffix(".so")
    return subprocess.Popen(
        [build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-shared",
         "-o", str(lib), str(cu)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib


def start_builds():
    """nvcc of the exchange kernels and of each variant of baselines.cu
    into ``build/bench_epoch_step`` (started together)."""
    out_dir = build.BUILD_DIR / "bench_epoch_step"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {"exchange": _nvcc(EXCHANGE_SRC.read_text(), "exchange", out_dir)}
    text = SRC.read_text()
    for i, (name, edits) in enumerate(VARIANTS):
        src = text
        for old, new in edits:
            if src.count(old) != 1:
                raise RuntimeError(f"{name}: the text to change is not in "
                                   f"{SRC.name} once: {old!r}")
            src = src.replace(old, new)
        procs[name] = _nvcc(src, f"variant{i}", out_dir)
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
    """``kernels/baselines.py``'s launchers on the variant ``lib`` (None:
    the library's own build)."""
    own = kb.library
    if lib is not None:
        kb.library = lambda: lib
    try:
        yield
    finally:
        kb.library = own


def spin_ms(fn, n=1):
    """ms per call: CUDA events around ``n`` calls after one, queued behind
    a spin so that they run back to back on the card."""
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
    return start.elapsed_time(end) / n


def draw_x(dev):
    """real-sim's shape on the card: NNZ draws per row (repeats fold),
    normal values on unit rows, labels +-1."""
    g = torch.Generator(device=dev).manual_seed(0)
    X = torch.zeros((M, D), device=dev)
    rows = torch.arange(M, device=dev).repeat_interleave(NNZ)
    cols = torch.randint(0, D, (M * NNZ,), generator=g, device=dev)
    X[rows, cols] = torch.randn(M * NNZ, generator=g, device=dev)
    X /= X.norm(dim=1, keepdim=True).clamp(min=1e-8)
    y = torch.where(torch.randn(M, generator=g, device=dev) >= 0, 1.0, -1.0)
    return X, y


def exchange_times(lib, dev):
    """ns per step of each exchange form: {(form, threads, C): ns}."""
    fn = lib.lib.cluster_exchange
    fn.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    out = torch.zeros(16 * 1024, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    times = {}
    for threads in (256, 512, 1024):
        for v, form in enumerate(EXCHANGES):
            row = []
            for c in (1, 2, 4, 8, 16):
                def call():
                    build.check("cluster_exchange", fn(
                        v, threads, c, 1, EXCHANGE_STEPS, out.data_ptr(),
                        stream))
                ns = spin_ms(call) * 1e6 / EXCHANGE_STEPS
                times[f"{form}, {threads} threads, cluster {c}"] = ns
                row.append(f"C{c} {ns:.1f}")
            print(f"exchange {form:38s} {threads:5d} threads: "
                  + "  ".join(row) + " ns per step", flush=True)
    return times


def main() -> int:
    if not torch.cuda.is_available():
        print("epoch_step: needs a CUDA card", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    procs = start_builds()
    build.library()
    dev = torch.device("cuda")
    X, y = draw_x(dev)
    libs = {name: load(name, *p) for name, p in procs.items()}
    result = {"card": smi, "exchange_ns_per_step": exchange_times(
        libs.pop("exchange"), dev)}
    lim = dict(smem_limit=int(torch.cuda.get_device_properties(dev)
                              .shared_memory_per_block_optin),
               max_cluster=kb.max_cluster())
    order = torch.randperm(M, generator=torch.Generator().manual_seed(5))
    order = order.to(device=dev, dtype=torch.int32)
    xn = (X * X).sum(dim=1)
    beta = torch.zeros(M, device=dev)
    z = lambda *s: torch.zeros(s, device=dev)  # noqa: E731
    out = z(64)
    plan_s = kb.epoch_plan("sgd", D, 1, **lim)
    plan_d = kb.epoch_plan("dcd", D, 1, **lim)
    print(f"plans: sgd {plan_s}, dcd {plan_d}", flush=True)
    kernels = {
        "sgd": lambda: kb.launch_sgd_epoch(
            X, y, order.reshape(1, M), z(1, D), z(1, D), 0.3, 1e-4, "hinge",
            "l2", 1, plan=plan_s),
        "dcd": lambda: kb.launch_dcd_epoch(X, y, order, z(D), beta.zero_(),
                                           1e-4, xn, plan=plan_d),
        "exchange-only floor": lambda: kb.launch_exchange_floor(
            plan_s.cluster, 1, M, out)}
    runs = [("library", None)] + [(n, libs[n]) for n, _ in VARIANTS]
    times = {}
    for name, lib in runs + runs[::-1]:
        with using(lib):
            for k, fn in kernels.items():
                if k == "exchange-only floor" and lib is not None:
                    continue
                times.setdefault(f"{k}: {name}", []).append(spin_ms(fn))
    for key, ms in times.items():
        print(f"{key}: " + ", ".join(f"{t:.3f}" for t in ms)
              + f" ms per epoch ({sum(ms) / len(ms) * 1e6 / M:.1f} ns per "
                f"step)", flush=True)
    result["epoch_ms"] = times
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
