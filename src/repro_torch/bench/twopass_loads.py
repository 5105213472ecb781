"""A/B of the two-pass tile step's load mechanism, on the card.

The span passes of ``csrc/dso_twopass.cu`` carry each row's span into
registers with the lanes' own 16-byte ``ld.global.nc`` loads ("loads").
``bench/twopass_bulk.cu`` holds the same two passes with the spans carried
by ``cp.async.bulk`` into a shared-memory ring ("bulk").  This script
builds that file beside the library, holds its passes against the
library's on the same inputs, and times each pass alone at svm-ocr's tile
(processor 0's block 1 of the 1,000,000 x 1,156 grid at p = 4: 250,000 x
289, row stride 1,156), in turns: loads, bulk, rows, rows, bulk, loads,
where "rows" is the library's 4-byte row kernels on a copy of the tile at
row stride 1,157.  Each time is CUDA events around 50 back-to-back
launches, after 3; X (289 MB) does not fit in the 50 MB L2.  The primal
pass adds into sums that are not zeroed between launches (no change of
work).

    PYTHONPATH=src python -m repro_torch.bench.twopass_loads

Prints the card's ``nvidia-smi`` name and power limit, ptxas's report on
the bulk kernels, one line per time, and last one JSON object of them.
Needs a CUDA card; exits 2 without one.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import subprocess
import sys

import torch

from repro_torch.kernels import build, dso_update

HBM_BYTES_S = 3.35e12       # H100 SXM device memory rate (data sheet)
TOL = 1e-5
SRC = build.CSRC.parent / "bench" / "twopass_bulk.cu"
M, LD, DB, BLOCK = 250_000, 1156, 289, 1
_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
SIGNATURES = {
    "twopass_bulk_primal": [_P, _L, _I, _I] + [_P] * 4,
    "twopass_bulk_dual": [_P, _L, _I, _I] + [_P] * 7 + [_F, _F, _I, _P],
}


def start_build():
    """nvcc of the bulk kernels into ``build/`` (started, not waited for):
    (process, path of the library)."""
    tag = hashlib.sha1(SRC.read_bytes() + " ".join(build.NVCC_FLAGS).encode()
                       + b"".join(f.read_bytes()
                                  for f in sorted(build.CSRC.glob("*.cuh"))))
    out = build.BUILD_DIR / f"twopass_bulk_{tag.hexdigest()[:12]}.so"
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    proc = subprocess.Popen(
        [build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-shared",
         "-o", str(out), str(SRC)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, out


def load_bulk(proc, out):
    log = proc.communicate()[0]
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {SRC.name}:\n{log}")
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"[ptxas] {line.strip()}", flush=True)
    lib = ctypes.CDLL(str(out))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return lib


def events_ms(fn, n=50, warm=3):
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


def close(got, want):
    d = (got - want).abs()
    return float(d.max()), bool(torch.all(d <= TOL + TOL * want.abs()))


def main() -> int:
    if not torch.cuda.is_available():
        print("twopass_loads: no CUDA card", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    proc, out = start_build()
    lib_loads = build.library().lib
    lib_bulk = load_bulk(proc, out)

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(20)
    full = torch.empty((M, LD), device=dev).normal_(0.0, LD ** -0.5,
                                                    generator=g)
    X = full[:, BLOCK * DB:(BLOCK + 1) * DB]
    Xr = torch.empty((M, LD + 1), device=dev)[:, :DB]
    Xr.copy_(X)
    routes = dso_update.twopass_route(X), dso_update.twopass_route(Xr)
    if routes != ("span", "rows"):
        raise RuntimeError(f"the tile and its copy take {routes}, expected "
                           f"('span', 'rows')")
    u = lambda n, lo, hi: torch.empty(n, device=dev).uniform_(  # noqa: E731
        lo, hi, generator=g)
    y = torch.where(u(M, -1, 1) >= 0, 1.0, -1.0)
    alpha, w = y * u(M, 0.05, 0.95), u(DB, -0.1, 0.1)
    ga, rn = u(M, 0.0, 0.01), torch.full((M,), float(LD), device=dev)
    eta, m, loss = 0.5, 1e6, dso_update.LOSS_IDS["hinge"]
    stream = torch.cuda.current_stream().cuda_stream
    sums = {k: (torch.zeros(DB, device=dev), torch.zeros(DB, device=dev))
            for k in ("loads", "bulk", "rows")}
    outs = {k: (torch.empty_like(alpha), torch.empty_like(ga))
            for k in ("loads", "bulk", "rows")}

    def primal(kind):
        x = Xr if kind == "rows" else X
        acc, cnt = sums[kind]
        if kind == "bulk":
            build.check("twopass_bulk_primal", lib_bulk.twopass_bulk_primal(
                x.data_ptr(), x.stride(0), M, DB, alpha.data_ptr(),
                acc.data_ptr(), cnt.data_ptr(), stream))
        else:
            dso_update.launch_twopass_primal(x, alpha, acc, cnt)

    def dual(kind):
        x = Xr if kind == "rows" else X
        a_out, ga_out = outs[kind]
        if kind == "bulk":
            build.check("twopass_bulk_dual", lib_bulk.twopass_bulk_dual(
                x.data_ptr(), x.stride(0), M, DB, w.data_ptr(),
                alpha.data_ptr(), a_out.data_ptr(), ga.data_ptr(),
                ga_out.data_ptr(), y.data_ptr(), rn.data_ptr(), eta, m, loss,
                stream))
        else:
            dso_update.launch_twopass_dual(x, w, alpha, a_out, ga, ga_out, y,
                                           rn, eta, m, "hinge")

    for kind in sums:
        primal(kind)
        dual(kind)
    torch.cuda.synchronize()
    errs = {}
    for kind in ("bulk", "rows"):
        e1, ok1 = close(sums[kind][0], sums["loads"][0])
        e2, ok2 = close(outs[kind][0], outs["loads"][0])
        e3, ok3 = close(outs[kind][1], outs["loads"][1])
        same_cnt = torch.equal(sums[kind][1], sums["loads"][1])
        errs[kind] = max(e1, e2, e3)
        print(f"{kind} vs loads: X^T alpha max|d| {e1:.3e}, alpha {e2:.3e}, "
              f"ga {e3:.3e}, column counts equal {same_cnt}", flush=True)
        if not (ok1 and ok2 and ok3 and same_cnt):
            raise RuntimeError(f"the {kind} passes disagree with the loads "
                               f"passes")
    read_ms = 4 * M * DB / HBM_BYTES_S * 1e3
    times = {}
    for name, launch in (("primal", primal), ("dual", dual)):
        for kind in ("loads", "bulk", "rows", "rows", "bulk", "loads"):
            ms = events_ms(lambda: launch(kind))
            times.setdefault(f"{name}_{kind}", []).append(ms)
            print(f"{name} pass, {kind}: {ms:.4f} ms per launch; one read "
                  f"of X {read_ms:.4f} ms ({read_ms / ms:.1%} of the HBM "
                  f"rate)", flush=True)
    print(json.dumps({"card": smi.stdout.strip().splitlines()[0],
                      "read_ms": read_ms, "max_abs_err": errs,
                      "ms": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
