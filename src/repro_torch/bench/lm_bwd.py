"""The LM backward kernels on the card: a quick check, and the A/Bs of the
attention's and the SSD's backward against the kernels they replaced.

Builds the library and, started together with it into
``build/bench_lm_bwd``, two libraries of the bench's own: the ``mma.sync``
baseline, ``bench/swa_bwd_mma.cu``, the kernels that the library's
``csrc/swa_attention_bwd.cu`` and ``swa_attention_bwd_tf32x3.cu`` replaced
(with ``csrc/swa_attention.cu`` and ``swa_attention_tc.cu``, so that the
packed route's entry links to them), and ``bench/ssd_bwd_parts.cu`` (with
``csrc/ssd_chunk_grad.cu``), the SSD backward one launch at a time.  The
baseline runs through ``ops`` with ``kernels/swa_attention.py``'s
``library`` swapped for it (its entry points, the library's for the rest).
Then:

1. checks: each attention route and each SSD width at small edge shapes
   (GQA, windows, decode offsets, rows with no key, ragged t and chunks;
   SSD: ragged head groups, n != dh, dh past 64, B and C in bf16 or
   float32, each case on its chunk-gradient plan, printed, and on the
   CUDA-core kernel): the forward that
   saves the rows' logsumexp or the chunk states and the backward kernels
   against the plain backward on the same saved tensors; a case is bad
   past 2e-2 x max(1, max|g|) in bf16, 1e-4 x in float32 (attention; SSD
   in the inputs' types: 2^-7 x in bf16, one rounding, 1e-3 x in
   float32), or with a gradient that is not finite;
2. times at the backward shapes of ``chip_smoke.py`` phase 7 (zamba2-7b's
   32 heads of 112: bf16 B 2 x T 4,096 causal, T 16,384 with a 4,096
   window, the misaligned packed case, float32 B 1 x T 4,096): the library
   and the baseline in turns (library, mma.sync, mma.sync, library), each
   by CUDA events around 3 calls queued behind a spin, the library's
   kernels under the profiler, and SDPA's backward in the same run; then
   the SSD backward at phase 7's shapes (zamba2-7b's group, mamba2-370m;
   x, B, C bf16): ``ops._ssd_scan_bwd`` with the tensor-core chunk
   gradients (``csrc/ssd_chunk_grad.cu``) and with the CUDA-core kernel
   they replaced (``ssd_chunk_grad_kernel``, the route that
   ``chunk_grad_plan`` keeps for shapes past the new kernel, forced by
   swapping ``chunk_grad_plan``) in turns (tc, fma, fma, tc), and each
   route's launches apart by CUDA events (``ssd_scan_bwd_part``): the
   state adjoint's two, the chunk gradients, the two ``torch.sum``s.

    PYTHONPATH=src python -m repro_torch.bench.lm_bwd

Prints the card's ``nvidia-smi`` name and power limit, ptxas's registers
and spills of the backward kernels (the attention's and the SSD's chunk
gradients), one line per case and per time, and
last ``ALL OK`` or ``SOME BAD`` (exit 1).  Needs a CUDA card; exits 2
without one.  ``chip_smoke.py`` phases 3l, 7 and 7t hold the same kernels
to their gates.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import re
import subprocess
import sys

import torch

from repro_torch.kernels import build, ops
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.kernels import swa_attention as swa

OUT_DIR = build.BUILD_DIR / "bench_lm_bwd"
SPIN_CYCLES = 20_000_000     # ~10 ms on an H100: longer than the host
                             # takes to queue the timed calls
HEADS, HEAD_DIM = 32, 112    # zamba2-7b's attention
# chip_smoke.py's SWA_BWD_FULL: (label, B, T, window, dtype, misaligned)
FULL = [("7t group, causal", 2, 4096, 4096, "bfloat16", False),
        ("sliding window", 1, 16384, 4096, "bfloat16", False),
        ("7t group, causal, misaligned", 2, 4096, 4096, "bfloat16", True),
        ("7t float32 group, causal", 1, 4096, 4096, "float32", False)]
# (B, Hq, Hkv, Tq, Tk, Dh, window, causal, q_offset, dtype, misaligned)
SWA_CASES = [
    (1, 2, 2, 256, 256, 64, 128, True, 0, "bfloat16", False),
    (2, 4, 2, 300, 300, 112, 128, True, 0, "bfloat16", False),
    (1, 8, 2, 200, 200, 112, 1, True, 0, "bfloat16", False),
    (1, 4, 1, 130, 190, 112, 50, False, 0, "bfloat16", False),
    (1, 4, 1, 16, 32, 64, 4, True, 30, "bfloat16", False),
    (2, 4, 2, 8, 1024, 64, 256, True, 1016, "bfloat16", False),
    (1, 2, 1, 77, 77, 36, 20, True, 0, "bfloat16", False),
    (1, 4, 2, 140, 140, 36, 70, True, 0, "bfloat16", True),
    (1, 2, 2, 130, 130, 33, 1000, True, 0, "bfloat16", False),
    (1, 4, 2, 150, 150, 112, 64, True, 0, "bfloat16", True),
    (1, 2, 2, 256, 256, 64, 128, True, 0, "float32", False),
    (2, 8, 2, 200, 200, 112, 150, True, 0, "float32", False),
    (1, 2, 1, 90, 90, 30, 45, True, 0, "float32", False),
    (1, 4, 1, 16, 32, 64, 4, True, 30, "float32", False),
    (1, 2, 2, 100, 100, 64, 100, False, 0, "float32", True),
    (1, 2, 1, 260, 260, 128, 300, True, 0, "float32", False),
]
# (b, t, h, dh, n, chunk), each in float32 and bf16 (B and C float32), and
# those with n a multiple of 8 in bf16 with B and C bf16 too
SSD_CASES = [(1, 128, 2, 32, 16, 64), (2, 256, 3, 32, 16, 64),
             (1, 100, 2, 16, 8, 32), (1, 1000, 4, 64, 64, 128),
             (1, 300, 2, 64, 128, 128), (1, 260, 2, 128, 64, 128),
             (2, 130, 2, 160, 16, 64), (1, 70, 1, 256, 8, 64),
             (1, 250, 2, 48, 24, 100), (2, 2100, 2, 112, 48, 64),
             (2, 300, 9, 64, 128, 128), (1, 256, 12, 64, 64, 128),
             (1, 200, 3, 36, 20, 128)]
# chip_smoke.py's SSD_BWD_FULL: (label, b, t, h, dh, n)
SSD_FULL = [("zamba2-7b group", 2, 4096, 112, 64, 64),
            ("mamba2-370m", 4, 2048, 32, 64, 128)]
FMA = ssd.GradPlan(False, 1, 1, False)    # the CUDA-core chunk gradients
_PART_ARGS = build.SIGNATURES["ssd_scan_bwd"][:-1] + [ctypes.c_int,
                                                      ctypes.c_void_p]


# ------------------------------------------------------------ baseline --

def _nvcc(name, sources):
    """Start nvcc on ``sources`` ({file name: text}) into one library in
    ``OUT_DIR`` (not waited for): (process, library path)."""
    tag = hashlib.sha1(" ".join(build.NVCC_FLAGS).encode())
    for f in sorted(build.CSRC.glob("*.cu*")):      # what sources include
        tag.update(f.read_bytes())
    for fname, text in sorted(sources.items()):
        tag.update(fname.encode() + b"\0" + text.encode())
    out = OUT_DIR / f"{name}_{tag.hexdigest()[:12]}"
    out.mkdir(parents=True, exist_ok=True)
    files = []
    for fname, text in sources.items():
        (out / fname).write_text(text)
        files.append(str(out / fname))
    lib = out / "lib.so"
    return subprocess.Popen(
        [build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-shared",
         "-o", str(lib), *files],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib


def start_build():
    """nvcc of the mma.sync baseline and of the SSD backward's parts
    (started, not waited for): {name: (process, library path)}."""
    bench = build.CSRC.parent / "bench"
    src = {f: (build.CSRC / f).read_text()
           for f in ("swa_attention.cu", "swa_attention_tc.cu")}
    src["swa_bwd_mma.cu"] = (bench / "swa_bwd_mma.cu").read_text()
    parts = {"ssd_bwd_parts.cu": (bench / "ssd_bwd_parts.cu").read_text(),
             "ssd_chunk_grad.cu": (build.CSRC /
                                   "ssd_chunk_grad.cu").read_text()}
    return {"mma.sync": _nvcc("mma_sync", src),
            "ssd parts": _nvcc("ssd_parts", parts)}


def ptxas_notes(name, log):
    """ptxas's registers and spills of each backward kernel in ``log``."""
    lines = log.splitlines()
    for i, line in enumerate(lines):
        hit = re.search(r"Compiling entry function "
                        r"'(\w*(?:swa_bwd|ssd_chunk_grad)\w*)'", line)
        if hit:
            notes = [x.split(":", 1)[-1].strip() for x in lines[i + 1:i + 4]
                     if "registers" in x or "spill" in x]
            print(f"[ptxas] {name}: {hit[1]} " + "; ".join(notes),
                  flush=True)


def load(name, proc, path):
    """The variant's library, its entry points typed as the library's."""
    log = proc.communicate()[0]
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on the {name!r} variant:\n{log}")
    ptxas_notes(name, log)
    cdll = ctypes.CDLL(str(path))
    sigs = dict(build.SIGNATURES, ssd_scan_bwd_part=_PART_ARGS)
    for entry, argtypes in sigs.items():
        if hasattr(cdll, entry):
            fn = getattr(cdll, entry)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return build.Library(cdll, str(path), 0.0, log)


class _Merged:
    """A variant's entry points; the library's for those it lacks."""

    def __init__(self, variant, own):
        self._variant, self._own = variant, own

    def __getattr__(self, name):
        try:
            return getattr(self._variant, name)
        except AttributeError:
            return getattr(self._own, name)


@contextlib.contextmanager
def routed(plan):
    """``ops._ssd_scan_bwd``'s chunk gradients on ``plan`` (None: the
    plan ``chunk_grad_plan`` picks)."""
    own = ssd.chunk_grad_plan
    if plan is not None:
        ssd.chunk_grad_plan = lambda *a: plan
    try:
        yield
    finally:
        ssd.chunk_grad_plan = own


@contextlib.contextmanager
def using(lib):
    """``kernels/swa_attention.py``'s launchers on the variant ``lib``
    (None: the library's own build)."""
    own = swa.library
    if lib is not None:
        merged = build.Library(_Merged(lib.lib, own().lib), lib.path, 0.0, "")
        swa.library = lambda: merged
    try:
        yield
    finally:
        swa.library = own


# -------------------------------------------------------------- checks --

def _misaligned(a):
    """A contiguous copy of ``a`` one element into a larger buffer, so its
    data is not 16-byte aligned (the packed route)."""
    buf = torch.empty(a.numel() + 1, dtype=a.dtype, device=a.device)
    out = buf[1:].view(a.shape)
    out.copy_(a)
    return out


def _err(got, want):
    """(max|d|, max|want|) over one gradient."""
    return (float((got.double() - want.double()).abs().max()),
            float(want.double().abs().max()))


def check_swa(gen, dev):
    ok_all = True
    for (B, Hq, Hkv, Tq, Tk, Dh, window, causal, off, dname,
         misaligned) in SWA_CASES:
        dtype = getattr(torch, dname)
        q = torch.randn(B, Hq, Tq, Dh, generator=gen, device=dev).to(dtype)
        do = torch.randn(B, Hq, Tq, Dh, generator=gen, device=dev).to(dtype)
        k, v = (torch.randn(B, Hkv, Tk, Dh, generator=gen,
                            device=dev).to(dtype) for _ in range(2))
        if misaligned:
            q, k, v, do = (_misaligned(a) for a in (q, k, v, do))
        kw = dict(window=window, causal=causal, q_offset=off)
        ops.reset_launch_counts()
        o, lse = ops._swa_launch(q, k, v, **kw, lse=True)
        grads = ops._swa_bwd_launch(q, k, v, o, lse, do, **kw)
        torch.cuda.synchronize()
        _, plse = swa.swa_attention_plain(q, k, v, **kw, return_lse=True)
        want = swa.swa_attention_bwd_plain(q, k, v, o, lse, do, **kw)
        counts = {n: c for n, c in ops.launch_counts().items() if c}
        live = plse > swa.NEG_INF / 2
        e_lse = float((lse - plse).abs()[live].max()) if live.any() else 0.0
        errs = [_err(g, w) for g, w in zip(grads, want)]
        tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
        bad = (any(e > tol * max(1.0, top) for e, top in errs) or
               not all(bool(torch.isfinite(g).all()) for g in grads) or
               e_lse > 1e-3)
        ok_all &= not bad
        print(f"SWA {dname} B={B} Hq={Hq} Hkv={Hkv} Tq={Tq} "
              f"Tk={Tk} Dh={Dh} window={window} causal={causal} "
              f"q_offset={off} misaligned={misaligned} {counts} lse max|d| "
              f"{e_lse:.3e} gradients (max|d|, max|g|) {errs} "
              f"{'BAD' if bad else 'ok'}", flush=True)
    return ok_all


def check_ssd(gen, dev):
    ok_all = True
    bf = torch.bfloat16
    runs = [(c, d, False) for c in SSD_CASES for d in ("float32", "bfloat16")]
    runs += [(c, "bfloat16", True) for c in SSD_CASES if c[4] % 8 == 0]
    for (b, t, h, dh, n, chunk), dname, bc16 in runs:
        dtype = getattr(torch, dname)
        r = lambda *s: torch.randn(*s, generator=gen,  # noqa: E731
                                   device=dev)
        x, dy = r(b, t, h, dh).to(dtype), r(b, t, h, dh).to(dtype)
        dt = r(b, t, h).abs() * 0.1 + 0.01
        A = -(r(h) * 0.3 + 1.0).abs()
        B, C = r(b, t, n) / n ** 0.5, r(b, t, n) / n ** 0.5
        if bc16:
            B, C = B.to(bf), C.to(bf)
        _, states, decay = ops._ssd_launch(x, dt, A, B, C, chunk=chunk,
                                           save=True)
        _, pst, _ = ssd.ssd_scan_plain(x, dt, A, B, C, chunk=chunk,
                                       return_states=True)
        want = ssd.ssd_scan_bwd_plain(x, dt, A, B, C, states, decay, dy,
                                      chunk=chunk)
        for force in (None, FMA):
            plan = force or ops._ssd_grad_plan(x, B, C, chunk=chunk)
            ops.reset_launch_counts()
            with routed(force):
                grads = ops._ssd_scan_bwd(x, dt, A, B, C, states, decay, dy,
                                          chunk=chunk)
            torch.cuda.synchronize()
            counts = {k: c for k, c in ops.launch_counts().items() if c}
            # in the inputs' types, as ops.SSDScan returns them; a bf16
            # gradient within one bf16 rounding of its largest element
            grads = [g.to(w.dtype) for g, w in zip(grads, want)]
            errs = [_err(g.float(), w.float()) for g, w in zip(grads, want)]
            tols = [2.0 ** -7 if w.dtype == bf else 1e-3 for w in want]
            bad = (any(e > tol * max(1.0, top)
                       for (e, top), tol in zip(errs, tols)) or
                   not all(bool(torch.isfinite(g).all()) for g in grads) or
                   counts.get("ssd_scan_bwd_fma", 0) != (not plan.tc))
            ok_all &= not bad
            print(f"SSD {dname} b={b} t={t} h={h} dh={dh} n={n} "
                  f"chunk={chunk} B, C {str(B.dtype)[6:]} "
                  f"{'forced ' if force else ''}{plan} {counts} states "
                  f"max|d| {_err(states, pst)[0]:.3e} gradients (max|d|, "
                  f"max|g|) {errs} {'BAD' if bad else 'ok'}", flush=True)
    return ok_all


# --------------------------------------------------------------- times --

def _ms(fn, n=3):
    """ms per call of ``fn``: CUDA events around ``n`` calls queued behind
    a spin, after one call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def _kernel_ms(fn, n=3):
    """[(kernel, device ms per call)] of ``n`` calls of ``fn`` under the
    profiler, longest first (a trace can lose records: PERF.md §7)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    got = [(e.key.replace("(anonymous namespace)::", "").split("(")[0][-32:],
            e.self_device_time_total / n / 1e3)
           for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    return sorted(got, key=lambda kv: -kv[1])


def _sdpa_bwd_ms(q, k, v, do):
    """ms of the backward of ``F.scaled_dot_product_attention(is_causal=
    True)`` on aligned copies (it faults on a misaligned upstream
    gradient): the forward once, then the gradients timed behind a spin."""
    import torch.nn.functional as F
    xs = [a.detach().clone().requires_grad_() for a in (q, k, v)]
    out = F.scaled_dot_product_attention(*xs, is_causal=True)
    up = do.clone()
    ms = _ms(lambda: torch.autograd.grad(out, xs, up, retain_graph=True))
    del out, xs
    torch.cuda.empty_cache()
    return ms


def times(baseline, parts, gen, dev):
    """The attention backward at phase 7's shapes, the library and the
    baseline in turns, beside SDPA's backward; then the SSD backward."""
    for label, B, T, window, dname, misaligned in FULL:
        dtype = getattr(torch, dname)
        q, k, v, do = (torch.randn(B, HEADS, T, HEAD_DIM, generator=gen,
                                   device=dev).to(dtype) for _ in range(4))
        if misaligned:
            q, k, v, do = (_misaligned(a) for a in (q, k, v, do))
        kw = dict(window=window, causal=True, q_offset=0)
        o, lse = ops._swa_launch(q, k, v, **kw, lse=True)

        def call():
            return ops._swa_bwd_launch(q, k, v, o, lse, do, **kw)
        runs = {"library": None, "mma.sync": baseline}
        order = ["library", "mma.sync", "mma.sync", "library"]
        got = {n: [] for n in runs}
        for name in order:
            with using(runs[name]):
                got[name].append(_ms(call))
        kern = _kernel_ms(call)
        sdpa = _sdpa_bwd_ms(q, k, v, do)
        fwd = _ms(lambda: ops._swa_launch(q, k, v, **kw))
        print(f"SWA backward {label} ({dname} B={B} H={HEADS} T={T} "
              f"Dh={HEAD_DIM} window={window}), ms per call in turns "
              f"{order}: "
              + "; ".join(f"{n} {sum(x) / len(x):.4f} "
                          f"({', '.join(f'{y:.4f}' for y in x)})"
                          for n, x in got.items())
              + "; the library's kernels under the profiler "
              + ", ".join(f"{n} {m:.4f}" for n, m in kern[:4])
              + f"; SDPA(is_causal) backward {sdpa:.4f}; forward "
                f"{fwd:.4f}", flush=True)
        del q, k, v, do, o, lse
        torch.cuda.empty_cache()
    for label, b, t, h, dh, n in SSD_FULL:
        times_ssd(label, b, t, h, dh, n, parts, gen, dev)


def _ssd_split(parts, x, dt, A, B, C, states, decay, dy, plan, chunk,
               n_rep=3):
    """ms of each of ``plan``'s launches and the two sums apart: CUDA events
    between them (``ssd_scan_bwd_part`` of ``parts``, the bench's build of
    ``ssd_scan.cu``), ``n_rep`` rounds queued behind a spin, averaged:
    {launch 1' (the adjoint's local sums), launch 2' (its pass), the chunk
    gradients, sum dB, sum dC}."""
    b, t, h, dh = x.shape
    n = B.shape[-1]
    f32 = torch.float32
    dtf, Af, Bf, Cf = (a.to(f32).contiguous() for a in (dt, A, B, C))
    Bk, Ck = (B, C) if plan.bc_bf16 else (Bf, Cf)
    dx = torch.empty_like(x)
    ddt = torch.empty(b, t, h, dtype=f32, device=x.device)
    dAp = torch.empty_like(decay)
    dBp = torch.empty(b, t, -(-h // plan.g), n, dtype=f32, device=x.device)
    dCp = torch.empty_like(dBp)
    wsz = torch.empty_like(states)
    names = ["adjoint 1'", "adjoint 2'", "chunk gradients", "sum dB",
             "sum dC"]

    def part(k):
        return lambda: build.check("ssd_scan_bwd_part",
                                   parts.lib.ssd_scan_bwd_part(
            x.data_ptr(), dtf.data_ptr(), Af.data_ptr(), Bf.data_ptr(),
            Cf.data_ptr(), dy.data_ptr(), states.data_ptr(),
            decay.data_ptr(), wsz.data_ptr(), dx.data_ptr(), ddt.data_ptr(),
            dBp.data_ptr(), dCp.data_ptr(), dAp.data_ptr(), Bk.data_ptr(),
            Ck.data_ptr(), b, t, h, dh, n, chunk,
            int(x.dtype == torch.bfloat16), int(plan.tc), plan.g, plan.xs,
            int(plan.bc_bf16), k, build.stream(dx)))
    steps = [part(1), part(2), part(3), lambda: dBp.sum(2),
             lambda: dCp.sum(2)]
    for fn in steps:
        fn()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(steps) + 1)]
    got = [0.0] * len(steps)
    for _ in range(n_rep):
        torch.cuda._sleep(SPIN_CYCLES)
        ev[0].record()
        for k, fn in enumerate(steps):
            fn()
            ev[k + 1].record()
        ev[-1].synchronize()
        for k in range(len(steps)):
            got[k] += ev[k].elapsed_time(ev[k + 1]) / n_rep
    return dict(zip(names, got))


def times_ssd(label, b, t, h, dh, n, parts, gen, dev, chunk=128):
    """The SSD backward at one of phase 7's shapes: ``ops._ssd_scan_bwd``
    with the tensor-core chunk gradients and with the CUDA-core ones in
    turns (tc, fma, fma, tc), then each route's launches apart."""
    bf = torch.bfloat16
    r = lambda *s: torch.randn(*s, generator=gen, device=dev)  # noqa: E731
    x, dy = r(b, t, h, dh).to(bf), r(b, t, h, dh).to(bf)
    dt = r(b, t, h).abs() * 0.1 + 0.01
    A = -(r(h) * 0.3 + 1.0).abs()
    B, C = (r(b, t, n) / n ** 0.5).to(bf), (r(b, t, n) / n ** 0.5).to(bf)
    _, states, decay = ops._ssd_launch(x, dt, A, B, C, chunk=chunk,
                                       save=True)
    tc = ops._ssd_grad_plan(x, B, C, chunk=chunk)
    runs = {"tc": None, "fma": FMA}
    order = ["tc", "fma", "fma", "tc"]
    got = {k: [] for k in runs}
    for name in order:
        with routed(runs[name]):
            got[name].append(_ms(lambda: ops._ssd_scan_bwd(
                x, dt, A, B, C, states, decay, dy, chunk=chunk)))
    split = {k: _ssd_split(parts, x, dt, A, B, C, states, decay, dy, p,
                           chunk)
             for k, p in (("tc", tc), ("fma", FMA))}
    fwd = _ms(lambda: ops._ssd_launch(x, dt, A, B, C, chunk=chunk))
    n_chunks = -(-t // chunk)
    print(f"SSD backward {label} (bf16 x, B, C; b={b} t={t} h={h} dh={dh} "
          f"n={n} chunk={chunk}), ms per call in turns {order}: "
          + "; ".join(f"{k} {sum(v) / len(v):.4f} "
                      f"({', '.join(f'{y:.4f}' for y in v)})"
                      for k, v in got.items())
          + f"; tc plan {tc}, its grid {b * n_chunks * -(-h // tc.g)} CTAs "
            f"(132 SMs), the CUDA-core kernel's {b * n_chunks * h}; "
          + "; ".join(f"{k} launches apart: "
                      + ", ".join(f"{n_} {m:.4f}" for n_, m in v.items())
                      for k, v in split.items())
          + f"; forward {fwd:.4f}", flush=True)
    del x, dy, states, decay
    torch.cuda.empty_cache()


def main() -> int:
    if not torch.cuda.is_available():
        print("lm_bwd: needs a CUDA card", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    procs = start_build()
    lib = build.library()
    print(f"built {lib.path} in {lib.build_s:.2f} s", flush=True)
    ptxas_notes("library", lib.log)
    baseline, parts = (load(k, *procs[k]) for k in ("mma.sync",
                                                    "ssd parts"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    ok = check_swa(gen, dev)
    ok &= check_ssd(gen, dev)
    times(baseline, parts, gen, dev)
    print("ALL OK" if ok else "SOME BAD")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
