"""The LM backward kernels alone, on the card: a quick check and a first
time, without the rest of ``chip_smoke.py``.

Builds the library, then for each attention route (split-TF32 float32,
bf16 in place, bf16 packed: Dh not a multiple of 8 or misaligned data)
and each SSD width, at small edge shapes (GQA, windows, decode offsets,
rows with no key, ragged t and chunks): the forward that saves the rows'
logsumexp or the chunk states (``ops._swa_launch(lse=True)``,
``ops._ssd_launch(save=True)``) and the backward kernels
(``ops._swa_bwd_launch``, ``ops._ssd_scan_bwd``) against the plain
backward on the same saved tensors; a case is bad past 2e-2 x max(1,
max|g|) in bf16, 1e-4 x in float32 (attention; SSD 1e-3), or with a
gradient that is not finite.  Then each backward's ms per call at
zamba2-7b's shapes (bf16 attention, B 2 x T 4,096 and B 1 x T 16,384 with
a 4,096 window, 32 heads of 112; the SSD scan at b 2 x t 4,096, 112 heads
of 64, state 64), CUDA events around 3 calls queued behind a spin, beside
the forward's.

    PYTHONPATH=src python -m repro_torch.bench.lm_bwd

Prints the card's ``nvidia-smi`` name and power limit, one line per case
and per time, and last ``ALL OK`` or ``SOME BAD`` (exit 1).  Needs a CUDA
card; exits 2 without one.  ``chip_smoke.py`` phases 3l and 7 hold the
same kernels to tighter bounds at more shapes.
"""

from __future__ import annotations

import subprocess
import sys

import torch

from repro_torch.kernels import build, ops
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.kernels import swa_attention as swa

SPIN_CYCLES = 20_000_000
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
# (b, t, h, dh, n, chunk), each in float32 and bf16
SSD_CASES = [(1, 128, 2, 32, 16, 64), (2, 256, 3, 32, 16, 64),
             (1, 100, 2, 16, 8, 32), (1, 1000, 4, 64, 64, 128),
             (1, 300, 2, 64, 128, 128), (1, 260, 2, 128, 64, 128),
             (2, 130, 2, 160, 16, 64), (1, 70, 1, 256, 8, 64),
             (1, 250, 2, 48, 24, 100), (2, 2100, 2, 112, 48, 64)]


def _misaligned(a):
    buf = torch.empty(a.numel() + 1, dtype=a.dtype, device=a.device)
    out = buf[1:].view(a.shape)
    out.copy_(a)
    return out


def _err(got, want):
    """(max|d|, max|want|) over one gradient."""
    return (float((got.double() - want.double()).abs().max()),
            float(want.double().abs().max()))


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
        print(f"SWA {dname} B={B} Hq={Hq} Hkv={Hkv} Tq={Tq} Tk={Tk} Dh={Dh} "
              f"window={window} causal={causal} q_offset={off} "
              f"misaligned={misaligned} {counts} lse max|d| {e_lse:.3e} "
              f"gradients (max|d|, max|g|) {errs} "
              f"{'BAD' if bad else 'ok'}", flush=True)
    return ok_all


def check_ssd(gen, dev):
    ok_all = True
    for b, t, h, dh, n, chunk in SSD_CASES:
        for dname in ("float32", "bfloat16"):
            dtype = getattr(torch, dname)
            r = lambda *s: torch.randn(*s, generator=gen,  # noqa: E731
                                       device=dev)
            x, dy = r(b, t, h, dh).to(dtype), r(b, t, h, dh).to(dtype)
            dt = r(b, t, h).abs() * 0.1 + 0.01
            A = -(r(h) * 0.3 + 1.0).abs()
            B, C = r(b, t, n) / n ** 0.5, r(b, t, n) / n ** 0.5
            ops.reset_launch_counts()
            _, states, decay = ops._ssd_launch(x, dt, A, B, C, chunk=chunk,
                                               save=True)
            grads = ops._ssd_scan_bwd(x, dt, A, B, C, states, decay, dy,
                                      chunk=chunk)
            torch.cuda.synchronize()
            _, pst, _ = ssd.ssd_scan_plain(x, dt, A, B, C, chunk=chunk,
                                           return_states=True)
            want = ssd.ssd_scan_bwd_plain(x, dt, A, B, C, states, decay, dy,
                                          chunk=chunk)
            counts = {k: c for k, c in ops.launch_counts().items() if c}
            errs = [_err(g, w) for g, w in zip(grads, want)]
            bad = (any(e > 1e-3 * max(1.0, top) for e, top in errs) or
                   not all(bool(torch.isfinite(g).all()) for g in grads))
            ok_all &= not bad
            print(f"SSD {dname} b={b} t={t} h={h} dh={dh} n={n} "
                  f"chunk={chunk} {counts} states max|d| "
                  f"{_err(states, pst)[0]:.3e} gradients (max|d|, max|g|) "
                  f"{errs} {'BAD' if bad else 'ok'}", flush=True)
    return ok_all


def times(gen, dev):
    bf = torch.bfloat16
    r = lambda *s: torch.randn(*s, generator=gen, device=dev)  # noqa: E731
    for B, T, window in ((2, 4096, 4096), (1, 16384, 4096)):
        q, k, v, do = (r(B, 32, T, 112).to(bf) for _ in range(4))
        kw = dict(window=window, causal=True, q_offset=0)
        o, lse = ops._swa_launch(q, k, v, **kw, lse=True)
        bwd = _ms(lambda: ops._swa_bwd_launch(q, k, v, o, lse, do, **kw))
        fwd = _ms(lambda: ops._swa_launch(q, k, v, **kw))
        print(f"SWA backward bf16 B={B} H=32 T={T} Dh=112 window={window}: "
              f"{bwd:.4f} ms per call; forward {fwd:.4f} ms", flush=True)
        del q, k, v, do, o, lse
    x, dy = r(2, 4096, 112, 64).to(bf), r(2, 4096, 112, 64).to(bf)
    dt = r(2, 4096, 112).abs() * 0.1 + 0.01
    A = -(r(112) * 0.3 + 1.0).abs()
    B, C = r(2, 4096, 64) / 8, r(2, 4096, 64) / 8
    _, states, decay = ops._ssd_launch(x, dt, A, B, C, chunk=128, save=True)
    bwd = _ms(lambda: ops._ssd_scan_bwd(x, dt, A, B, C, states, decay, dy,
                                        chunk=128))
    fwd = _ms(lambda: ops._ssd_launch(x, dt, A, B, C, chunk=128))
    print(f"SSD backward bf16 x b=2 t=4096 h=112 dh=64 n=64 chunk=128: "
          f"{bwd:.4f} ms per call; forward {fwd:.4f} ms", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("lm_bwd: needs a CUDA card", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    lib = build.library()
    print(f"built {lib.path} in {lib.build_s:.2f} s", flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    ok = check_swa(gen, dev)
    ok &= check_ssd(gen, dev)
    times(gen, dev)
    print("ALL OK" if ok else "SOME BAD")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
