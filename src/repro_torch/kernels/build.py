"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled by its own ``nvcc -c`` (all started
together), then the objects are linked into ONE shared library in
``build/``, named by a hash over every source and header in ``csrc/`` and
the flags, so a changed source builds anew and an unchanged one is loaded
from ``build/``.  The entry points have a plain C interface; ``library``
sets each one's ``argtypes`` from ``SIGNATURES`` and loads it with
``ctypes``.  Each entry point returns ``cudaGetLastError()`` after its
launch, and ``check`` raises on anything but 0.

Nothing here runs at import: the first ``library()`` call builds.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import NamedTuple

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
SIGNATURES = {
    # csrc/dso_sparse.cu
    "dso_sparse_dual_scatter":
        [_P] * 10 + [_I] * 6 + [_F, _F, _I, _P],
    "dso_sparse_dual_scatter_live":
        [_P] * 10 + [_I] * 7 + [_F, _F, _I, _P],
    "dso_sparse_block_step":
        [_P] * 13 + [_I] * 9 + [_F] * 5 + [_I, _I, _P],
    "dso_bucketed_dual_scatter":
        [_P] * 12 + [_I] * 7 + [_F, _F, _I, _P],
    "dso_bucketed_dual_scatter_shared":
        [_P] * 12 + [_I] * 7 + [_F, _F, _I, _P],
    "dso_bucketed_dual_scatter_hot":
        [_P] * 12 + [_I] * 7 + [_F, _F, _I, _P, _P, _I, _P],
    "dso_bucketed_block_step_shared":
        [_P] * 15 + [_I] * 9 + [_F] * 5 + [_I, _I, _P],
    "dso_bucketed_block_step_hot":
        [_P] * 15 + [_I] * 9 + [_F] * 5 + [_I, _I, _P, _P, _I, _P],
    "dso_bucketed_hot_slots":
        [_I, ctypes.POINTER(_I), ctypes.POINTER(_I)],
    "dso_primal_update":
        [_P] * 6 + [_I] * 4 + [_F] * 5 + [_I, _P],
    "dso_sparse_probe":
        [_P] * 3 + [_I] * 2 + [_P],
    # csrc/dso_update.cu
    "dso_dense_dual_scatter":
        [_P, _L, _L] + [_P] * 8 + [_I] * 5 + [_F, _F, _I, _P],
    # csrc/dso_twopass.cu
    "dso_twopass_route":
        [_P, _L, _I],
    "dso_twopass_primal":
        [_P, _L, _I, _I] + [_P] * 4,
    "dso_twopass_dual":
        [_P, _L, _I, _I] + [_P] * 7 + [_F, _F, _I, _P],
    # csrc/swa_attention.cu
    "swa_attention_fwd":
        [_P] * 5 + [_I] * 6 + [_L, _I, _L, _F, _P, _P],
    "swa_attention_bwd_packed":
        [_P] * 11 + [_I] * 6 + [_L, _I, _L, _F, _P],
    # csrc/swa_attention_tc.cu
    "swa_attention_tc_fwd":
        [_P] * 4 + [_I] * 7 + [_L, _I, _L, _F, _P, _P],
    # csrc/swa_attention_tf32x3.cu
    "swa_attention_tf32x3_fwd":
        [_P] * 4 + [_I] * 6 + [_L, _I, _L, _F, _P, _P],
    # csrc/swa_attention_bwd.cu
    "swa_attention_bwd":
        [_P] * 10 + [_I] * 7 + [_L, _I, _L, _F, _I, _P],
    # csrc/ssd_scan.cu
    "ssd_scan_fwd":
        [_P] * 8 + [_I] * 7 + [_P],
    "ssd_scan_bwd":
        [_P] * 16 + [_I] * 11 + [_P],
    # csrc/ssd_chunk_grad.cu
    "ssd_chunk_grad_smem":
        [_I] * 5,
    # csrc/dso_serial.cu
    "dso_serial_epoch":
        [_P] * 4 + [_I] + [_P] * 7 + [_I, _I, _P, _L, _P] + [_F] * 5
        + [_I] * 7 + [_P],
    "dso_serial_epoch_one_thread":
        [_P] * 4 + [_I] + [_P] * 7 + [_F] * 5 + [_I] * 3 + [_P],
    "dso_serial_smem":
        [_I] * 5 + [ctypes.POINTER(_I)],
    "dso_serial_max_cluster":
        [_I, _I, ctypes.POINTER(_I)],
    "dso_serial_step_latency":
        [_I] + [_F] * 9 + [_I] * 3 + [_P, _P],
    # csrc/baselines.cu
    "sgd_epoch":
        [_P, _L, _P, _P, _I, _I, _P, _P, _I, _I, _F, _F, _I, _I, _I, _I, _I,
         _P],
    "dcd_epoch":
        [_P, _L, _P, _P, _I, _P, _P, _P, _I, _F, _F, _F, _I, _I, _I, _P],
    "sgd_epoch_one_block":
        [_P, _L, _P, _P, _I, _I, _P, _P, _I, _I, _F, _F, _I, _I, _P],
    "dcd_epoch_one_block":
        [_P, _L, _P, _P, _I, _P, _P, _P, _I, _F, _F, _F, _P],
    "baselines_smem":
        [_I, _I, _I, _I, ctypes.POINTER(_I)],
    "baselines_max_cluster":
        [ctypes.POINTER(_I)],
    "baselines_exchange_floor":
        [_I, _I, _I, _P, _P],
}


class Library(NamedTuple):
    """The loaded kernel library and what its build printed."""

    lib: ctypes.CDLL
    path: str
    build_s: float      # seconds nvcc took (0.0 when loaded from build/)
    log: str            # nvcc/ptxas output (-Xptxas -v: registers, smem)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin/nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): the CUDA kernels are built "
                       "from source on first use")


def sources() -> list[Path]:
    """The ``.cu`` files compiled into the library, in name order."""
    return sorted(CSRC.glob("*.cu"))


def _tag() -> str:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cu*")):            # .cu and .cuh
        h.update(f.name.encode() + b"\0" + f.read_bytes())
    return h.hexdigest()[:12]


def _build(out: Path) -> tuple[float, str]:
    nvcc = _nvcc()
    tmp_dir = BUILD_DIR / f"obj_{out.stem}_{os.getpid()}"
    tmp_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    objs, procs = [], []
    for src in sources():
        obj = tmp_dir / (src.stem + ".o")
        objs.append(obj)
        procs.append(subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = [p.communicate()[0] for p in procs]
    log = "".join(logs)
    failed = [str(s.name) for s, p in zip(sources(), procs)
              if p.returncode != 0]
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    link = subprocess.run([nvcc, "-shared", "-o", str(tmp),
                           *map(str, objs)], capture_output=True, text=True)
    log += link.stdout + link.stderr
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{log}")
    os.replace(tmp, out)
    shutil.rmtree(tmp_dir, ignore_errors=True)
    return time.perf_counter() - t0, log


@functools.lru_cache(maxsize=None)
def library() -> Library:
    """Build every ``csrc/*.cu`` into one library in ``build/`` (once per
    set of sources and flags, named by their hash) and load it."""
    out = BUILD_DIR / f"libdso_kernels_{_tag()}.so"
    build_s, log = 0.0, "(loaded from build/)"
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        build_s, log = _build(out)
    lib = ctypes.CDLL(str(out))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return Library(lib, str(out), build_s, log)


def check(name: str, err: int):
    """Raise when an entry point reports a refused launch."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError "
                           f"{err}")


def stream(t: torch.Tensor) -> int:
    """The current CUDA stream of ``t``'s device, as an int for ctypes."""
    return torch.cuda.current_stream(t.device).cuda_stream
