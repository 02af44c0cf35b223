"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source compiles with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface, loaded with ``ctypes`` (no PyTorch headers, so
a build takes seconds).  The library is named after a hash of its source
and flags, so a stale build is never loaded.  Builds go to
``build/repro_torch/`` at the repository root, at first use.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
# -Xptxas=-v prints each kernel's registers, shared memory and spills
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

P, I, I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
# C entry points of each source: {symbol: argtypes}; every entry returns
# a cudaError_t as an int
ENTRY_POINTS = {
    "gnn_mp": {"gnn_mp_segment_sum": [P, P, P, P, I, I, P],
               "gnn_mp_segment_sum_pair": [P] * 8 + [I, I, P]},
    "wc_oracle": {"wc_oracle_step": [P, P, P, P, P, P, I, I, I, P],
                  "wc_oracle_trips": [P] * 15 + [I] * 12 + [P]},
    "flash_attention": {"flash_attention_fwd":
                        [P, P, P, P, I, I, I, I, I, I, I, P]},
    "flash_attention_sm90": {"flash_attention_wgmma_fwd":
                             [P, P, P, P, I, I, I, I, I, I, P]},
    "mamba2_scan": {"mamba2_scan_fwd":
                    [P] * 9 + [I] * 9 + [I64] * 6 + [P]},
}

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{tag.hexdigest()[:16]}.so"


def _start(name: str):
    """Start nvcc for one source; -> (final path, temp path, process) or
    None when the library is already built."""
    so = library_path(name)
    if so.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
           str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return so, Path(tmp), proc


def _finish(name: str, job) -> str:
    so, tmp, proc = job
    out, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{out}")
    os.replace(tmp, so)              # atomic: a reader never sees half a file
    return out


def build_all(names=tuple(ENTRY_POINTS)) -> dict[str, str]:
    """Build every named source in parallel (one nvcc each, started
    together); -> compiler output per source that was built."""
    jobs = {n: _start(n) for n in names}
    return {n: _finish(n, job) for n, job in jobs.items() if job is not None}


def load(name: str) -> ctypes.CDLL:
    """The kernel library for ``csrc/<name>.cu``, built on first use."""
    lib = _loaded.get(name)
    if lib is None:
        build_all((name,))
        lib = ctypes.CDLL(str(library_path(name)))
        for symbol, argtypes in ENTRY_POINTS[name].items():
            fn = getattr(lib, symbol)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _loaded[name] = lib
    return lib


def check(name: str, rc: int) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {rc}")
