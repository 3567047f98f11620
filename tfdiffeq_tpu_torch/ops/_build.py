"""Build the CUDA kernels of this package with `nvcc` and bind them with
`ctypes`.

The sources under `tfdiffeq_tpu_torch/csrc/` expose plain `extern "C"`
launch functions, so no PyTorch header is compiled: one `nvcc` call builds
them for Hopper (`sm_90a`) into one shared library in
`tfdiffeq_tpu_torch/_build/` (listed in .gitignore), named by a hash of the
sources and flags. The build runs at the first launch, never at import;
later launches in the process, and later processes on the same checkout,
reuse it.

Flags: `--fmad=false` keeps every multiply and add separately rounded, as
PyTorch's eager elementwise ops are, so a float64 kernel solve takes the
same accept/reject decisions as its plain PyTorch version. `-Xptxas -v`
reports each kernel's registers, shared memory and spills; the report is
kept in `build_log()`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

_PKG = pathlib.Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("step_kernel.cu", "solve_kernel.cu")
HEADERS = ("mlp_rk.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v", "-lineinfo")

_lib = None
_log = ""
_seconds = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double

# Argument lists of the launch functions (csrc/*.cu); every pointer and the
# stream are c_void_p, so ctypes never truncates them to 32 bits.
_STEP_ARGS = ([_P] * 10                                    # tensors
              + [_I] * 4 + [_D] * 3                         # B .. atol
              + [_P, _P])                                   # coeffs, stream
_SOLVE_ARGS = ([_P] * 7                                     # tensors
               + [_I, _I, _I, _I]                           # T, B, D, threads
               + [_D] * 8 + [_I, _I]                        # scalars
               + [_I, _P, _I, _I, _I, _I]                   # network
               + [_I, _I, _I, _P, _P, _P, _P, _P]           # tableau
               + [_P])                                      # stream


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
        "PATH): the CUDA kernels of tfdiffeq_tpu_torch are built from "
        "source on the machine with the card")


def source_hash() -> str:
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _build() -> pathlib.Path:
    global _log, _seconds
    so = BUILD_DIR / f"libtfdiffeq_kernels_{source_hash()}.so"
    if so.exists():
        _seconds = 0.0
        return so
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp),
           *(str(CSRC / s) for s in SOURCES)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    _seconds = time.perf_counter() - t0
    _log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{_log}")
    os.replace(tmp, so)      # atomic: a concurrent build never sees a stub
    (BUILD_DIR / f"{so.stem}.log").write_text(_log)
    return so


def library() -> ctypes.CDLL:
    """The kernels' shared library, built on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(_build()))
        for name in ("tfd_dopri5_mlp_step_f32", "tfd_dopri5_mlp_step_f64"):
            fn = getattr(lib, name)
            fn.argtypes = _STEP_ARGS
            fn.restype = _I
        for name in ("tfd_mlp_solve_f32", "tfd_mlp_solve_f64"):
            fn = getattr(lib, name)
            fn.argtypes = _SOLVE_ARGS
            fn.restype = _I
        lib.tfd_error_string.argtypes = [_I]
        lib.tfd_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def build_log() -> str:
    """nvcc's output of this process's build (the `-Xptxas -v` report), or
    the log saved beside a library an earlier process built."""
    if _log:
        return _log
    saved = BUILD_DIR / f"libtfdiffeq_kernels_{source_hash()}.log"
    return saved.read_text() if saved.exists() else ""


def build_seconds():
    """Seconds the nvcc call took in this process (0.0 when the library
    was already built; None before the first use)."""
    return _seconds


def check(err: int, what: str) -> None:
    """Raise if a launch function returned a CUDA error."""
    if err != 0:
        msg = library().tfd_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
