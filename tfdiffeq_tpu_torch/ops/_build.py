"""Build the CUDA kernels of this package with `nvcc` and bind them with
`ctypes`.

The sources under `tfdiffeq_tpu_torch/csrc/` expose plain `extern "C"`
launch functions, so no PyTorch header is compiled: one `nvcc` process per
source, all started together, compiles them for Hopper (`sm_90a`), and one
more links the objects into one shared library in
`tfdiffeq_tpu_torch/_build/` (listed in .gitignore), named by a hash of the
sources and flags. The build runs at the first launch, never at import;
later launches in the process, and later processes on the same checkout,
reuse it.

Flags: `--fmad=false` keeps every multiply and add separately rounded, as
PyTorch's eager elementwise ops are, so a float64 kernel solve takes the
same accept/reject decisions as its plain PyTorch version. `-Xptxas -v`
reports each kernel's registers, shared memory and spills; the report is
kept in `build_log()`.

K14's and K15's plan libraries (`plan_libraries`): one generated source
per plan structure and host kernel (ops/plan_codegen.py: K2, K8, K5, K10,
K11, K12 with its two plans, and the adjoint hosts K3, K6, K9), compiled
with the same flags by one `nvcc -shared` each, all started together, into
`libtfd_plan_<hash>_<host>.so` in the same directory, named by a hash of
the generated source, the headers and the flags. An in-process cache keyed
by that hash makes a repeated structure build nothing; `plan_builds` counts
the nvcc processes and `plan_build_seconds` their wall time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

_PKG = pathlib.Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("step_kernel.cu", "solve_kernel.cu", "adjoint_kernel.cu",
           "fixed_kernel.cu", "fixed_adjoint_kernel.cu",
           "conv_solve_kernel.cu", "perlane_solve_kernel.cu",
           "perlane_adjoint_kernel.cu", "tier_net_kernel.cu",
           "adams_kernel.cu", "vcabm_kernel.cu")
HEADERS = ("grid_meet.cuh", "lane_group.h", "mlp_rk.cuh", "mlp_group_aug.cuh",
           "dot_tiers.cuh",
           "cnf_net.cuh", "rk_solve.cuh", "rk_fixed.cuh", "rk_perlane.cuh",
           "rk_adjoint.cuh", "rk_adams.cuh", "rk_vcabm.cuh")
#: The headers a plan library compiles against.
PLAN_HEADERS = ("grid_meet.cuh", "lane_group.h", "mlp_rk.cuh",
                "dot_tiers.cuh", "rk_solve.cuh", "rk_fixed.cuh",
                "rk_perlane.cuh", "rk_adjoint.cuh", "rk_adams.cuh",
                "rk_vcabm.cuh", "rk_hyper.cuh", "plan_ops.cuh",
                "plan_rhs.cuh", "plan_aug.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v", "-lineinfo")
LINK_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-shared")

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
_L = ctypes.c_long
_SOLVE_ARGS = ([_P] * 7                                     # tensors
               + [_I, _I, _I, _I]                           # T, B, D, threads
               + [_D] * 8 + [_I, _I]                        # scalars
               + [_I, _P, _I, _I, _I, _I]                   # network
               + [_I, _I, _I, _P, _P, _P, _P, _P]           # tableau
               + [_I, _P, _P, _L]                           # route, tiers
               + [_I]                                       # rhs = cnf
               + [_P, _L, _I]                               # grid
               + [_P]                                       # layout
               + [_P])                                      # stream
_ADJOINT_ARGS = ([_P] * 9                                   # tensors
                 + [_L]                                     # work size
                 + [_I, _I, _I, _I]                         # T, B, D, threads
                 + [_D] * 8 + [_I, _I]                      # scalars
                 + [_I, _P, _I, _I, _I, _I]                 # network
                 + [_I, _I, _P, _P, _P, _P]                 # tableau
                 + [_I, _P, _L]                             # route, pwork
                 + [_I]                                     # rhs = cnf
                 + [_P, _L, _I]                             # grid
                 + [_P]                                     # layout
                 + [_P])                                    # stream
_SOLVE_FIXED_ARGS = ([_P] * 8                               # tensors
                     + [_L]                                 # work size
                     + [_I] * 6                             # G .. group
                     + [_D, _I]                             # sign, valid
                     + [_I, _P, _I, _I, _I, _I]             # network
                     + [_I, _P, _P, _P]                     # tableau
                     + [_I, _P, _P, _L]                     # route, tiers
                     + [_P])                                # stream
_ADJOINT_FIXED_ARGS = ([_P] * 9                             # tensors
                       + [_L]                               # work size
                       + [_I] * 5                           # T .. n_sub
                       + [_D]                               # sign
                       + [_I, _P, _I, _I, _I, _I]           # network
                       + [_I, _P, _P, _P]                   # tableau
                       + [_I]                               # route
                       + [_P])                              # stream
_CONV_SOLVE_ARGS = ([_P] * 9                                # tensors
                    + [_L, _P]                              # grid, table
                    + [_I] * 12                             # n_cta .. z_smem
                    + [_D] * 8 + [_I, _I]                   # scalars
                    + [_I, _I, _I, _P, _P, _P, _P, _P]      # tableau
                    + [_P])                                 # stream
_SOLVE_PERLANE_ARGS = ([_P] * 9                             # tensors
                       + [_L]                               # work size
                       + [_I] * 5                           # T .. group
                       + [_D] * 7 + [_I, _I]                # scalars
                       + [_I, _P, _I, _I, _I, _I]           # network
                       + [_I, _I, _I, _P, _P, _P, _P, _P]   # tableau
                       + [_I, _P, _P, _L]                   # route, tiers
                       + [_P])                              # stream
_ADJOINT_PERLANE_ARGS = ([_P] * 12                          # tensors
                         + [_L]                             # work size
                         + [_I] * 4                         # T, B, D, threads
                         + [_D] * 7 + [_I]                  # scalars
                         + [_I, _P, _I, _I, _I, _I]         # network
                         + [_I, _I, _P, _P, _P, _P]         # tableau
                         + [_I]                             # route
                         + [_P])                            # stream
_TIER_NET_ARGS = ([_P] * 3                                  # tensors
                  + [_I, _I]                                # B, D
                  + [_I, _P, _I, _I, _I, _I]                # network
                  + [_D, _P, _P, _L]                        # t, tiers, work
                  + [_I]                                    # mode
                  + [_P])                                   # stream

_SOLVE_ADAMS_ARGS = ([_P] * 8                               # tensors
                     + [_L]                                 # work size
                     + [_I] * 6                             # G .. group
                     + [_D] * 3                             # sign .. atol
                     + [_I] * 4                             # max_order .. nfe
                     + [_P, _P]                             # ab, am
                     + [_I, _P, _I, _I, _I, _I]             # network
                     + [_I]                                 # route
                     + [_P, _L, _I]                         # grid
                     + [_P]                                 # layout
                     + [_P])                                # stream
_SOLVE_VCABM_ARGS = ([_P] * 7                               # tensors
                     + [_I] * 4                             # T, B, D, threads
                     + [_D] * 8                             # scalars
                     + [_I] * 3 + [_P]                      # .. gstar
                     + [_I, _P, _I, _I, _I, _I]             # network
                     + [_I]                                 # route
                     + [_P, _L, _I]                         # grid
                     + [_P])                                # stream

_PLAN_CONSTS = [_P, _I, _P, _I]                            # consts .. smem
#: A tiled plan's workspace (csrc/plan_rhs.cuh PlanTileRhs): null and 0
#: at 'highest'.
_PLAN_TILE = [_P, _L]
_PLAN_ARGS = {
    "solve": ([_P] * 6 + [_I] * 4 + [_D] * 8 + [_I, _I]    # tau .. valid
              + [_I, _I, _I, _P, _P, _P, _P, _P]           # tableau
              + _PLAN_CONSTS + [_P, _L, _I]               # grid
              + [_P, _P, _I] + _PLAN_TILE + [_P]),        # dense, stream
    "fixed": ([_P] * 7 + [_L] + [_I] * 5 + [_D, _I]        # grid .. valid
              + [_I, _P, _P, _P]                           # tableau
              + _PLAN_CONSTS + _PLAN_TILE + [_P]),
    "perlane": ([_P] * 8 + [_L] + [_I] * 4 + [_D] * 7      # tau .. dfactor
                + [_I, _I]                                 # .. valid
                + [_I, _I, _I, _P, _P, _P, _P, _P]         # tableau
                + _PLAN_CONSTS + _PLAN_TILE + [_P]),
    "adams": ([_P] * 7 + [_L] + [_I] * 6 + [_D] * 3      # grid .. atol
              + [_I] * 4 + [_P, _P]                       # max_order .. am
              + _PLAN_CONSTS + [_P, _L, _I, _P, _P]),     # grid .. stream
    "vcabm": ([_P] * 6 + [_I] * 4 + [_D] * 8             # tau .. dfactor
              + [_I] * 3 + [_P]                           # .. gstar
              + _PLAN_CONSTS + [_P, _L, _I]               # grid
              + [_L, _P]),                                # work, stream
    # K12: two plans' constants (csrc/plan_rhs.cuh launch_plan_hyper).
    "hyper": ([_P] * 6 + [_L] + [_I] * 4 + [_D] + [_I] * 2  # .. grid_is_t
              + [_P, _I, _P, _I] * 2 + [_P, _P]),         # .. layout, stream
    # K15's hosts (csrc/plan_aug.cuh).
    "adjoint": ([_P] * 10 + [_I] * 4 + [_D] * 8 + [_I, _I]  # tau .. seminorm
                + [_I, _I, _P, _P, _P, _P]                  # tableau
                + _PLAN_CONSTS + [_I]                       # quad_smem
                + [_P, _L, _I, _P]),                        # grid, stream
    "perlane_adjoint": ([_P] * 12 + [_L]                   # .. work size
                        + [_I] * 4 + [_D] * 7 + [_I]
                        + [_I, _I, _P, _P, _P, _P]          # tableau
                        + _PLAN_CONSTS + [_P]),
    "fixed_adjoint": ([_P] * 9 + [_L]                      # .. work size
                      + [_I] * 5 + [_D]                     # T .. sign
                      + [_I, _P, _P, _P]                    # tableau
                      + _PLAN_CONSTS + [_P]),
}

#: Launch functions -> argument lists, each in float32 and float64.
_ENTRIES = {"tfd_dopri5_mlp_step": _STEP_ARGS, "tfd_mlp_solve": _SOLVE_ARGS,
            "tfd_mlp_adjoint": _ADJOINT_ARGS,
            "tfd_mlp_solve_fixed": _SOLVE_FIXED_ARGS,
            "tfd_mlp_adjoint_fixed": _ADJOINT_FIXED_ARGS,
            "tfd_conv_solve": _CONV_SOLVE_ARGS,
            "tfd_mlp_solve_perlane": _SOLVE_PERLANE_ARGS,
            "tfd_mlp_perlane_adjoint": _ADJOINT_PERLANE_ARGS,
            "tfd_tier_net": _TIER_NET_ARGS,
            "tfd_mlp_solve_adams": _SOLVE_ADAMS_ARGS,
            "tfd_mlp_solve_vcabm": _SOLVE_VCABM_ARGS}


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
    h.update(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    return h.hexdigest()[:16]


def _build() -> pathlib.Path:
    global _log, _seconds
    so = BUILD_DIR / f"libtfdiffeq_kernels_{source_hash()}.so"
    if so.exists():
        _seconds = 0.0
        return so
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{source_hash()}.{os.getpid()}"
    objs = [BUILD_DIR / f"{pathlib.Path(s).stem}.{tag}.o" for s in SOURCES]
    t0 = time.perf_counter()
    # One nvcc per source, all at once; each is waited for and its output
    # kept, whatever the others do.
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(CSRC / s)]
            for s, o in zip(SOURCES, objs)]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    _log = "".join(outs)
    failed = [(c, p.returncode, o) for c, p, o in zip(cmds, procs, outs)
              if p.returncode != 0]
    if not failed:
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *LINK_FLAGS, "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              check=False)
        _log += proc.stdout + proc.stderr
        if proc.returncode != 0:
            failed = [(cmd, proc.returncode, proc.stdout + proc.stderr)]
    for o in objs:
        o.unlink(missing_ok=True)
    _seconds = time.perf_counter() - t0
    if failed:
        cmd, rc, out = failed[0]
        raise RuntimeError(f"nvcc failed ({rc}):\n{' '.join(cmd)}\n{out}")
    os.replace(tmp, so)      # atomic: a concurrent build never sees a stub
    (BUILD_DIR / f"{so.stem}.log").write_text(_log)
    return so


def library() -> ctypes.CDLL:
    """The kernels' shared library, built on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(_build()))
        for entry, args in _ENTRIES.items():
            for suffix in ("_f32", "_f64"):
                fn = getattr(lib, entry + suffix)
                fn.argtypes = args
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


# ---------------------------------------------------------------------------
# K14's plan libraries
# ---------------------------------------------------------------------------

plan_builds = 0
plan_build_seconds = 0.0
#: (source key, host) -> seconds from the start of its batch of builds to
#: the end of its nvcc process.
plan_build_times = {}
_plan_libs = {}
_plan_logs = {}


@functools.lru_cache(maxsize=256)
def plan_key(source: str) -> str:
    """Name of a plan library: a hash of its source, the headers it
    includes and the flags, worked out once a source in a process (every
    plan launch asks for its library by this key)."""
    h = hashlib.sha256(source.encode())
    for name in PLAN_HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _bind_plan(path: pathlib.Path, host: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for suffix in ("_f32", "_f64"):
        fn = getattr(lib, f"tfd_plan_{host}{suffix}")
        fn.argtypes = _PLAN_ARGS[host]
        fn.restype = _I
    lib.tfd_plan_error_string.argtypes = [_I]
    lib.tfd_plan_error_string.restype = ctypes.c_char_p
    return lib


def plan_libraries(sources) -> list:
    """Build (or find) the plan library of each (source, host) pair and
    load it: the missing ones by one `nvcc -shared` each, all started
    together. Returns the ctypes libraries in order. An nvcc failure raises
    RuntimeError with its output."""
    global plan_builds, plan_build_seconds
    keys = [(plan_key(src), host) for src, host in sources]
    todo = {}
    for (key, host), (src, _) in zip(keys, sources):
        so = BUILD_DIR / f"libtfd_plan_{key}_{host}.so"
        if (key, host) not in _plan_libs and not so.exists():
            todo[(key, host)] = (src, so)
    if todo:
        nvcc = _nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        jobs = []
        for (key, host), (src, so) in todo.items():
            stem = BUILD_DIR / f"tfd_plan_{key}_{host}.{os.getpid()}"
            cu, log = stem.with_suffix(".cu"), stem.with_suffix(".out")
            cu.write_text(src)
            tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-shared", "-o",
                   str(tmp), str(cu)]
            with open(log, "w") as fh:
                proc = subprocess.Popen(cmd, stdout=fh,
                                        stderr=subprocess.STDOUT)
            jobs.append(((key, host), cu, log, tmp, so, cmd, proc))
        # Each process's end is recorded as it comes.
        pending = list(jobs)
        while pending:
            for job in list(pending):
                if job[-1].poll() is not None:
                    plan_build_times[job[0]] = time.perf_counter() - t0
                    pending.remove(job)
            time.sleep(0.05)
        failed = []
        for ident, cu, log, tmp, so, cmd, proc in jobs:
            out = log.read_text()
            _plan_logs[ident] = out
            if proc.returncode != 0:
                failed.append((cmd, proc.returncode, out))
            else:
                os.replace(tmp, so)
                so.with_suffix(".log").write_text(out)
            cu.unlink(missing_ok=True)
            log.unlink(missing_ok=True)
        plan_builds += len(jobs)
        plan_build_seconds += time.perf_counter() - t0
        if failed:
            cmd, rc, out = failed[0]
            raise RuntimeError(f"nvcc failed on a plan library ({rc}):\n"
                               f"{' '.join(cmd)}\n{out}")
    libs = []
    for key, host in keys:
        lib = _plan_libs.get((key, host))
        if lib is None:
            so = BUILD_DIR / f"libtfd_plan_{key}_{host}.so"
            lib = _plan_libs[(key, host)] = _bind_plan(so, host)
        libs.append(lib)
    return libs


def plan_build_log(source: str, host: str) -> str:
    """nvcc's output (the `-Xptxas -v` report) of a plan library."""
    key = plan_key(source)
    if (key, host) in _plan_logs:
        return _plan_logs[(key, host)]
    saved = BUILD_DIR / f"libtfd_plan_{key}_{host}.log"
    return saved.read_text() if saved.exists() else ""


def check(err: int, what: str) -> None:
    """Raise if a launch function returned a CUDA error."""
    if err != 0:
        msg = library().tfd_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
