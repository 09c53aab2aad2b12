"""Build and load the port's CUDA kernels, and count their launches.

Each ``procedurevrl_torch/csrc/<name>.cu`` is compiled by ``nvcc`` for
Hopper (``sm_90a``) into its own shared library with a plain C interface,
``build/torch_kernels/<name>-<source hash>.so`` at the repository root,
and loaded with ``ctypes``.  The build happens on first use (or all at once
through :func:`build`, which starts one ``nvcc`` per source in parallel);
a library whose source hash matches is reused.  The host code of the data
pipeline, ``csrc/<name>.cpp``, is built the same way by ``g++`` for the
host CPU (:func:`build_host`).  Nothing here runs at import time, so the
CPU-only tests import every module without a compiler.

The launch counters are the port's only global state: each kernel wrapper
adds one to its kernel's count where it launches it, so a run can show
that the main path went through the kernels.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import platform
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# the JAX package's flags for native/videoproc.cpp, so both libraries round
# alike (procedurevrl_tpu/datasets/videoproc.py:_build)
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_L = ctypes.c_longlong
# C entry points of each source: name -> argtypes (all return the CUDA
# error code of the launch as an int)
ENTRY_POINTS = {
    "spatial_attention": {
        "spatial_attention_fwd": [_P] * 4 + [_I] * 5 + [_F, _P],
        "spatial_attention_fwd_probs": [_P] * 5 + [_I] * 5 + [_F, _P],
        "spatial_attention_bwd": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                  _F, _P],
        "spatial_attention_pipe_depth": [_I, _I, _I],
        "spatial_attention_fwd_pipe": [_P] * 4 + [_I] * 6 + [_F, _P],
        "spatial_attention_bwd_recompute": [_P] * 7 + [_I] * 5 + [_F, _P],
        "spatial_attention_bwd_delta": [_P] * 9 + [_I] * 4 + [_F, _P],
    },
    "temporal_attention": {
        "temporal_attention_fwd": [_P] * 2 + [_I] * 6 + [_F, _P],
        "temporal_attention_bwd": [_P] * 3 + [_I] * 6 + [_F, _P],
        "temporal_attention_v3_fwd": [_P] * 3 + [_I] * 6 + [_F, _P],
        "temporal_attention_v3_bwd": [_P] * 4 + [_I] * 5 + [_F, _P],
    },
    "mvit_attention": {
        "mvit_attention_fwd": [_P] * 8 + [_I] * 10 + [_F, _P],
        "mvit_attention_kt_fwd": [_P] * 8 + [_I] * 9 + [_F, _P],
        "mvit_attention_fwd_probs": [_P] * 9 + [_I] * 10 + [_F, _P],
        "mvit_attention_bwd": [_I] + [_P] * 18 + [_I] * 11 + [_F, _P],
    },
    "flash_attention": {
        "flash_attention_fwd": [_P] * 9 + [_I] * 5 + [_L] * 4 + [_I, _I, _F,
                                                                  _P],
        "flash_attention_bwd": [_P] * 16 + [_I] * 5 + [_L] * 6 + [_I, _I, _F,
                                                                   _P],
    },
    "depthwise_pool": {
        "depthwise_pool3d_fwd": [_P] * 3 + [_I] * 8 + [_L, _L, _I, _I, _P],
        "depthwise_pool3d_dw": [_P] * 4 + [_I] * 7 + [_L, _L, _I, _P],
    },
}

# kernel name -> launches since the last reset_launches()
LAUNCHES: Dict[str, int] = {}


def count_launch(kernel: str) -> None:
    LAUNCHES[kernel] = LAUNCHES.get(kernel, 0) + 1


def reset_launches() -> None:
    LAUNCHES.clear()


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME)")
    return found


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` lives: named by a hash of
    the source, the shared headers and the compiler flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:12]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, dict]:
    """Compile the named sources (default: all) that have no current
    library, one ``nvcc`` process per source, all started together.

    Returns ``{name: {"seconds": wall time or 0.0 if reused,
    "ptxas": the compiler's resource report}}``; raises with the compiler's
    output if any build fails."""
    names = list(ENTRY_POINTS) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    report: Dict[str, dict] = {}
    for name in names:
        target = library_path(name)
        if target.exists():
            report[name] = {"seconds": 0.0, "ptxas": ""}
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, target, time.perf_counter())
    failures = []
    for name, (proc, tmp, target, t0) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"nvcc failed for {name}.cu:\n{log}")
            continue
        os.replace(tmp, target)
        report[name] = {"seconds": time.perf_counter() - t0, "ptxas": log}
    if failures:
        raise RuntimeError("\n".join(failures))
    return report


def _host_cpu() -> bytes:
    """What ``-march=native`` compiles for: the host CPU's model and
    feature flags, so that a library built on another CPU is not reused."""
    try:
        with open("/proc/cpuinfo") as f:
            lines = {line for line in f
                     if line.startswith(("model name", "flags"))}
        return "".join(sorted(lines)).encode()
    except OSError:
        return f"{platform.machine()} {platform.processor()}".encode()


def host_library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cpp`` lives: named by a hash of
    the source, the compiler flags and the host CPU."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(_host_cpu())
    h.update((CSRC / f"{name}.cpp").read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:12]}.so"


def build_host(name: str) -> Path:
    """The library of ``csrc/<name>.cpp``, compiled by ``g++`` if it has no
    current one; raises with the compiler's output if the build fails."""
    target = host_library_path(name)
    if target.exists():
        return target
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError(f"g++ not found: {name}.cpp needs a C++ compiler")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([gxx, *GXX_FLAGS, "-o", str(tmp),
                           str(CSRC / f"{name}.cpp"), "-lpthread"],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for {name}.cpp:\n{proc.stdout}")
    os.replace(tmp, target)
    return target


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu`` (built first if needed),
    with argument and result types declared for its entry points."""
    target = library_path(name)
    if not target.exists():
        build([name])
    lib = ctypes.CDLL(str(target))
    for fn, argtypes in ENTRY_POINTS[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def check(rc: int, kernel: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with error {rc}")
