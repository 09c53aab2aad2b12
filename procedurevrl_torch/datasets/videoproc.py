"""ctypes binding of the native video preprocess, ``csrc/videoproc.cpp``
(counterpart of ``procedurevrl_tpu/datasets/videoproc.py``).

The library is built by ``g++`` with the JAX package's flags on first use
into ``build/torch_kernels/`` (``ops/_build.py:build_host``) and exposes:

- :func:`fused_preprocess`: uint8 ``[T, H, W, 3]`` -> the normalised
  float32 crop in one pass (bilinear resize, crop, flip, normalise),
  threaded over frames;
- :func:`resize_bilinear`: the plain resize (a parity entry).

Unlike the JAX binding, which quietly reports the library unavailable and
lets ``transform.spatial_sampling_fused`` take its numpy chain, a failed
build raises here, naming the compiler's error.  ``PASSES`` counts the
fused passes run, so a run can show that its frames went through the
library.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import List, Optional

import numpy as np

from procedurevrl_torch.ops import _build

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
PASSES = {"fused_preprocess": 0}

_U8P = ctypes.POINTER(ctypes.c_uint8)
_F32P = ctypes.POINTER(ctypes.c_float)
_I = ctypes.c_int


def library_path() -> Path:
    """The library built from ``csrc/videoproc.cpp`` for this host."""
    return _build.host_library_path("videoproc")


def load() -> ctypes.CDLL:
    """The library, built first if needed; raises if it cannot be built."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(_build.build_host("videoproc")))
            lib.vp_fused_preprocess.restype = _I
            lib.vp_fused_preprocess.argtypes = [
                _U8P, _I, _I, _I,       # frames, T, H, W
                _I, _I,                 # new_h, new_w
                _I, _I,                 # crop_y, crop_x
                _I, _I,                 # crop_h, crop_w
                _I,                     # flip
                _F32P, _F32P, _F32P, _I,  # mean, std, out, threads
            ]
            lib.vp_resize_bilinear.restype = _I
            lib.vp_resize_bilinear.argtypes = [_U8P, _I, _I, _I, _I, _I,
                                               _F32P, _I]
            _LIB = lib
        return _LIB


def fused_preprocess(frames: np.ndarray, new_h: int, new_w: int, crop_y: int,
                     crop_x: int, crop_size: int, flip: bool,
                     mean: List[float], std: List[float],
                     n_threads: int = 4) -> np.ndarray:
    """uint8 ``[T, H, W, 3]`` -> float32 ``[T, crop, crop, 3]``: resized to
    ``new_h x new_w``, cropped at (``crop_y``, ``crop_x``), flipped if
    asked, ``(x / 255 - mean) / std``."""
    lib = load()
    frames = np.ascontiguousarray(frames, dtype=np.uint8)
    t, h, w, c = frames.shape
    if c != 3:
        raise ValueError(f"fused_preprocess: {c} channels, expected 3")
    out = np.empty((t, crop_size, crop_size, 3), np.float32)
    mean_a = np.asarray(mean, np.float32)
    std_a = np.asarray(std, np.float32)
    rc = lib.vp_fused_preprocess(
        frames.ctypes.data_as(_U8P), t, h, w, new_h, new_w, crop_y, crop_x,
        crop_size, crop_size, int(flip), mean_a.ctypes.data_as(_F32P),
        std_a.ctypes.data_as(_F32P), out.ctypes.data_as(_F32P), n_threads)
    if rc != 0:
        raise RuntimeError(f"vp_fused_preprocess failed: {rc}")
    with _LOCK:
        PASSES["fused_preprocess"] += 1
    return out


def resize_bilinear(frames: np.ndarray, new_h: int, new_w: int,
                    n_threads: int = 4) -> np.ndarray:
    """uint8 ``[T, H, W, 3]`` -> float32 ``[T, new_h, new_w, 3]`` in [0, 255]."""
    lib = load()
    frames = np.ascontiguousarray(frames, dtype=np.uint8)
    t, h, w, _ = frames.shape
    out = np.empty((t, new_h, new_w, 3), np.float32)
    rc = lib.vp_resize_bilinear(frames.ctypes.data_as(_U8P), t, h, w, new_h,
                                new_w, out.ctypes.data_as(_F32P), n_threads)
    if rc != 0:
        raise RuntimeError(f"vp_resize_bilinear failed: {rc}")
    return out
