"""Native (C++) host-side preprocessing, bound with ctypes (port of
paddlemix_tpu/native, which builds its library beside its source and falls
back silently where the build fails).

`preprocess.cpp` is built with g++ at first use into `<repo>/build/native/`
(listed in .gitignore), named by a hash of the source and the flags;
importing this module builds nothing. A failed build raises with g++'s
stderr: the port hides no failed build, so a caller that asked for the
native path (PMIX_NATIVE_PREPROCESS=1) gets the error, not the other path.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Sequence, Tuple

import numpy as np

SRC = Path(__file__).resolve().parent / "preprocess.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-O3", "-shared", "-fPIC")  # the JAX package's flags: the same arithmetic
_BUILD_LOCK = threading.Lock()  # a loader's worker threads reach the first call together


def load_library() -> ctypes.CDLL:
    """Build (once per source hash) and load the library; RuntimeError with
    g++'s stderr where g++ is missing or fails."""
    with _BUILD_LOCK:
        return _load()


@functools.lru_cache(maxsize=None)
def _load() -> ctypes.CDLL:
    digest = hashlib.sha1(SRC.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:12]
    out = BUILD_DIR / f"libpmixpre-{digest}.so"
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        try:
            proc = subprocess.run(["g++", *CXX_FLAGS, str(SRC), "-o", str(tmp)],
                                  capture_output=True, text=True, timeout=120)
        except FileNotFoundError as e:
            raise RuntimeError(f"g++ not found: the native preprocess cannot be built ({e})") \
                from e
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed to build {SRC} (exit {proc.returncode}):\n"
                               f"{proc.stderr}")
        os.replace(tmp, out)  # atomic: another worker never loads a partial file
    lib = ctypes.CDLL(str(out))
    f32p, u8p, i64 = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64
    lib.resize_bilinear_normalize_u8.argtypes = [u8p, i64, i64, i64, f32p, i64, i64, f32p, f32p,
                                                 ctypes.c_float]
    lib.center_crop_f32.argtypes = [f32p, i64, i64, i64, f32p, i64, i64]
    lib.extract_patches_f32.argtypes = [f32p, i64, i64, i64, f32p, i64, i64, i64]
    for fn in (lib.resize_bilinear_normalize_u8, lib.center_crop_f32, lib.extract_patches_f32):
        fn.restype = None
    return lib


def _f32(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def resize_normalize(image: np.ndarray, size: Tuple[int, int], mean: Sequence[float],
                     std: Sequence[float], scale: float = 1 / 255.0) -> np.ndarray:
    """uint8 (H, W, C) -> float32 (h, w, C): a bilinear resize to `size`
    (height, width), then (v * scale - mean) / std, in one pass."""
    lib = load_library()
    src = np.ascontiguousarray(image, np.uint8)
    if src.ndim != 3 or len(mean) != src.shape[2] or len(std) != src.shape[2]:
        raise ValueError(f"resize_normalize: an (H, W, C) image and C means and stds, got "
                         f"{src.shape}, {len(mean)}, {len(std)}")
    h, w, c = src.shape
    dh, dw = size
    dst = np.empty((dh, dw, c), np.float32)
    mean_a = np.ascontiguousarray(mean, np.float32)
    std_a = np.ascontiguousarray(std, np.float32)
    lib.resize_bilinear_normalize_u8(src.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), h, w, c,
                                     _f32(dst), dh, dw, _f32(mean_a), _f32(std_a),
                                     ctypes.c_float(scale))
    return dst


def center_crop(image: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """float32 (H, W, C) -> its centred (ch, cw) window; the image must be
    at least as large as the crop (the C code does not pad)."""
    lib = load_library()
    src = np.ascontiguousarray(image, np.float32)
    h, w, c = src.shape
    ch, cw = size
    if ch > h or cw > w:
        raise ValueError(f"center_crop: crop {size} larger than the image {src.shape[:2]}")
    dst = np.empty((ch, cw, c), np.float32)
    lib.center_crop_f32(_f32(src), h, w, c, _f32(dst), ch, cw)
    return dst


def extract_patches(image: np.ndarray, patch_size: int, merge_size: int = 2,
                    temporal_patch_size: int = 2) -> np.ndarray:
    """float32 (H, W, C) -> (patches, C tp ps ps) in merge-grouped order."""
    lib = load_library()
    src = np.ascontiguousarray(image, np.float32)
    h, w, c = src.shape
    gh, gw = h // patch_size, w // patch_size
    dst = np.empty((gh * gw, c * temporal_patch_size * patch_size * patch_size), np.float32)
    lib.extract_patches_f32(_f32(src), h, w, c, _f32(dst), patch_size, merge_size,
                            temporal_patch_size)
    return dst
