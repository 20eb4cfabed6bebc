"""ctypes binding of the C++ tag36h11 detector (``apriltag/detector.cpp``,
the same source as the JAX package's), built with ``g++`` at first use.

The library builds with the JAX package's flags (``-O2 -shared -fPIC
-std=c++17``) into ``build/mc_nerf_torch/apriltag/<hash>/`` at the
repository root (keyed by the source, the flags and the platform), under a
per-process temporary name published with ``os.replace``, so processes
that build at once each load a whole library.  A failed build raises with
the compiler's output.  Detections come as the reference consumes them
(ref ``data/data_read.py:181-199``): per tag, its id, center and corners
[lt, rt, rb, lb].
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path
from typing import List, NamedTuple, Optional

import numpy as np

from mc_nerf_torch.data.tag36h11 import TAG36H11_CODES
from mc_nerf_torch.ops.cuda._build import BUILD_ROOT

SRC = Path(__file__).resolve().parent / "apriltag" / "detector.cpp"
GXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None   # the loaded library, once built


class TagDetection(NamedTuple):
    tag_id: int
    center: np.ndarray    # [2] (x, y)
    corners: np.ndarray   # [4, 2] lt, rt, rb, lb

    @property
    def keypoints(self) -> np.ndarray:
        """[5, 2]: center + corners, the layout the losses consume."""
        return np.concatenate([self.center[None], self.corners], axis=0)


def lib_path() -> Path:
    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    tag = f"{platform.system()}-{platform.machine()}".lower()
    return BUILD_ROOT / "apriltag" / h.hexdigest()[:16] / f"libmcn_apriltag-{tag}.so"


def build() -> Path:
    """Compile the detector unless its library exists; returns its path."""
    out = lib_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp), str(SRC)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building the tag36h11 detector failed (g++ rc {proc.returncode}):\n"
                           f"{proc.stderr}")
    tmp.replace(out)      # atomic: a concurrent build publishes a whole file too
    return out


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.mcn_detect_tags.restype = ctypes.c_int
            lib.mcn_detect_tags.argtypes = [
                ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.c_uint64), ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.c_float), ctypes.c_int,
            ]
            _lib = lib
        return _lib


def detector_available() -> bool:
    """Whether the detector builds and loads here."""
    try:
        _load()
        return True
    except (OSError, RuntimeError):
        return False


def detect_tags(gray: np.ndarray, max_hamming: int = 1,
                max_detections: int = 32) -> List[TagDetection]:
    """tag36h11 markers in a [H, W] uint8 grayscale image (``rgb_to_gray``
    for colour), corners [lt, rt, rb, lb] in the tag's canonical frame."""
    lib = _load()
    gray = np.ascontiguousarray(gray, dtype=np.uint8)
    if gray.ndim != 2:
        raise ValueError(f"expected a grayscale [H, W] image, got shape {gray.shape}")
    h, w = gray.shape
    codes = np.asarray(TAG36H11_CODES, dtype=np.uint64)
    out = np.zeros((max_detections, 11), dtype=np.float32)
    n = lib.mcn_detect_tags(
        gray.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), h, w,
        codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)), len(codes), max_hamming,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), max_detections,
    )
    return [TagDetection(int(row[0]), row[1:3].copy(), row[3:11].reshape(4, 2).copy())
            for row in out[:n]]


def rgb_to_gray(img: np.ndarray) -> np.ndarray:
    """[H, W, 3] uint8 or float in [0, 1] -> [H, W] uint8 (ITU-R 601 luma)."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = np.clip(img * 255.0 + 0.5, 0, 255).astype(np.uint8)
    g = 0.299 * img[..., 0] + 0.587 * img[..., 1] + 0.114 * img[..., 2]
    return np.clip(g + 0.5, 0, 255).astype(np.uint8)
