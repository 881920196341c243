"""ctypes binding for the native C++ SAH cluster builder.

Port of ``tputracer/accel/native.py``, binding the same source,
``native/bvh_builder.cpp``, which both packages share and neither edits.
It is compiled at first use with ``g++ -O3 -shared -fPIC`` into
``native/build/`` (listed in ``.gitignore``) under a name keyed on a hash
of the source; the JAX binding uses the same name for the same source and
flags, so a library either package built serves both.  This is a host
build step, not a device route: any failure (no compiler, build error,
capacity overflow) falls back to the NumPy builder in accel.bvh.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_SRC = os.path.join(_REPO, "native", "bvh_builder.cpp")
_BUILD = os.path.join(_REPO, "native", "build")

_lib = None
_tried = False


def _load():
    """Compile (if needed) and load the builder library, once per process.
    No -march=native, so a library built on one host runs on another."""
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    try:
        with open(_SRC, "rb") as f:
            h = hashlib.sha256(f.read()).hexdigest()[:16]
        so = os.path.join(_BUILD, f"libtptbvh-{h}.so")
        if not os.path.exists(so):
            os.makedirs(_BUILD, exist_ok=True)
            tmp = so + f".tmp{os.getpid()}"
            subprocess.run(
                ["g++", "-O3", "-shared", "-fPIC", "-o", tmp, _SRC],
                check=True, capture_output=True, timeout=120)
            os.replace(tmp, so)
        lib = ctypes.CDLL(so)
        fn = lib.tpt_build_clusters
        fn.restype = ctypes.c_int
        fn.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
            ctypes.c_float,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.c_int,
        ]
        _lib = lib
    except (OSError, subprocess.SubprocessError, AttributeError):
        _lib = None
    return _lib


def available():
    return _load() is not None


def build_clusters_native(tv, leaf_size=128, eps=1e-5, pad_clusters_to=8):
    """Native SAH build; same contract as accel.bvh.build_clusters.
    Returns None if the native library is unavailable or overflows."""
    lib = _load()
    if lib is None:
        return None
    tv = np.ascontiguousarray(tv, np.float32)
    T = tv.shape[0]
    # SAH leaves hold > leaf_size/8 tris (balance guard in the C++), so
    # 16x the dense cluster count is a safe capacity bound
    cap = max(16, 16 * (-(-T // leaf_size)))
    perm = np.zeros((cap * leaf_size,), np.int32)
    mask = np.zeros((cap * leaf_size,), np.float32)
    cmin = np.zeros((cap, 3), np.float32)
    cmax = np.zeros((cap, 3), np.float32)
    fp = ctypes.POINTER(ctypes.c_float)
    ip = ctypes.POINTER(ctypes.c_int32)
    C = lib.tpt_build_clusters(
        tv.ctypes.data_as(fp), T, leaf_size, ctypes.c_float(eps),
        perm.ctypes.data_as(ip), mask.ctypes.data_as(fp),
        cmin.ctypes.data_as(fp), cmax.ctypes.data_as(fp), cap)
    if C < 0:
        return None
    Cp = C
    if pad_clusters_to:
        Cp = -(-C // pad_clusters_to) * pad_clusters_to
    return (perm[:Cp * leaf_size], mask[:Cp * leaf_size],
            cmin[:Cp].copy(), cmax[:Cp].copy())
