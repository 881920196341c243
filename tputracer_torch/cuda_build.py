"""Build a CUDA source of ``tputracer_torch/csrc`` into a shared library.

Kernels are compiled with ``nvcc`` at first use, never at import, into
``tputracer_torch/csrc/build/`` (listed in ``.gitignore``).  The library
has a plain C interface and is loaded with ctypes; its file name carries
a hash of the source and the flags, so an edited kernel is rebuilt and an
unchanged one is loaded from the cache.

Processes that start together (the ranks of a world sharing one build
directory) build each library once: the first takes a lock beside it and
compiles to a temporary name, then renames the file into place; the
others wait on the lock and load that file.  The lock is an ``flock``,
which the system drops when its holder dies, so a lock file left behind
never blocks a later build.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

from tputracer_torch.trace import span

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = CSRC / "build"

# sm_90a: Hopper.  -fmad=false keeps every multiply and add rounded on its
# own, as the float32 reference computes them; no --use_fast_math, so
# division and sqrt stay IEEE-exact.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

# what the last build of each source printed (ptxas registers, spills);
# empty for a library loaded from the cache.  How long each load took,
# and whether nvcc ran, are the records of ``trace`` span
# ``build.<source>`` (count ``compiled``).
BUILD_LOG: dict[str, str] = {}


def _nvcc():
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return found


def library_path(source: str) -> Path:
    """Where the library of ``csrc/<source>`` is built: its name carries a
    hash of the source and the flags."""
    src = CSRC / source
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{src.stem}-{digest}.so"


def load_library(source: str) -> ctypes.CDLL:
    """Compile ``csrc/<source>`` (if not cached) and load it."""
    with span(f"build.{source}", compiled=0) as rec:
        so = library_path(source)
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            with open(so.with_name(f"{so.name}.lock"), "w") as lock:
                fcntl.flock(lock, fcntl.LOCK_EX)
                if not so.exists():     # else another process built it
                    _build(source, so)
                    rec.add(compiled=1)
        return ctypes.CDLL(str(so))


def _build(source, so):
    """nvcc ``csrc/<source>`` to a temporary name, then rename it to
    ``so``: no process ever loads half a library."""
    src = CSRC / source
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    try:
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
        os.replace(tmp, so)
    finally:
        tmp.unlink(missing_ok=True)
    BUILD_LOG[source] = proc.stderr
