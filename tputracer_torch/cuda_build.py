"""The hand-written kernels' one home: build, bind, launch and count.

Each library of ``tputracer_torch/csrc`` is declared once, as a
:class:`Library`, by the module that launches its kernels: its entry
points, their argtypes, the kernels each call launches and its
error-string function.  :meth:`Library.launch` is the only launch: it
passes the device's current stream, raises on an error and counts each
kernel launched in :data:`LAUNCHES`, the counts ``graphs`` checks a
captured graph against.  :func:`check` is the wrappers' argument check,
and :func:`scratch` keeps the kernels' per-stream scratch.

Kernels are compiled with ``nvcc`` at first use, never at import, into
``tputracer_torch/csrc/build/`` (listed in ``.gitignore``).  The library
has a plain C interface and is loaded with ctypes; its file name carries
a hash of the source, its headers and the flags, so an edited kernel is
rebuilt and an unchanged one is loaded from the cache.

Processes that start together (the ranks of a world sharing one build
directory) build each library once: the first takes a lock beside it and
compiles to a temporary name, then renames the file into place; the
others wait on the lock and load that file.  The lock is an ``flock``,
which the system drops when its holder dies, so a lock file left behind
never blocks a later build.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

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
    hash of the source, the headers beside it (``*.cuh``) and the flags."""
    src = CSRC / source
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers
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


# kernel launches since the last reset, by kernel name (the names
# graphs.census reads from a graph's kernel nodes): what each entry point
# declares it launches, added once a call that returned no error
LAUNCHES: collections.Counter = collections.Counter()

# the declared libraries, by source; a library is declared when the module
# that launches its kernels is imported
LIBRARIES: dict = {}

# the kernels' scratch by (device index, stream, name), kept between calls
# and by the CUDA graphs that captured it (scratch_of)
_SCRATCH: dict = {}


class Library:
    """One library of ``csrc/``, declared once by the module that launches
    its kernels and built at its first launch, never at import.

    ``entries`` maps each entry point to its argtypes (the stream, which
    every entry takes last, left out) and the kernels one successful call
    launches, by name; ``errstr`` names the library's error-string
    function; ``uncounted`` names kernels that a call launches a varying
    number of times, which graphs.census counts but :data:`LAUNCHES` does
    not."""

    def __init__(self, source, errstr, entries, uncounted=()):
        self.source, self.errstr, self.entries = source, errstr, entries
        self.uncounted = tuple(uncounted)
        self._lib = None
        LIBRARIES[source] = self

    def kernels(self):
        """Each kernel's name, with whether :data:`LAUNCHES` counts it."""
        counted = dict.fromkeys((k for _, ks in self.entries.values()
                                 for k in ks), True)
        return {**counted, **dict.fromkeys(self.uncounted, False)}

    def load(self):
        """The library, built (first use), loaded and bound."""
        if self._lib is None:
            lib = load_library(self.source)
            for name, (argtypes, _) in self.entries.items():
                fn = getattr(lib, name)
                fn.argtypes = [*argtypes, ctypes.c_void_p]
                fn.restype = ctypes.c_int
            err = getattr(lib, self.errstr)
            err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
            self._lib = lib
        return self._lib

    def limit(self, name):
        """What the library's int function ``name`` returns (a capacity
        of its kernels)."""
        return getattr(self.load(), name)()

    def launch(self, entry, device, *args):
        """Call ``entry`` with ``args`` (a tensor passes its data pointer)
        and the current stream of ``device``.  Raises RuntimeError with
        the library's error string, counting nothing, if it returns an
        error; else adds its kernels to :data:`LAUNCHES`."""
        lib = self.load()
        args = [a.data_ptr() if isinstance(a, torch.Tensor) else a
                for a in args]
        with _on_stream(device) as stream:
            err = getattr(lib, entry)(*args, stream)
        if err != 0:
            raise RuntimeError(f"{entry} launch failed: "
                               f"{getattr(lib, self.errstr)(err).decode()} "
                               f"({err})")
        LAUNCHES.update(self.entries[entry][1])


def kernels():
    """Every declared library's kernels, with whether :data:`LAUNCHES`
    counts each."""
    return {k: c for lib in LIBRARIES.values()
            for k, c in lib.kernels().items()}


@contextlib.contextmanager
def _on_stream(device):
    """``device`` made current, giving its current stream's handle."""
    with torch.cuda.device(device):
        yield torch.cuda.current_stream(device).cuda_stream


def check(who, name, t, dtype, shape, device):
    """Raise ValueError unless ``t`` is a contiguous ``dtype`` tensor of
    ``shape`` on ``device``, as ``who``'s kernels read it; returns its
    data pointer."""
    shape = tuple(shape)
    if (t.device != device or t.dtype != dtype or tuple(t.shape) != shape
            or not t.is_contiguous()):
        raise ValueError(
            f"{who}: want {name} a contiguous {dtype} {shape} tensor on "
            f"{device}, got {t.dtype} {tuple(t.shape)} on {t.device}"
            f"{'' if t.is_contiguous() else ' (not contiguous)'}")
    return t.data_ptr()


def owned(t):
    """``t`` itself where it is contiguous and no view of another tensor,
    else a contiguous copy: a tensor that a kernel may write in place
    without writing through into memory its caller did not hand over."""
    if t._base is not None or not t.is_contiguous():
        return t.clone(memory_format=torch.contiguous_format)
    return t


def scratch(who, name, device, n, dtype, fill=None):
    """The scratch ``name`` of ``device``'s current stream: at least ``n``
    entries of ``dtype``, made (filled with ``fill``, or left
    uninitialized) or grown (to twice its size at least) outside a CUDA
    graph capture only: in one it would live in the graph's pool, so
    there it raises."""
    with torch.cuda.device(device):
        key = (device.index, torch.cuda.current_stream(device).cuda_stream,
               name)
        t = _SCRATCH.get(key)
        if t is None or t.shape[0] < n:
            if torch.cuda.is_current_stream_capturing():
                raise RuntimeError(
                    f"{who}: this stream's {name} must hold {n} before a "
                    f"CUDA graph capture (one call on the capture stream "
                    f"first), or it would live in the graph's pool")
            size = n if t is None else max(n, 2 * t.shape[0])
            t = _SCRATCH[key] = (
                torch.empty(size, dtype=dtype, device=device) if fill is None
                else torch.full((size,), fill, dtype=dtype, device=device))
    return t


def drop_scratch(name, device):
    """Forget the scratch ``name`` of ``device``'s current stream."""
    with torch.cuda.device(device):
        _SCRATCH.pop((device.index,
                      torch.cuda.current_stream(device).cuda_stream, name),
                     None)


def scratch_of(device, stream):
    """All scratch of (``device``, ``stream``), for a graph that captured
    it to keep alive."""
    return [t for (d, s, _), t in _SCRATCH.items()
            if (d, s) == (device.index, stream.cuda_stream)]
