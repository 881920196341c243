"""tputracer_torch.cuda_build on the CPU, with a fake compiler in nvcc's
place: builders that start together compile a library once, to a
temporary name renamed into place, and all load that one file; each load
is a ``build.<source>`` span that says whether nvcc ran; a declared
library's launch counts its kernels when its entry returns no error, and
raises with the library's error string, counting nothing, when it does.
"""

import collections
import contextlib
import ctypes
import os
import stat
import threading

import pytest

from tputracer_torch import cuda_build

FAKE_NVCC = """#!/bin/sh
# nvcc's arguments; builds an empty C library at -o, slowly, and counts
# its runs
out=""
while [ $# -gt 0 ]; do
  if [ "$1" = "-o" ]; then out="$2"; shift; fi
  shift
done
echo run >> "{count}"
sleep 0.3
cat > "$out.c" <<'SRC'
int tpt_fake(void) {{ return 7; }}
int tpt_fake_ok(int n, void* stream) {{ return 0; }}
int tpt_fake_fail(int n, void* stream) {{ return 3; }}
const char* tpt_fake_error_string(int err) {{ return "fake failure"; }}
SRC
cc -shared -fPIC -x c -o "$out" "$out.c" && rm -f "$out.c"
"""


@pytest.fixture
def fake_build(tmp_path, monkeypatch):
    """cuda_build pointed at a source and a build directory under
    tmp_path, with the fake compiler as nvcc; returns the count file."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "fake.cu").write_text("// a source\n")
    count = tmp_path / "runs"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(count=count))
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setattr(cuda_build, "CSRC", csrc)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", csrc / "build")
    monkeypatch.setattr(cuda_build, "_nvcc", lambda: str(nvcc))
    return count


def test_builders_together_compile_once_and_rename(fake_build):
    """Four builders at once: the compiler runs once, the library sits at
    its hashed name, no temporary file is left, and every builder loads a
    working library."""
    libs, errors = [], []

    def build():
        try:
            libs.append(cuda_build.load_library("fake.cu"))
        except Exception as e:   # reported below, in the test's thread
            errors.append(e)

    threads = [threading.Thread(target=build) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    assert fake_build.read_text().splitlines() == ["run"]
    so = cuda_build.library_path("fake.cu")
    assert so.exists()
    assert not [p for p in os.listdir(so.parent) if p.endswith(".tmp")]
    for lib in libs:
        lib.tpt_fake.restype = ctypes.c_int
        assert lib.tpt_fake() == 7
    # a later builder loads the cached file without compiling
    cuda_build.load_library("fake.cu")
    assert fake_build.read_text().splitlines() == ["run"]


def test_failed_build_leaves_no_library(fake_build, monkeypatch):
    """A compiler that fails raises with its message and leaves neither
    the library nor a temporary file behind."""
    bad = fake_build.parent / "bad_nvcc"
    bad.write_text("#!/bin/sh\necho broken >&2\nexit 1\n")
    bad.chmod(bad.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setattr(cuda_build, "_nvcc", lambda: str(bad))
    with pytest.raises(RuntimeError, match="broken"):
        cuda_build.load_library("fake.cu")
    so = cuda_build.library_path("fake.cu")
    assert not so.exists()
    assert not [p for p in os.listdir(so.parent) if p.endswith(".tmp")]


def test_each_load_is_a_build_span_that_counts_a_compile(fake_build):
    """Each load_library is a ``build.<source>`` span: ``compiled`` 1 when
    nvcc ran, 0 when the library came from the cache; the compile's time
    lies inside the first."""
    from tputracer_torch import trace

    trace.reset()
    cuda_build.load_library("fake.cu")
    cuda_build.load_library("fake.cu")
    first, second = trace.records("build.fake.cu")
    assert first.counts == {"compiled": 1} and first.parent == 0
    assert second.counts == {"compiled": 0}
    assert first.ms >= 300      # the fake compiler sleeps 0.3 s
    assert not hasattr(cuda_build, "BUILD_SECONDS")
    trace.reset()


@pytest.fixture
def fake_library(fake_build, monkeypatch):
    """The fake library declared as a Library (in a registry and launch
    counts of the test's own), its stream lookup stubbed."""
    @contextlib.contextmanager
    def no_stream(device):
        yield None

    monkeypatch.setattr(cuda_build, "LIBRARIES", {})
    monkeypatch.setattr(cuda_build, "LAUNCHES", collections.Counter())
    monkeypatch.setattr(cuda_build, "_on_stream", no_stream)
    return cuda_build.Library("fake.cu", "tpt_fake_error_string", {
        "tpt_fake_ok": ([ctypes.c_int], ["fake_a_kernel", "fake_b_kernel"]),
        "tpt_fake_fail": ([ctypes.c_int], ["fake_c_kernel"])})


def test_a_launch_counts_each_declared_kernel(fake_library):
    """A call whose entry returns 0 adds each kernel it declares once."""
    fake_library.launch("tpt_fake_ok", "cpu", 5)
    assert cuda_build.LAUNCHES == {"fake_a_kernel": 1, "fake_b_kernel": 1}
    fake_library.launch("tpt_fake_ok", "cpu", 5)
    assert cuda_build.LAUNCHES == {"fake_a_kernel": 2, "fake_b_kernel": 2}
    assert cuda_build.LIBRARIES == {"fake.cu": fake_library}


def test_a_failed_launch_raises_and_counts_nothing(fake_library):
    """A call whose entry returns an error raises RuntimeError with the
    library's error string, the code and the entry's name, and adds no
    launch."""
    with pytest.raises(RuntimeError, match=r"tpt_fake_fail launch failed: "
                                           r"fake failure \(3\)"):
        fake_library.launch("tpt_fake_fail", "cpu", 5)
    assert cuda_build.LAUNCHES == {}
