"""Compiled dispatch: the render entry points as CUDA graphs.

The JAX package jit-compiles its render entry points with the config as a
static argument, so a render is one compiled program that holds every
chunk and every bounce (``tputracer/api.py``).  PyTorch's counterpart is a
CUDA graph: the kernels of one eager call, recorded once for each static
configuration, then launched together from one host call.  The kernels
and their order do not change, so neither do the bits.

:func:`call` runs ``fn(scene, *inputs)`` for a key: its first call
eagerly, its second through a graph captured then, every later one by
replaying that graph:

  * **the key** is the function's name and static arguments (a frozen
    config, a pass's sample count), the scene's Python fields (``n_tris``,
    ``eps``, ``leaf_size``), the shape, dtype and device of every scene and
    camera tensor and of every dynamic input, and the intersection route
    that ``TPUTRACER_PAIRS`` selects (read at each call, as accel does).
    Table values are not in it: a material or light edited in place, or
    replaced by a tensor of the same shape, replays the same graph, as an
    edited pytree leaf reuses JAX's program;
  * **the first call** of a key runs eagerly on the device's capture
    stream.  It is the capture's warm-up: it builds the kernels' sources,
    finds their block counts, sets their shared-memory limits and
    allocates the wrappers' per-stream scratch, outside any capture.  A
    render made once costs what an eager render costs, and keeps no
    memory;
  * **the capture** (the second call) records ``fn`` on a Scene of static
    tensors of the key's layout with ``torch.cuda.graph``, into one pool
    that a device's graphs share (their replays are serialised, below, so
    no two of them run at once).  A failed capture raises, naming the op
    that broke it; nothing falls back to eager on the card;
  * **a replay** copies the caller's tensors into the static ones
    (``copy_``, counted in :data:`COPIES`), so the graph never reads the
    caller's memory, replays, and clones the outputs, so the next replay
    does not overwrite what a caller holds.  The copy and the replay run
    on the capture stream, which waits for the caller's stream and is
    waited for by it: a device's replays run one at a time, in the order
    of their calls, whatever stream each caller has current, so the
    scratch they share (B2's ray counter, the pair test's fold keys) is
    never used by two at once;
  * **launch counts**: ``cuda_build`` counts each launch of a
    hand-written kernel in Python (``cuda_build.LAUNCHES``), which a
    replay does not run.  At the capture the graph's kernel nodes are
    read back through libcuda and counted by kernel (:func:`census`); the
    capture fails unless the counts of the counted kernels are what
    ``cuda_build`` counted while it recorded.  Each replay then adds the
    graph's own counts, and the capture's recording adds none: after a
    call the counts read one render's launches, whether it ran eagerly,
    captured or replayed.

CPU tensors run ``fn`` eagerly (CPU PyTorch has no graphs), and so does a
call with gradients enabled on a scene whose tensors require them (the
gradient entry points are not graphed).

Each call is a ``graphs.call`` span (``tputracer_torch.trace``) holding
the spans of its parts: ``graphs.key``; ``graphs.eager`` (a key's first
call, or with the count ``ungraphed`` a call that is never graphed);
``graphs.capture`` (count ``pool_bytes``) with ``graphs.census`` and
``graphs.instantiate``; and of a replay ``graphs.copy_in`` (counts
``tensors`` and ``bytes``), ``graphs.launch`` (its device times, see
:class:`Graph`, with those of the phases ``fn`` ran while it was
captured and the values it counted) and ``graphs.clone``.  The cache
lives as long as the process, like jit's; :func:`clear` empties it and
frees the graphs' pool.
"""

from __future__ import annotations

import ctypes
import dataclasses
import re

import torch

from tputracer_torch import cuda_build
from tputracer_torch.accel import _use_pairs
from tputracer_torch.scene.types import (CAMERA_FIELDS, TENSOR_FIELDS,
                                         TREE_FIELDS, Camera)
from tputracer_torch.trace import (SETTLERS, capturing, count_values,
                                   counting, phase_ms, span)

# tensors copied into graphs' static inputs since the last reset
COPIES = 0
# graphs captured since the last reset
CAPTURES = 0
# float32 slots of a graph's pinned buffer for its counted values
COUNT_SLOTS = 1024

# key -> its Graph, or None after the key's first (eager) call
_CACHE: dict = {}
# the capture stream and the graphs' memory pool of each device
_STREAMS: dict = {}
_POOLS: dict = {}


def scene_tensors(scene):
    """The scene's tensors in a fixed order: TENSOR_FIELDS, TREE_FIELDS,
    then the camera's CAMERA_FIELDS."""
    return ([getattr(scene, f) for f in TENSOR_FIELDS + TREE_FIELDS]
            + [getattr(scene.camera, f) for f in CAMERA_FIELDS])


def _layout(t):
    return tuple(t.shape), t.dtype, t.device


def graph_key(name, static, scene, inputs=()):
    """The cache key of ``name`` called with static arguments ``static``
    on ``scene`` and dynamic tensors ``inputs``: everything a capture
    depends on, and no tensor's values."""
    return (name, static, scene.n_tris, scene.eps, scene.leaf_size,
            tuple(_layout(t) for t in scene_tensors(scene)),
            tuple(_layout(t) for t in inputs), _use_pairs())


def static_like(scene):
    """A Scene with fresh, uninitialized tensors of ``scene``'s layout."""
    kw = {f: torch.empty_like(getattr(scene, f))
          for f in TENSOR_FIELDS + TREE_FIELDS}
    camera = Camera(*(torch.empty_like(getattr(scene.camera, f))
                      for f in CAMERA_FIELDS))
    return dataclasses.replace(scene, camera=camera, **kw)


def copy_in(static, scene, static_inputs=(), inputs=()):
    """Copy ``scene``'s tensors and ``inputs`` into ``static`` and
    ``static_inputs`` (``copy_``); returns the number of tensors copied."""
    dst = scene_tensors(static) + list(static_inputs)
    src = scene_tensors(scene) + list(inputs)
    with torch.no_grad():
        for d, s in zip(dst, src):
            d.copy_(s)
    return len(dst)


def kernel_of(symbol):
    """The name of the declared kernel (``cuda_build.kernels``) that a
    device function's symbol names (mangled, as libcuda gives it, or
    demangled, as a trace shows it), or None."""
    for k in cuda_build.kernels():
        if f"{len(k)}{k}" in symbol or re.search(rf"(?<!\w){k}(?!\w)",
                                                 symbol):
            return k
    return None


class _KernelNodeParams(ctypes.Structure):   # CUDA_KERNEL_NODE_PARAMS_v2
    _fields_ = [("func", ctypes.c_void_p), ("grid", ctypes.c_uint * 3),
                ("block", ctypes.c_uint * 3), ("shared", ctypes.c_uint),
                ("params", ctypes.c_void_p), ("extra", ctypes.c_void_p),
                ("kern", ctypes.c_void_p), ("ctx", ctypes.c_void_p)]


def _driver(cu, fn, *args):
    err = getattr(cu, fn)(*args)
    if err:
        raise RuntimeError(f"{fn} failed (CUresult {err})")


def census(raw_graph):
    """The nodes of a cudaGraph_t, read with libcuda: a dict with
    ``nodes``, ``kernel_nodes``, ``event_nodes`` (event records) and the
    number of kernel nodes of each declared kernel."""
    cu = ctypes.CDLL("libcuda.so.1")
    graph = ctypes.c_void_p(raw_graph)
    n = ctypes.c_size_t(0)
    _driver(cu, "cuGraphGetNodes", graph, None, ctypes.byref(n))
    nodes = (ctypes.c_void_p * n.value)()
    _driver(cu, "cuGraphGetNodes", graph, nodes, ctypes.byref(n))
    out = dict.fromkeys(cuda_build.kernels(), 0)
    out.update(nodes=n.value, kernel_nodes=0, event_nodes=0)
    kind, params, name = ctypes.c_int(), _KernelNodeParams(), ctypes.c_char_p()
    names = {}   # function handle -> its declared kernel, or None
    for node in nodes:
        node = ctypes.c_void_p(node)
        _driver(cu, "cuGraphNodeGetType", node, ctypes.byref(kind))
        if kind.value == 7:                  # CU_GRAPH_NODE_TYPE_EVENT_RECORD
            out["event_nodes"] += 1
        if kind.value != 0:                  # CU_GRAPH_NODE_TYPE_KERNEL
            continue
        out["kernel_nodes"] += 1
        _driver(cu, "cuGraphKernelNodeGetParams_v2", node,
                ctypes.byref(params))
        handle = params.func or params.kern
        if handle not in names:
            if params.func:
                _driver(cu, "cuFuncGetName", ctypes.byref(name),
                        ctypes.c_void_p(params.func))
            else:
                _driver(cu, "cuKernelGetName", ctypes.byref(name),
                        ctypes.c_void_p(params.kern))
            names[handle] = kernel_of(name.value.decode())
        if names[handle] is not None:
            out[names[handle]] += 1
    return out


def _capture_stream(device):
    s = _STREAMS.get(device.index)
    if s is None:
        s = _STREAMS[device.index] = torch.cuda.Stream(device)
    return s


def _pool(device):
    pool = _POOLS.get(device.index)
    if pool is None:
        with torch.cuda.device(device):
            pool = _POOLS[device.index] = torch.cuda.graph_pool_handle()
    return pool


class Graph:
    """One captured call: its static inputs, the graph, its outputs, its
    kernels (``census``), its name and memory pool's growth (``info``),
    and the events that time its replays on the device.  Made on a key's
    second call, on the capture stream, after the first call's warm-up
    there.

    The graph's first and last nodes record the events ``begin`` and
    ``end`` (external event nodes, not kernels); each replay records
    ``ready`` on the stream just before it.  A replay's ``graphs.launch``
    record gets ``wait_ms`` (ready to begin: the device, done with what
    came before, waiting for the graph's first node) and ``replay_ms``
    (begin to end) once the events have completed: at the next replay,
    when records are read, or at :func:`clear`.  Each
    ``tputracer_torch.trace.phase`` that ``fn`` ran during the capture
    left a pair of event nodes too (``phases``), and the record also gets
    each phase's device ms under its name, summed over its pairs, and
    each ``tputracer_torch.trace.device_count`` of the capture under its
    name (``counts``: copied by the graph into the pinned buffer
    ``host``, read on the host once ``end`` has completed, summed by
    name).  Nothing waits on them; a replay whose events had not
    completed by its graph's next replay gets the count ``untimed``."""

    def __init__(self, name, fn, scene, inputs):
        global CAPTURES
        dev = scene.device
        stream = _capture_stream(dev)
        launches = cuda_build.LAUNCHES
        before = launches.copy()
        try:
            with torch.no_grad(), torch.cuda.device(dev):
                stream.wait_stream(torch.cuda.current_stream(dev))
                with torch.cuda.stream(stream):
                    self.scene = static_like(scene)
                    self.inputs = tuple(torch.empty_like(x) for x in inputs)
                stream.synchronize()
                torch.cuda.empty_cache()
                reserved = torch.cuda.memory_reserved(dev)
                self.ready = torch.cuda.Event(enable_timing=True)
                self.begin, self.end = (
                    torch.cuda.Event(enable_timing=True, external=True)
                    for _ in range(2))
                self.graph = torch.cuda.CUDAGraph(keep_graph=True)
                self.host = torch.empty(COUNT_SLOTS, dtype=torch.float32,
                                        pin_memory=True)
                with capturing() as self.phases, \
                        counting(self.host) as self.counts:
                    self.out = _capture(self.graph, stream, _pool(dev), name,
                                        fn, self.scene, self.inputs,
                                        self.begin, self.end)
                counted = [k for k, c in cuda_build.kernels().items() if c]
                recorded = {k: launches[k] - before[k] for k in counted}
                with span("graphs.census"):
                    self.census = census(self.graph.raw_cuda_graph())
                with span("graphs.instantiate"):
                    self.graph.instantiate()
                    torch.cuda.synchronize(dev)
        finally:
            launches.clear()
            launches.update(before)
        self.launches = {k: self.census[k] for k in counted}
        if self.launches != recorded:
            raise RuntimeError(
                f"CUDA graph of {name}: its kernel nodes {self.launches} "
                f"are not the launches its capture recorded {recorded}")
        self.stream = stream
        # the per-stream scratch the capture baked in (B2's ray counter,
        # the pair test's fold keys) lives as long as the graph
        self.scratch = cuda_build.scratch_of(dev, stream)
        self.info = {"name": name,
                     "pool_bytes": torch.cuda.memory_reserved(dev) - reserved}
        # the bytes a replay copies in: every static input, whole
        self.in_bytes = sum(t.nbytes for t in scene_tensors(self.scene)
                            + list(self.inputs))
        self.timing = None      # the last replay's record, until timed
        self.replays = 0
        CAPTURES += 1

    def __call__(self, scene, inputs):
        global COPIES
        self.settle(final=True)
        caller = torch.cuda.current_stream(scene.device)
        self.stream.wait_stream(caller)
        with torch.cuda.stream(self.stream):
            with span("graphs.copy_in") as rec:
                n = copy_in(self.scene, scene, self.inputs, inputs)
                rec.add(tensors=n, bytes=self.in_bytes)
            COPIES += n
            with span("graphs.launch") as self.timing:
                self.ready.record()
                self.graph.replay()
        caller.wait_stream(self.stream)
        self.replays += 1
        cuda_build.LAUNCHES.update(self.launches)
        with span("graphs.clone"):
            return _clone(self.out)

    def settle(self, final=False):
        """Give the last replay's ``graphs.launch`` record its device
        times if its events have completed; if not, and ``final``, the
        count ``untimed``."""
        rec = self.timing
        if rec is None:
            return
        if self.end.query():
            rec.device = {"wait_ms": self.ready.elapsed_time(self.begin),
                          "replay_ms": self.begin.elapsed_time(self.end),
                          **phase_ms(self.phases),
                          **count_values(self.host.numpy(), self.counts)}
        elif final:
            rec.add(untimed=1)
        else:
            return
        self.timing = None


def _settle_all():
    for g in graphs():
        g.settle()


SETTLERS.append(_settle_all)


def _capture(graph, stream, pool, name, fn, scene, inputs, begin, end):
    """fn(scene, *inputs) captured into ``graph`` on ``stream`` in
    ``pool``, between nodes that record the events ``begin`` and ``end``;
    returns its outputs (the graph's static outputs).  Raises
    RuntimeError naming the first error, the op's own, if the capture
    fails."""
    first = []
    try:
        with torch.cuda.graph(graph, pool=pool, stream=stream):
            try:
                begin.record()
                out = fn(scene, *inputs)
                end.record()
                return out
            except Exception as e:
                first.append(e)
                raise
    except Exception as e:
        cause = first[0] if first else e
        raise RuntimeError(f"CUDA graph capture of {name} failed: "
                           f"{type(cause).__name__}: {cause}") from cause


def _clone(out):
    if isinstance(out, torch.Tensor):
        return out.clone()
    if isinstance(out, dict):
        return {k: _clone(v) for k, v in out.items()}
    if isinstance(out, (tuple, list)):
        return type(out)(_clone(v) for v in out)
    return out


def _record(out, stream):
    """Mark the tensors of ``out``, made on the capture stream, as used on
    the caller's ``stream`` (the allocator then keeps them until it is
    done)."""
    if isinstance(out, torch.Tensor):
        out.record_stream(stream)
    elif isinstance(out, dict):
        for v in out.values():
            _record(v, stream)
    elif isinstance(out, (tuple, list)):
        for v in out:
            _record(v, stream)


def _first_call(fn, scene, inputs):
    """A key's first call: fn eagerly on the capture stream, the warm-up
    of the capture that its second call makes."""
    dev = scene.device
    stream = _capture_stream(dev)
    caller = torch.cuda.current_stream(dev)
    stream.wait_stream(caller)
    with torch.cuda.device(dev), torch.cuda.stream(stream):
        out = fn(scene, *inputs)
    caller.wait_stream(stream)
    _record(out, caller)
    return out


def _wants_grad(scene, inputs):
    return torch.is_grad_enabled() and any(
        t.requires_grad for t in scene_tensors(scene) + list(inputs))


def call(name, fn, scene, static, *inputs):
    """``fn(scene, *inputs)`` for the key ``graph_key(name, static, scene,
    inputs)``: eagerly on its first call, through a CUDA graph captured on
    its second and replayed after; on CPU tensors, or with gradients
    wanted, eagerly always.  ``fn`` must depend on nothing but its
    arguments and ``static``."""
    with span("graphs.call"):
        if scene.device.type != "cuda" or _wants_grad(scene, inputs):
            with span("graphs.eager", ungraphed=1):
                return fn(scene, *inputs)
        with span("graphs.key"):
            key = graph_key(name, static, scene, inputs)
        if key not in _CACHE:
            _CACHE[key] = None
            with span("graphs.eager"):
                return _first_call(fn, scene, inputs)
        graph = _CACHE[key]
        if graph is None:
            with span("graphs.capture") as rec:
                graph = _CACHE[key] = Graph(name, fn, scene, inputs)
                rec.add(pool_bytes=graph.info["pool_bytes"])
        return graph(scene, inputs)


def graphs():
    """The captured graphs, in the order of their keys' first calls."""
    return [g for g in _CACHE.values() if g is not None]


def clear():
    """Drop every captured graph and free their pool (jax.clear_caches()'s
    counterpart)."""
    if _CACHE and torch.cuda.is_available():
        torch.cuda.synchronize()
        _settle_all()
    _CACHE.clear()
    _POOLS.clear()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
