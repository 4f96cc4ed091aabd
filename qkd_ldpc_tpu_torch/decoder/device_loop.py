"""The decode loops' control flow on the card: loop bookkeeping as a kernel,
and a decode captured as one CUDA graph whose loops are WHILE nodes.

The JAX package runs a decode as one compiled device program:
``lax.while_loop`` around the iteration (``qkd_ldpc_tpu/decoder/bp.py:454``,
``layered.py:225``), ``lax.cond`` around the compaction's fallback phase
(``bp.py:546``), ``fori_loop`` around the continuation's segment
(``sim/continuation.py:235``).  The port's counterparts:

- :func:`loop_step_plain` — the loop's carry and condition
  (``csrc/loop_step.cuh``): after a pass ``done |= active & ok``, ``it += 1``
  (the layered carry also sets ``iters = it`` where a frame newly converged),
  then ``active = ~done & ~frozen`` and the condition ``it < limit &&
  any(active)``; the ENTRY mode only tests.  On the card the ENTRY test is a
  kernel of its own (:func:`loop_step`, ``csrc/device_loop.cu``); the test
  after a pass is a :class:`LoopTail` handed to the pass's last kernel (the
  check update of a flooding pass, the sweep of a layered one), whose last
  block runs it, so a pass launches no bookkeeping kernel.  The plain
  versions of those kernels run :func:`loop_step_plain` after the plain pass.
- :func:`run_loop` — ``lax.while_loop``.  Eagerly (the CPU, ``backend="xla"``,
  or :func:`eager_loops`) it is a Python ``while`` that fetches the condition
  byte after every pass.  Inside a capture it is a conditional WHILE node:
  the entry kernel sets the node's condition before it and the pass's last
  kernel after every pass, so the card runs the loop with no host round
  trip.  A ``lax.cond`` whose branches are "run the loop" and "nothing" (phase
  C) is the same node with the cond's predicate as its entry test.
- :func:`run_schedule` — a decode's loops, for both decode schedules: one
  early-exit loop, or the residency-compaction phases A, B and C (three
  WHILE nodes, with torch's ``argsort``, gathers and scatters between them).
  A schedule's state is a :class:`Lanes` that supplies one pass and how its
  state is gathered into the compacted lanes and scattered back
  (``bp._Lanes``, ``layered._SweepLanes``).  :func:`batch_last_decode` runs
  either schedule's decode of ``[N, B]`` tensors as a graph or eagerly.
- :class:`Graph` — one program captured on a side stream with
  ``torch.cuda.CUDAGraph`` (``thread_local`` error mode, so shards in other
  threads may synchronise meanwhile): torch's ops between the loops
  (``argsort``, ``index_select``, ``index_copy_``, ``where``) take their
  memory from the graph's pool; a WHILE body allocates nothing and holds only
  the port's kernels, launched through ctypes into buffers made before it.
  The program runs once eagerly on a side stream before its capture (so the
  kernel libraries are loaded and torch's workspaces exist); that run's
  launches are not counted.  A capture that fails raises: nothing falls back
  to the eager loop.  :meth:`Graph.conditional` adds a WHILE or an IF node
  on a handle that a kernel sets before it; a body may hold such nodes
  itself (the continuation's outer loop holds its refill loop, whose body is
  one IF node for ``regen`` and one for ``refill``: ``sim/continuation.py``).
- :func:`run_graph` — a bounded cache of captured programs per device (a
  decode, or a whole trial chunk of ``sim/runner.py``), one per program key:
  the inputs (tensors on the card, or in pinned host memory) are copied into
  the static inputs without a synchronisation, the graph replayed, and copies
  of its outputs returned (the next replay overwrites the static buffers).
  Host threads that share a card (a mesh's shards) share its graphs: their
  calls are serialised per card, and each call's stream waits for the
  previous call's output copies before it overwrites the inputs.

Launch counts: a capture lists its kernel nodes (``_build.recording``);
every replay counts the outer graph's nodes, and each conditional body's
kernels are counted by the passes one of its kernels adds to a device counter
(read when the counts are read, and folded into the host's counts when the
graph leaves the cache); a body that holds only conditional nodes has no
kernel of its own to count.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import threading
from typing import NamedTuple

import torch

from qkd_ldpc_tpu_torch import _build
from qkd_ldpc_tpu_torch.spans import span
from qkd_ldpc_tpu_torch.utils import canonical_device

ENTRY, FLOODING, LAYERED = 0, 1, 2
# The name the launch counts use for the entry test's kernel.
KERNEL_ENTRY = "loop_entry"
# WHILE nodes one decode holds (phases A, B and C); a program of several
# decodes (a trial chunk) sizes its graph with LOOPS_PER_DECODE each.
LOOPS_PER_DECODE = 3
# Kinds of conditional node, and how deep they nest (the continuation: its
# outer loop, the refill loop inside it, and the two IF nodes inside that).
WHILE, IF = "while", "if"
MAX_DEPTH = 3
# Captured programs kept at once on one device, decodes and trial chunks
# alike (each holds its static state and graph pool: a flagship decode's is
# ~70 MB, and a chunk's pool holds about one batch's working set, its
# batches reusing each other's blocks).
CACHE_SIZE = 8

_eager = threading.local()


@contextlib.contextmanager
def eager_loops():
    """Inside, this thread's decodes run the eager kernel loop (one condition
    fetch a pass) instead of the graph: the version the graph is held
    against."""
    before = getattr(_eager, "on", False)
    _eager.on = True
    try:
        yield
    finally:
        _eager.on = before


def graphs_on(use_kernel: bool, device: torch.device) -> bool:
    """Whether a decode on ``device`` runs as a captured graph: the kernel
    backend on a CUDA device, outside :func:`eager_loops`."""
    return use_kernel and device.type == "cuda" and not getattr(_eager, "on", False)


class LoopState:
    """The per-loop buffers a pass and its bookkeeping share: ``ok`` (the
    pass's convergence flags), ``done``, ``active``, ``it`` ([1] int32,
    passes so far), ``go`` ([1] bool, the eager loop's condition), ``ticket``
    ([1] int32, 0: the blocks of the pass's last kernel count themselves on
    it to elect the one that runs the bookkeeping)."""

    def __init__(self, done: torch.Tensor, it: torch.Tensor):
        B, device = done.shape[0], done.device
        self.done, self.it = done, it
        self.ok = torch.ones((B,), dtype=torch.bool, device=device)
        # active and the ticket (on a 16-byte boundary) zeroed by one fill
        b16 = -(-B // 16) * 16
        zeros = torch.zeros((b16 + 4,), dtype=torch.uint8, device=device)
        self.active = zeros[:B].view(torch.bool)
        self.ticket = zeros[b16:].view(torch.int32)
        self.go = torch.zeros((1,), dtype=torch.bool, device=device)


class _LoopStepArgs(ctypes.Structure):
    """``struct LoopStep`` of ``csrc/loop_step.cuh``, field for field."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "done", "active", "frozen", "it", "iters", "passes", "go", "ticket")] + [
        ("handle", ctypes.c_ulonglong), ("limit", ctypes.c_int), ("B", ctypes.c_int),
        ("set_handle", ctypes.c_int)]


class LoopTail(NamedTuple):
    """The bookkeeping after a pass (FLOODING or LAYERED), handed to the
    pass's last kernel: its wrapper runs it over the pass's flags, in the
    kernel's last block on the card (the kernel's tail) or as
    :func:`loop_step_plain` after the plain pass.  ``passes`` (the WHILE
    body's counter) and ``handle`` (its condition) inside a capture."""

    mode: int
    done: torch.Tensor
    active: torch.Tensor
    frozen: torch.Tensor | None
    it: torch.Tensor
    iters: torch.Tensor | None
    limit: int
    go: torch.Tensor
    ticket: torch.Tensor
    passes: torch.Tensor | None = None
    handle: int | None = None

    def plain(self, ok: torch.Tensor) -> None:
        """The bookkeeping over ``ok`` in plain PyTorch."""
        loop_step_plain(self.mode, ok, self.done, self.active, self.frozen, self.it,
                        self.iters, self.limit, self.passes, self.go)

    def args(self, ok: torch.Tensor) -> _LoopStepArgs:
        """The kernel's argument, after checking that the tail's buffers fit
        the pass's flags ``ok`` (bool ``[B]`` on the card)."""
        B = ok.shape[0]
        _check_step(self.mode, ok, self.done, self.active, self.frozen, self.it, self.iters,
                    self.passes, self.go)
        if self.mode == ENTRY:
            raise ValueError("a pass's tail is the FLOODING or LAYERED bookkeeping")
        if self.ticket.shape != (1,) or self.ticket.dtype != torch.int32 or (
                self.ticket.device != ok.device):
            raise ValueError("ticket must be int32 [1] on the device of ok")

        def ptr(t):
            return None if t is None else t.data_ptr()

        return _LoopStepArgs(ptr(self.done), ptr(self.active), ptr(self.frozen), ptr(self.it),
                             ptr(self.iters), ptr(self.passes), ptr(self.go), ptr(self.ticket),
                             self.handle or 0, self.limit, B, int(self.handle is not None))


def loop_step_plain(mode, ok, done, active, frozen, it, iters, limit, passes=None,
                    go=None):
    """Plain version of the bookkeeping kernel (same arguments), in place on
    ``done``, ``active``, ``it``, ``iters`` (LAYERED), ``passes`` and ``go``."""
    it_new = it + (0 if mode == ENTRY else 1)
    if mode != ENTRY:
        newly = active & ok & ~done
        done |= newly
        if mode == LAYERED:
            iters.copy_(torch.where(newly, it_new, iters))
        it.copy_(it_new)
        if passes is not None:
            passes += 1
    act = ~done if frozen is None else ~done & ~frozen
    active.copy_(act)
    if go is not None:
        go.copy_((it_new < limit) & act.any())


def _check_step(mode, ok, done, active, frozen, it, iters, passes, go):
    B = done.shape[0]
    flags = [ok, done, active] + ([] if frozen is None else [frozen])
    if any(t.shape != (B,) or t.dtype != torch.bool for t in flags):
        raise ValueError("ok, done, active and frozen must be bool [B]")
    if it.shape != (1,) or it.dtype != torch.int32:
        raise ValueError("it must be int32 [1]")
    if mode == LAYERED and (iters is None or iters.shape != (B,)
                            or iters.dtype != torch.int32):
        raise ValueError("the layered step needs int32 iters [B]")
    tensors = flags + [it] + [t for t in (iters, passes, go) if t is not None]
    if any(t.device != done.device or not t.is_contiguous() for t in tensors):
        raise ValueError("inputs must be contiguous and on one device")
    if done.device.type != "cuda":
        raise ValueError("the loop's bookkeeping on the card needs CUDA tensors")


def loop_step_cuda(mode, ok, done, active, frozen, it, iters, limit, passes=None,
                   go=None, handle=None):
    """Launch the entry test's kernel on the current stream (``mode`` ENTRY:
    a pass's bookkeeping runs in the pass's last kernel, :class:`LoopTail`);
    ``handle`` (a WHILE node's condition, inside a capture) is set as well
    as ``go``."""
    if mode != ENTRY:
        raise ValueError("a pass's bookkeeping runs in the pass's last kernel (LoopTail)")
    _check_step(mode, ok, done, active, frozen, it, iters, passes, go)
    fn = _build.function(
        "device_loop", "loop_entry",
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2
        + [ctypes.c_ulonglong, ctypes.c_int, ctypes.c_void_p],
    )

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(done.device):
        err = fn(ptr(done), ptr(active), ptr(frozen), ptr(it), ptr(go), limit, done.shape[0],
                 0 if handle is None else handle, int(handle is not None),
                 torch.cuda.current_stream().cuda_stream)
    _build.check_launch(KERNEL_ENTRY, err)


def loop_step(mode, ok, done, active, frozen, it, iters, limit, *, use_kernel,
              passes=None, go=None, handle=None):
    """The entry test (the kernel when ``use_kernel``, which raises for a CPU
    tensor), or any mode's plain version."""
    if use_kernel:
        loop_step_cuda(mode, ok, done, active, frozen, it, iters, limit, passes, go, handle)
    else:
        loop_step_plain(mode, ok, done, active, frozen, it, iters, limit, passes, go)


def run_loop(body, state: LoopState, limit: int, mode: int, *, use_kernel: bool,
             frozen=None, iters=None, graph=None):
    """``lax.while_loop``: while ``state.it < limit`` and some frame is
    active (not done, not frozen), run ``body(tail)`` — one pass, which
    writes its convergence flags into ``state.ok`` and hands ``tail`` (the
    bookkeeping of ``mode``, a :class:`LoopTail`) to its last kernel.

    ``graph`` (a :class:`Graph` being captured) makes it a WHILE node;
    otherwise the loop fetches the condition byte after every pass."""

    def tail(handle=None, passes=None):
        return LoopTail(mode, state.done, state.active, frozen, state.it, iters, limit,
                        state.go, state.ticket, passes, handle)

    def entry(handle=None):
        loop_step(ENTRY, state.ok, state.done, state.active, frozen, state.it, iters, limit,
                  use_kernel=use_kernel, go=state.go, handle=handle)

    if graph is not None:
        handle = graph.handle()
        entry(handle)
        graph.conditional(WHILE, handle, lambda passes: body(tail(handle, passes)))
        return
    entry()
    while bool(state.go):  # the eager loop's host sync, one a pass
        body(tail())


class Lanes:
    """A batch's decode state on its lanes under one schedule, with the
    loop's flags (:class:`LoopState`).  A schedule's subclass supplies
    ``mode`` (its bookkeeping: FLOODING, or LAYERED, which also carries
    ``iters``), ``pass_(tail)`` (one pass over the active lanes, allocating
    nothing), ``gather(idx, done)`` (its state on the lanes ``idx`` as a new
    instance whose count of passes starts from this one's) and ``scatter(idx,
    part)`` (what phase B moved, back in place)."""

    mode: int
    iters: torch.Tensor

    def __init__(self, done: torch.Tensor, it: torch.Tensor, use_kernel: bool):
        self.loop = LoopState(done, it)
        self.use_kernel = use_kernel

    def run(self, limit: int, graph, frozen=None) -> None:
        """The early-exit loop (``lax.while_loop``) up to ``limit`` passes in
        all; ``frozen`` ([B] bool) marks lanes whose bookkeeping must not
        change (phase C: the compacted lanes)."""
        run_loop(self.pass_, self.loop, limit, self.mode, use_kernel=self.use_kernel,
                 frozen=frozen, iters=self.iters if self.mode == LAYERED else None,
                 graph=graph)


def run_schedule(lanes: Lanes, opts, graph) -> None:
    """A decode's loops over ``lanes`` under ``opts`` (``DecodeOptions``):
    one early-exit loop up to ``max_iterations``, or the residency-compaction
    schedule when ``0 < compact_lanes < B`` and ``compact_after <
    max_iterations``.  Its phase A runs ``compact_after`` passes on the full
    batch; phase B gathers the unconverged minority into ``compact_lanes``
    lanes and finishes only those; phase C (``lax.cond``: a loop whose entry
    test is the overflow predicate) continues any lanes left over from their
    phase-A state, the compacted lanes frozen.  Every lane's trajectory is
    the plain loop's, merely re-scheduled.  ``lanes.loop.done`` holds the
    flags afterwards."""
    B, B2 = lanes.loop.done.shape[0], opts.compact_lanes
    if not (0 < B2 < B and opts.compact_after < opts.max_iterations):
        lanes.run(opts.max_iterations, graph)
        return
    lanes.run(opts.compact_after, graph)
    done_a = lanes.loop.done
    # Unconverged lanes first (the sort is stable: ties keep lane order);
    # when fewer than compact_lanes are unconverged the tail picks
    # already-done lanes, which the loop's masks keep inert.
    idx = torch.argsort(done_a.to(torch.int32), stable=True)[:B2]
    part = lanes.gather(idx, done_a)
    part.run(opts.max_iterations, graph)
    lanes.scatter(idx, part)
    done_a.index_copy_(0, idx, part.loop.done)
    frozen = torch.zeros((B,), dtype=torch.bool, device=done_a.device).index_fill_(0, idx, True)
    lanes.run(opts.max_iterations, graph, frozen=frozen)


def _call(fn, *args) -> None:
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"CUDA graph capture failed: error {err}")


class Graph:
    """One program captured as a CUDA graph on ``device``, with its
    conditional nodes (WHILE and IF, nested up to :data:`MAX_DEPTH` deep) and
    the kernel launches it stands for."""

    def __init__(self, device, loops: int = LOOPS_PER_DECODE):
        self.device = torch.device(device)
        self.graph = torch.cuda.CUDAGraph()
        self.stream = torch.cuda.Stream(self.device)
        # the stream that captures a conditional body at each nesting depth
        self.body_streams = [torch.cuda.Stream(self.device) for _ in range(MAX_DEPTH)]
        self.depth = 0
        # one device counter of passes for each conditional body the program holds
        self.passes = torch.zeros((loops,), dtype=torch.int64, device=self.device)
        self.outer: list[str] = []  # kernel nodes of the outer graph
        self.nodes = 0  # all nodes of the outer graph (torch's ops and conditional nodes too)
        self.bodies: list[list[str]] = []  # kernel nodes of each conditional body
        self.kinds: list[str] = []  # WHILE or IF, for each body
        self.counters: list[torch.Tensor] = []  # each body's passes
        self.outputs = None
        self.keep = None  # what the captured pointers point into
        # Recorded after a call's copies of the outputs: the next call's
        # stream waits for it before it overwrites the static inputs.
        self.free = torch.cuda.Event()

    def capture(self, program, warmup=None):
        """Run ``warmup()`` (default: ``program(None)``) eagerly on the side
        stream with its launches discarded, then capture ``program(self)``;
        its return value becomes :attr:`outputs`."""
        current = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(current)
        with (span("qkd.graph.capture"), torch.cuda.device(self.device),
              torch.cuda.stream(self.stream)):
            with _build.recording():
                (warmup or (lambda: program(None)))()
            with _build.recording() as outer:
                self.graph.capture_begin(capture_error_mode="thread_local")
                try:
                    self.outputs = program(self)
                    count = ctypes.c_ulonglong(0)
                    _call(_build.function("device_loop", "capture_nodes",
                                          [ctypes.c_void_p, ctypes.c_void_p]),
                          self.stream.cuda_stream, ctypes.byref(count))
                    self.nodes = count.value
                finally:
                    self.graph.capture_end()
        current.wait_stream(self.stream)
        self.outer = list(outer)
        self.counters = [self.passes[k] for k in range(len(self.bodies))]
        for names, counter in zip(self.bodies, self.counters):
            _build.add_device_counter(names, counter)
        return self

    def release(self) -> None:
        """Before the graph is dropped: wait for its last replay and fold
        its bodies' passes into the host's launch counts."""
        torch.cuda.synchronize(self.device)
        _build.fold_device_counters(self.counters)

    def handle(self) -> int:
        """A new condition handle, made on the top-level graph (so it serves
        a node at any depth); a kernel sets it before its node tests it."""
        handle = ctypes.c_ulonglong(0)
        _call(_build.function("device_loop", "while_handle",
                              [ctypes.c_void_p, ctypes.c_void_p]),
              self.stream.cuda_stream, ctypes.byref(handle))
        return handle.value

    def conditional(self, kind: str, handle: int, body) -> None:
        """Capture a conditional node of ``kind`` (:data:`WHILE` or
        :data:`IF`) on ``handle`` after the work captured so far on the
        current stream; ``body(passes)`` launches the body on this depth's
        body stream, and one of its kernels adds one to ``passes`` (an int64
        ``[1]`` device counter) every time the body runs.  ``body`` may
        capture conditional nodes itself; a body made of them alone launches
        no kernel of its own and leaves ``passes`` unused."""
        k = len(self.bodies)
        if k == self.passes.shape[0]:
            raise RuntimeError(f"this captured program holds at most {k} conditional bodies")
        if self.depth == MAX_DEPTH:
            raise RuntimeError(f"conditional nodes nest at most {MAX_DEPTH} deep")
        self.bodies.append([])
        self.kinds.append(kind)
        stream = torch.cuda.current_stream(self.device).cuda_stream
        body_stream = self.body_streams[self.depth]
        begin = {WHILE: "while_begin", IF: "if_begin"}[kind]
        _call(_build.function("device_loop", begin,
                              [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_ulonglong]),
              stream, body_stream.cuda_stream, handle)
        self.depth += 1
        try:
            with torch.cuda.stream(body_stream), _build.recording() as names:
                body(self.passes[k:k + 1])
        finally:
            self.depth -= 1
            _call(_build.function("device_loop", "while_end", [ctypes.c_void_p]),
                  body_stream.cuda_stream)
        self.bodies[k] = names

    def replay(self) -> None:
        """Launch the graph on the current stream (no synchronisation)."""
        with span("qkd.graph.replay"):
            self.graph.replay()
        _build.count_replay(self.outer)


class _DeviceCache:
    """One device's captured programs, most recently used last, and the lock
    that serialises the calls of host threads sharing the device."""

    def __init__(self):
        self.lock = threading.Lock()
        self.graphs: collections.OrderedDict = collections.OrderedDict()


_caches: dict = {}
_caches_lock = threading.Lock()


def run_graph(key: tuple, program, inputs: tuple, keep=None, device=None,
              loops: int = LOOPS_PER_DECODE, warmup=None) -> tuple:
    """Run ``program(*static_inputs, graph)`` as a captured graph on
    ``device`` (default: the first input's): captured at the first call for
    ``key`` on this device, replayed after copying ``inputs`` (on the card,
    or on the host: copied from pinned memory) into the static inputs on the
    current stream.
    ``program(..., None)`` must be the same computation run eagerly; the
    capture first runs ``warmup(*static_inputs)`` (default: the program)
    eagerly.  ``loops`` bounds the program's conditional bodies.  Returns
    copies of the outputs."""
    device = canonical_device(device if device is not None else inputs[0].device)
    # a copy from pinned memory queues behind the stream's work, and the
    # host allocator keeps the block until that copy has run
    inputs = tuple(x if x.is_cuda else x.pin_memory() for x in inputs)
    with _caches_lock:
        cache = _caches.setdefault(device, _DeviceCache())
    with cache.lock:
        stream = torch.cuda.current_stream(device)
        g = cache.graphs.get(key)
        if g is None:
            static = tuple(torch.empty(x.shape, dtype=x.dtype, device=device)
                           for x in inputs)
            for dst, src in zip(static, inputs):
                dst.copy_(src, non_blocking=True)
            g = Graph(device, loops).capture(
                lambda graph: program(*static, graph),
                warmup=None if warmup is None else lambda: warmup(*static))
            g.keep = (static, keep)
            cache.graphs[key] = g
            while len(cache.graphs) > CACHE_SIZE:
                cache.graphs.popitem(last=False)[1].release()
        cache.graphs.move_to_end(key)
        stream.wait_event(g.free)  # the previous call's copies of the outputs
        for dst, src in zip(g.keep[0], inputs):
            dst.copy_(src, non_blocking=True)
        g.replay()
        outs = tuple(out.clone() for out in g.outputs)
        g.free.record(stream)
    return outs


def batch_last_decode(kind: str, build, code, llr: torch.Tensor, syndrome: torch.Tensor,
                      opts) -> tuple:
    """The decode by ``build(code, opts, device)`` (``(run, use_kernel,
    keep)``, as ``bp.decode_program``) of ``llr [N, B]`` float32 toward
    ``syndrome [M, B]`` on their device: ``(z [N, B] int8, iters [B] int32,
    ok [B] bool)``.  Where :func:`graphs_on`, one replay of the graph cached
    under ``(kind, code, B, opts)``; otherwise eagerly."""
    run, use_kernel, keep = build(code, opts, llr.device)
    if llr.dtype != torch.float32 or llr.ndim != 2:
        raise ValueError("llr must be float32 [N, B]")
    syn = syndrome.to(torch.int8)
    if graphs_on(use_kernel, llr.device):
        return run_graph((kind, code.fingerprint, llr.shape[1], opts), run, (llr, syn),
                         keep=keep)
    return run(llr.contiguous(), syn.contiguous(), None)
