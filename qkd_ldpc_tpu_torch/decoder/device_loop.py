"""The decode loops' control flow on the card: loop bookkeeping as a kernel,
and a decode captured as one CUDA graph whose loops are WHILE nodes.

The JAX package runs a decode as one compiled device program:
``lax.while_loop`` around the iteration (``qkd_ldpc_tpu/decoder/bp.py:454``,
``layered.py:225``), ``lax.cond`` around the compaction's fallback phase
(``bp.py:546``; here a ladder, :func:`run_schedule`), ``fori_loop`` around
the continuation's segment (``sim/continuation.py:235``).  The port's
counterparts:

- :func:`loop_step_plain` — the loop's carry and condition
  (``csrc/loop_step.cuh``): after a pass ``done |= active & ok``, ``it += 1``
  (the layered carry also sets ``iters = it`` where a frame newly converged),
  then ``active = ~done & ~frozen`` and the condition ``it < limit && live >
  floor``, ``live`` the count of active frames (``floor`` 0: JAX's
  ``any(active)``); the ENTRY mode only tests.  On the card the ENTRY test is
  a kernel of its own (:func:`loop_step`, ``csrc/device_loop.cu``); the test
  after a pass is a :class:`LoopTail` handed to the pass's last kernel (the
  check update of a flooding pass, the sweep of a layered one), whose last
  block runs it, so a pass launches no bookkeeping kernel.  The plain
  versions of those kernels run :func:`loop_step_plain` after the plain pass.
- :func:`run_loop` — ``lax.while_loop``.  Eagerly (the CPU, ``backend="xla"``,
  or :func:`eager_loops`) it is a Python ``while`` that fetches the condition
  byte after every pass.  Inside a capture it is a conditional WHILE node:
  the entry kernel sets the node's condition before it and the pass's last
  kernel after every pass, so the card runs the loop with no host round
  trip.  A ``lax.cond`` whose branches are "run this" and "nothing" is an IF
  node whose condition a kernel sets before it.
- :func:`run_schedule` — a decode's loops, for both decode schedules: one
  early-exit loop, or residency compaction: phase A on the full batch, then
  phase B (the lanes left, when they fit ``compact_lanes``, in that many
  lanes to the cap) or, when they overflow it, a ladder of halving widths
  (:func:`ladder`: 512 -> 256 -> 128) whose every rung runs while its live
  lanes would not fit the next.  The JAX package runs the overflow as a
  phase C of the full batch after phase B (``bp.py:546``), a second pass of
  the iterations at full width; the ladder runs each iteration once, at a
  width within a halving of the live lanes.  A schedule's state is a
  :class:`Lanes` that supplies one pass, its compacted twin and the tensors
  a rung moves in and back (``bp._Lanes``, ``layered._SweepLanes``).
- The lane moves (``csrc/device_loop.cu``): :func:`partition` (one block:
  the flags' stable order, the moved count ``k``, the rung's loop state,
  the condition of the IF node around the rung; after phase A also that of
  the IF node around the ladder), then inside the rung's IF node
  :func:`compact_copy`'s gather of the ``k`` unconverged lanes, the rung's
  loop and the scatter back.  A batch whose lanes all converged in phase A
  runs the partition alone, one whose lanes fit ``compact_lanes`` phase B.
  The device counter :data:`COMPACTION_COUNTS` says how often each branch
  engages and how many lane-passes ran after phase A
  (:func:`compaction_counter`).  :func:`batch_last_decode` runs either
  schedule's decode of ``[N, B]`` tensors as a graph or eagerly.
- :class:`Graph` — one program captured on a side stream with
  ``torch.cuda.CUDAGraph`` (``thread_local`` error mode, so shards in other
  threads may synchronise meanwhile): the buffers made between the loops
  (the rungs' lanes, the finalize's ``where``) take their memory from the
  graph's pool; a conditional body allocates nothing and holds only the
  port's kernels, launched through ctypes into buffers made before it.
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
import math
import threading
from typing import NamedTuple

import torch

from qkd_ldpc_tpu_torch import _build
from qkd_ldpc_tpu_torch.spans import span
from qkd_ldpc_tpu_torch.utils import canonical_device

ENTRY, FLOODING, LAYERED = 0, 1, 2
# The names the launch counts use for the entry test's kernel and the lane moves'.
KERNEL_ENTRY = "loop_entry"
KERNEL_PARTITION = "compact_partition"
KERNEL_GATHER = "compact_gather"
KERNEL_SCATTER = "compact_scatter"
# The compaction's device counter, read with the launch counts.  At the
# partition after phase A: batches, those with a lane left (k > 0), the lanes
# k = min(#unconverged, compact_lanes), and batches whose unconverged lanes
# overflowed compact_lanes.  The ladder's: batches that took it (every
# overflow), rung compactions run inside it and the lanes they moved.  Every
# loop after phase A: lane-passes run (a pass adds its width).  Of the
# ladder's lanes, those its narrowest rung moved (they go back as the
# decode's result, a wider rung's as the next rung's state).
COMPACTION_COUNTS = ("compaction_batches", "compaction_engaged", "compaction_lanes",
                     "compaction_overflows", "ladder_batches", "ladder_rungs",
                     "ladder_lanes", "compaction_lane_passes", "ladder_last_lanes")
# Tensors one gather or scatter moves at most (csrc/device_loop.cu).
MAX_COPIES = 6
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

    def __init__(self, done: torch.Tensor, it: torch.Tensor, fill: bool = True):
        B, device = done.shape[0], done.device
        self.done, self.it = done, it
        # fill=False: left unset, for the compaction's partition to write
        ones, zeros = (torch.ones, torch.zeros) if fill else (torch.empty, torch.empty)
        self.ok = ones((B,), dtype=torch.bool, device=device)
        # active and the ticket (on a 16-byte boundary) zeroed by one fill
        b16 = -(-B // 16) * 16
        flags = zeros((b16 + 4,), dtype=torch.uint8, device=device)
        self.active = flags[:B].view(torch.bool)
        self.ticket = flags[b16:].view(torch.int32)
        self.go = zeros((1,), dtype=torch.bool, device=device)


class _LoopStepArgs(ctypes.Structure):
    """``struct LoopStep`` of ``csrc/loop_step.cuh``, field for field."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "done", "active", "frozen", "it", "iters", "passes", "go", "ticket",
        "lane_passes")] + [
        ("handle", ctypes.c_ulonglong), ("limit", ctypes.c_int), ("B", ctypes.c_int),
        ("set_handle", ctypes.c_int), ("floor", ctypes.c_int)]


class LoopTail(NamedTuple):
    """The bookkeeping after a pass (FLOODING or LAYERED), handed to the
    pass's last kernel: its wrapper runs it over the pass's flags, in the
    kernel's last block on the card (the kernel's tail) or as
    :func:`loop_step_plain` after the plain pass.  ``passes`` (the WHILE
    body's counter) and ``handle`` (its condition) inside a capture; the
    loop goes on only while more than ``floor`` frames are active, and
    ``lane_passes`` (an int64 ``[1]`` counter) gains the width a pass."""

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
    floor: int = 0
    lane_passes: torch.Tensor | None = None

    def plain(self, ok: torch.Tensor) -> None:
        """The bookkeeping over ``ok`` in plain PyTorch."""
        loop_step_plain(self.mode, ok, self.done, self.active, self.frozen, self.it,
                        self.iters, self.limit, self.passes, self.go, self.floor,
                        self.lane_passes)

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
        lp = self.lane_passes
        if lp is not None and (lp.numel() != 1 or lp.dtype != torch.int64
                               or lp.device != ok.device):
            raise ValueError("lane_passes must be an int64 counter on the device of ok")

        def ptr(t):
            return None if t is None else t.data_ptr()

        return _LoopStepArgs(ptr(self.done), ptr(self.active), ptr(self.frozen), ptr(self.it),
                             ptr(self.iters), ptr(self.passes), ptr(self.go), ptr(self.ticket),
                             ptr(lp), self.handle or 0, self.limit, B,
                             int(self.handle is not None), self.floor)


def loop_step_plain(mode, ok, done, active, frozen, it, iters, limit, passes=None,
                    go=None, floor=0, lane_passes=None):
    """Plain version of the bookkeeping kernel (same arguments), in place on
    ``done``, ``active``, ``it``, ``iters`` (LAYERED), ``passes``,
    ``lane_passes`` and ``go``."""
    it_new = it + (0 if mode == ENTRY else 1)
    if mode != ENTRY:
        newly = active & ok & ~done
        done |= newly
        if mode == LAYERED:
            iters.copy_(torch.where(newly, it_new, iters))
        it.copy_(it_new)
        if passes is not None:
            passes += 1
        if lane_passes is not None:
            lane_passes += done.shape[0]
    act = ~done if frozen is None else ~done & ~frozen
    active.copy_(act)
    if go is not None:
        go.copy_((it_new < limit) & (act.sum() > floor))


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
                   go=None, handle=None, floor=0):
    """Launch the entry test's kernel on the current stream (``mode`` ENTRY:
    a pass's bookkeeping runs in the pass's last kernel, :class:`LoopTail`);
    ``handle`` (a WHILE node's condition, inside a capture) is set as well
    as ``go``."""
    if mode != ENTRY:
        raise ValueError("a pass's bookkeeping runs in the pass's last kernel (LoopTail)")
    _check_step(mode, ok, done, active, frozen, it, iters, passes, go)
    fn = _build.function(
        "device_loop", "loop_entry",
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
        + [ctypes.c_ulonglong, ctypes.c_int, ctypes.c_void_p],
    )

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(done.device):
        err = fn(ptr(done), ptr(active), ptr(frozen), ptr(it), ptr(go), limit, done.shape[0],
                 floor, 0 if handle is None else handle, int(handle is not None),
                 torch.cuda.current_stream().cuda_stream)
    _build.check_launch(KERNEL_ENTRY, err)


def loop_step(mode, ok, done, active, frozen, it, iters, limit, *, use_kernel,
              passes=None, go=None, handle=None, floor=0):
    """The entry test (the kernel when ``use_kernel``, which raises for a CPU
    tensor), or any mode's plain version."""
    if use_kernel:
        loop_step_cuda(mode, ok, done, active, frozen, it, iters, limit, passes, go, handle,
                       floor)
    else:
        loop_step_plain(mode, ok, done, active, frozen, it, iters, limit, passes, go, floor)


def run_loop(body, state: LoopState, limit: int, mode: int, *, use_kernel: bool,
             frozen=None, iters=None, graph=None, floor=0, lane_passes=None):
    """``lax.while_loop``: while ``state.it < limit`` and more than ``floor``
    frames are active (not done, not frozen; ``floor`` 0: any), run
    ``body(tail)`` — one pass, which writes its convergence flags into
    ``state.ok`` and hands ``tail`` (the bookkeeping of ``mode``, a
    :class:`LoopTail`, which adds the width to ``lane_passes`` where given)
    to its last kernel.

    ``graph`` (a :class:`Graph` being captured) makes it a WHILE node;
    otherwise the loop fetches the condition byte after every pass."""

    def tail(handle=None, passes=None):
        return LoopTail(mode, state.done, state.active, frozen, state.it, iters, limit,
                        state.go, state.ticket, passes, handle, floor, lane_passes)

    def entry(handle=None):
        loop_step(ENTRY, state.ok, state.done, state.active, frozen, state.it, iters, limit,
                  use_kernel=use_kernel, go=state.go, handle=handle, floor=floor)

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
    nothing), ``compacted(n)`` (an instance of the same schedule over ``n``
    lanes, its tensors and loop state unset: ``fill=False``, sharing this
    instance's pass count ``it``), ``gathered()`` (the tensors a rung
    reads, each with its lane axis), ``carried()`` (those a pass changes,
    its counts ``iters`` and flags apart: what a rung hands back for the
    next) and ``returned()`` (those of the decode's result, its counts and
    flags apart), each in the same order on the compacted instance."""

    mode: int
    iters: torch.Tensor

    def __init__(self, done: torch.Tensor, it: torch.Tensor, use_kernel: bool,
                 fill: bool = True):
        self.loop = LoopState(done, it, fill)
        self.use_kernel = use_kernel

    def handed_back(self, narrowest: bool) -> tuple:
        """What a rung hands back into the batch: :meth:`carried` (what the
        next rung reads) or, from the narrowest, :meth:`returned`, each with
        the counts ``iters`` and the flags ``loop.done``."""
        return ((self.returned() if narrowest else self.carried())
                + (self.iters, self.loop.done))

    def lane_bytes(self) -> "LaneBytes":
        """The bytes of one lane that the compaction's copies move, from the
        tensors they copy: :meth:`gathered` into a rung, :meth:`handed_back`
        out of it."""
        B = self.loop.done.shape[0]

        def per_lane(tensors):
            return sum(x.numel() * x.element_size() for x in tensors) // B

        return LaneBytes(per_lane(self.gathered()), per_lane(self.handed_back(False)),
                         per_lane(self.handed_back(True)))

    def run(self, limit: int, graph, floor: int = 0, lane_passes=None) -> None:
        """The early-exit loop (``lax.while_loop``) up to ``limit`` passes in
        all, while more than ``floor`` lanes are active; ``lane_passes``
        gains the width a pass."""
        run_loop(self.pass_, self.loop, limit, self.mode, use_kernel=self.use_kernel,
                 iters=self.iters if self.mode == LAYERED else None, graph=graph,
                 floor=floor, lane_passes=lane_passes)


def lanes_like(x: torch.Tensor, dim: int, n: int) -> torch.Tensor:
    """An unset tensor shaped as ``x`` with ``n`` lanes on axis ``dim``."""
    shape = list(x.shape)
    shape[dim] = n
    return torch.empty(shape, dtype=x.dtype, device=x.device)


def compacting(B: int, opts) -> bool:
    """Whether a decode of ``B`` lanes under ``opts`` runs residency
    compaction: ``0 < compact_lanes < B`` and ``compact_after <
    max_iterations``."""
    return 0 < opts.compact_lanes < B and opts.compact_after < opts.max_iterations


def ladder(B: int, B2: int) -> list[int]:
    """The rungs below a batch of ``B`` lanes, widest first: the width
    halves while its half still exceeds ``B2``, then ``B2`` (512 -> 128:
    ``[256, 128]``)."""
    widths, w = [], B
    while w // 2 > B2:
        w //= 2
        widths.append(w)
    return widths + [B2]


def loops_per_decode(B: int, opts) -> int:
    """Conditional bodies one decode of ``B`` lanes holds: the early-exit
    loop's WHILE node, or under compaction phase A's, the ladder's IF node
    and its full-width loop, and an IF node and a loop for each rung.  A
    program of several decodes (a trial chunk) sizes its graph with the
    sum."""
    return 3 + 2 * len(ladder(B, opts.compact_lanes)) if compacting(B, opts) else 1


def run_schedule(lanes: Lanes, opts, graph) -> None:
    """A decode's loops over ``lanes`` under ``opts`` (``DecodeOptions``):
    one early-exit loop up to ``max_iterations``, or residency compaction
    (:func:`compacting`).  Its phase A runs ``compact_after`` passes on the
    full batch, and a partition reads the lanes left unconverged.

    Where they fit ``compact_lanes`` (B2), phase B, an IF node run only when
    a lane is left, gathers them into B2 lanes, finishes them and scatters
    them back.  Where they overflow B2, the batch descends a ladder of
    halving widths (:func:`ladder`) inside an IF node instead: the full
    batch goes on while its live lanes would not fit half of it (the loop's
    floor); then each rung's partition moves the live lanes into the
    narrowest rung that holds them, and that rung runs while they would not
    fit the next (an IF node around its gather, loop and scatter back into
    the batch); the partition for the narrowest rung, last in the ladder,
    sets phase B's IF node anew, and that rung runs to the cap.  So a
    converged lane gives up its slot within a halving of the batch, where
    phase C used to run the overflow lanes at full width after phase B.
    Every rung shares the batch's pass count, so the rungs run the plain
    loop's passes one after another, and every lane's trajectory is the
    plain loop's, merely re-scheduled.  The graph is a function of the
    shapes alone: the data picks which IF nodes run.  ``lanes.loop.done``
    holds the flags afterwards."""
    B, cap = lanes.loop.done.shape[0], opts.max_iterations
    if not compacting(B, opts):
        lanes.run(cap, graph)
        return
    lanes.run(opts.compact_after, graph)
    dev, kern = lanes.loop.done.device, lanes.use_kernel
    widths = ladder(B, opts.compact_lanes)
    below = widths[1:] + [0]
    lane_passes = compaction_counter(dev).narrow(
        0, COMPACTION_COUNTS.index("compaction_lane_passes"), 1)

    def handle():
        return None if graph is None else graph.handle()

    # every rung's buffers and handles before the first conditional body
    rungs = [(lanes.compacted(w), Selection(B, w, dev, below=f, limit=cap, handle=handle()))
             for w, f in zip(widths, below)]
    over = torch.empty((1,), dtype=torch.bool, device=dev)
    over_handle = handle()

    def rung(i, passes=None):
        part, sel = rungs[i]
        back = list(zip(lanes.handed_back(not below[i]), part.handed_back(not below[i])))
        compact_copy(list(zip(lanes.gathered(), part.gathered())), sel, scatter=False,
                     use_kernel=kern, passes=passes)
        part.run(cap, graph, floor=below[i], lane_passes=lane_passes)
        compact_copy(back, sel, scatter=True, use_kernel=kern)

    def engage(i):
        sel = rungs[i][1]
        if graph is not None:
            graph.conditional(IF, sel.handle, lambda passes: rung(i, passes))
        elif bool(sel.go):  # the eager program's host read, one a rung
            rung(i)

    def descend(passes=None):
        lanes.run(cap, graph, floor=widths[0], lane_passes=lane_passes)
        for i in range(len(widths) - 1):
            partition(lanes, *rungs[i], use_kernel=kern, first=False)
            engage(i)
        partition(lanes, *rungs[-1], use_kernel=kern, first=False, passes=passes)

    partition(lanes, *rungs[-1], use_kernel=kern, over=over, over_handle=over_handle)
    if graph is not None:
        graph.conditional(IF, over_handle, descend)
    elif bool(over):
        descend()
    engage(len(widths) - 1)


class Selection:
    """A rung's choice of lanes over a batch of ``B``: ``idx [W]`` int32
    (the flags' stable order, unconverged lanes first, cut to the rung's
    ``W`` lanes), ``k`` ([1] int32: ``min(#unconverged, W)``), ``go`` ([1]
    bool: the rung runs, when ``0 < #unconverged <= W``, more than
    ``below`` (the next narrower rung's lanes) and the pass count under
    ``limit``), ``handle`` (inside a capture, the condition of the IF node
    around the rung) and ``counts`` (:func:`compaction_counter`).  A
    partition writes ``idx``, ``k`` and ``go``."""

    def __init__(self, B: int, W: int, device, below: int = 0, limit: int = 2 ** 31 - 1,
                 handle=None):
        def empty(n, dtype):
            return torch.empty((n,), dtype=dtype, device=device)

        self.B, self.below, self.limit, self.handle = B, below, limit, handle
        self.idx = empty(W, torch.int32)
        self.k, self.go = empty(1, torch.int32), empty(1, torch.bool)
        self.counts = compaction_counter(device)


_counters: dict = {}
_counters_lock = threading.Lock()


class LaneBytes(NamedTuple):
    """The bytes of one lane that the compaction's copies move
    (:meth:`Lanes.lane_bytes`): into a rung (``compact_gather``), and back
    (``compact_scatter``) from a rung above the narrowest or from the
    narrowest."""

    gathered: int
    carried: int
    returned: int


def compaction_bytes(counts, lane: LaneBytes, compact_lanes: int) -> int:
    """The bytes ``compact_gather`` and ``compact_scatter`` moved, from the
    counter's lane counts (``counts``: :data:`COMPACTION_COUNTS` by name, as
    ``_build.launch_counts()`` gives them) of decodes whose lanes weigh
    ``lane`` and whose narrowest rung holds ``compact_lanes``.  A batch that
    overflowed counted ``compact_lanes`` at the partition after phase A and
    moved none there; every other lane counted there went to phase B."""
    phase_b = counts["compaction_lanes"] - compact_lanes * counts["compaction_overflows"]
    ladder_lanes, last = counts["ladder_lanes"], counts["ladder_last_lanes"]
    return ((phase_b + ladder_lanes) * lane.gathered + (phase_b + last) * lane.returned
            + (ladder_lanes - last) * lane.carried)


def compaction_counter(device) -> torch.Tensor:
    """The device's int64 counter of :data:`COMPACTION_COUNTS`, made at
    first use (before any capture: :class:`Graph` asks for it) and read with
    the launch counts (``_build.launch_counts``, which a reset zeroes).
    Every partition and every loop after phase A on the device adds to it,
    in a graph or eagerly."""
    device = canonical_device(device)
    with _counters_lock:
        counter = _counters.get(device)
        if counter is None:
            counter = torch.zeros((len(COMPACTION_COUNTS),), dtype=torch.int64, device=device)
            for i, name in enumerate(COMPACTION_COUNTS):
                _build.add_device_counter((name,), counter[i])
            _counters[device] = counter
    return counter


class _PartitionArgs(ctypes.Structure):
    """``struct Partition`` of ``csrc/device_loop.cu``, field for field."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "done", "iters", "it", "idx", "k", "go", "part_done", "part_iters", "part_ok",
        "part_active", "part_ticket", "over", "counts", "passes")] + [
        ("handle", ctypes.c_ulonglong), ("over_handle", ctypes.c_ulonglong)] + [
        (name, ctypes.c_int) for name in ("B", "W", "below", "limit", "first", "set_handle")]


def partition_plain(lanes: Lanes, part: Lanes, sel: Selection, first: bool = True,
                    over=None, passes=None) -> None:
    """Plain version of the partition kernel, as the kernel computes it: each
    lane's place in the stable order from the count of unconverged lanes
    before it; the order's first ``W`` lanes into ``sel.idx``, their flags
    and counts into the part's, ``k``, ``go``, the part's loop state, and the
    counter; after phase A (``first``) also ``over``."""
    done, W = lanes.loop.done, sel.idx.shape[0]
    B, device = done.shape[0], done.device
    u = ~done
    before = torch.cumsum(u, 0, dtype=torch.int32) - u.to(torch.int32)
    n = u.sum(dtype=torch.int32)
    pos = torch.where(u, before, n + torch.arange(B, dtype=torch.int32, device=device) - before)
    order = torch.empty((B,), dtype=torch.int32, device=device)
    order[pos.long()] = torch.arange(B, dtype=torch.int32, device=device)
    idx = order[:W]
    k = n.clamp(max=W)
    engage = (n > 0) & (n <= W) & (n > sel.below) & (lanes.loop.it[0] < sel.limit)
    overflow = (n > W) & first
    sel.idx.copy_(idx)
    sel.k.copy_(k.reshape(1))
    sel.go.copy_(engage.reshape(1))
    ploop = part.loop
    ploop.done.copy_(done[idx.long()])
    part.iters.copy_(lanes.iters[idx.long()])
    ploop.ok.fill_(True)
    ploop.active.zero_()
    ploop.ticket.zero_()
    if over is not None:
        over.copy_(overflow.reshape(1))
    if passes is not None:
        passes += 1
    zero = torch.zeros_like(k)
    if first:
        counts = [torch.ones_like(k), (k > 0).to(k.dtype), k, overflow.to(k.dtype),
                  overflow.to(k.dtype), zero, zero, zero, zero]
    else:
        counts = [zero] * 5 + [engage.to(k.dtype), k * engage, zero,
                               k * engage * (sel.below == 0)]
    sel.counts += torch.stack(counts).to(torch.int64)


def partition_cuda(lanes: Lanes, part: Lanes, sel: Selection, first: bool = True, over=None,
                   over_handle=None, passes=None) -> None:
    done, ploop = lanes.loop.done, part.loop
    B, W = done.shape[0], sel.idx.shape[0]
    flags = [(done, B), (ploop.done, W), (ploop.ok, W), (ploop.active, W), (sel.go, 1)] + (
        [] if over is None else [(over, 1)])
    ints = [(lanes.iters, B), (lanes.loop.it, 1), (sel.idx, W), (sel.k, 1),
            (part.iters, W), (ploop.ticket, 1)]
    if any(t.shape != (n,) or t.dtype != torch.bool for t, n in flags) or any(
            t.shape != (n,) or t.dtype != torch.int32 for t, n in ints):
        raise ValueError("partition: bool flags and int32 counts of B, W or 1 lanes")
    tensors = [t for t, _ in flags + ints] + [sel.counts] + ([] if passes is None else [passes])
    if done.device.type != "cuda" or any(
            t.device != done.device or not t.is_contiguous() for t in tensors):
        raise ValueError("partition needs contiguous CUDA tensors on one device")
    if sel.handle is not None and first and over_handle is None:
        raise ValueError("the partition after phase A sets the ladder's IF node too")

    def ptr(t):
        return None if t is None else t.data_ptr()

    args = _PartitionArgs(
        done.data_ptr(), lanes.iters.data_ptr(), lanes.loop.it.data_ptr(), sel.idx.data_ptr(),
        sel.k.data_ptr(), sel.go.data_ptr(), ploop.done.data_ptr(), part.iters.data_ptr(),
        ploop.ok.data_ptr(), ploop.active.data_ptr(), ploop.ticket.data_ptr(), ptr(over),
        sel.counts.data_ptr(), ptr(passes), sel.handle or 0, over_handle or 0, B, W,
        sel.below, sel.limit, int(first), int(sel.handle is not None))
    fn = _build.function("device_loop", KERNEL_PARTITION, [ctypes.c_void_p, ctypes.c_void_p])
    with torch.cuda.device(done.device):
        err = fn(ctypes.byref(args), torch.cuda.current_stream().cuda_stream)
    _build.check_launch(KERNEL_PARTITION, err)


def partition(lanes: Lanes, part: Lanes, sel: Selection, *, use_kernel: bool,
              first: bool = True, over=None, over_handle=None, passes=None) -> None:
    """A rung's choice of lanes: the kernel when ``use_kernel`` (inside a
    capture it sets ``sel.handle``, and after phase A ``over_handle``), else
    the plain version.  ``first``: the partition after phase A, which counts
    the batch and writes ``over`` ([1] bool, or None: the lanes left
    overflow the rung); otherwise it counts a rung it engages.  ``passes``
    (the enclosing body's counter) gains one."""
    if use_kernel:
        partition_cuda(lanes, part, sel, first, over, over_handle, passes)
    else:
        partition_plain(lanes, part, sel, first, over, passes)


def lane_axis(full: torch.Tensor, part: torch.Tensor) -> int:
    """The axis on which ``part`` holds the compacted lanes of ``full``: the
    one whose sizes differ (every other equal)."""
    axes = [d for d, (a, b) in enumerate(zip(full.shape, part.shape)) if a != b]
    if full.ndim != part.ndim or len(axes) != 1 or full.dtype != part.dtype:
        raise ValueError("a phase-B tensor and its compacted twin differ in their lanes alone")
    return axes[0]


def copy_run(full: torch.Tensor, part: torch.Tensor) -> tuple[int, int, int]:
    """A tensor's shape as the copy kernels see it: ``(rows, units, unit)``,
    ``rows`` the size before the lane axis and each lane's run of a row
    ``units`` units of ``unit`` bytes, the widest of 16, 8, 4, 2 and 1 that
    divides the run's bytes and both base addresses.  Batch-last tensors
    have a run of one element; the layered ``[rows, B, z]`` ones a run of
    ``z``."""
    d = lane_axis(full, part)
    rows, run = math.prod(full.shape[:d]), math.prod(full.shape[d + 1:])
    nbytes = run * full.element_size()
    unit = next(u for u in (16, 8, 4, 2, 1)
                if nbytes % u == 0 and full.data_ptr() % u == 0 and part.data_ptr() % u == 0)
    return rows, nbytes // unit, unit


class _CopyRunArgs(ctypes.Structure):
    """``struct CopyRun`` of ``csrc/device_loop.cu``."""

    _fields_ = [("src", ctypes.c_void_p), ("dst", ctypes.c_void_p), ("rows", ctypes.c_int),
                ("units", ctypes.c_int), ("unit", ctypes.c_int)]


class _CopyPlanArgs(ctypes.Structure):
    """``struct CopyPlan`` of ``csrc/device_loop.cu``, field for field."""

    _fields_ = [("run", _CopyRunArgs * MAX_COPIES), ("idx", ctypes.c_void_p),
                ("k", ctypes.c_void_p), ("passes", ctypes.c_void_p), ("n", ctypes.c_int),
                ("B", ctypes.c_int), ("B2", ctypes.c_int)]


def compact_copy_plain(pairs, sel: Selection, scatter: bool, passes=None) -> None:
    """Plain version of the gather (lane ``idx[s]`` of each ``(full, part)``
    pair into slot ``s``, for ``s < k``; the other slots zeroed) or the
    scatter (slot ``s`` back into lane ``idx[s]``, for ``s < k``)."""
    k = int(sel.k)  # the plain version's host read
    lanes = sel.idx[:k].long()
    for full, part in pairs:
        d = lane_axis(full, part)
        if scatter:
            full.index_copy_(d, lanes, part.narrow(d, 0, k))
        else:
            part.zero_()
            part.narrow(d, 0, k).copy_(full.index_select(d, lanes))
    if passes is not None:
        passes += 1


def compact_copy_cuda(pairs, sel: Selection, scatter: bool, passes=None) -> None:
    B, B2 = sel.B, sel.idx.shape[0]
    if not 0 < len(pairs) <= MAX_COPIES:
        raise ValueError(f"one launch moves 1 to {MAX_COPIES} tensors")
    plan = _CopyPlanArgs()
    dev = sel.idx.device
    for i, (full, part) in enumerate(pairs):
        d = lane_axis(full, part)
        if full.shape[d] != B or part.shape[d] != B2:
            raise ValueError(f"a rung's tensors hold {B} and {B2} lanes")
        if dev.type != "cuda" or any(t.device != dev or not t.is_contiguous()
                                     for t in (full, part)):
            raise ValueError("the compaction's copies need contiguous CUDA tensors on one device")
        rows, units, unit = copy_run(full, part)
        if rows * B * units >= 2 ** 31:
            raise ValueError("the compaction's copies take tensors of under 2**31 units")
        src, dst = (part, full) if scatter else (full, part)
        plan.run[i] = _CopyRunArgs(src.data_ptr(), dst.data_ptr(), rows, units, unit)
    if passes is not None and (passes.device != dev or passes.dtype != torch.int64):
        raise ValueError("passes must be an int64 counter on the tensors' device")
    plan.idx, plan.k = sel.idx.data_ptr(), sel.k.data_ptr()
    plan.passes = None if passes is None else passes.data_ptr()
    plan.n, plan.B, plan.B2 = len(pairs), B, B2
    name = KERNEL_SCATTER if scatter else KERNEL_GATHER
    fn = _build.function("device_loop", "compact_copy",
                         [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])
    with torch.cuda.device(dev):
        err = fn(ctypes.byref(plan), int(scatter), torch.cuda.current_stream().cuda_stream)
    _build.check_launch(name, err)


def compact_copy(pairs, sel: Selection, *, scatter: bool, use_kernel: bool,
                 passes=None) -> None:
    """Phase B's gather (``scatter`` False: the full batch's lanes ``idx[:k]``
    into the part's first ``k`` slots) or scatter (back), over ``pairs`` of
    (full batch's tensor, part's tensor) in either layout: the kernel when
    ``use_kernel``, else the plain version.  ``passes`` (the IF body's
    counter) gains one."""
    if use_kernel:
        compact_copy_cuda(pairs, sel, scatter, passes)
    else:
        compact_copy_plain(pairs, sel, scatter, passes)


def _call(fn, *args) -> None:
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"CUDA graph capture failed: error {err}")


class Graph:
    """One program captured as a CUDA graph on ``device``, with its
    conditional nodes (WHILE and IF, nested up to :data:`MAX_DEPTH` deep) and
    the kernel launches it stands for."""

    def __init__(self, device, loops: int):
        self.device = torch.device(device)
        self.graph = torch.cuda.CUDAGraph()
        self.stream = torch.cuda.Stream(self.device)
        # the stream that captures a conditional body at each nesting depth
        self.body_streams = [torch.cuda.Stream(self.device) for _ in range(MAX_DEPTH)]
        self.depth = 0
        # one device counter of passes for each conditional body the program holds
        self.passes = torch.zeros((loops,), dtype=torch.int64, device=self.device)
        compaction_counter(self.device)  # made now: a capture cannot
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


def run_graph(key: tuple, program, inputs: tuple, keep=None, device=None, *, loops: int,
              warmup=None) -> tuple:
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
        B = llr.shape[1]
        return run_graph((kind, code.fingerprint, B, opts), run, (llr, syn), keep=keep,
                         loops=loops_per_decode(B, opts))
    return run(llr.contiguous(), syn.contiguous(), None)
