"""Continuation batching: refill converged lanes with fresh trials.

Counterpart of ``qkd_ldpc_tpu/sim/continuation.py``.  Near the decoding
threshold per-frame residency spans ~10-100 iterations, so the plain
batched runner — whose whole batch runs until its LAST frame converges or
hits ``max_iterations`` — wastes most of its lanes on the barrier.  This
runner keeps the batch full instead: the decode runs in segments of
``segment`` iterations; after each segment, lanes whose trial finished
(converged, or hit the iteration cap) bank their statistics and are
refilled with fresh trials, generated on the device from the SAME per-trial
keys the plain runner derives.

**Statistics are bit-identical to the plain runner**:

- a trial's decode trajectory depends only on its own (llr, syndrome) —
  lanes are independent, so lane placement and neighbours cannot change it;
- a refilled lane's first fused update carries a ``fresh`` flag that skips
  the bit-update clip, making it exactly the peeled first check update of
  ``decoder.bp`` (a fresh lane has ``Lr = 0``, so the variable update gives
  it ``total`` = the a-priori LLRs in storage type, and ``total - 0``
  unclipped is the first iteration's input — for sum-product as for
  min-sum).  That first pass completes no iteration: the lane's count
  starts at -1 and its syndrome flag is cleared by the check update;
- per-trial iteration counts are banked when the trial finishes, and all
  reductions (integer sums, min/max) are order-independent.

The JAX runner is one jitted ``while_loop``, and so is the port's: one
program, :class:`_ContinuationProgram`, whose structure is JAX's line by line
and whose carry lives on the device.  On the card under the kernel backend it
is captured once per (code, batch, segment, refill quantum, options, prng,
points) as one CUDA graph (``decoder/device_loop.py``): the outer
``while_loop`` is a WHILE node, the refill ``while_loop`` inside it another,
and ``lax.cond(pos >= S, regen, refill)`` two IF nodes, the refill loop's
whole body; the loop's test runs in the step before it (the start or the
banking before the loop, the regeneration or refill of the last pass), so a
regeneration's test enables the refill in its own pass — JAX's regen pass
and the refill pass after it are one pass here, in JAX's order, and no
kernel tests on its own; the segment's ``fori_loop`` is unrolled
(``segment`` passes of the variable update, which runs the previous
pass's bookkeeping first, and the check update with the ``fresh`` flags;
then the last pass's bookkeeping) and the banking is one kernel.
Every step around the decode is a kernel of ``csrc/continuation.cu``
(``sim/cuda_continuation.py``), and regen's channel is K4, K3, K4's gated tie
row and KT writing into buffers made before the capture.  A call copies one
int32 input vector in (trials, first trial id, the points' keys, error
counts and LLR magnitudes), replays the graph once and copies the ``[7, P]``
statistics and the loops' counters out: no host read in between.  The CPU,
``backend="xla"`` and ``device_loop.eager_loops()`` run the same program
eagerly, the steps' plain versions (or the kernels, launched one by one)
with a Python ``while`` that fetches the loops' verdicts.  A refilled lane
starts with ``Lr = 0`` and ``age = -1``: its first pass only forms its
a-priori totals.

The continuation runner decodes with the flooding schedule only and raises
on ``schedule="layered"``.  Over a trial mesh (``parallel.mesh``) each trial
shard runs its own lane pool over a contiguous range of every point's
global trial ids (shard ``s`` of ``S`` takes ``[s*q + min(s, r), ...)`` with
``q, r = divmod(trials, S)``); the shards' ``[7, P]`` integer statistics
merge on the host by sums, minima and maxima, so the result is again the
plain runner's.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Callable

import numpy as np
import torch

from qkd_ldpc_tpu_torch.channel.cuda_prng import ALICE, SCORES, TIES, DeviceRange, trial_words_cuda
from qkd_ldpc_tpu_torch.channel.cuda_select import complete_ties_cuda, select_flip_cuda
from qkd_ldpc_tpu_torch.channel.keys import make_trials_from_ids, num_errors_for
from qkd_ldpc_tpu_torch.codes.ldpc_code import LDPCCode
from qkd_ldpc_tpu_torch.decoder import device_loop
from qkd_ldpc_tpu_torch.decoder.bp import DecodeOptions, _DecodeCore
from qkd_ldpc_tpu_torch.decoder.cuda_kernels import PassFold
from qkd_ldpc_tpu_torch.decoder.reconcile import llr_magnitude
from qkd_ldpc_tpu_torch.sim import cuda_continuation as steps
from qkd_ldpc_tpu_torch.sim.runner import _HostCopy
from qkd_ldpc_tpu_torch.sim.stats import PointPartials, partials_from_stacked
from qkd_ldpc_tpu_torch.spans import span
from qkd_ldpc_tpu_torch.utils import canonical_device, resolve_device


# How often the most recent continuation run went round its loops, summed
# over its trial shards: outer steps (`segment` decode iterations each),
# refills and staging-block generations, read from the device's carry with the
# statistics.  A diagnostic, read by callers that hold the kernels' launch
# counts against the loop structure.
last_loop_counts = {"outer_steps": 0, "refills": 0, "generations": 0}
_COUNT_SLOTS = {"outer_steps": steps.OUTER, "refills": steps.REFILLS,
                "generations": steps.GENS}
# Conditional bodies of the captured program: the outer loop, the refill
# loop, regen and refill.
_BODIES = 4
_M32 = 0xFFFFFFFF


def continuation_inputs(point_keys: list, num_errors: list[int], trials: int,
                        trial_offset: int, outer_cap: int, n_vars: int) -> torch.Tensor:
    """The int32 input vector of one continuation call, on the host:
    ``trials``, the first global trial id (raw uint32 bits, mod 2**32), the
    outer loop's bound (``cuda_continuation.loop_caps``), the P point keys'
    words (raw uint32 bits), the P error counts, and the bits of the P
    float32 a-priori LLR magnitudes (``reconcile.llr_magnitude`` of the
    float32 QBER ``num_errors / n_vars``, as ``apriori_llr`` computes it)."""
    words = [int(w) & _M32 for key in point_keys for w in torch.as_tensor(key).tolist()]
    q = np.asarray(num_errors, np.float32) / np.float32(n_vars)
    vec = np.concatenate([
        np.array([trials], np.int32),
        np.array([int(trial_offset) & _M32], np.uint32).view(np.int32),
        np.array([outer_cap], np.int32),
        np.array(words, np.uint32).view(np.int32),
        np.asarray(num_errors, np.int32),
        llr_magnitude(q).astype(np.float32).view(np.int32)])
    return torch.from_numpy(vec)


class _ContinuationProgram:
    """Trials ``[x[OFFSET], x[OFFSET] + x[TRIALS])`` of P consecutive sweep
    points with cross-point lane continuation on ``batch`` lanes: JAX's
    ``_continuation_core``, eager (``graph=None``) or captured into a
    :class:`~qkd_ldpc_tpu_torch.decoder.device_loop.Graph`.  Returns the
    carry, int32 ``[7 P + SLOTS]``: the ``[7, P]`` statistics, then the
    scalars of ``sim/cuda_continuation.py`` (the loops' counts among them).

    Points are consumed in order; as point p's ids run out, drained lanes
    start hosting point p+1's trials at once.  Each lane is tagged with its
    point, statistics bank into per-point accumulators with order-independent
    integer adds, minima and maxima, and a trial's trajectory depends only on
    its own (llr, syndrome) — so the per-point statistics are bit-identical
    to running each point alone.  Everything the program allocates it
    allocates before its loops: their bodies write into those buffers only.
    """

    def __init__(self, code, P, batch, segment, refill_min, opts, prng, device):
        if prng not in ("threefry", "pallas"):
            raise ValueError(f"Unknown prng contract {prng!r}: expected 'threefry' (v1) "
                             "or 'pallas' (v2)")
        self.code, self.P, self.B, self.segment = code, P, batch, segment
        self.S = batch  # staging-block size: one key generation per `batch` trials,
        # as the plain runner's per-batch keygen
        self.K = refill_min
        assert self.S % self.K == 0, "refill quantum must divide the staging block"
        self.opts, self.prng, self.device = opts, prng, device
        self.inner_cap = steps.loop_caps(0, P, batch, self.S, self.K, opts.max_iterations,
                                         segment)[1]
        self.core = _DecodeCore(code, opts, device)
        self.use_kernel = self.core.use_kernel

    def _buffers(self, dev):
        """The program's state, made before any loop.  Dead lanes keep
        computing on harmless values (llr pinned positive, zero messages) and
        are masked out of all statistics."""
        code, B, S, P = self.code, self.B, self.S, self.P
        N, M = code.n_vars, code.n_checks

        def zeros(shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=dev)

        b = SimpleNamespace()
        b.Lr = zeros((code.dc_max, M, B), self.core.mdt)
        b.llr = torch.ones((N, B), dtype=torch.float32, device=dev)
        b.syn = zeros((M, B), torch.int8)
        b.alice, b.z = zeros((N, B), torch.int8), zeros((N, B), torch.int8)
        b.age = zeros((B,), torch.int32)  # iterations completed; -1 on a fresh lane
        b.done, b.live = zeros((B,), torch.bool), zeros((B,), torch.bool)
        b.run = zeros((B,), torch.bool)  # live & ~done & (age < max_it)
        # the segment's passes alternate between (run, age, ok) and this second
        # set (see _segment_and_bank); the last pass's bookkeeping brings the
        # lanes home to the first
        b.run2, b.age2 = zeros((B,), torch.bool), zeros((B,), torch.int32)
        b.ok2 = torch.ones((B,), dtype=torch.bool, device=dev)
        b.fresh = zeros((B,), torch.bool)
        b.lane_p = zeros((B,), torch.int32)  # sweep-point index of each lane's trial
        b.total = torch.empty((N, B), dtype=self.core.mdt, device=dev)
        b.ok = torch.ones((B,), dtype=torch.bool, device=dev)
        b.scratch = self.core.scratch(B)
        # the staging block: S fresh trials of point st[SP], slot i = id st[BASE] + i
        b.llr_s = zeros((N, S), torch.float32)
        b.syn_s, b.alice_s = zeros((M, S), torch.int8), zeros((N, S), torch.int8)
        b.fill_bits = (zeros(steps.fill_bits_shape(S, N), torch.int32) if self.use_kernel
                       else None)  # stage_fill's packed bits
        # regen's channel: K4's rows, K3's threshold and Bob's rows
        b.a_rows, b.bob = zeros((S, N), torch.uint8), zeros((S, N), torch.uint8)
        b.scores, b.ties = zeros((S, N), torch.int32), zeros((S, N), torch.int32)
        b.thresh = zeros((S, 1), torch.int32)
        b.carry = zeros((7 * P + steps.SLOTS,), torch.int32)
        b.acc, b.st = b.carry[:7 * P].view(7, P), b.carry[7 * P:]
        b.lane_of = zeros((self.K,), torch.int32)
        b.mis = zeros((B,), torch.int32)
        b.flags = zeros((4,), torch.uint8)
        return b

    def _test(self, b, handles=None) -> steps.RefillTest:
        """The refill loop's test, which the step before each of its tests
        runs (``handles`` inside a capture)."""
        return steps.RefillTest(self.B, self.P, self.K, self.S, self.inner_cap, b.flags, handles)

    def _regen(self, x, b, passes=None, test=None):
        """``regen``: the next S staged trials — of the next point once the
        current one's ids are exhausted.  Ids past ``trials`` are generated
        but never consumed (at most one block a point).  Its step runs the
        refill loop's ``test`` (which may enable the refill that follows)."""
        kern, st, N = self.use_kernel, b.st, self.code.n_vars
        steps.stage_step(x, st, self.S, self.P, use_kernel=kern, passes=passes, test=test)
        key, k = st[steps.KEY0:steps.KEY1 + 1], st[steps.K:steps.K + 1]
        ids = DeviceRange(st[steps.ID_BASE:steps.ID_BASE + 1], range(self.S))
        if kern:
            excess = st[steps.EXCESS:steps.EXCESS + 1]
            trial_words_cuda(key, N, ids, (ALICE, SCORES), self.device,
                             out=(b.a_rows, b.scores))
            select_flip_cuda(b.scores, k, b.a_rows, out=(b.thresh, b.bob, excess))
            trial_words_cuda(key, N, ids, (TIES,), self.device, gate=excess, out=(b.ties,))
            complete_ties_cuda(b.scores, b.thresh, k, b.ties, b.a_rows, b.bob, excess)
        else:
            a, bob = make_trials_from_ids(key, N, ids, k, self.prng, self.opts.backend,
                                          self.device)
            b.a_rows.copy_(a)
            b.bob.copy_(bob)
        steps.stage_fill(b.a_rows, b.bob, self.core.maps, st[steps.MAG:steps.MAG + 1], b.llr_s,
                         b.syn_s, b.alice_s, use_kernel=kern, bits=b.fill_bits)

    def _refill(self, x, b, passes=None, test=None):
        """``refill``: the next K staged trials (fewer at the tail of a point)
        into the first empty lanes; the read position moves by K.  Its lane
        step runs the refill loop's ``test``."""
        kern = self.use_kernel
        lanes = (b.live, b.run, b.done, b.fresh, b.age, b.lane_p)
        steps.refill_lanes(x, b.st, lanes, b.lane_of, self.K, use_kernel=kern, passes=passes,
                           test=test)
        steps.refill_copy(b.st, b.lane_of, (b.llr_s, b.syn_s, b.alice_s),
                          (b.llr, b.syn, b.alice, b.Lr), use_kernel=kern)

    def _segment_and_bank(self, x, b, passes=None, handle=None, test=None):
        """``segment`` decode iterations of every lane, in place (per-lane
        bookkeeping as in decoder.bp: stopped lanes keep computing, masked out
        of the statistics; the variable update moves z and age on the running
        lanes, the check update's ok is the syndrome of those totals), then
        the banking of the finished lanes into their points' accumulators,
        which runs the next refill loop's ``test`` where the outer loop goes
        on.

        A pass's bookkeeping (JAX's :225-233) runs inside the next pass's
        variable update (``PassFold``), which reads the lanes' (run, age, ok)
        from one set of buffers and writes their successors into the other;
        the sets alternate pass by pass, and the last pass's bookkeeping
        (``pass_step``) brings the lanes home to (run, age, ok), whatever the
        parity of ``segment``.  Pass 0's update is the plain one."""
        core, kern, max_it = self.core, self.use_kernel, self.opts.max_iterations
        home = (b.run, b.age, b.ok)
        lanes = home
        for i in range(self.segment):
            if i == 0:
                core.variable_update(b.Lr, b.llr, b.z, b.age, b.run, out=(b.total, b.ok))
            else:
                run, age, ok = lanes
                lanes = (b.run2, b.age2, b.ok2) if i % 2 else home
                # pass 1 ends the refilled lanes' fresh pass
                fold = PassFold(ok=ok, done=b.done, run=lanes[0], count=lanes[1],
                                fresh=b.fresh if i == 1 else None, max_it=max_it)
                core.variable_update(b.Lr, b.llr, b.z, age, run, out=(b.total, lanes[2]),
                                     fold=fold)
            core.check_update_fused(b.total, b.Lr, b.syn, fresh=b.fresh, ok=lanes[2], out=b.Lr,
                                    scratch=b.scratch)
        steps.pass_step(lanes[2], b.done, lanes[0], lanes[1], b.fresh, max_it,
                        self.segment == 1, use_kernel=kern, out=home)
        steps.bank(x, b.acc, b.st, (b.live, b.run, b.done, b.age, b.lane_p), b.z, b.alice,
                   b.mis, max_it, b.flags, use_kernel=kern, passes=passes, handle=handle,
                   test=test)

    def __call__(self, x: torch.Tensor, graph=None, outer_limit=None) -> torch.Tensor:
        """Run (or capture into ``graph``) the program on the input vector
        ``x`` (:func:`continuation_inputs`, on the device); ``outer_limit``
        stops the eager program after that many outer steps (a capture's
        warm-up)."""
        b = self._buffers(x.device)
        lanes = (b.live, b.run, b.done, b.fresh, b.age, b.lane_p)
        kern, max_it = self.use_kernel, self.opts.max_iterations
        if graph is None:
            test = self._test(b)
            steps.start(x, b.acc, b.st, lanes, self.S, max_it, b.flags, use_kernel=kern,
                        test=test)
            done_steps = 0
            while b.flags[steps.OUTER_GO]:  # the eager program's host read, an outer step
                # 1. refill empty lanes, K at a time, while enough have retired
                # (or none are live at all); regenerate the staging block when
                # it runs dry — advancing to the next point's ids as needed.
                # A pass is the graph's: a regeneration and the refill its
                # test enables, or a refill.
                while True:
                    go, regen, refill = b.flags[steps.IN_GO:].tolist()  # one host read
                    if not go:
                        break
                    if regen:
                        self._regen(x, b, test=test)
                        refill = bool(b.flags[steps.REFILL])  # the regeneration's test
                    if refill:
                        self._refill(x, b, test=test)
                # 2. decode `segment` iterations; 3. bank finished trials.
                self._segment_and_bank(x, b, test=test)
                done_steps += 1
                if outer_limit is not None and done_steps >= outer_limit:
                    break
            return b.carry
        h_out, h_in, h_regen, h_refill = (graph.handle() for _ in range(4))
        test = self._test(b, (h_in, h_regen, h_refill))
        steps.start(x, b.acc, b.st, lanes, self.S, max_it, b.flags, use_kernel=kern,
                    handle=h_out, test=test)

        def refill_loop(_passes):
            # the body is the cond's two branches alone, no kernel of its own:
            # the test before each pass ran in the step before it, and a
            # regeneration's test sets the refill's node that follows it
            graph.conditional(device_loop.IF, h_regen, lambda p: self._regen(x, b, p, test))
            graph.conditional(device_loop.IF, h_refill, lambda p: self._refill(x, b, p, test))

        def outer_step(passes):
            graph.conditional(device_loop.WHILE, h_in, refill_loop)
            self._segment_and_bank(x, b, passes, h_out, test)

        graph.conditional(device_loop.WHILE, h_out, outer_step)
        return b.carry


def _continuation_core(
    code: LDPCCode,
    point_keys: list,  # P PRNG keys, one per sweep point
    num_errors: list[int],  # [P]
    trials: int,  # trials per point
    trial_offset: int,  # first global trial id of every point (mod 2**32)
    batch: int,
    segment: int,
    refill_min: int,
    opts: DecodeOptions,
    prng: str = "threefry",
    device=None,
) -> tuple[torch.Tensor, dict]:
    """Trials [trial_offset, trial_offset + trials) of P consecutive sweep
    points with CROSS-POINT lane continuation; returns the stacked [7, P]
    int32 stat matrix on the host and the loops' counts.  On the card under
    the kernel backend one replay of the program's captured graph; elsewhere
    the same program eagerly."""
    with span("qkd.cont.dispatch"):
        device = canonical_device(resolve_device(device))
        P = len(point_keys)
        outer_cap, _ = steps.loop_caps(trials, P, batch, batch, refill_min,
                                       opts.max_iterations, segment)
        x = continuation_inputs(point_keys, num_errors, trials, trial_offset, outer_cap,
                                code.n_vars)
        program = _ContinuationProgram(code, P, batch, segment, refill_min, opts, prng, device)
        if device_loop.graphs_on(program.use_kernel, device):
            key = ("continuation", code.fingerprint, batch, segment, refill_min, opts, prng, P)
            carry = device_loop.run_graph(
                key, lambda v, graph: (program(v, graph),), (x,), keep=program, device=device,
                loops=_BODIES, warmup=lambda v: program(v, None, outer_limit=1))[0]
        else:
            carry = program(x.to(device))
        # one copy into pinned memory, the run's only wait for the card
        copy = _HostCopy(carry)
    carry = copy.get()
    fault = int(carry[7 * P + steps.FAULT])
    if fault:
        raise RuntimeError(f"the continuation program stopped a loop at its bound (fault "
                           f"bits {fault}): a fault of the program, not of the data")
    counts = {name: int(carry[7 * P + slot]) for name, slot in _COUNT_SLOTS.items()}
    return carry[:7 * P].view(7, P), counts


def _run_shards(code, point_keys, n_errs, trials, batch, segment, refill_min, opts,
                prng, device, mesh) -> torch.Tensor:
    """The continuation on ``device``, or on every trial shard of ``mesh``
    (``batch`` lanes each); returns the merged [7, P] statistics on the host
    and records the loops' counts in ``last_loop_counts``."""
    if mesh is None:
        stacked, counts = _continuation_core(
            code, point_keys, n_errs, trials, 0, batch, segment, refill_min, opts, prng,
            device)
        last_loop_counts.update(counts)
        return stacked
    from qkd_ldpc_tpu_torch.parallel.mesh import (
        TRIAL_AXIS,
        all_gather_rows,
        run_on_shards,
        trial_sharding,
    )

    n_shards = mesh.shape[TRIAL_AXIS]
    q, r = divmod(trials, n_shards)

    def shard_run(shard):
        s = shard.index
        return _continuation_core(
            code, point_keys, n_errs, q + (s < r), s * q + min(s, r), batch, segment,
            refill_min, opts, prng, shard.device)

    shards = trial_sharding(mesh, n_shards)
    runs = [r for sh, r in zip(shards, run_on_shards(shard_run, shards)) if sh.row.leader]
    last_loop_counts.update({k: sum(c[k] for _, c in runs) for k in last_loop_counts})
    rows = (torch.stack([st.to(torch.int64) for st, _ in runs]) if runs  # [k, 7, P]
            else torch.empty((0, 7, len(point_keys)), dtype=torch.int64))
    if mesh.process_count > 1:
        rows = all_gather_rows(rows)
    # Integer sums, minima and maxima: exact, independent of the shard order.
    return torch.cat([rows[:, :5].sum(0), rows[:, 5:6].amin(0),
                      rows[:, 6:7].amax(0)]).to(torch.int32)


def _check_point(code, qbers, trials, opts, hint):
    """The guards shared by the entry points; returns the error counts."""
    if opts.schedule == "layered":
        raise ValueError(
            "the continuation runner decodes with the flooding schedule "
            "only; schedule='layered' cannot be combined with it"
        )
    n_errs = [num_errors_for(code.n_vars, q) for q in qbers]
    if any(n == 0 for n in n_errs):
        raise ValueError(f"Key size '{code.n_vars}' is too small for QBER.")
    mi2 = max(opts.max_iterations, 1) ** 2
    if trials * mi2 > 2**31 - 1:
        raise ValueError(
            f"trials ({trials}) x max_iterations^2 ({opts.max_iterations}^2) "
            f"overflows the int32 iteration statistics accumulated on device; {hint}"
        )
    return n_errs


def _refill_quantum(batch: int, refill_frac: float) -> int:
    """Largest divisor of ``batch`` not exceeding the requested fraction
    (contiguous staging slices must tile the staging block)."""
    want = max(1, int(batch * refill_frac))
    return next(d for d in range(want, 0, -1) if batch % d == 0)


class _SweepSlice:
    """Per-point view of a [7, P] continuation-sweep result, fetched from
    the device ONCE for the whole group."""

    def __init__(self, host: torch.Tensor, idx: int):
        self._host, self._idx = host, idx

    def fetch(self):
        return self._host[:, self._idx]


def dispatch_sweep_continuation(
    code: LDPCCode,
    point_keys: list,
    qbers: list[float],
    trials: int,
    batch: int,
    opts: DecodeOptions,
    mesh=None,
    segment: int = 4,
    refill_frac: float = 0.25,
    prng: str = "threefry",
    device=None,
) -> tuple[list[list], list[float]]:
    """Run P consecutive waterfall points as ONE cross-point continuation
    (drained lanes of point p host point p+1's trials), on ``device`` or on
    every trial shard of ``mesh`` with ``batch`` lanes each.  Returns
    per-point result lists (each a single shared-fetch slice) and the actual
    QBERs.
    """
    n_errs = _check_point(code, qbers, trials, opts,
                          "lower continuation_qber or trials_number")
    host = _run_shards(code, list(point_keys), n_errs, trials, batch, segment,
                       _refill_quantum(batch, refill_frac), opts, prng, device, mesh)
    futures = [[_SweepSlice(host, i)] for i in range(len(qbers))]
    return futures, [n / code.n_vars for n in n_errs]


def run_point_continuation(
    code: LDPCCode,
    point_key: torch.Tensor,
    qber: float,
    trials: int,
    batch: int,
    opts: DecodeOptions,
    segment: int = 4,
    refill_frac: float = 0.25,
    tick: Callable[[int], None] | None = None,
    device=None,
) -> tuple[PointPartials, float]:
    """All trials of one (matrix, QBER) point with lane continuation.

    Bit-identical statistics to :func:`sim.runner.run_point`; worth it
    wherever per-frame iteration residency varies widely (the waterfall).
    ``device=None`` means the card and raises when there is none.
    """
    with span("qkd.cont.run"):
        (n_err,) = _check_point(code, [qber], trials, opts,
                                "split the point or use the plain runner")
        host = _run_shards(code, [point_key], [n_err], trials, batch, segment,
                           _refill_quantum(batch, refill_frac), opts, "threefry", device, None)
        # Merging into an empty PointPartials applies the n_sp == 0 min/max
        # convention, so partials compare bit-equal with the plain runner.
        total = PointPartials().merge(partials_from_stacked(host[:, 0]))
        if tick is not None:
            tick(total.n_trials)
        return total, n_err / code.n_vars


def dispatch_point_continuation_sharded(
    code: LDPCCode,
    point_key: torch.Tensor,
    qber: float,
    trials: int,
    batch: int,
    opts: DecodeOptions,
    mesh,
    segment: int = 4,
    refill_frac: float = 0.25,
) -> tuple[list, float]:
    """One point's continuation on every trial shard of ``mesh`` (``batch``
    lanes each), in the futures protocol of ``sim.runner``."""
    futures, actuals = dispatch_sweep_continuation(
        code, [point_key], [qber], trials, batch, opts, mesh=mesh,
        segment=segment, refill_frac=refill_frac,
    )
    return futures[0], actuals[0]


def run_point_continuation_sharded(
    code: LDPCCode,
    point_key: torch.Tensor,
    qber: float,
    trials: int,
    batch: int,  # lanes per trial shard
    opts: DecodeOptions,
    mesh,
    segment: int = 4,
    refill_frac: float = 0.25,
    tick: Callable[[int], None] | None = None,
) -> tuple[PointPartials, float]:
    """All trials of one point with one continuation lane pool a trial shard.

    Statistics bit-identical to :func:`run_point_continuation` and to the
    plain (sharded or single-device) runner.
    """
    futures, actual = dispatch_point_continuation_sharded(
        code, point_key, qber, trials, batch, opts, mesh,
        segment=segment, refill_frac=refill_frac,
    )
    total = PointPartials().merge(partials_from_stacked(futures[0].fetch()))
    if tick is not None:
        tick(total.n_trials)
    return total, actual
