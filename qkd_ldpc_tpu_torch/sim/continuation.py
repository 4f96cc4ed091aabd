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

The JAX runner is one jitted ``while_loop``; here the outer loop runs on
the host.  What the host needs from the device is ONE small fetch per outer
step (the number of live lanes after banking); the staging block's base,
read position and point, and the ids consumed, are functions of the refill
count and ``trials`` alone and live on the host as Python ints.  Refills
copy staged columns into the first empty lanes with ``index_copy_`` along
the lane axis.  One pass of the segment loop is the two kernels of
``decoder/cuda_kernels.py`` (variable update, then check update with the
decision syndrome, in place over ``Lr``) and four small per-lane ops; the
loop carries ``Lr``, and neither the totals nor a gathered copy of them are
lane state.  On the card under the kernel backend the ``segment`` passes
(JAX's ``fori_loop``) are captured once per run as one CUDA graph over the
lane state, and each outer step replays it: one host call for ``segment``
iterations (``decoder/device_loop.py``).

The continuation runner decodes with the flooding schedule only and raises
on ``schedule="layered"``.  Over a trial mesh (``parallel.mesh``) each trial
shard runs its own lane pool over a contiguous range of every point's
global trial ids (shard ``s`` of ``S`` takes ``[s*q + min(s, r), ...)`` with
``q, r = divmod(trials, S)``); the shards' ``[7, P]`` integer statistics
merge on the host by sums, minima and maxima, so the result is again the
plain runner's.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from qkd_ldpc_tpu_torch.channel.keys import make_trials_from_ids, num_errors_for
from qkd_ldpc_tpu_torch.codes.ldpc_code import LDPCCode
from qkd_ldpc_tpu_torch.decoder import device_loop
from qkd_ldpc_tpu_torch.decoder.bp import DecodeOptions, _DecodeCore
from qkd_ldpc_tpu_torch.decoder.reconcile import apriori_llr
from qkd_ldpc_tpu_torch.decoder.syndrome import syndrome as syndrome_fn
from qkd_ldpc_tpu_torch.sim.stats import PointPartials, partials_from_stacked
from qkd_ldpc_tpu_torch.utils import resolve_device


# How often the most recent continuation run went round its loops, summed
# over its trial shards: outer steps (one device fetch and `segment` decode
# iterations each), refills and staging-block generations.  A diagnostic, read
# by callers that hold the kernels' launch counts against the loop structure.
last_loop_counts = {"outer_steps": 0, "refills": 0, "generations": 0}


def _continuation_core(
    code: LDPCCode,
    point_keys: list,  # P PRNG keys, one per sweep point
    num_errors: list[int],  # [P]
    trials: int,  # trials per point
    trial_offset: int,  # first global trial id of every point
    batch: int,
    segment: int,
    refill_min: int,
    opts: DecodeOptions,
    prng: str = "threefry",
    device=None,
) -> tuple[torch.Tensor, dict]:
    """Trials [trial_offset, trial_offset + trials) of P consecutive sweep
    points with CROSS-POINT lane continuation; returns the stacked [7, P]
    int32 stat matrix on the device and the loops' counts.

    Points are consumed in order; as point p's ids run out, drained lanes
    start hosting point p+1's trials immediately.  Each lane is tagged with
    its point, statistics bank into per-point accumulators with
    order-independent scatter adds/mins/maxes, and a trial's trajectory
    depends only on its own (llr, syndrome) — so the per-point statistics
    are bit-identical to running each point alone.
    """
    device = resolve_device(device)
    N, M = code.n_vars, code.n_checks
    P = len(point_keys)
    core = _DecodeCore(code, opts, device)
    mdt, dc = core.mdt, code.dc_max
    max_it = opts.max_iterations
    S = batch  # staging-block size: one key generation per `batch` trials,
    # as the plain runner's per-batch keygen
    K = refill_min
    assert S % K == 0, "refill quantum must divide the staging block"

    def zeros(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    i32 = torch.int32
    # Device state.  Dead lanes keep computing on harmless values (llr
    # pinned positive, zero messages) and are masked out of all statistics.
    Lr = zeros((dc, M, batch), mdt)
    llr = torch.ones((N, batch), dtype=torch.float32, device=device)
    syn = zeros((M, batch), torch.int8)
    alice, z = zeros((N, batch), torch.int8), zeros((N, batch), torch.int8)
    age = zeros((batch,), i32)  # iterations completed; -1 on a fresh lane
    done = zeros((batch,), torch.bool)
    live = zeros((batch,), torch.bool)
    run = zeros((batch,), torch.bool)  # live & ~done & (age < max_it)
    fresh = zeros((batch,), torch.bool)
    lane_p = zeros((batch,), torch.int64)  # sweep-point index of each lane's trial
    total = torch.empty((N, batch), dtype=mdt, device=device)
    ok = torch.ones((batch,), dtype=torch.bool, device=device)
    scratch = core.scratch(batch)

    def segment_passes(Lr, llr, syn, z, age, done, run, fresh, total, ok):
        """``segment`` decode iterations of every lane, in place (per-lane
        bookkeeping as in decoder.bp: stopped lanes keep computing, masked
        out of stats).  The variable update moves z and age on the running
        lanes; the check update's ok is the syndrome of those totals."""
        for i in range(segment):
            core.variable_update(Lr, llr, z, age, run, out=(total, ok))
            core.check_update_fused(total, Lr, syn, fresh=fresh, ok=ok, out=Lr,
                                    scratch=scratch)
            conv = ok & run
            done |= conv
            torch.bitwise_and(run ^ conv, age < max_it, out=run)  # conv is a subset of run
            if i == 0:
                fresh.zero_()

    lane_state = (Lr, llr, syn, z, age, done, run, fresh, total, ok)
    segment_graph = None
    if device_loop.graphs_on(core.use_kernel, device):
        segment_graph = device_loop.Graph(device).capture(
            lambda graph: segment_passes(*lane_state),
            warmup=lambda: segment_passes(*(x.clone() for x in lane_state)))

    # Seven [P] per-point accumulators, in stats.STAT_KEYS order.
    acc = [zeros((P,), i32) for _ in range(7)]
    acc[5].fill_(max_it)

    # Host state.  The staging block holds S fresh trials OF POINT sp: slot i
    # is trial id base + i, slots pos..S-1 are unconsumed.  It starts empty
    # (pos == S forces a regeneration; base starts at -S so the first block
    # holds trials 0..S-1 of point 0).  next_id counts the ids consumed of
    # the stage's current point; live_n is the device's live-lane count as
    # of the last fetch plus the refills since.
    llr_s = syn_s = alice_s = None
    base, pos, sp, next_id, live_n = -S, S, 0, 0, 0

    def more_ids():
        return sp < P - 1 or next_id < trials

    counts = dict.fromkeys(last_loop_counts, 0)
    while more_ids() or live_n > 0:
        counts["outer_steps"] += 1
        # 1. refill empty lanes, K at a time, while enough have retired (or
        # none are live at all); regenerate the staging block when it runs
        # dry — advancing to the next point's ids as needed.
        while more_ids() and (batch - live_n >= K or live_n == 0):
            if pos >= S:
                base += S
                if base >= trials:  # current point exhausted -> advance
                    base, sp, next_id = 0, min(sp + 1, P - 1), 0
                # ids >= trials are generated but never consumed (tail waste
                # of at most one block per point).
                ids = range(trial_offset + base, trial_offset + base + S)  # mod 2**32
                ne = num_errors[sp]
                a_new, b_new = make_trials_from_ids(
                    point_keys[sp], N, ids, ne, prng, opts.backend, device)
                aq = np.float32(ne) / np.float32(N)
                llr_s = apriori_llr(b_new, aq).T
                syn_s = syndrome_fn(code, a_new).T.to(torch.int8)
                alice_s = a_new.T.to(torch.int8)
                pos = 0
                counts["generations"] += 1
                continue
            # Move the next K staged trials (fewer at the tail of a point)
            # into the first empty lanes.  The refill predicate guarantees
            # >= K empty lanes; the stable sort lists them in lane order.
            n_new = min(max(trials - (base + pos), 0), K)
            if n_new > 0:
                lanes = torch.argsort(live.to(torch.int8), stable=True)[:n_new]
                cols = slice(pos, pos + n_new)
                llr.index_copy_(1, lanes, llr_s[:, cols])
                syn.index_copy_(1, lanes, syn_s[:, cols])
                alice.index_copy_(1, lanes, alice_s[:, cols])
                # Zero messages: the lane's next variable update makes its
                # totals the a-priori LLRs, which completes no iteration.
                Lr.index_fill_(2, lanes, 0)
                age.index_fill_(0, lanes, -1)
                done.index_fill_(0, lanes, False)
                live.index_fill_(0, lanes, True)
                run.index_fill_(0, lanes, True)
                # Accumulates: several refills can run back to back in one
                # outer step when many lanes retired at once.
                fresh.index_fill_(0, lanes, True)
                lane_p.index_fill_(0, lanes, sp)
                next_id += n_new
                live_n += n_new
                counts["refills"] += 1
            pos += K

        # 2. decode `segment` iterations: one replay of the segment graph
        # on the card, the same passes eagerly elsewhere.
        if segment_graph is not None:
            segment_graph.replay()
        else:
            segment_passes(*lane_state)

        # 3. bank statistics of finished trials into their POINT's
        # accumulators (integer scatter add/min/max: exact and
        # order-independent), mark their lanes empty.
        finished = live & ~run
        sp_r = finished & done
        keys = (z == alice).all(dim=0)  # keys_match (only used when sp_r)
        it_sp = torch.where(sp_r, age, 0)
        acc[0].index_add_(0, lane_p, finished.to(i32))
        acc[1].index_add_(0, lane_p, sp_r.to(i32))
        acc[2].index_add_(0, lane_p, (sp_r & keys).to(i32))
        acc[3].index_add_(0, lane_p, it_sp)
        acc[4].index_add_(0, lane_p, it_sp * it_sp)
        # Unfinished/dead lanes contribute the neutral elements.
        acc[5].scatter_reduce_(0, lane_p, torch.where(sp_r, age, max_it),
                               "amin", include_self=True)
        acc[6].scatter_reduce_(0, lane_p, it_sp, "amax", include_self=True)
        live = live & ~finished
        live_n = int(live.sum())  # the one fetch per outer step
    return torch.stack(acc), counts


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
        return stacked.cpu()
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
    rows = (torch.stack([st.cpu().to(torch.int64) for st, _ in runs]) if runs  # [k, 7, P]
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
