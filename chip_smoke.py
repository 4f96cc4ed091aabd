#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's decode paths and protocol surface on the card.

Run ``python3 chip_smoke.py`` from the repository root on a machine with one
NVIDIA Hopper GPU, ``nvcc`` and PyTorch built for CUDA.  It

1. builds the CUDA kernels of ``qkd_ldpc_tpu_torch/csrc`` (all ``nvcc``
   processes in parallel) and prints the card, the toolchain and the build time;
2. holds every kernel against its plain PyTorch version on the card at the
   flagship shapes (``[10240, 512]`` totals and ``[6, 5120, 512]`` messages,
   512 trials of 10240 bits, k = 512, layered state ``[20, 512, 512]`` /
   ``[60, 512, 512]``) and times kernel, plain version and, where one PyTorch
   call computes the same function, that call; the two flooding kernels also
   at B = 128 (the compacted width) and at a ragged B (their scalar
   instances); the sweep kernel also on a code too wide for shared memory
   (its totals then stay in global memory); the two channel kernels for both
   forms of trial ids and all three rows, and a point key on the card (K4),
   and on crafted tie rows, a per-row k and every instance of K3 (rows in 8 or
   20 words a thread or re-read from device memory, each with 16-byte and with
   single-word accesses), and the second-word tie path end to end;
3. drives ``run_point`` — keygen (K4), exact-weight channel (K3, and the
   second-word tie path gated on the card: K4's tie row and the tie kernel),
   syndrome, flooding BP decode with compaction (its loops WHILE nodes),
   statistics, the four batches one replay of the chunk's captured CUDA graph
   — on the flagship quasi-cyclic code at its operating point and checks the
   statistics and the launch counts (K4 twice, K3, the tie kernel, K1 and
   the three loop-entry tests once per batch; K2, the variable update and the
   loop's bookkeeping once per pass, read from the graph's device counters;
   no plain threefry tree on the card);
   3b. the same point with ``schedule="layered"`` (the sweep kernel);
   3c. ``run_point_continuation`` at a waterfall point — the whole
   continuation one graph replay per call: the outer loop and the refill loop
   WHILE nodes, regen and refill IF nodes, the ``segment`` passes (the
   fresh-lane kernel) and the banking inside — against ``run_point`` on the
   same point key: seven equal partial sums, launches per outer step, the
   staging blocks and the program's own steps counted from the card; the
   same call under ``torch.cuda.set_sync_debug_mode("error")``; a three-point
   ``dispatch_sweep_continuation`` and a two-shard sharded continuation, each
   equal to ``run_point`` at each point; the capture's time, nodes,
   conditional nodes and pool bytes; the kernels of ``csrc/continuation.cu``
   bit-equal to their plain versions (a tail refill of n_new < K among the
   cases) and timed; then the three paths' walls in turns, each beside its
   eager kernel loop;
   3d. (``device_loops``) every decode leg as a graph against the eager kernel
   loop, bit for bit and launch for launch, and against the plain versions:
   flooding and layered at the flagship (SP/bf16, min-sum/int8), with a
   forced phase-C overflow, with every lane converged in phase A, and at
   check degree 15 (the loop instance and its scratch); four host threads
   sharing one graph; K2 in place over its input; the continuation program
   against its eager program (7/7, equal launches of every kernel); the tie
   path gated on the card against
   ``_uniform_ties`` on a forced-tie flagship batch and on rows of many ties
   sharing their second words across the row; ``point_batch_partials`` and
   the decodes under
   ``torch.cuda.set_sync_debug_mode("error")`` (any host synchronisation
   fails the script); the Reconciler with 1 and 4 chunks in flight; the new
   kernels (loop entry, loop step, sweep step, tie completion) held to their
   plain versions and timed;
   3e. (``chunk_graph``) the trial chunk as one CUDA graph: sweep A through
   ``batch_simulation`` captures once per code; the chunk graph against the
   eager chunk 7/7 and launch for launch on the ``run_point`` legs (flooding
   and layered in SP/bf16 and min-sum/int8, the continuation's crossover
   point) and on a trial mesh of four shards; one graph replayed for four
   inputs that differ in key, error count, first trial and tail, each equal
   to its eager chunk; ``_dispatch_point`` under the sync-debug gate; each
   capture's time, nodes and pool bytes;
4. repeats the paths through the plain versions (``backend="xla"``) and
   compares the seven partial sums;
   2b. (``f1_degrees``) the flooding kernels K1, K2, K5 and the variable
   update at every check degree 2..9, 12, 15, 60 and 200 (and the three
   dense matrices of ``data/``), vector and scalar instances, all storage
   types (int8 at padded slots too), and the sweep kernel at base-row degrees
   15 and 60 with its totals in shared and in global memory, all against
   their plain versions, error 0 required; K2 timed at degrees 12, 15 and 60,
   K6 at 15 and 60, with ptxas's registers and spills of the check kernel's
   instances;
5. runs the sweep as a user does, through ``cli.main``, over the reference's
   own irregular alist (rows of 5 and 6: padded check slots) and the QC
   flagship (``cli_sweep``): native and numpy ingest (equal, and timed), the QC
   sidecar round trip, the four flooding kernels (K1, K2, K5 and the variable
   update) at the alist's shapes, ``config.example.json``'s
   sweep, the same sweep resumed from its checkpoint, the continuation
   crossover, layered, a rate-0.8 code (check degree 15) under the config's
   0.8 row, a min-sum identity of kernels and plain versions, and
   interactive mode at B = 1 — each sweep counted on its own; sweep A also
   in turns with the eager kernel loop;
6. drives the protocol surface on the flagship (``protocol``): the keys
   (the flat-block kernel, its tie block gated on K3's flag, held against its
   plain version on a forced-tie batch and timed), the
   ``Reconciler`` at 128 and 101 lanes against ``backend="xla"``,
   ``reconcile_secure``, the rate-adapted endpoint (flooding and layered) and
   the four decoder kernels on its erasure/pinned LLRs, a blind session, and
   the four Toeplitz methods at the flagship and at a 262,144-bit frame;
7. drives ``parallel/`` on the one card (``parallel``): a trial mesh
   of four shards on the card (``run_point_sharded`` flooding and layered, the
   sharded continuation, ``run_sweep_sharded`` over three points, each equal
   to the single-device runner, 7/7, with its kernels counted and no plain
   update on the card), the general node-sharded decoder on (1 x 2) and
   (2 x 2) meshes of the card (min-sum equal per lane, sum-product on
   decisions and iterations) and ``run_point_node_sharded``, and the CLI run
   by two processes sharing the card in a gloo group (CSV and checkpoint
   byte-equal to one process's).  Shards on one card measure overhead, not
   scaling;
8. drives the QC node-sharded decoder (``qc_node``) on the flagship: 128
   frames, flooding and layered, sum-product and min-sum (bf16; min-sum also
   int8 on (1 x 2)), on (1 x 2), (2 x 2) and (1 x 3) meshes of the card, each
   held against the single-device kernel decode of its schedule (min-sum
   equal per lane, sum-product on decisions with at most 2 frames moved by
   one iteration); its sweep point (min-sum, 512 trials, (2 x 2)) equal to
   ``run_point`` 7/7 with the general decoder never called; and a (1 x 2)
   row whose shards lie in two processes sharing the card (gloo): every
   decode bit-equal to the one-process row, the point 7/7.

Each phase prints one JSON object on a line of its own; any failure raises.
The last line is ``{"ok": true, "device": {...}}``.  The script exits non-zero
without a CUDA device.  ``--profile`` adds a device-time table of each of the
three paths, of one batch of trials (at most ten launches) and of the CLI's
sweep A, and the host's launch calls per graph replay (per chunk on the trial
paths and sweep A); all tracing comes after
every untraced timing.  Times are this card's, labelled with its name and power
limit; they are a smoke measurement, not a benchmark.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet: 80 GB of HBM at 3.35 TB/s
# Data-sheet float32 rate outside the tensor cores.
FP32_OPS_PER_S = 67e12
# 32-bit integer rate: 132 SMs x 64 INT32 lanes per SM and clock (Hopper
# architecture white paper) x 1.98 GHz boost clock (H100 SXM data sheet).  The
# two channel kernels do integer work only.  Their bound_ms stays at the
# float32 rate, the one a measured time has never beaten: the compiler issues
# part of the adds as IMAD on the float pipe, so the INT32 lanes alone are not
# the ceiling.  The bound at this rate is printed beside it.
INT32_OPS_PER_S = 132 * 64 * 1.98e9

# Operations per element, counted from the kernels' arithmetic with each
# transcendental as ONE operation (so the operation bound is a lower bound):
OPS_PER_EDGE = {
    # (tot - lr, clip 2), *0.5, tanh, prefix mul, suffix mul, pre*suf*syn 2,
    # 2x, 1-x, divide, log1p, clip 2
    "sum-product": 15,
    # (tot - lr, clip 2), abs, sign test, top-2 scan 4, parity 2, select,
    # sign*syn, alpha*sign*loo 2, clip 2
    "min-sum": 17,
}
# The flooding check kernel adds per edge the decision syndrome: compare, xor.
OPS_PER_EDGE_SYNDROME = 2
# The variable update: one add per edge; per (variable, frame) the a-priori
# add and the decision compare.
OPS_PER_VARIABLE = 2
# The layered sweep adds per edge: index add and wrap 2, delta, t += delta,
# and the parity pass (index 2, compare, xor).
OPS_PER_EDGE_LAYERED_EXTRA = 8
# One threefry block: 20 rounds x (add, rotate, xor), a rotate being one funnel
# shift; 5 key injections x 2 adds (the round constant folds into the key
# word); 2 adds of the key to the counter; the output xor.
OPS_PER_THREEFRY = 73
# The radix select and the mask, per score: 4 digits x (mask-compare with the
# prefix, shift-and for the bin, the histogram add), then compare and xor.
OPS_PER_SCORE_SELECT = 14

Z, NB, MB_ROWS, DV, CODE_SEED = 512, 20, 10, 3, 666
QBER, BATCH, N_BATCHES = 0.05, 512, 4
MASTER_SEED, POINT_INDEX = 777, 0
MEAN_ITERATIONS_GATE = (5.5, 8.0)
SP_ITERATION_SUM_ALLOWANCE = 2  # +-1-iteration boundary frames per run
# The layered path: same point, about 1.7 x fewer sweeps than flooding.
LAYERED_COMPACT_AFTER = 4
MEAN_SWEEPS_GATE = (3.2, 4.8)
# The continuation path: a waterfall point (844 flips; about 0.28 of the frames
# fail there at the cap of 100, the others take 21 to 100 iterations).
WATERFALL_QBER, WATERFALL_POINT_INDEX = 0.0825, 1
SEGMENT, REFILL_FRAC = 4, 0.125
# The continuation's three-point sweep (points 0, 1, 2 of the master seed).
CONTINUATION_QBERS = (0.075, 0.08, WATERFALL_QBER)
FRESH_THRESHOLD = 3.0  # K5's check: the Lq clip must bite where it is applied
# Other widths of the two flooding kernels: the compacted batch (vector
# instances) and a width no vector divides (scalar instances).
COMPACT_BATCH, RAGGED_BATCH = BATCH // 4, 101
# One batch of trials on the card: K4, the flag's fill, K3, K4's gated tie row
# and the gated tie kernel.
KEYGEN_LAUNCH_LIMIT = 10
# Rows of the N = 4096 codes: K3's instances of 8 words a thread.
SHORT_N = 4096
# A code whose frame of totals (116 x 512 floats) exceeds a block's shared
# memory: the sweep kernel's global-memory mode, held against the plain sweep.
WIDE_NB, WIDE_MB, WIDE_SEED, WIDE_BATCH = 116, 58, 667, 32
# The cli_sweep phase: the reference's own matrix (irregular, rows of 5 and
# 6), and the name the QC flagship is written under beside it.
REFERENCE_ALIST = "(N=10240,M=5231,R=0.49,CW=3,GEN=666).alist"
QC_ALIST = "qc_z512_nb20_mb10_dv3_seed666.alist"
# The f1_degrees phase: the flooding kernels at every check degree.  (n, m, dv)
# of make_code, whose dc_max is ceil(n * dv / m) (rows of two degrees, so padded
# slots, where that does not divide): dc_max 2..8 (the unrolled instances), 9
# (the loop instance at its lowest degree), 12, 15, 60 and 200; the N = 10240
# codes have the flagship's 30,720 edges a frame.  Then the three matrices of
# data/dense_matrices (rows of mixed degrees, N of 6 to 10).
F1_CODES = ((2048, 1024, 1), (2048, 1366, 2), (2048, 1536, 3), (2048, 1229, 3),
            (2048, 1024, 3), (2048, 878, 3), (2048, 768, 3), (2048, 683, 3),
            (10240, 2560, 3), (10240, 2048, 3), (10240, 512, 3), (10240, 154, 3))
F1_WIDTHS = (COMPACT_BATCH, RAGGED_BATCH)  # vector and scalar instances
F1_TIMED_DEGREES = (12, 15, 60)  # K2 timed there beside the flagship's 6
# The check kernel's instances whose registers and spills the f1 line reports
# beside the loop instance's: the fused sum-product update at the vector width,
# unrolled at DC = 6 and 8.
F1_RESOURCE_DEGREES = (6, 8)
# QC codes of base-row degree 15 and 60 (dv 3): totals in shared memory at
# N = 10240, in global memory at nb = 120 (240 KiB of totals a frame).
F1_LAYERED_CODES = ((512, 20, 4), (128, 80, 4), (512, 120, 24), (512, 120, 6))
F1_LAYERED_WIDE_BATCH = 32
# The cli_sweep phase's rate-0.8 code (dc 15): config.example.json's 0.8 row.
RATE08_CODE = dict(n=10240, m=2048, dv=3, seed=8)
RATE08_POINTS = 10  # 0.005, 0.0075, ... 0.0275
# The protocol phase on the flagship: keys from PROTOCOL_SEED's threefry
# blocks; the Reconciler at 128 lanes and at 101 (the kernels' scalar
# instances); the rate-adapted endpoint (erasures and +-64 pins); a blind
# session; amplification at the flagship and at the 262,144-bit frame of
# benchmarks/frame_scale.py.
PROTOCOL_SEED, PROTOCOL_FRAMES = 4242, 512
PROTOCOL_LANES = (128, RAGGED_BATCH)
ADAPT_PUNCTURED, ADAPT_SHORTENED, ADAPT_SEED, ADAPT_QBER = 512, 512, 3, 0.04
BLIND_PUNCTURED, BLIND_STEP, BLIND_QBER = 1024, 256, 0.065
AMPLIFY_FRAMES, BIG_FRAME, BIG_LEAK = 32, 262144, 131072
AMPLIFY_BLOCKS, AMPLIFY_ROWS_CHECKED = (128, 256, 512), 64
# The parallel phase: four trial shards on the one card (a global batch of
# BATCH, BATCH / 4 lanes a shard); a sweep of three points; node-sharded
# decodes of NODE_BATCH flagship frames on (trial x node) meshes of the card;
# the CLI in two processes sharing the card (each given CLI_PROCESS_TIMEOUT s).
PARALLEL_SHARDS = 4
PARALLEL_SWEEP_QBERS, PARALLEL_SWEEP_TRIALS = [0.04, 0.05, 0.06], 1024
NODE_BATCH, NODE_POINT_TRIALS = 128, 512
PARALLEL_NODE_MESHES = ((1, 2), (2, 2))
CLI_PROCESS_TRIALS, CLI_PROCESS_TIMEOUT = 1000, 180
# The qc_node phase: the QC node-sharded decoder (routing "auto") on
# (trial x node) meshes of the card, NODE_BATCH flagship frames; (1 x 3) pads
# one dummy block (nb_s = 7).  Its sweep point on (2 x 2), NODE_POINT_TRIALS
# trials.  Then one (1 x 2) row whose two shards lie in two processes sharing
# the card (each given ROW_PROCESS_TIMEOUT s).
QC_NODE_MESHES = ((1, 2), (2, 2), (1, 3))
ROW_PROCESS_TIMEOUT = 300


def _time_ms(torch, fn, flush, repeats=20, warmup=3, prepare=None):
    """Median time of ``fn`` in ms by CUDA events, L2 flushed before each run;
    ``prepare`` (optional) runs before the flush, outside the timed window."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(repeats):
        if prepare is not None:
            prepare()
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _bound(n_bytes, n_ops, ops_per_s=FP32_OPS_PER_S):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _dequant(torch, q, scale):
    x = q.to(torch.float32)
    return x * scale if scale is not None else x


def _compare_messages(torch, got, ref, dtype_name, algorithm, scale):
    """Kernel vs plain version for one check-update call.  Returns
    (max_abs_err, n_differing).  Min-sum has no transcendentals and must be
    equal.  Sum-product: float32 within rtol 1e-5 / atol 1e-5, or within 16 ulps
    of the leave-one-out product x (``tanhf`` and ``log1pf`` may differ by
    ulps between the two code paths); bfloat16 / int8
    equal except where that float32 difference crosses a rounding boundary —
    there by at most one storage step (2^-7 relative for bfloat16, one LSB for
    int8), on at most 1e-3 of the entries."""
    a, b = _dequant(torch, got, scale), _dequant(torch, ref, scale)
    if not bool(torch.isfinite(a).eq(torch.isfinite(b)).all()):
        raise AssertionError("infinities at different places")
    fin = torch.isfinite(b)
    if not bool((a[~fin] == b[~fin]).all()):
        raise AssertionError("infinities of different sign")
    diff = (a[fin] - b[fin]).abs()
    max_err = float(diff.max()) if diff.numel() else 0.0
    n_diff = int((diff > 0).sum())
    if algorithm == "min-sum":
        if n_diff:
            raise AssertionError(f"min-sum kernel differs on {n_diff} entries")
        return max_err, n_diff
    mag = torch.maximum(a[fin].abs(), b[fin].abs())
    if dtype_name == "float32":
        # 2 atanh(x) amplifies an ulp of x without limit as |x| -> 1: beyond
        # the plain tolerance, 16 float32 ulps of x after mapping back.
        x_gap = (torch.tanh(a[fin].double() / 2) - torch.tanh(b[fin].double() / 2)).abs()
        tol = torch.where(x_gap <= 16 * 2.0**-24, diff, 1e-5 + 1e-5 * mag)
    elif dtype_name == "bfloat16":
        tol = mag * 2.0**-7
    else:
        tol = torch.full_like(mag, scale)
    if bool((diff > tol).any()):
        raise AssertionError(
            f"sum-product/{dtype_name}: max abs err {max_err} beyond tolerance"
        )
    if dtype_name != "float32" and n_diff > 1e-3 * diff.numel():
        raise AssertionError(
            f"sum-product/{dtype_name}: {n_diff} of {diff.numel()} entries "
            "differ by a storage step (bound 1e-3)"
        )
    return max_err, n_diff


def _compare_sweep(torch, got, ref, act, dtype_name, algorithm, scale, dv):
    """Kernel vs plain version for one layered sweep: ``(t, Lr, ok)`` each.
    Returns (max_abs_err over t and Lr, entries differing).  Min-sum: t and Lr
    equal, ok equal on active frames.  Sum-product: Lr by
    :func:`_compare_messages`' rule; a total is its old value plus at most
    ``dv`` message differences, so t agrees within ``dv`` times the largest Lr
    difference found (plus float32 rounding of the sum, 1e-5 relative); ok is
    equal on every active frame whose decisions ``t <= 0`` are equal.  The
    kernel leaves an inactive frame untouched and reports its ok as False."""
    (t_k, lr_k, ok_k), (t_p, lr_p, ok_p) = got, ref
    lr_err, n_diff = _compare_messages(torch, lr_k, lr_p, dtype_name, algorithm, scale)
    t_diff = (t_k - t_p).abs()
    t_err = float(t_diff.max())
    n_diff += int((t_diff > 0).sum())
    if algorithm == "min-sum":
        if t_err:
            raise AssertionError(f"min-sum sweep: totals differ by {t_err}")
        same = act
    else:
        if bool((t_diff > dv * lr_err + 1e-5 * (1.0 + t_p.abs())).any()):
            raise AssertionError(
                f"sum-product/{dtype_name} sweep: totals differ by {t_err}, "
                f"messages by {lr_err}")
        same = act & ((t_k <= 0) == (t_p <= 0)).all(dim=2).all(dim=0)
    if not bool((ok_k[same] == ok_p[same]).all()):
        raise AssertionError("sweep kernel's ok differs on an active frame")
    if bool(ok_k[~act].any()):
        raise AssertionError("sweep kernel reported ok for an inactive frame")
    return max(t_err, lr_err), n_diff


def _kernel_resources(log, kernel, instance):
    """Registers, stack frame and spills of one kernel instance, from ptxas's
    report in the build log (``instance``: a regex of its template arguments)."""
    import re

    m = re.search(r"Compiling entry function '\S*" + kernel + instance
                  + r"\S*'(.*?)Used (\d+) registers", log, re.S)
    if m is None:
        raise AssertionError(f"no ptxas report for {kernel}<{instance}>")
    frame = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores", m.group(1))
    return {"registers_per_thread": int(m.group(2)),
            "stack_frame_bytes": int(frame.group(1)) if frame else None,
            "spill_store_bytes": int(frame.group(2)) if frame else None}


def _sweep_kernel_resources(log, instance):
    """Registers per thread of one sweep-kernel instance, from ptxas's report
    in the build log, and the blocks of ``threads`` threads and ``shared``
    bytes an SM then holds (64 Ki registers, 2048 threads, 32 blocks, 227 KiB
    + 1 KiB per block).  ``instance`` = (template argument string, threads,
    shared)."""
    template, threads, shared = instance
    regs = _kernel_resources(log, "layered_sweep_kernel", "I" + template + "E")[
        "registers_per_thread"]
    per_warp = -(-regs * 32 // 256) * 256  # allocated per warp in units of 256
    limits = {"by_registers": 65536 // (per_warp * threads // 32),
              "by_threads": 2048 // threads, "by_block_slots": 32,
              "by_shared_memory": (228 * 1024) // (shared + 1024)}
    return {"registers_per_thread": regs, "blocks_per_sm": min(limits.values()),
            **limits}


def _profile_path(torch, path, step, card, untraced_ms, iteration_starts=None,
                  keygen_launches=0):
    """``--profile``: trace one path and print the device time by kernel
    name and the device-busy share of the UNTRACED run's wall time (tracing
    slows the host, not the kernels).  The first traced run absorbs the
    tracer's start-up; both runs do the same work, so totals are halved.

    ``iteration_starts`` = (class, method name) of the call that opens a
    graph replay (a decode, or a continuation step's segment passes): it is
    wrapped to leave a marker in the trace, and the host's launch calls
    (graph launches, kernels, copies and fills) are counted between one
    marker and the next.  Their median is the host calls one replay window
    costs (the replay and what the host launches up to the next one),
    counted and not derived.
    """
    import bisect

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    if iteration_starts is not None:
        owner, method = iteration_starts
        real = getattr(owner, method)

        def marked(*args, **kwargs):
            with record_function("decode_iteration_starts"):
                pass
            return real(*args, **kwargs)

        setattr(owner, method, marked)
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(2):
                step()
                torch.cuda.synchronize()
    finally:
        if iteration_starts is not None:
            setattr(owner, method, real)
    rows, marks, calls = {}, [], []
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            ms, count = rows.get(ev.name, (0.0, 0))
            rows[ev.name] = (ms + ev.device_time / 1e3 / 2, count + 0.5)
        elif ev.name == "decode_iteration_starts":
            marks.append(ev.time_range.start)
        elif ev.name.startswith(("cudaLaunchKernel", "cudaMemcpyAsync", "cudaMemsetAsync",
                                 "cudaGraphLaunch")):
            calls.append(ev.time_range.start)
    if not rows:
        raise AssertionError("the profiler recorded no device time")
    table = sorted(((ms, c, k) for k, (ms, c) in rows.items()), reverse=True)
    busy_ms = sum(r[0] for r in table)
    n_launches = sum(r[1] for r in table)
    per_iteration = None
    if iteration_starts is not None:
        marks.sort()
        calls.sort()
        if len(marks) < 3 or not calls:
            raise AssertionError("the trace holds no iteration markers or launch calls")
        windows = [bisect.bisect_left(calls, hi) - bisect.bisect_left(calls, lo)
                   for lo, hi in zip(marks, marks[1:])]
        per_iteration = {
            "replays_traced": len(marks) / 2,
            "launches_median": statistics.median(windows),
            "launches_lowest": min(windows),
            "share_of_windows_at_median": windows.count(
                statistics.median(windows)) / len(windows),
            "whole_path_less_keygen": (n_launches - keygen_launches) / (len(marks) / 2),
        }
    # Where the host's time goes: operators by their own CPU time, under tracing.
    host = sorted(((a.self_cpu_time_total / 1e3 / 2, a.count / 2, a.key)
                   for a in prof.key_averages()), reverse=True)
    print(json.dumps({"profile": {
        "path": path, "card": card, "untraced_wall_ms": untraced_ms,
        "device_busy_ms": busy_ms, "device_busy_share": busy_ms / untraced_ms,
        "kernel_launches": n_launches, "keygen_launches": keygen_launches,
        "host_calls_per_replay": per_iteration,
        "by_kernel_ms_count_name": [[round(m, 4), c, k[:100]] for m, c, k in table[:30]],
        "traced_host_self_ms_count_op": [[round(m, 3), c, k[:60]] for m, c, k in host[:12]],
    }}), flush=True)
    return n_launches


def _channel_kernels(torch, dev, flush, point_key, n, n_err, wide_n, wide_err, gen):
    """K4 and K3 against their plain versions on the card, bit for bit, then
    timed at the flagship shape.  K4: every id form (a range, with and without
    the wrap at 2**32, an id tensor, a device range whose base lies on the
    card) and all three rows, and a point key on the card (int64 words, and
    int32 raw words as a captured chunk holds it).  K3: the real flagship
    rows, crafted tie rows (excess and not), a per-row k (with and without
    Alice's row), k as one int32 on the card, and each of its six instances.
    Both timed in the forms the captured trial chunk launches (key, first id
    and k read on the card), the host-argument forms beside them.  Returns
    (K4 entry, K3 entry, details)."""
    import ctypes

    from qkd_ldpc_tpu_torch import _build
    from qkd_ldpc_tpu_torch.channel import cuda_prng, cuda_select, keys
    from qkd_ldpc_tpu_torch.channel.cuda_prng import ALICE, SCORES, TIES
    from qkd_ldpc_tpu_torch.channel.threefry import flip_sign, to_raw_int32

    all_rows = (ALICE, SCORES, TIES)

    def differ(got, ref):
        """(max abs difference, entries differing) of two tuples of tensors."""
        err, n_diff = 0, 0
        for g, r in zip(got, ref):
            if (g is None) != (r is None):
                raise AssertionError("kernel and plain version return different outputs")
            if g is None:
                continue
            if g.shape != r.shape or g.dtype != r.dtype:
                raise AssertionError(f"shape/dtype {g.shape} {g.dtype} != {r.shape} {r.dtype}")
            d = (g.to(torch.int64) - r.to(torch.int64)).abs()
            err, n_diff = max(err, int(d.max())), n_diff + int((d > 0).sum())
        return err, n_diff

    # ---- K4 ---------------------------------------------------------------
    id_forms = {
        "range": range(0, BATCH),
        "range_wrapping": range(2**32 - BATCH // 2, 2**32 + BATCH // 2),
        "id_tensor": torch.randint(0, 2**32, (BATCH,), device=dev, generator=gen,
                                   dtype=torch.int64),
    }
    base = to_raw_int32(torch.tensor([2**32 - BATCH // 2], dtype=torch.int64, device=dev))
    id_forms["device_range_wrapping"] = cuda_prng.DeviceRange(base, range(0, BATCH))
    k4_cases = {}
    for form, ids in id_forms.items():
        for rows in (all_rows, (ALICE, SCORES), (TIES,)):
            got = cuda_prng.trial_words_cuda(point_key, n, ids, rows, dev)
            ref = cuda_prng.trial_words_plain(point_key, n, ids, rows, dev)
            torch.cuda.synchronize()
            k4_cases[f"{form}:{'+'.join(rows)}"] = differ(got, ref)
    # a key on the card, read there by the kernel: int64 words, int32 raw words
    for form, key in (("int64", point_key.to(dev)), ("raw_int32", to_raw_int32(point_key).to(dev))):
        got = cuda_prng.trial_words_cuda(key, n, range(0, BATCH), all_rows, dev)
        ref = cuda_prng.trial_words_plain(point_key, n, range(0, BATCH), all_rows, dev)
        torch.cuda.synchronize()
        k4_cases[f"range:point_key_on_card_{form}"] = differ(got, ref)
    k4_err = max(e for e, _ in k4_cases.values())
    k4_diff = sum(d for _, d in k4_cases.values())
    if k4_err or k4_diff:
        raise AssertionError(f"trial_words kernel differs from its plain version: {k4_cases}")
    host_args = (point_key, n, range(0, BATCH), (ALICE, SCORES), dev)
    # as the captured chunk launches it: key words and first id on the card
    x_key = to_raw_int32(point_key).to(dev)
    x_first = torch.zeros(1, dtype=torch.int32, device=dev)
    main = (x_key, n, cuda_prng.DeviceRange(x_first, range(0, BATCH)), (ALICE, SCORES), dev)
    k4_bytes = BATCH * n * (1 + 4)  # Alice's bits as bytes, the scores as words
    k4_ops = OPS_PER_THREEFRY * (2 * BATCH * n + 3 * BATCH)  # + 3 key blocks a trial
    k4_bound, k4_by = _bound(k4_bytes, k4_ops)
    k4 = {
        "max_abs_err": k4_err, "entries_differing": k4_diff, "cases": len(k4_cases),
        "bound_ms": k4_bound, "bound_by": k4_by, "bytes": k4_bytes, "operations": k4_ops,
        "bound_ms_at_int32_rate": _bound(k4_bytes, k4_ops, INT32_OPS_PER_S)[0],
        "ms": _time_ms(torch, lambda: cuda_prng.trial_words_cuda(*main), flush),
        "host_arguments_ms": _time_ms(
            torch, lambda: cuda_prng.trial_words_cuda(*host_args), flush),
        "plain_ms": _time_ms(torch, lambda: cuda_prng.trial_words_plain(*main), flush,
                             repeats=5, warmup=1),
        "library_ms": None,
    }

    # ---- K3 ---------------------------------------------------------------
    alice, scores = cuda_prng.trial_words_cuda(*main)
    # Crafted rows at the flagship width, k = n_err: rows 0-15 as drawn (no
    # ties), 16-31 cut to their top 12 bits (ties everywhere), 32-47 with
    # n_at == need, 48-63 with excess ties (index order decides); a quarter of
    # the short and of the wide rows of each of the last two kinds.
    def craft_ties(s, k, rows_at_need, rows_excess):
        """Copy the k-th smallest score of a row over its (k-1)-th smallest
        (n_at == need == 2) or over its (k+1)-th smallest (n_at = 2 > need)."""
        vals, idx = flip_sign(s).sort(dim=1)
        for rows, j in ((rows_at_need, k - 2), (rows_excess, k)):
            r = torch.arange(*rows, device=dev)
            s[r, idx[r, j]] = flip_sign(vals[r, k - 1])
        return s

    tie_s = scores[:64].clone()
    tie_s[16:32] &= -(1 << 20)
    craft_ties(tie_s, n_err, (32, 48), (48, 64))
    k_dev = torch.tensor([n_err], dtype=torch.int32, device=dev)  # a chunk's error count
    k_rows = torch.randint(1, n + 1, (BATCH,), device=dev, generator=gen, dtype=torch.int32)
    k_rows[:2] = torch.tensor([1, n], device=dev, dtype=torch.int32)
    wide_a, wide_s = cuda_prng.trial_words_cuda(point_key, wide_n, range(0, WIDE_BATCH),
                                                (ALICE, SCORES), dev)
    craft_ties(wide_s, wide_err, (0, WIDE_BATCH // 4), (WIDE_BATCH // 4, WIDE_BATCH // 2))
    short_err = keys.num_errors_for(SHORT_N, QBER)
    short_a, short_s = cuda_prng.trial_words_cuda(point_key, SHORT_N, range(0, 64),
                                                  (ALICE, SCORES), dev)
    craft_ties(short_s, short_err, (0, 16), (16, 32))
    a_off = torch.empty(64 * n + 1, dtype=torch.uint8, device=dev)[1:].view(64, n)
    a_off.copy_(alice[:64])
    width_of = _build.function("kth_smallest", "select_flip_width", [ctypes.c_int])
    vector_of = _build.function("kth_smallest", "select_flip_vector",
                                [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                                 ctypes.c_void_p])

    def instance(s, a):
        """(groups a thread holds, words a group) of the kernel instance the
        launcher picks for these rows; 0 groups = rows re-read from memory."""
        p = None if a is None else a.data_ptr()
        w, v = width_of(s.shape[-1]), vector_of(s.shape[-1], s.data_ptr(), p, p)
        return w // v, v

    def odd(x):  # one word narrower: single-word accesses
        return x[:, 1:].contiguous()

    k3_inputs = {
        "flagship": (scores, n_err, alice),
        "crafted_ties": (tie_s, n_err, alice[:64]),
        "per_row_k": (scores, k_rows, alice),
        "k_on_card": (scores, k_dev, alice),
        "crafted_ties_k_on_card": (tie_s, k_dev, alice[:64]),
        "per_row_k_threshold_only": (scores, k_rows, None),
        "k_zero": (scores[:8], 0, alice[:8]),
        # single-word accesses: a width not a multiple of 4, an unaligned Alice
        "crafted_ties_odd_width": (odd(tie_s), n_err, odd(alice[:64])),
        "crafted_ties_unaligned": (tie_s, n_err, a_off),
        "short_rows": (short_s, short_err, short_a),
        "short_rows_odd_width": (odd(short_s), short_err, odd(short_a)),
        "wide_rows": (wide_s, wide_err, wide_a),
        "wide_rows_odd_width": (odd(wide_s), wide_err, odd(wide_a)),
        "wide_rows_per_row_k_threshold_only": (
            wide_s, k_rows[:WIDE_BATCH] * (wide_n // n), None),
    }
    instances = {name: instance(s, a) for name, (s, _, a) in k3_inputs.items()}
    if (instances["flagship"], instances["crafted_ties_odd_width"],
            instances["crafted_ties_unaligned"], instances["short_rows"],
            instances["short_rows_odd_width"], instances["wide_rows"],
            instances["wide_rows_odd_width"]) != (
            (5, 4), (20, 1), (20, 1), (2, 4), (8, 1), (0, 4), (0, 1)):
        raise AssertionError(f"the rows did not take the expected instances: {instances}")
    k3_cases, flags = {}, {}
    for name, (s, k, a) in k3_inputs.items():
        got = cuda_select.select_flip_cuda(s, k, a)
        ref = cuda_select.select_flip_plain(s, k, a)
        torch.cuda.synchronize()
        k3_cases[name] = differ(got, ref)
        if a is not None:
            flags[name] = bool(ref[2])
    # The second-word tie path end to end on the crafted rows: K4's tie row,
    # K3's per-row k threshold and the plain passes between them, against the
    # same path through the plain versions.
    tie_words = cuda_prng.trial_words_cuda(point_key, n, range(0, 64), (TIES,), dev)[0]
    tie_bob = keys._exact_weight_flip(tie_s, alice[:64], n_err, lambda: tie_words)
    tie_ref = keys._exact_weight_flip(tie_s, alice[:64], n_err, lambda: tie_words, "xla")
    index_bob = cuda_select.select_flip_cuda(tie_s, n_err, alice[:64])[1]
    torch.cuda.synchronize()
    k3_cases["tie_path"] = differ((tie_bob,), (tie_ref,))
    if torch.equal(tie_bob, index_bob) or not bool(
            ((tie_bob ^ alice[:64]).sum(dim=1) == n_err).all()):
        raise AssertionError("the tie path did not rank the excess ties by the second word")
    k3_err = max(e for e, _ in k3_cases.values())
    k3_diff = sum(d for _, d in k3_cases.values())
    if k3_err or k3_diff:
        raise AssertionError(f"kth_smallest kernel differs from its plain version: {k3_cases}")
    if not all(flags[c] for c in (
            "crafted_ties", "crafted_ties_k_on_card", "crafted_ties_odd_width",
            "crafted_ties_unaligned",
            "short_rows", "short_rows_odd_width", "wide_rows", "wide_rows_odd_width")) or (
            flags["k_zero"]):
        raise AssertionError(f"the crafted rows do not reach the tie branch: {flags}")
    lib_thr = torch.kthvalue(flip_sign(scores), n_err, dim=-1, keepdim=True).values
    thr = cuda_select.select_flip_cuda(scores, n_err, alice)[0]
    if not bool((flip_sign(thr) == lib_thr).all()):
        raise AssertionError("the kernel's threshold differs from torch.kthvalue")
    flipped = flip_sign(scores)
    k3_bytes = BATCH * n * (4 + 1 + 1) + BATCH * 4 + 4  # scores, Alice, Bob; t, flag
    k3_ops = OPS_PER_SCORE_SELECT * BATCH * n
    k3_bound, k3_by = _bound(k3_bytes, k3_ops)
    k3 = {
        "max_abs_err": k3_err, "entries_differing": k3_diff, "cases": len(k3_cases),
        "bound_ms": k3_bound, "bound_by": k3_by, "bytes": k3_bytes, "operations": k3_ops,
        "bound_ms_at_int32_rate": _bound(k3_bytes, k3_ops, INT32_OPS_PER_S)[0],
        # as the captured chunk calls it (k read on the card): the flag's fill
        # (about 1 us) included
        "ms": _time_ms(torch, lambda: cuda_select.select_flip_cuda(scores, k_dev, alice),
                       flush),
        "host_argument_ms": _time_ms(
            torch, lambda: cuda_select.select_flip_cuda(scores, n_err, alice), flush),
        "threshold_only_ms": _time_ms(
            torch, lambda: cuda_select.select_flip_cuda(scores, n_err), flush),
        "wide_rows_ms": _time_ms(
            torch, lambda: cuda_select.select_flip_cuda(wide_s, wide_err, wide_a), flush),
        "plain_ms": _time_ms(
            torch, lambda: cuda_select.select_flip_plain(scores, n_err, alice), flush,
            repeats=5, warmup=1),
        "library_ms": _time_ms(
            torch, lambda: torch.kthvalue(flipped, n_err, dim=-1), flush,
            repeats=5, warmup=1),
    }
    log = _build.build_log("kth_smallest")
    details = {
        "trial_words_cases": k4_cases, "kth_smallest_cases": k3_cases,
        "excess_ties_flag": flags,
        "select_flip_instance_groups_words": instances,
        "select_flip_resources": {
            f"groups_{g}_of_{v}_words": _kernel_resources(
                log, "select_flip_kernel", f"ILi{g}ELi{v}E")
            for g, v in sorted(set(instances.values()), reverse=True)},
        "trial_rows_resources": _kernel_resources(
            _build.build_log("threefry_words"), "trial_rows_kernel", ""),
    }
    return k4, k3, details


def _flooding_inputs(torch, dev, gen, code, width, dtype_name, scale):
    """Random state of the two flooding kernels on ``code`` at batch ``width``."""
    from qkd_ldpc_tpu_torch.decoder import cuda_kernels
    from qkd_ldpc_tpu_torch.decoder.syndrome import syndrome

    N, M, dc = code.n_vars, code.n_checks, code.dc_max
    mdt = cuda_kernels.STORAGE_DTYPES[dtype_name]

    def rand(*shape):
        return torch.randn(shape, device=dev, generator=gen)

    def flags(p):
        return torch.rand((width,), device=dev, generator=gen) < p

    tot = cuda_kernels._store(4.0 * rand(N, width), mdt, scale)
    # The target of frame 0 is the syndrome of its own decisions, so its ok
    # flag is True; the other frames' targets are random bits.
    syn = (torch.rand((M, width), device=dev, generator=gen) < 0.5).to(torch.int8)
    z0 = (cuda_kernels._load(tot[:, 0], scale) <= 0).to(torch.uint8)
    syn[:, 0] = syndrome(code, z0[None, :])[0].to(torch.int8)
    return dict(
        tot=tot, lrp=cuda_kernels._store(2.0 * rand(dc, M, width), mdt, scale),
        syn=syn, llr=4.0 * rand(N, width), fresh=flags(0.4), active=flags(0.7),
        z=torch.full((N, width), 7, dtype=torch.int8, device=dev),
        count=torch.arange(width, dtype=torch.int32, device=dev))


def _check_modes(kw, fresh):
    """(kernel name, first, keyword arguments) of K1, K2 and K5 = K2 with a
    mixed fresh mask and a clip that bites."""
    from qkd_ldpc_tpu_torch.decoder import cuda_kernels

    return (
        (cuda_kernels.KERNEL_FIRST, True, dict(kw, first=True)),
        (cuda_kernels.KERNEL_FUSED, False, dict(kw, first=False)),
        (cuda_kernels.KERNEL_FRESH, False,
         dict(kw, first=False, fresh=fresh, threshold=FRESH_THRESHOLD)),
    )


def _compare_check(torch, x, code_maps, own_maps, first, mode, dtype_name, algorithm,
                   scale):
    """One check update, kernel against plain: messages by
    :func:`_compare_messages`; the syndrome flag has no transcendentals and
    must be equal, also with the flag buffer handed in as the loops do.
    ``own_maps``: the maps are those of the code whose syndrome made frame 0's
    target, so its flag must be set (and not every flag is)."""
    from qkd_ldpc_tpu_torch.decoder import cuda_kernels

    args = (x["tot"], None if first else x["lrp"], x["syn"], code_maps)
    got, ok = cuda_kernels.check_update_cuda(*args, **mode)
    ref, ok_ref = cuda_kernels.check_update_plain(*args, **mode)
    if not first:
        buf = torch.ones_like(ok)
        got_b, ok_b = cuda_kernels.check_update_cuda(*args, ok=buf, **mode)
        if ok_b is not buf or not bool((ok_b == ok).all() & (got_b == got).all()):
            raise AssertionError("the check kernel differs with a flag buffer")
    torch.cuda.synchronize()
    if not first:
        if not bool((ok == ok_ref).all()):
            raise AssertionError("the check kernel's syndrome flag differs")
        if "fresh" in mode:
            if bool(ok[x["fresh"]].any()):
                raise AssertionError("ok set on a fresh frame")
        elif own_maps and (not bool(ok[0]) or bool(ok.all())):
            raise AssertionError("the syndrome flags do not discriminate")
    return _compare_messages(torch, got, ref, dtype_name, algorithm, scale)


def _compare_variable(torch, x, code_maps, scale):
    """The variable update, kernel against plain: totals, decisions and
    counts, all exact (no transcendentals); inactive frames untouched."""
    from qkd_ldpc_tpu_torch.decoder import cuda_kernels

    z_k, count_k = x["z"].clone(), x["count"].clone()
    got = cuda_kernels.variable_update_cuda(
        x["lrp"], x["llr"], z_k, count_k, x["active"], code_maps, scale=scale)
    ref = cuda_kernels.variable_update_plain(
        x["lrp"], x["llr"], x["z"], x["count"], x["active"], code_maps, scale=scale)
    torch.cuda.synchronize()
    if got[1] is not z_k or got[2] is not count_k:
        raise AssertionError("the variable kernel does not update in place")
    if not bool(got[3].all()):
        raise AssertionError("the variable kernel left a flag unset")
    n_diff = sum(int((g != r).sum()) for g, r in zip(got, ref))
    err = float((cuda_kernels._load(got[0], scale)
                 - cuda_kernels._load(ref[0], scale)).abs().max())
    if n_diff or not bool((z_k[:, ~x["active"]] == 7).all()):
        raise AssertionError(f"variable_update differs on {n_diff} entries")
    return err, n_diff


def _require_exact(what, err, n_diff):
    """The kernels equal their plain versions bit for bit wherever they run the
    same arithmetic: any difference, even one a tolerance would admit, fails."""
    if err != 0.0 or n_diff:
        raise AssertionError(f"{what}: max abs err {err}, {n_diff} entries differ "
                             "from the plain version")


def _f1_degrees(torch, np, dev, gen, flush, card, copy_bytes_per_s):
    """Fault F1 closed: K1, K2, K5 and the variable update against their plain
    versions at every check degree of ``F1_CODES`` and the dense matrices
    (sum-product and min-sum x float32, bfloat16 and int8, vector and scalar
    instances), then K6 at base-row degrees 15 and 60 with its totals in shared
    and in global memory; every holding exact.  K2 timed at degrees 12, 15 and
    60, K6 at 15 and 60 (sum-product, bfloat16, B = 512); ptxas's registers and
    spills of the check kernel's fused sum-product instances.  Returns the
    line's dict and the degrees held."""
    from qkd_ldpc_tpu_torch import _build
    from qkd_ldpc_tpu_torch.channel.keys import make_trial_batch, derive_point_key
    from qkd_ldpc_tpu_torch.codes import make_code, make_qc_code, read_dense
    from qkd_ldpc_tpu_torch.decoder import cuda_kernels, cuda_layered, layered
    from qkd_ldpc_tpu_torch.decoder.reconcile import apriori_llr
    from qkd_ldpc_tpu_torch.decoder.syndrome import syndrome

    t0 = time.perf_counter()
    dense_dir = Path(__file__).resolve().parent / "data" / "dense_matrices"
    codes = [make_code(n=n, m=m, dv=dv, seed=5) for n, m, dv in F1_CODES]
    codes += [read_dense(p) for p in sorted(dense_dir.glob("*.txt"))]
    cells, timed = [], {}
    for code in codes:
        maps = code.to_device(dev)
        padded = not bool(code.chk_mask.all())
        worst, n_diff, n_calls = 0.0, 0, 0
        for algorithm in ("sum-product", "min-sum"):
            for dtype_name in ("float32", "bfloat16", "int8"):
                scale = 0.25 if dtype_name == "int8" else None
                mdt = cuda_kernels.STORAGE_DTYPES[dtype_name]
                kw = dict(threshold=100.0, clip=True, algorithm=algorithm,
                          min_sum_alpha=0.8, min_sum_beta=0.0, scale=scale)
                for width in F1_WIDTHS:
                    x = _flooding_inputs(torch, dev, gen, code, width, dtype_name, scale)
                    vec = cuda_kernels.vector_width("check_update", width, mdt, x["tot"])
                    if (vec > 1) != (width == COMPACT_BATCH):
                        raise AssertionError(f"B = {width} took the wrong instance")
                    for name, first, mode in _check_modes(kw, x["fresh"]):
                        err, nd = _compare_check(torch, x, maps, True, first, mode,
                                                 dtype_name, algorithm, scale)
                        _require_exact(f"{name} on {code.name} (dc_max {code.dc_max}), "
                                       f"{algorithm} {dtype_name} B={width}", err, nd)
                        worst, n_diff, n_calls = max(worst, err), n_diff + nd, n_calls + 1
                    if algorithm == "sum-product":
                        err, nd = _compare_variable(torch, x, maps, scale)
                        _require_exact(f"variable update on {code.name}, {dtype_name} "
                                       f"B={width}", err, nd)
                        worst, n_diff, n_calls = max(worst, err), n_diff + nd, n_calls + 1
                    del x
        cells.append({"code": code.name, "dc_max": code.dc_max, "padded_slots": padded,
                      "calls": n_calls, "max_abs_err": worst, "entries_differing": n_diff})
        if code.dc_max in F1_TIMED_DEGREES:  # K2 as the main path runs it
            kw = dict(threshold=100.0, clip=True, algorithm="sum-product",
                      min_sum_alpha=0.8, min_sum_beta=0.0, scale=None)
            x = _flooding_inputs(torch, dev, gen, code, BATCH, "bfloat16", None)
            args = (x["tot"], x["lrp"], x["syn"], maps)
            buf = torch.ones((BATCH,), dtype=torch.bool, device=dev)
            ms = _time_ms(torch, lambda: cuda_kernels.check_update_cuda(
                *args, ok=buf, first=False, **kw), flush, prepare=lambda: buf.fill_(True))
            plain_ms = _time_ms(torch, lambda: cuda_kernels.check_update_plain(
                *args, first=False, **kw), flush, repeats=3, warmup=1)
            N, M, dc = code.n_vars, code.n_checks, code.dc_max
            n_edge = dc * M * BATCH
            n_bytes = N * BATCH * 2 + 2 * n_edge * 2 + M * BATCH + 2 * dc * M * 4 + BATCH
            bound_ms, bound_by = _bound(n_bytes, (OPS_PER_EDGE["sum-product"]
                                                  + OPS_PER_EDGE_SYNDROME) * n_edge)
            timed[f"check_update_fused_dc{dc}"] = {
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                "bytes": n_bytes, "bound_ms_at_copy_rate": n_bytes / copy_bytes_per_s * 1e3}
            del x, args, buf

    # K6 at base-row degrees 15 and 60, shared and global totals.
    point_key = derive_point_key(MASTER_SEED, POINT_INDEX)
    sweeps = []
    for z, nb, mb in F1_LAYERED_CODES:
        qc = make_qc_code(z=z, nb=nb, mb=mb, dv=DV, seed=CODE_SEED)
        tables = layered.layer_tables(qc, dev)
        ncells = tables.col.shape[0]
        shared = cuda_layered.totals_in_shared_memory(nb, z, mb, ncells)
        width = BATCH if shared else F1_LAYERED_WIDE_BATCH
        n_err = int(qc.n_vars * QBER)
        a, b = make_trial_batch(point_key, qc.n_vars, width, n_err, 0, device=dev)
        llr = apriori_llr(b, np.float32(n_err) / np.float32(qc.n_vars)).T
        syn = syndrome(qc, a).T
        act = torch.rand((width,), device=dev, generator=gen) < 0.7
        act_all = torch.ones_like(act)
        worst, n_diff = 0.0, 0
        for algorithm in ("sum-product", "min-sum"):
            for dtype_name in ("float32", "bfloat16", "int8"):
                scale = 0.25 if dtype_name == "int8" else None
                kw = dict(threshold=100.0, clip=True, algorithm=algorithm,
                          min_sum_alpha=0.8, min_sum_beta=0.0, scale=scale)
                t_s, lr_s, syn3 = layered.initial_state(
                    tables, llr, syn, cuda_kernels.STORAGE_DTYPES[dtype_name])
                t_s, lr_s, _ = layered.layered_sweep_plain(
                    t_s, lr_s, syn3, act_all, tables, **kw)
                ref = layered.layered_sweep_plain(t_s, lr_s, syn3, act, tables, **kw)
                got = cuda_layered.layered_sweep_cuda(
                    t_s.clone(), lr_s.clone(), syn3, act, tables, **kw)
                torch.cuda.synchronize()
                err, nd = _compare_sweep(torch, got, ref, act, dtype_name, algorithm,
                                         scale, DV)
                _require_exact(f"layered sweep on {qc.name} (row degree "
                               f"{tables.max_row_degree}, shared {shared}), {algorithm} "
                               f"{dtype_name}", err, nd)
                worst, n_diff = max(worst, err), n_diff + nd
                if shared and (algorithm, dtype_name) == ("sum-product", "bfloat16"):
                    t_w, lr_w = t_s.clone(), lr_s.clone()
                    ms = _time_ms(torch, lambda: cuda_layered.layered_sweep_cuda(
                        t_w, lr_w, syn3, act_all, tables, **kw), flush)
                    plain_ms = _time_ms(torch, lambda: layered.layered_sweep_plain(
                        t_s, lr_s, syn3, act_all, tables, **kw), flush, repeats=3,
                        warmup=1)
                    n_edge = ncells * z * width
                    n_bytes = width * (2 * nb * z * 4 + 2 * ncells * z * 2 + mb * z + 2)
                    bound_ms, bound_by = _bound(n_bytes, (
                        OPS_PER_EDGE[algorithm] + OPS_PER_EDGE_LAYERED_EXTRA) * n_edge)
                    timed[f"layered_sweep_row_degree{tables.max_row_degree}"] = {
                        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                        "bound_by": bound_by, "bytes": n_bytes,
                        "bound_ms_at_copy_rate": n_bytes / copy_bytes_per_s * 1e3}
                    del t_w, lr_w
                del t_s, lr_s, syn3, ref, got
        sweeps.append({"code": qc.name, "row_degree": tables.max_row_degree,
                       "totals_in_shared_memory": shared, "batch": width,
                       "max_abs_err": worst, "entries_differing": n_diff})
        del a, b, llr, syn
    resources = {}
    for dtype_name in cuda_kernels.STORAGE_DTYPES:
        library = "check_update_" + dtype_name
        log, vec = _build.build_log(library), _build.constant(
            library, "check_update_vector_width")
        for dc in F1_RESOURCE_DEGREES:  # <sum-product, not FIRST, DC, VEC>
            resources[f"{dtype_name}_dc{dc}_vec{vec}"] = _kernel_resources(
                log, "check_update_kernel", f"ILi0ELb0ELi{dc}ELi{vec}EE")
        resources[f"{dtype_name}_loop_vec{vec}"] = _kernel_resources(
            log, "check_update_any_kernel", f"ILi0ELb0ELi{vec}EE")
    line = {"card": card, "flooding": cells, "layered": sweeps, "timed": timed,
            "check_kernel_resources": resources, "seconds": time.perf_counter() - t0}
    flooding_degrees = sorted({c["dc_max"] for c in cells})
    layered_degrees = sorted({c["row_degree"] for c in sweeps})
    return line, flooding_degrees, layered_degrees


def _block_kernel(torch, dev, key, n, n_err, alice, keygen_s):
    """The flat-block kernel (``block_words``, fault D1's repair) against its
    plain version on the protocol's flagship block (``introduce_errors(key,
    alice, n_err)``'s tie block, 512 x 10,240 words): ungated, and gated on
    K3's flag of a forced-tie batch (the scores cut to their top 12 bits:
    excess ties in every row), where the gated block equals the plain block
    and Bob's bits equal the plain tie path's.  Timed ungated, gated off (a
    flag of 0: launch only) and the protocol keys' warm wall.  Returns
    (report, kernel-line measurement)."""
    from qkd_ldpc_tpu_torch.channel import cuda_prng, cuda_select, keys
    from qkd_ldpc_tpu_torch.channel.threefry import fold_in

    B = alice.shape[0]
    count = B * n
    tie_key = fold_in(key, 1)
    got = cuda_prng.block_words_cuda(tie_key, count, dev)
    ref = cuda_prng.block_words_plain(tie_key, count, dev)
    scores = (cuda_prng.block_words_cuda(key, count, dev) & -(1 << 20)).view(B, n)
    _, _, excess = cuda_select.select_flip_cuda(scores, n_err, alice)
    gated = cuda_prng.block_words_cuda(tie_key, count, dev, gate=excess)
    bob = keys._exact_weight_flip(
        scores, alice, n_err, lambda: ref.view(B, n),
        gated_tie_scores=lambda e: keys.block_words(tie_key, (B, n), dev, e))
    bob_plain = keys._exact_weight_flip(scores, alice, n_err, lambda: ref.view(B, n), "xla")
    torch.cuda.synchronize()
    err = max(int((g.to(torch.int64) - ref.to(torch.int64)).abs().max()) for g in (got, gated))
    bits_off = int((bob != bob_plain).sum())
    if int(excess) != 1 or err or bits_off or not bool(
            ((bob ^ alice).sum(dim=1) == n_err).all()):
        raise AssertionError(f"block_words: flag {int(excess)}, words off by {err}, "
                             f"{bits_off} tie-path bits off")
    off = torch.zeros(1, dtype=torch.int32, device=dev)
    flush = torch.empty(1 << 30, dtype=torch.uint8, device=dev)
    bound_ms, bound_by = _bound(4 * count, OPS_PER_THREEFRY * count)
    measured = dict(
        max_abs_err=float(err + bits_off), bound_ms=bound_ms, bound_by=bound_by,
        ms=_time_ms(torch, lambda: cuda_prng.block_words_cuda(tie_key, count, dev), flush),
        plain_ms=_time_ms(torch, lambda: cuda_prng.block_words_plain(tie_key, count, dev),
                          flush, repeats=5, warmup=1),
        library_ms=None)
    report = dict(measured, words=count, forced_tie_flag=1, tie_path_bits_off=bits_off,
                  bound_ms_at_int32_rate=_bound(4 * count, OPS_PER_THREEFRY * count,
                                                INT32_OPS_PER_S)[0],
                  gated_off_ms=_time_ms(torch, lambda: cuda_prng.block_words_cuda(
                      tie_key, count, dev, gate=off), flush),
                  protocol_keys_warm_s=keygen_s())
    return report, measured


def _protocol(torch, np, dev, card, code, names):
    """The protocol surface on the flagship, through the entry points a
    deployed node calls: keys (threefry blocks; Bob's flips by K3), the
    Reconciler (SP/bf16 at 128 and 101 lanes, each against backend="xla":
    min-sum equal per lane, sum-product on decisions and iterations),
    reconcile_secure (keys equal to Alice's amplification), the rate-adapted
    endpoint in flooding and layered, K1/K2/K5/KV and K6 against their plain
    versions on its LLRs (erasures and +-64 pins), a blind session (min-sum,
    equal to backend="xla" per frame) and the four amplification methods
    (bit-equal at the flagship and, blocked ones, at a 262,144-bit frame, 64
    rows against a numpy GF(2) product).  Returns the line's dict."""
    from qkd_ldpc_tpu_torch import _build
    from qkd_ldpc_tpu_torch.channel import (
        generate_random_bits,
        introduce_errors,
        num_errors_for,
    )
    from qkd_ldpc_tpu_torch.channel import cuda_prng
    from qkd_ldpc_tpu_torch.channel.threefry import bernoulli_half, fold_in, prng_key
    from qkd_ldpc_tpu_torch.channel.threefry import random_bits
    from qkd_ldpc_tpu_torch.decoder import (
        DecodeOptions,
        RateAdapter,
        blind_reconcile_sim,
        cuda_kernels,
        cuda_layered,
        layered,
    )
    from qkd_ldpc_tpu_torch.decoder.syndrome import syndrome
    from qkd_ldpc_tpu_torch.postprocess import (
        _DENSE_LIMIT,
        amplified_key_bits,
        privacy_amplify,
        toeplitz_hash,
    )
    from qkd_ldpc_tpu_torch.serve import Reconciler

    K1, K2, K3, K4, K5, K6, KV = names
    KB = cuda_prng.KERNEL_BLOCK
    t_phase = time.perf_counter()
    N, M = code.n_vars, code.n_checks
    key = prng_key(PROTOCOL_SEED)
    base = dict(max_iterations=100, clip_messages=True, message_threshold=100.0,
                message_dtype="bfloat16")

    def counted(fn):
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, _build.launch_counts()

    def keys(k, n_bits, qber):
        a = generate_random_bits(k, n_bits, PROTOCOL_FRAMES, device=dev)
        n_err = num_errors_for(n_bits, qber)
        return a, introduce_errors(fold_in(k, 1), a, n_err), n_err

    (alice_t, bob_t, n_err), keygen_s, keygen_launches = counted(lambda: keys(key, N, QBER))
    alice, bob = alice_t.cpu().numpy(), bob_t.cpu().numpy()
    if keygen_launches.get(K3, 0) < 1 or not ((alice ^ bob).sum(axis=1) == n_err).all():
        raise AssertionError(f"protocol keys: {keygen_launches}")
    q = n_err / N
    # The flat-block kernel: generate_random_bits, introduce_errors' scores and
    # its tie block, which is drawn only where K3's flag is set (read on the card)
    if keygen_launches.get(KB, 0) != 3:
        raise AssertionError(f"protocol keys: {keygen_launches.get(KB, 0)} block launches")
    block, block_measured = _block_kernel(
        torch, dev, fold_in(key, 1), N, n_err, alice_t,
        lambda: _wall(torch, lambda: keys(key, N, QBER)))
    report = {"card": card, "code": code.name, "frames": PROTOCOL_FRAMES, "qber": q,
              "keygen_s": keygen_s, "keygen_launches": keygen_launches,
              "block_words": block}

    # ---- the Reconciler, 128 and 101 lanes, against the plain versions ------
    rec_report = {}
    for lanes in PROTOCOL_LANES:
        outs = {}
        for alg in ("sum-product", "min-sum"):
            for backend in ("auto", "xla"):
                rec = Reconciler(code, DecodeOptions(algorithm=alg, backend=backend, **base),
                                 lanes=lanes, device=dev)
                if backend == "auto":
                    rec.warmup()
                syn = rec.syndromes(alice)
                outs[alg, backend] = counted(lambda: rec.reconcile(bob, syn, q))
        sp, sp_s, sp_launches = outs["sum-product", "auto"]
        if not sp.syndromes_match.all() or not (sp.bits == alice).all():
            raise AssertionError(f"Reconciler at {lanes} lanes: "
                                 f"{int(sp.syndromes_match.sum())} frames verified")
        mean_it = float(sp.iterations.mean())
        if not MEAN_ITERATIONS_GATE[0] <= mean_it <= MEAN_ITERATIONS_GATE[1]:
            raise AssertionError(f"Reconciler: implausible mean iterations {mean_it}")
        chunks = -(-PROTOCOL_FRAMES // lanes)
        if sp_launches.get(K1, 0) != chunks or sp_launches.get(K2, 0) <= 0 or (
                sp_launches.get(KV) != sp_launches.get(K2)) or sp_launches.get(K6, 0):
            raise AssertionError(f"Reconciler launches {sp_launches} for {chunks} chunks")
        ms, ms_plain = outs["min-sum", "auto"][0], outs["min-sum", "xla"][0]
        if any(not np.array_equal(a, b) for a, b in zip(ms, ms_plain)):
            raise AssertionError(f"Reconciler min-sum at {lanes} lanes: kernels != plain")
        sp_plain = outs["sum-product", "xla"][0]
        moved = sp.iterations != sp_plain.iterations
        if not (np.array_equal(sp.bits, sp_plain.bits)
                and np.array_equal(sp.syndromes_match, sp_plain.syndromes_match)) or (
                int(moved.sum()) > SP_ITERATION_SUM_ALLOWANCE) or (
                np.abs(sp.iterations - sp_plain.iterations).max() > 1):
            raise AssertionError(f"Reconciler sum-product at {lanes} lanes: kernels vs plain")
        if sum(outs["sum-product", "xla"][2].values()):
            raise AssertionError("backend='xla' launched a kernel")
        rec_report[lanes] = {
            "sum_product_s": sp_s, "frames_per_s": PROTOCOL_FRAMES / sp_s,
            "mean_iterations": mean_it, "launches": sp_launches,
            "min_sum_s": outs["min-sum", "auto"][1],
            "plain_sum_product_s": outs["sum-product", "xla"][1],
            "min_sum_equal_to_plain": True,
            "sum_product_frames_moved_one_iteration": int(moved.sum())}
        if lanes == PROTOCOL_LANES[0]:
            lanes_results = sp
        elif any(not np.array_equal(a, b) for a, b in zip(sp, lanes_results)):
            raise AssertionError("Reconciler: 101 lanes differ from 128 lanes")
    report["reconciler"] = rec_report

    # ---- the secure chain ----------------------------------------------------
    rec = Reconciler(code, DecodeOptions(algorithm="sum-product", **base),
                     lanes=PROTOCOL_LANES[0], device=dev)
    tag_key, pa_key = prng_key(11), prng_key(12)
    syn = rec.syndromes(alice)
    a_tags = rec.tags(alice, tag_key)
    final_bits = rec.final_key_bits()
    if final_bits != N - M - 64 - 100 or final_bits * N > _DENSE_LIMIT:
        raise AssertionError(f"final key bits {final_bits}")
    sec, sec_s, sec_launches = counted(
        lambda: rec.reconcile_secure(bob, syn, q, a_tags, tag_key, pa_key))
    a_key = privacy_amplify(alice, pa_key, final_bits, device=dev).cpu().numpy()
    if not sec.verified.all() or not np.array_equal(sec.key, a_key):
        raise AssertionError(f"reconcile_secure: {int(sec.verified.sum())} verified, "
                             "keys differ from Alice's")
    report["reconcile_secure"] = {"wall_s": sec_s, "final_bits": final_bits,
                                  "verified": int(sec.verified.sum()),
                                  "keys_equal_to_alice": True, "launches": sec_launches}

    # ---- the rate-adapted endpoint: flooding and layered ---------------------
    ad = RateAdapter.make(code, n_punctured=ADAPT_PUNCTURED, n_shortened=ADAPT_SHORTENED,
                          seed=ADAPT_SEED)
    l = ad.payload_bits
    a_pay_t, b_pay_t, ne = keys(fold_in(key, 2), l, ADAPT_QBER)
    a_pay, b_pay = a_pay_t.cpu().numpy(), b_pay_t.cpu().numpy()
    frame_key = fold_in(key, 4)
    adapted = {}
    for schedule in ("flooding", "layered"):
        rec_a = Reconciler(code, DecodeOptions(algorithm="sum-product", schedule=schedule,
                                               **base),
                           lanes=PROTOCOL_LANES[0], adapter=ad, device=dev)
        syn_a = rec_a.syndromes(a_pay, frame_key=frame_key)
        out_a, s_a, launches_a = counted(lambda: rec_a.reconcile(b_pay, syn_a, ne / l))
        if not out_a.syndromes_match.all() or not (out_a.bits == a_pay).all():
            raise AssertionError(f"adapted endpoint ({schedule}): "
                                 f"{int(out_a.syndromes_match.sum())} verified")
        kernel = K6 if schedule == "layered" else K2
        other = K2 if schedule == "layered" else K6
        if launches_a.get(kernel, 0) <= 0 or launches_a.get(other, 0):
            raise AssertionError(f"adapted endpoint ({schedule}) launches {launches_a}")
        adapted[schedule] = {"wall_s": s_a, "frames_per_s": PROTOCOL_FRAMES / s_a,
                             "mean_iterations": float(out_a.iterations.mean()),
                             "launches": launches_a}
    report["adapted_endpoint"] = {"n_punctured": ADAPT_PUNCTURED,
                                  "n_shortened": ADAPT_SHORTENED, "qber": ne / l,
                                  "effective_rate": ad.effective_rate, **adapted}

    # ---- K1/K2/K5/KV and K6 on the adapter's LLRs ---------------------------
    llr_a = ad.llr(b_pay_t[:BATCH], ne / l).T.contiguous()  # erasures and pins
    frames = ad.build_frames(a_pay_t[:BATCH], frame_key)
    syn_t = syndrome(code, frames).T.contiguous()
    maps = code.to_device(dev)
    tables = layered.layer_tables(code, dev)
    gen = torch.Generator(device=dev).manual_seed(99)
    act = torch.rand((BATCH,), device=dev, generator=gen) < 0.7
    fresh = torch.rand((BATCH,), device=dev, generator=gen) < 0.4
    ones = torch.ones_like(act)
    held = []
    for algorithm in ("sum-product", "min-sum"):
        for dtype_name in ("float32", "bfloat16", "int8"):
            scale = 0.25 if dtype_name == "int8" else None
            mdt = cuda_kernels.STORAGE_DTYPES[dtype_name]
            kw = dict(threshold=100.0, clip=True, algorithm=algorithm,
                      min_sum_alpha=0.8, min_sum_beta=0.0, scale=scale)
            total0 = cuda_kernels._store(llr_a, mdt, scale)
            lr1 = cuda_kernels.check_update_plain(total0, None, syn_t, maps, first=True,
                                                  **kw)[0]
            total1 = cuda_kernels.variable_update_plain(
                lr1, llr_a, torch.zeros((N, BATCH), dtype=torch.int8, device=dev),
                torch.zeros((BATCH,), dtype=torch.int32, device=dev), ones, maps,
                scale=scale)[0]
            x = dict(syn=syn_t, lrp=lr1, llr=llr_a, fresh=fresh, active=act,
                     z=torch.full((N, BATCH), 7, dtype=torch.int8, device=dev),
                     count=torch.arange(BATCH, dtype=torch.int32, device=dev))
            worst, n_diff = 0.0, 0
            for name, first, mode in _check_modes(kw, fresh):
                x["tot"] = total0 if first else total1
                err, nd = _compare_check(torch, x, maps, False, first, mode, dtype_name,
                                         algorithm, scale)
                _require_exact(f"{name} on the adapter's LLRs, {algorithm} {dtype_name}",
                               err, nd)
                worst, n_diff = max(worst, err), n_diff + nd
            if algorithm == "sum-product":
                err, nd = _compare_variable(torch, x, maps, scale)
                _require_exact(f"variable update on the adapter's LLRs, {dtype_name}",
                               err, nd)
                worst, n_diff = max(worst, err), n_diff + nd
            t_s, lr_s, syn3 = layered.initial_state(tables, llr_a, syn_t, mdt)
            for _ in range(2):
                t_s, lr_s, _ = layered.layered_sweep_plain(t_s, lr_s, syn3, ones, tables,
                                                           **kw)
            ref = layered.layered_sweep_plain(t_s, lr_s, syn3, act, tables, **kw)
            got = cuda_layered.layered_sweep_cuda(t_s.clone(), lr_s.clone(), syn3, act,
                                                  tables, **kw)
            torch.cuda.synchronize()
            err, nd = _compare_sweep(torch, got, ref, act, dtype_name, algorithm, scale, DV)
            _require_exact(f"layered sweep on the adapter's LLRs, {algorithm} {dtype_name}",
                           err, nd)
            held.append({"algorithm": algorithm, "storage": dtype_name,
                         "max_abs_err": max(worst, err), "entries_differing": n_diff + nd})
            del x, total0, total1, lr1, t_s, lr_s, syn3, ref, got
    report["kernels_on_adapter_llrs"] = held

    # ---- blind: min-sum, kernels against the plain versions per frame -------
    d = BLIND_PUNCTURED
    a_b, b_b, _ = keys(fold_in(key, 5), N - d, BLIND_QBER)
    blind = {}
    for backend in ("auto", "xla"):
        o = DecodeOptions(algorithm="min-sum", backend=backend, **base)
        blind[backend] = counted(lambda: blind_reconcile_sim(
            code, a_b, b_b, n_punctured=d, qber_hint=BLIND_QBER, opts=o,
            reveal_step=BLIND_STEP, device=dev))
    (res_k, km_k), blind_s, blind_launches = blind["auto"]
    (res_p, km_p), blind_plain_s, _ = blind["xla"]
    # the first blind run captured its decode graph; a second replays it
    o = DecodeOptions(algorithm="min-sum", **base)
    _, blind_warm_s, _ = counted(lambda: blind_reconcile_sim(
        code, a_b, b_b, n_punctured=d, qber_hint=BLIND_QBER, opts=o,
        reveal_step=BLIND_STEP, device=dev))
    for f in res_k._fields:
        if not np.array_equal(getattr(res_k, f), getattr(res_p, f)):
            raise AssertionError(f"blind session: {f} differs from backend='xla'")
    if not (res_k.rounds > 0).any() or not np.array_equal(km_k, km_p) or (
            not km_k[res_k.ok].all()) or blind_launches.get(K2, 0) <= 0:
        raise AssertionError(f"blind session: rounds {np.bincount(res_k.rounds)}, "
                             f"launches {blind_launches}")
    report["blind"] = {"n_punctured": d, "reveal_step": BLIND_STEP, "qber": BLIND_QBER,
                       "frames_by_rounds": np.bincount(res_k.rounds).tolist(),
                       "verified": int(res_k.ok.sum()), "keys_match": int(km_k.sum()),
                       "wall_s": blind_s, "warm_wall_s": blind_warm_s,
                       "plain_wall_s": blind_plain_s,
                       "equal_to_plain_per_frame": True, "launches": blind_launches}

    # ---- amplification --------------------------------------------------------
    methods = ("dense", "blocked", "blocked-xor", "blocked-diag")
    bits32 = torch.as_tensor(alice[:AMPLIFY_FRAMES], device=dev)
    amp = {}
    dense = None
    for m in methods:
        out, wall, _ = counted(lambda: toeplitz_hash(bits32, pa_key, final_bits, method=m))
        dense = out if dense is None else dense
        if not torch.equal(out, dense):
            raise AssertionError(f"amplification: {m} differs from dense at the flagship")
        amp[f"flagship_{m}_s"] = wall
    n_out = amplified_key_bits(BIG_FRAME, BIG_LEAK)
    big = generate_random_bits(fold_in(key, 7), BIG_FRAME, 1, device=dev)
    first = None
    big_walls = {}
    for c in AMPLIFY_BLOCKS:
        for m in methods[1:]:
            out, wall, _ = counted(lambda: toeplitz_hash(big, pa_key, n_out, block_out=c,
                                                         method=m))
            first = out if first is None else first
            if not torch.equal(out, first):
                raise AssertionError(f"amplification at {BIG_FRAME} bits: {m}, c = {c}")
            big_walls[f"{m}_c{c}_s"] = wall
            del out
    s = bernoulli_half(random_bits(pa_key, BIG_FRAME + n_out - 1)).numpy().astype(np.int64)
    x = big[0].cpu().numpy().astype(np.int64)
    j = np.arange(BIG_FRAME)
    rows = np.random.default_rng(0).choice(n_out, AMPLIFY_ROWS_CHECKED, replace=False)
    got = first[0].cpu().numpy()
    for i in rows:
        if int(s[i - j + BIG_FRAME - 1] @ x) & 1 != got[i]:
            raise AssertionError(f"amplification at {BIG_FRAME} bits: row {i} != GF(2)")
    amp.update(frame_bits=BIG_FRAME, n_out=n_out, rows_checked=AMPLIFY_ROWS_CHECKED,
               big_frame_walls=big_walls)
    report["amplification"] = amp
    report["seconds"] = time.perf_counter() - t_phase
    return report, block_measured


def _reference_alist_and_example():
    """The reference's own matrix file and config.example.json's settings."""
    repo = Path(__file__).resolve().parent
    return (repo / "data" / "alist_sparse_matrices" / REFERENCE_ALIST,
            json.loads((repo / "configs" / "config.example.json").read_text()))


def _matrix_dir(code, directory, with_reference=True):
    """A matrix directory: the reference alist (optional) and the QC flagship
    written beside it by the port's ``write_alist`` (alist and sidecar)."""
    from qkd_ldpc_tpu_torch.codes import write_alist

    directory.mkdir()
    if with_reference:
        ref_path, _ = _reference_alist_and_example()
        shutil.copy(ref_path, directory / ref_path.name)
    write_alist(code, directory / QC_ALIST)
    return directory


def _cli_sweep(torch, np, dev, card, code, names):
    """The sweep as a user runs it: ``cli.main`` over a matrix directory with
    the reference's irregular alist (rows of 5 and 6: padded check slots) and
    the QC flagship, on the card.  Ingest (native and numpy parsers equal and
    timed; the QC sidecar round trip), K1/K2/K5/KV against their plain
    versions at the alist's shapes, then sweeps A (config.example.json's
    settings), A again (resumed from the checkpoint: no launch, the same
    bytes), B (the continuation crossover: the same bytes), C (layered on the
    QC code), a min-sum identity of kernels and plain versions through the
    CLI, and interactive mode at B = 1.  Each sweep is counted on its own.
    Returns sweep A's wall in seconds."""
    from qkd_ldpc_tpu_torch import _build, cli
    from qkd_ldpc_tpu_torch.channel import cuda_select
    from qkd_ldpc_tpu_torch.codes import make_code, read_alist, write_alist
    from qkd_ldpc_tpu_torch.decoder import cuda_kernels, device_loop
    from qkd_ldpc_tpu_torch.decoder.layered import NOT_QC_MESSAGE
    from qkd_ldpc_tpu_torch.sim import interactive_simulation, rate_based_qber_range, runner
    from qkd_ldpc_tpu_torch.config import load_config

    K1, K2, K3, K4, K5, K6, KV = names
    KT = cuda_select.KERNEL_TIES
    ref_path, example = _reference_alist_and_example()
    tmp = Path(tempfile.mkdtemp(prefix="cli_sweep_"))
    try:
        # ---- ingest ---------------------------------------------------------
        ref = read_alist(ref_path, native=True)
        ref_np = read_alist(ref_path, native=False)
        fields = ("chk_adj", "chk_mask", "var_adj", "var_mask", "var_slot",
                  "chk_slot", "var_deg", "chk_deg")
        if not all(np.array_equal(getattr(ref, f), getattr(ref_np, f)) for f in fields):
            raise AssertionError("native and numpy alist parsers disagree")
        hist = {int(d): int(c) for d, c in enumerate(np.bincount(ref.chk_deg)) if c}
        if ref.qc is not None or ref.dc_max != 6 or set(hist) != {5, 6}:
            raise AssertionError(f"unexpected reference alist profile {hist}")
        both = _matrix_dir(code, tmp / "matrices")
        qc_only = _matrix_dir(code, tmp / "qc_matrices", with_reference=False)
        back = read_alist(both / QC_ALIST)
        if back.qc != code.qc or not all(
                np.array_equal(getattr(back, f), getattr(code, f)) for f in fields):
            raise AssertionError("the QC flagship did not round-trip with its layout")
        # What the native loader saves a sweep: each file read by both parsers
        # (the library already built and loaded), median of five, on the host.
        ingest_ms = {}
        for label, path in (("reference_alist", ref_path), ("qc_flagship", both / QC_ALIST)):
            for native in (True, False):
                times = []
                for _ in range(5):
                    t0 = time.perf_counter()
                    read_alist(path, native=native)
                    times.append((time.perf_counter() - t0) * 1e3)
                ingest_ms[f"{label}_{'native' if native else 'numpy'}"] = (
                    statistics.median(times))

        # ---- K1 / K2 / K5 / KV at the alist's shapes (padded check slots) ---
        maps = ref.to_device(dev)
        gen = torch.Generator(device=dev).manual_seed(4321)
        cells = []
        for algorithm in ("sum-product", "min-sum"):
            for dtype_name in ("float32", "bfloat16"):
                for width in (BATCH, RAGGED_BATCH):
                    kw = dict(threshold=100.0, clip=True, algorithm=algorithm,
                              min_sum_alpha=0.8, min_sum_beta=0.0, scale=None)
                    x = _flooding_inputs(torch, dev, gen, ref, width, dtype_name, None)
                    by_kernel = {}
                    for name, first, mode in _check_modes(kw, x["fresh"]):
                        by_kernel[name] = _compare_check(
                            torch, x, maps, True, first, mode, dtype_name, algorithm, None)
                    by_kernel[KV] = _compare_variable(torch, x, maps, None)
                    if any(err != 0.0 or nd for err, nd in by_kernel.values()):
                        raise AssertionError(
                            f"K1/K2/K5/KV differ from their plain versions on the alist: "
                            f"{algorithm} {dtype_name} B={width}: {by_kernel}")
                    cells.append({
                        "algorithm": algorithm, "storage": dtype_name, "batch": width,
                        "max_abs_err": {k: e for k, (e, _) in by_kernel.items()},
                        "entries_differing": sum(nd for _, nd in by_kernel.values()),
                        "frames_per_thread": [cuda_kernels.vector_width(
                            k, width, cuda_kernels.STORAGE_DTYPES[dtype_name], x["tot"])
                            for k in ("check_update", "variable_update")]})
                    del x
        if {K1, K2, K5, KV} - set(cells[0]["max_abs_err"]):
            raise AssertionError("a flooding kernel was not held on the alist")
        torch.cuda.synchronize()

        # ---- the sweeps through the CLI -----------------------------------------
        seen_trials = []
        real_finalize = runner.finalize_point

        def recording_finalize(partials, **kw):
            seen_trials.append(partials.n_trials)
            return real_finalize(partials, **kw)

        def sweep(label, matrix_dir, expect_rc=0, **overrides):
            """One CLI run, counted: (wall seconds, launches, csv path, stderr)."""
            raw = dict(example, checkpoint_dir=str(tmp / f"ckpt_{label}"),
                       results_dir=str(tmp / f"results_{label}"),
                       matrix_dir=str(matrix_dir), **overrides)
            cfg_path = tmp / f"config_{label}.json"
            cfg_path.write_text(json.dumps(raw))
            seen_trials.clear()
            err = io.StringIO()
            torch.cuda.synchronize()
            _build.reset_launch_counts()
            runner.finalize_point = recording_finalize
            try:
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(io.StringIO()), \
                        contextlib.redirect_stderr(err):
                    rc = cli.main(["--config", str(cfg_path), "--no-progress"])
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            finally:
                runner.finalize_point = real_finalize
            if rc != expect_rc:
                raise AssertionError(f"sweep {label}: exit {rc}: {err.getvalue()}")
            results = sorted((tmp / f"results_{label}").glob("*.csv"))
            return wall, _build.launch_counts(), results, err.getvalue(), cfg_path

        def rows(path):
            lines = path.read_text().splitlines()
            return lines, [line.split(";") for line in lines[1:]]

        points = 13  # per code: the 0.58 row of the rate table, 0.03 ... 0.09
        batches = 2 * points * -(-example["trials_number"] // BATCH)
        report = {"card": card, "trials_per_point": example["trials_number"],
                  "batch": BATCH, "reference_alist": {
                      "n": ref.n_vars, "m": ref.n_checks, "dc_max": ref.dc_max,
                      "row_weights": hist},
                  "ingest_ms": ingest_ms,
                  "alist_kernel_cells": cells}

        with _counting_calls(device_loop.Graph, "replay") as replays_a:
            wall_a, launches_a, csv_a, _, cfg_a = sweep("A", both, compact_after=8)
        if replays_a[0] != 2 * points:  # a point of 1000 trials is one chunk
            raise AssertionError(f"sweep A: {replays_a[0]} graph replays for {2 * points} "
                                 "one-chunk points")
        lines_a, rows_a = rows(csv_a[0])
        if len(lines_a) != 2 * points + 1 or len(csv_a) != 1:
            raise AssertionError(f"sweep A wrote {len(lines_a)} lines")
        if seen_trials != [example["trials_number"]] * 2 * points:
            raise AssertionError(f"sweep A: trials per point {seen_trials}")
        names_in_order = [r[1] for r in rows_a]
        if names_in_order != [ref_path.name] * points + [QC_ALIST] * points:
            raise AssertionError(f"sweep A: matrices {names_in_order}")
        if rows_a[0][-1] != "0" or rows_a[points][-1] != "0":
            raise AssertionError(f"sweep A: FER at QBER 0.03 {rows_a[0]}, {rows_a[points]}")
        # a batch: K4 (Alice, scores), K3, K4's gated tie row, the gated tie kernel
        if (launches_a.get(K4, 0), launches_a.get(K3, 0), launches_a.get(KT, 0)) != (
                2 * batches, batches, batches):
            raise AssertionError(f"sweep A: K3/K4 launches {launches_a} for {batches} batches")
        if launches_a.get(K1, 0) < batches or launches_a.get(K2, 0) <= 0 or (
                launches_a.get(KV, 0) != launches_a.get(K2, 0)):
            raise AssertionError(f"sweep A: flooding launches {launches_a}")
        ckpt_a = sorted((tmp / "ckpt_A").iterdir())
        if len(ckpt_a) != 1 or len(ckpt_a[0].read_text().splitlines()) != 2 * points:
            raise AssertionError(f"sweep A: checkpoint {ckpt_a}")
        report["A"] = {"wall_s": wall_a, "points": 2 * points, "batches": batches,
                       "trials": 2 * points * example["trials_number"],
                       "rows_per_s": 2 * points / wall_a, "launches": launches_a,
                       "graph_replays": replays_a[0], "compact_after": 8}

        # A's wall with the decode graphs and with the eager kernel loop, in
        # turns (graph, eager, eager, graph), each run a fresh sweep.
        turns = {"graph": [], "eager": []}
        for i, mode in enumerate(("graph", "eager", "eager", "graph")):
            with (device_loop.eager_loops() if mode == "eager" else contextlib.nullcontext()):
                wall_t, _, csv_t, _, _ = sweep(f"A_turn{i}", both, compact_after=8)
            if csv_t[0].read_bytes() != csv_a[0].read_bytes():
                raise AssertionError(f"sweep A ({mode}) changed the CSV")
            turns[mode].append(wall_t)
        report["A"]["walls_in_turns_s"] = turns

        # A again: every point from the checkpoint, nothing on the card.
        wall_r, launches_r, csv_r, _, _ = sweep("A", both, compact_after=8)
        if sum(launches_r.values()) or seen_trials or len(csv_r) != 2 or (
                not csv_r[1].name.endswith("_1.csv")) or (
                csv_r[1].read_bytes() != csv_a[0].read_bytes()):
            raise AssertionError(f"resumed sweep A: {launches_r}, {csv_r}")
        report["A_resumed"] = {"wall_s": wall_r, "launches": launches_r,
                               "csv_identical": True}

        wall_b, launches_b, csv_b, _, _ = sweep(
            "B", both, compact_after=8, continuation_qber=0.07)
        if csv_b[0].read_bytes() != csv_a[0].read_bytes():
            raise AssertionError("sweep B (continuation crossover) changed the CSV")
        if launches_b.get(K5, 0) <= 0:
            raise AssertionError(f"sweep B never launched {K5}: {launches_b}")
        report["B"] = {"wall_s": wall_b, "points": 2 * points,
                       "continuation_points": 2 * sum(
                           q >= 0.07 for q in rate_based_qber_range(
                               ref.code_rate, load_config(cfg_a).r_qber_parameters)),
                       "trials": 2 * points * example["trials_number"],
                       "rows_per_s": 2 * points / wall_b, "launches": launches_b,
                       "csv_identical_to_A": True}

        _, launches_x, _, err_x, _ = sweep(
            "C_alist", both, expect_rc=1, schedule="layered", compact_after=4)
        if NOT_QC_MESSAGE not in err_x or sum(launches_x.values()):
            raise AssertionError(f"layered over the alist: {err_x!r}, {launches_x}")
        wall_c, launches_c, csv_c, _, _ = sweep(
            "C", qc_only, schedule="layered", compact_after=4)
        _, rows_c = rows(csv_c[0])
        at_05 = min(rows_c, key=lambda r: abs(float(r[6]) - QBER))
        mean_05 = float(at_05[7])
        if len(rows_c) != points or launches_c.get(K6, 0) <= 0 or not (
                MEAN_SWEEPS_GATE[0] <= mean_05 <= MEAN_SWEEPS_GATE[1]):
            raise AssertionError(f"sweep C: {len(rows_c)} rows, mean sweeps {mean_05}, "
                                 f"{launches_c}")
        if any(launches_c.get(k, 0) for k in (K1, K2, K5, KV)):
            raise AssertionError(f"sweep C launched a flooding kernel: {launches_c}")
        report["C"] = {"wall_s": wall_c, "points": points,
                       "trials": points * example["trials_number"],
                       "rows_per_s": points / wall_c, "launches": launches_c,
                       "mean_sweeps_at_0.05": mean_05, "compact_after": 4,
                       "layered_over_the_alist_refused": True}

        # D: a rate-0.8 code (check degree 15, the loop instances) under the
        # config's 0.8 row, written as a user's alist.
        rate08 = make_code(**RATE08_CODE)
        r08_dir = tmp / "rate08_matrices"
        r08_dir.mkdir()
        write_alist(rate08, r08_dir / "rate08.alist")
        wall_d, launches_d, csv_d, _, _ = sweep("D", r08_dir)
        _, rows_d = rows(csv_d[0])
        if rate08.dc_max != 15 or len(rows_d) != RATE08_POINTS or rows_d[0][-1] != "0" or (
                launches_d.get(K2, 0) <= 0 or launches_d.get(KV) != launches_d.get(K2)):
            raise AssertionError(f"sweep D (rate 0.8): {len(rows_d)} rows, first "
                                 f"{rows_d[0] if rows_d else None}, {launches_d}")
        report["D_rate_0.8"] = {"wall_s": wall_d, "dc_max": rate08.dc_max,
                                "points": RATE08_POINTS, "launches": launches_d,
                                "fer_by_qber": [[float(r[6]), float(r[-1])] for r in rows_d]}

        # Identity: min-sum through the kernels and through the plain versions.
        ident = dict(decoder="min-sum", trials_number=256, code_rate_QBER_parameters=[
            {"code_rate": 0.58, "QBER_begin": 0.03, "QBER_end": 0.05, "QBER_step": 0.005}])
        ref_only = tmp / "ref_matrices"
        ref_only.mkdir()
        shutil.copy(ref_path, ref_only / ref_path.name)
        wall_k, launches_k, csv_k, _, _ = sweep("identity_auto", ref_only, **ident)
        wall_p, launches_p, csv_p, _, _ = sweep(
            "identity_xla", ref_only, backend="xla", **ident)
        if csv_k[0].read_bytes() != csv_p[0].read_bytes():
            raise AssertionError("min-sum sweep: kernels and plain versions differ")
        if len(rows(csv_k[0])[1]) != 4 or launches_k.get(K2, 0) <= 0 or (
                sum(launches_p.values())):
            raise AssertionError(f"identity sweeps: {launches_k}, {launches_p}")
        report["identity_min_sum"] = {"points": 4, "trials_per_point": 256,
                                      "wall_s_kernels": wall_k, "wall_s_plain": wall_p,
                                      "launches_kernels": launches_k,
                                      "csv_identical": True}

        # Interactive mode: matrix 1 (the alist), one trial per point at B = 1.
        lines = []
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        interactive_simulation(load_config(cfg_a), both, input_fn=lambda _: "1",
                               print_fn=lines.append, device=dev)
        torch.cuda.synchronize()
        wall_i = time.perf_counter() - t0
        launches_i = _build.launch_counts()
        verdicts = [x for x in lines if x.startswith("Error reconciliation")]
        if len(verdicts) != points or launches_i.get(K1, 0) != points or (
                launches_i.get(K4, 0) < points):
            raise AssertionError(f"interactive: {len(verdicts)} verdicts, {launches_i}")
        report["interactive"] = {"wall_s": wall_i, "points": points, "batch": 1,
                                 "successful": sum("SUCCESSFUL" in x for x in verdicts),
                                 "launches": launches_i}
        print(json.dumps({"cli_sweep": report}), flush=True)
        return wall_a
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _trace_cli_sweep(torch, code, card, untraced_ms):
    """``--profile``: sweep A once more under the tracer, without a
    checkpoint so that both traced runs decode: its device-busy share of the
    untraced wall."""
    from qkd_ldpc_tpu_torch import cli
    from qkd_ldpc_tpu_torch.decoder import device_loop

    _, example = _reference_alist_and_example()
    tmp = Path(tempfile.mkdtemp(prefix="cli_sweep_traced_"))
    try:
        raw = dict(example, checkpoint_dir="", results_dir=str(tmp / "results"),
                   matrix_dir=str(_matrix_dir(code, tmp / "matrices")), compact_after=8)
        (tmp / "config.json").write_text(json.dumps(raw))

        def sweep_a():
            with contextlib.redirect_stdout(io.StringIO()):
                if cli.main(["--config", str(tmp / "config.json"), "--no-progress"]):
                    raise AssertionError("the traced sweep failed")

        # a point of sweep A is one chunk, one replay: the window is a chunk's
        # host calls (a run first, untraced, recaptures graphs evicted since)
        sweep_a()
        _profile_path(torch, "cli_sweep_A", sweep_a, card, untraced_ms,
                      (device_loop.Graph, "replay"))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


@contextlib.contextmanager
def _counting_calls(owner, method):
    """Inside, every call of ``owner.method`` adds one to ``yielded[0]``."""
    real, n = getattr(owner, method), [0]

    def counted_call(*args, **kwargs):
        n[0] += 1
        return real(*args, **kwargs)

    setattr(owner, method, counted_call)
    try:
        yield n
    finally:
        setattr(owner, method, real)


@contextlib.contextmanager
def _no_plain_on_card(torch):
    """Fail if a plain check, variable or layered update runs on a CUDA
    tensor inside the block (the wrappers look them up at call time)."""
    from qkd_ldpc_tpu_torch.decoder import cuda_kernels, layered

    seen = []
    patched = [(cuda_kernels, "check_update_plain"), (cuda_kernels, "variable_update_plain"),
               (layered, "layered_sweep_plain")]
    reals = [getattr(mod, name) for mod, name in patched]

    def watch(real, name):
        def watched(*args, **kw):
            if any(isinstance(a, torch.Tensor) and a.is_cuda for a in args):
                seen.append(name)
            return real(*args, **kw)
        return watched

    for (mod, name), real in zip(patched, reals):
        setattr(mod, name, watch(real, name))
    try:
        yield
    finally:
        for (mod, name), real in zip(patched, reals):
            setattr(mod, name, real)
    if seen:
        raise AssertionError(f"plain updates ran on the card: {sorted(set(seen))}")


def _sp_drift(torch, got, ref):
    """Sum-product across formulations: verdicts equal, bits equal where the
    iterations are; returns the lanes whose iterations differ (each by 1 at
    most, else it raises)."""
    if not torch.equal(got.syndromes_match, ref.syndromes_match):
        raise AssertionError("node-sharded SP: convergence verdicts differ")
    same = got.iterations == ref.iterations
    if not torch.equal(got.bits[same], ref.bits[same]):
        raise AssertionError("node-sharded SP: decisions differ on frames of equal iterations")
    moved = (~same).nonzero().flatten().tolist()
    if (got.iterations - ref.iterations).abs().max() > 1:
        raise AssertionError(f"node-sharded SP: a frame moved by more than 1 iteration: {moved}")
    return moved


def _wall(torch, fn):
    """Seconds of one call of ``fn`` ending in a synchronise (after a warm-up
    call)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def _collective_bytes(algorithm, n_trial, n_node, m, batch):
    """Bytes the node-sharded decoder's collectives move per iteration between
    the cards of its rows, were each shard on a card of its own: every shard
    but a row's first sends its check partials (the fused stack: 2 float32
    rows for sum-product, 4 int32 rows for min-sum) and its decision parity
    row, and receives the merged stack back.  On one card no copy is made."""
    depth = 4 if algorithm == "min-sum" else 2
    return n_trial * (n_node - 1) * (2 * depth + 1) * m * (batch // n_trial) * 4


def _two_process_cli(code):
    """``python -m qkd_ldpc_tpu_torch`` over the flagship alone (3 points,
    1000 trials a point, the last through the continuation), once in one
    process and once in two processes sharing the card (gloo group on a free
    localhost port): exactly one CSV and one checkpoint each, byte-equal.
    A failed or late child fails the phase.  Returns the walls."""
    import os
    import socket

    from qkd_ldpc_tpu_torch.codes import write_alist

    repo = Path(__file__).resolve().parent
    tmp = Path(tempfile.mkdtemp(prefix="two_process_"))
    try:
        (tmp / "m").mkdir()
        write_alist(code, tmp / "m" / QC_ALIST)
        _, example = _reference_alist_and_example()
        cfg = dict(example, trials_number=CLI_PROCESS_TRIALS, continuation_qber=0.055,
                   code_rate_QBER_parameters=[dict(code_rate=0.5, QBER_begin=0.04,
                                                   QBER_end=0.065, QBER_step=0.01)])
        env = dict(os.environ, PYTHONPATH=str(repo))

        def run(tag, n_procs):
            d = tmp / tag
            d.mkdir()
            (d / "config.json").write_text(json.dumps(dict(
                cfg, checkpoint_dir=str(d / "ckpt"), results_dir=str(d / "res"))))
            with socket.socket() as s:
                s.bind(("127.0.0.1", 0))
                port = s.getsockname()[1]
            argv = [sys.executable, "-m", "qkd_ldpc_tpu_torch", "--config",
                    str(d / "config.json"), "--matrix-dir", str(tmp / "m"), "--no-progress"]
            group = ["--coordinator", f"127.0.0.1:{port}", "--num-processes", str(n_procs)]
            t0 = time.perf_counter()
            procs = [subprocess.Popen(
                argv + (group + ["--process-id", str(i)] if n_procs > 1 else []),
                cwd=repo, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                for i in range(n_procs)]
            try:
                outs = [p.communicate(timeout=CLI_PROCESS_TIMEOUT) for p in procs]
            finally:
                for p in procs:
                    p.kill()
            seconds = time.perf_counter() - t0
            for i, (p, (_, err)) in enumerate(zip(procs, outs)):
                if p.returncode != 0:
                    raise AssertionError(f"{tag} process {i} exited {p.returncode}:\n{err[-2000:]}")
            files = [sorted((d / sub).glob(pat)) for sub, pat in (("res", "*.csv"),
                                                                   ("ckpt", "*.jsonl"))]
            if [len(f) for f in files] != [1, 1]:
                raise AssertionError(f"{tag}: {files} (one CSV and one checkpoint expected)")
            return [f[0] for f in files], seconds

        single, s1 = run("single", 1)
        multi, s2 = run("two", 2)
        for a, b in zip(single, multi):
            if a.name != b.name or a.read_bytes() != b.read_bytes():
                raise AssertionError(f"two-process {b.name} differs from one process's")
        rows = single[0].read_text().splitlines()[1:]
        return {"points": len(rows), "trials_per_point": CLI_PROCESS_TRIALS,
                "byte_equal": True, "one_process_seconds": s1, "two_process_seconds": s2,
                "csv_rows": rows}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _qc_collective_bytes(algorithm, schedule, n_trial, n_node, m, z, batch):
    """Bytes the QC node-sharded decoder's collectives would move between
    cards, were each shard on a card of its own: every shard's check partials
    go to every other shard of its row (sum-product one float32 row of
    products a check, min-sum four int32 rows) and each shard's decision
    parities to the row's first shard.  Flooding: per iteration (all M
    checks, one parity); layered: per layer (z checks) and per sweep (mb
    layers, one parity).  On one card, and within a process, no copy is
    made."""
    depth = 4 if algorithm == "min-sum" else 1
    b = batch // n_trial
    gather = n_trial * n_node * (n_node - 1) * depth * 4 * b  # a check's partials
    parity = n_trial * (n_node - 1) * 4 * m * b
    if schedule == "flooding":
        return {"collective_bytes_per_iteration": gather * m + parity}
    return {"collective_bytes_per_layer": gather * z,
            "collective_bytes_per_sweep": gather * m + parity}


# One process of a (1 x 2) row spanning two processes that share the card:
# argv = coordinator port, rank, output directory, parameters (JSON).  It
# makes the row's frames, decodes them (flooding and layered, sum-product and
# min-sum) and runs the min-sum sweep point, and saves what it got.
_ROW_CHILD = r"""
import dataclasses, json, sys, time
import numpy as np
import torch
from qkd_ldpc_tpu_torch import _build
from qkd_ldpc_tpu_torch.channel.keys import derive_point_key, make_trial_batch, num_errors_for
from qkd_ldpc_tpu_torch.codes import make_qc_code
from qkd_ldpc_tpu_torch.decoder.bp import DecodeOptions
from qkd_ldpc_tpu_torch.decoder.reconcile import apriori_llr
from qkd_ldpc_tpu_torch.decoder.syndrome import syndrome
from qkd_ldpc_tpu_torch.parallel import (
    decode_qc_node_sharded, initialize_distributed, make_mesh, run_point_node_sharded)
port, rank, out, p = sys.argv[1], int(sys.argv[2]), sys.argv[3], json.loads(sys.argv[4])
initialize_distributed(f"127.0.0.1:{port}", 2, rank)
card = torch.device("cuda", 0)
mesh = make_mesh(1, 2, devices=[card])
assert mesh.rows[0].group is not None and mesh.rows[0].nodes == (rank,)
code = make_qc_code(**p["code"])
key = derive_point_key(p["master_seed"], p["point_index"])
n_err = num_errors_for(code.n_vars, p["qber"])
alice, bob = make_trial_batch(key, code.n_vars, p["batch"], n_err, 0, device=card)
llr = apriori_llr(bob, np.float32(n_err) / np.float32(code.n_vars))
syn = syndrome(code, alice)
got = {}
for sched, alg in p["legs"]:
    o = DecodeOptions(algorithm=alg, schedule=sched, **p["base"])
    decode_qc_node_sharded(code, llr, syn, o, mesh)  # warm-up
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    r = decode_qc_node_sharded(code, llr, syn, o, mesh)
    torch.cuda.synchronize()
    got[f"{sched}/{alg}"] = dict(bits=r.bits.cpu(), iterations=r.iterations.cpu(),
                                 syndromes_match=r.syndromes_match.cpu(),
                                 seconds=time.perf_counter() - t0,
                                 launches=_build.launch_counts())
points = {}
for sched in ("flooding", "layered"):
    o = DecodeOptions(algorithm="min-sum", schedule=sched, **p["base"])
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    part, _ = run_point_node_sharded(code, key, p["qber"], p["trials"], p["trials"], o, mesh)
    torch.cuda.synchronize()
    points[sched] = dict(partials=list(dataclasses.astuple(part)),
                         seconds=time.perf_counter() - t0, launches=_build.launch_counts())
torch.save(dict(decodes=got, points=points), f"{out}/rank{rank}.pt")
"""


def _two_process_row(torch, code, base, legs, trials):
    """The (1 x 2) row across two processes sharing the card; returns each
    rank's saved results.  A failed or late child fails the phase."""
    import os
    import socket

    repo = Path(__file__).resolve().parent
    tmp = Path(tempfile.mkdtemp(prefix="two_process_row_"))
    try:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        params = json.dumps(dict(
            code=dict(z=Z, nb=NB, mb=MB_ROWS, dv=DV, seed=CODE_SEED), master_seed=MASTER_SEED,
            point_index=POINT_INDEX, qber=QBER, batch=NODE_BATCH, trials=trials, base=base,
            legs=legs))
        env = dict(os.environ, PYTHONPATH=str(repo))
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, "-c", _ROW_CHILD, str(port), str(i), str(tmp), params],
            cwd=repo, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for i in range(2)]
        try:
            outs = [p.communicate(timeout=ROW_PROCESS_TIMEOUT) for p in procs]
        finally:
            for p in procs:
                p.kill()
        seconds = time.perf_counter() - t0
        for i, (p, (_, err)) in enumerate(zip(procs, outs)):
            if p.returncode != 0:
                raise AssertionError(f"row process {i} exited {p.returncode}:\n{err[-3000:]}")
        return [torch.load(tmp / f"rank{i}.pt", weights_only=True) for i in range(2)], seconds
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _qc_node(torch, np, dev, card, code, names, counted, as_stats, point_key):
    """The QC node-sharded decoder on meshes of the card (routing "auto"),
    held against the single-device kernel decodes; its sweep point against
    ``run_point``; a row across two processes against the one-process row.
    Returns the phase's line."""
    from qkd_ldpc_tpu_torch.channel.keys import make_trial_batch, num_errors_for
    from qkd_ldpc_tpu_torch.decoder.bp import DecodeOptions, decode
    from qkd_ldpc_tpu_torch.decoder.reconcile import apriori_llr
    from qkd_ldpc_tpu_torch.decoder.syndrome import syndrome
    from qkd_ldpc_tpu_torch.parallel import (
        decode_qc_node_sharded,
        make_mesh,
        node_sharded,
        run_point_node_sharded,
    )
    from qkd_ldpc_tpu_torch.sim import run_point
    from qkd_ldpc_tpu_torch.utils import canonical_device

    K1, K2, K3, K4, K5, K6, KV = names
    card0 = canonical_device(dev)
    N, M = code.n_vars, code.n_checks
    n_err = num_errors_for(N, QBER)
    alice, bob = make_trial_batch(point_key, N, NODE_BATCH, n_err, 0, device=card0)
    llr = apriori_llr(bob, np.float32(n_err) / np.float32(N))
    syn = syndrome(code, alice)
    base = dict(max_iterations=100, clip_messages=True, message_threshold=100.0,
                routing="auto")
    report = {"card": card, "batch": NODE_BATCH, "qber": QBER, "routing": "auto",
              "note": "shards share one card: overhead, not scaling"}
    kernels_of = {"flooding": (K1, K2, KV), "layered": (K6,)}

    # The general decoder must never run for the QC code.
    general = []
    real_general = node_sharded._decode_row

    def watched_general(*a, **k):
        general.append(1)
        return real_general(*a, **k)

    node_sharded._decode_row = watched_general
    one_process = {}
    try:
        for sched in ("flooding", "layered"):
            for alg, dtype in (("min-sum", "bfloat16"), ("sum-product", "bfloat16"),
                               ("min-sum", "int8")):
                o = DecodeOptions(algorithm=alg, schedule=sched, message_dtype=dtype, **base)
                decode(code, llr, syn, o, device=card0)  # warm-up
                with _no_plain_on_card(torch):
                    ref, ref_s, ref_launches = counted(
                        lambda: decode(code, llr, syn, o, device=card0))
                for k in kernels_of[sched]:
                    if ref_launches.get(k, 0) <= 0:
                        raise AssertionError(f"{sched} reference: {k} never launched")
                legs = {"single_device_kernel_seconds": ref_s,
                        "single_device_launches": ref_launches,
                        "mean_iterations": float(ref.iterations.float().mean())}
                meshes = QC_NODE_MESHES if dtype == "bfloat16" else ((1, 2),)
                for n_trial, n_node in meshes:
                    m = make_mesh(n_trial, n_node, devices=[card0] * (n_trial * n_node))
                    decode_qc_node_sharded(code, llr, syn, o, m)  # warm-up: plans, indices
                    got, secs, launches = counted(
                        lambda: decode_qc_node_sharded(code, llr, syn, o, m))
                    if alg == "min-sum":
                        for f in ("bits", "iterations", "syndromes_match"):
                            if not torch.equal(getattr(got, f), getattr(ref, f)):
                                raise AssertionError(
                                    f"QC node {sched} {alg}/{dtype} {n_trial}x{n_node}: {f} differ")
                        moved = []
                    else:
                        moved = _sp_drift(torch, got, ref)
                        if len(moved) > SP_ITERATION_SUM_ALLOWANCE:
                            raise AssertionError(
                                f"QC node {sched} SP {n_trial}x{n_node}: lanes {moved}")
                    if (n_trial, n_node) == (1, 2) and dtype == "bfloat16":
                        one_process[f"{sched}/{alg}"] = got
                    legs[f"{n_trial}x{n_node}"] = {
                        "equal_per_lane": alg == "min-sum",
                        "sp_lanes_moved_1_iteration": moved,
                        "sp_lanes_moved_iterations": [
                            [int(ref.iterations[i]), int(got.iterations[i])] for i in moved],
                        "seconds": secs, "launches": launches,
                        **_qc_collective_bytes(alg, sched, n_trial, n_node, M, Z, NODE_BATCH),
                    }
                report[f"{sched}_{alg}_{dtype}"] = legs

        # ---- the sweep point on (2 x 2): the QC decoder, keygen on the card --
        m22 = make_mesh(2, 2, devices=[card0] * 4)
        for sched in ("flooding", "layered"):
            o = DecodeOptions(algorithm="min-sum", schedule=sched, message_dtype="bfloat16",
                              **base)
            (p_node, _), s_node, launches = counted(lambda: run_point_node_sharded(
                code, point_key, QBER, NODE_POINT_TRIALS, NODE_POINT_TRIALS, o, m22))
            (p_ref, _), s_ref, _ = counted(lambda: run_point(
                code, point_key, QBER, NODE_POINT_TRIALS, NODE_POINT_TRIALS, o, device=card0))
            if as_stats(p_node) != as_stats(p_ref):
                raise AssertionError(f"QC node point {sched}: {as_stats(p_node)} != "
                                     f"{as_stats(p_ref)}")
            if launches.get(K4, 0) < 2 or launches.get(K3, 0) < 2:
                raise AssertionError(f"QC node point {sched}: keygen launches {launches}")
            report[f"point_{sched}"] = {
                "mesh": "2x2", "trials": NODE_POINT_TRIALS, "partials": as_stats(p_node),
                "seconds": s_node, "launches": launches, "run_point_seconds": s_ref}
    finally:
        node_sharded._decode_row = real_general
    if general:
        raise AssertionError(f"the general node-sharded decoder ran {len(general)} times")

    # ---- (1 x 2) across two processes sharing the card ------------------------
    legs = [[sched, alg] for sched in ("flooding", "layered")
            for alg in ("min-sum", "sum-product")]
    ranks, seconds = _two_process_row(torch, code, dict(base, message_dtype="bfloat16"),
                                      legs, NODE_POINT_TRIALS)
    row = {"processes": 2, "mesh": "1x2", "bit_equal_to_one_process": True,
           "wall_seconds_both_processes": seconds}
    for sched, alg in legs:
        key = f"{sched}/{alg}"
        ref = one_process[key]
        for rank, res in enumerate(ranks):
            got = res["decodes"][key]
            for f in ("bits", "iterations", "syndromes_match"):
                if not torch.equal(got[f], getattr(ref, f).cpu()):
                    raise AssertionError(f"two-process row {key} rank {rank}: {f} differ")
        row[key] = {"seconds_per_rank": [r["decodes"][key]["seconds"] for r in ranks],
                    "launches_per_rank": [r["decodes"][key]["launches"] for r in ranks],
                    "one_process_seconds": report[f"{sched}_{alg}_bfloat16"]["1x2"]["seconds"],
                    **_qc_collective_bytes(alg, sched, 1, 2, M, Z, NODE_BATCH)}
    for sched in ("flooding", "layered"):
        want = [report[f"point_{sched}"]["partials"][k] for k in
                ("n_trials", "n_sp", "n_ldpc", "sum_it", "sum_it2", "min_it", "max_it")]
        for rank, res in enumerate(ranks):
            if res["points"][sched]["partials"] != want:
                raise AssertionError(f"two-process row point {sched} rank {rank}: "
                                     f"{res['points'][sched]['partials']} != {want}")
        row[f"point_{sched}"] = {"trials": NODE_POINT_TRIALS, "partials_equal": True,
                                 "seconds_per_rank": [r["points"][sched]["seconds"]
                                                      for r in ranks],
                                 "launches_per_rank": [r["points"][sched]["launches"]
                                                       for r in ranks]}
    report["two_process_row"] = row
    return report


def _parallel(torch, np, dev, card, code, names, opts, opts_l, opts_c, point_key, key_c,
              counted, channel_launches, as_stats):
    """``parallel/`` on one card: (a) a trial mesh of four shards on
    the card — ``run_point_sharded`` (flooding, then layered),
    ``run_sweep_sharded`` over three points and the sharded continuation,
    each equal to the single-device runner, 7/7, and each counted: the
    kernels of its schedule launched, no plain update on the card; (b) the
    general node-sharded decoder on (1 x 2) and (2 x 2) meshes (min-sum equal
    per lane, sum-product on decisions and iterations) and
    ``run_point_node_sharded``; (c) two CLI processes sharing the card
    through a gloo group, their CSV and checkpoint byte-equal to one
    process's.  Shards on one card: every number is overhead, not scaling.
    Returns the line's dict."""
    from qkd_ldpc_tpu_torch.channel.threefry import fold_in, prng_key
    from qkd_ldpc_tpu_torch.decoder.bp import DecodeOptions, decode
    from qkd_ldpc_tpu_torch.decoder.reconcile import apriori_llr
    from qkd_ldpc_tpu_torch.decoder.syndrome import syndrome
    from qkd_ldpc_tpu_torch.channel.keys import make_trial_batch, num_errors_for
    from qkd_ldpc_tpu_torch.parallel import (
        decode_node_sharded,
        make_mesh,
        make_trial_mesh,
        run_point_node_sharded,
        run_point_sharded,
        run_sweep_sharded,
    )
    from qkd_ldpc_tpu_torch.sim import run_point, run_point_continuation
    from qkd_ldpc_tpu_torch.sim.continuation import run_point_continuation_sharded

    K1, K2, K3, K4, K5, K6, KV = names
    from qkd_ldpc_tpu_torch.utils import canonical_device

    card0 = canonical_device(dev)
    trials = N_BATCHES * BATCH
    b = BATCH // PARALLEL_SHARDS  # lanes a shard
    mesh = make_trial_mesh([card0] * PARALLEL_SHARDS)
    report = {"card": card, "shards_on_one_card": PARALLEL_SHARDS, "trials": trials,
              "global_batch": BATCH, "note": "shards share one card: overhead, not scaling"}

    def equal(what, got, ref):
        if as_stats(got) != as_stats(ref):
            raise AssertionError(f"{what}: {as_stats(got)} != {as_stats(ref)}")

    def leg(name, step, ref_step, must, must_not):
        """Warm up, then run ``step`` counted (no plain update on the card)
        and ``ref_step``; hold them equal; check the launches."""
        step()
        with _no_plain_on_card(torch):
            (got, _), seconds, launches = counted(step)
        (ref, _), ref_seconds, _ = counted(ref_step)
        equal(name, got, ref)
        for k in must:
            if launches.get(k, 0) <= 0:
                raise AssertionError(f"{name}: kernel {k} was never launched: {launches}")
        for k in must_not:
            if launches.get(k, 0):
                raise AssertionError(f"{name}: kernel {k} was launched: {launches}")
        report[name] = {"partials": as_stats(got), "launches": launches,
                        "seconds": seconds, "frames_per_s": trials / seconds,
                        "single_device_seconds": ref_seconds,
                        "single_device_frames_per_s": trials / ref_seconds}
        return got, launches

    # ---- (a) the trial mesh ------------------------------------------------
    # compaction within each shard's lanes: compact_lanes from the shard's batch
    opts_a = dataclasses.replace(opts, compact_lanes=b // 4)
    _, launches = leg(
        "trial_mesh_flooding",
        lambda: run_point_sharded(code, point_key, QBER, trials, BATCH, opts_a, mesh),
        lambda: run_point(code, point_key, QBER, trials, BATCH, opts, prng="pallas",
                          device=card0),
        (K1, K2, K3, K4, KV), (K5, K6))
    batches = PARALLEL_SHARDS * N_BATCHES  # batches of b lanes
    if launches[K1] != batches:
        raise AssertionError(f"trial mesh: {launches[K1]} {K1} launches for {batches} batches")
    channel_launches("trial mesh", launches, batches)
    opts_la = dataclasses.replace(opts_l, compact_lanes=b // 4)
    leg("trial_mesh_layered",
        lambda: run_point_sharded(code, point_key, QBER, trials, BATCH, opts_la, mesh),
        lambda: run_point(code, point_key, QBER, trials, BATCH, opts_l, prng="pallas",
                          device=card0),
        (K3, K4, K6), (K1, K2, K5, KV))
    cont, _ = leg("trial_mesh_continuation",
        lambda: run_point_continuation_sharded(code, key_c, WATERFALL_QBER, trials, b,
                                               opts_c, mesh, segment=SEGMENT,
                                               refill_frac=REFILL_FRAC),
        lambda: run_point_continuation(code, key_c, WATERFALL_QBER, trials, BATCH, opts_c,
                                       segment=SEGMENT, refill_frac=REFILL_FRAC,
                                       device=card0),
        (K3, K4, K5, KV), (K1, K2, K6))
    plain_c, _ = run_point(code, key_c, WATERFALL_QBER, trials, BATCH, opts_c, device=card0)
    equal("sharded continuation against run_point", cont, plain_c)
    master = prng_key(MASTER_SEED)
    swept = run_sweep_sharded(code, master, PARALLEL_SWEEP_QBERS, PARALLEL_SWEEP_TRIALS,
                              BATCH, opts_a, mesh)
    for i, (p, q) in enumerate(swept):
        ref, q_ref = run_point(code, fold_in(master, i), PARALLEL_SWEEP_QBERS[i],
                               PARALLEL_SWEEP_TRIALS, BATCH, opts, device=card0)
        equal(f"run_sweep_sharded point {i}", p, ref)
        if q != q_ref:
            raise AssertionError(f"run_sweep_sharded point {i}: QBER {q} != {q_ref}")
    report["sweep_sharded"] = {"qbers": PARALLEL_SWEEP_QBERS, "trials": PARALLEL_SWEEP_TRIALS,
                               "partials": [as_stats(p) for p, _ in swept]}

    # ---- (b) node sharding at the flagship -------------------------------------
    N = code.n_vars
    n_err = num_errors_for(N, QBER)
    alice, bob = make_trial_batch(point_key, N, NODE_BATCH, n_err, 0, device=card0)
    llr = apriori_llr(bob, np.float32(n_err) / np.float32(N))
    syn = syndrome(code, alice)
    base = dict(max_iterations=100, clip_messages=True, message_threshold=100.0,
                message_dtype="bfloat16", routing="gather")
    node = {"batch": NODE_BATCH, "qber": QBER}
    M = code.n_checks
    for alg in ("min-sum", "sum-product"):
        o = DecodeOptions(algorithm=alg, **base)
        ref = decode(code, llr, syn, o, device=card0)
        plain = dataclasses.replace(o, backend="xla")
        for n_trial, n_node in PARALLEL_NODE_MESHES:
            m = make_mesh(n_trial, n_node, devices=[card0] * (n_trial * n_node))
            got = decode_node_sharded(code, llr, syn, o, m)
            if alg == "min-sum":
                for f in ("bits", "iterations", "syndromes_match"):
                    if not torch.equal(getattr(got, f), getattr(ref, f)):
                        raise AssertionError(f"node-sharded min-sum {n_trial}x{n_node}: {f} differ")
                moved = []
            else:
                moved = _sp_drift(torch, got, ref)
                if len(moved) > SP_ITERATION_SUM_ALLOWANCE:
                    raise AssertionError(f"node-sharded SP {n_trial}x{n_node}: lanes {moved}")
            node[f"{alg}_{n_trial}x{n_node}"] = {
                "equal_per_lane": alg == "min-sum", "sp_lanes_moved_1_iteration": moved,
                "seconds": _wall(torch, lambda: decode_node_sharded(code, llr, syn, o, m)),
                "collective_bytes_per_iteration": _collective_bytes(
                    alg, n_trial, n_node, M, NODE_BATCH),
            }
        node[f"{alg}_single_device_kernel_seconds"] = _wall(
            torch, lambda: decode(code, llr, syn, o, device=card0))
        node[f"{alg}_single_device_plain_seconds"] = _wall(
            torch, lambda: decode(code, llr, syn, plain, device=card0))
        node[f"{alg}_mean_iterations"] = float(ref.iterations.float().mean())
    o_ms = DecodeOptions(algorithm="min-sum", **base)
    m22 = make_mesh(2, 2, devices=[card0] * 4)
    (p_node, _), s_node, launches_node = counted(
        lambda: run_point_node_sharded(code, point_key, QBER, NODE_POINT_TRIALS, BATCH, o_ms, m22))
    p_ref, _ = run_point(code, point_key, QBER, NODE_POINT_TRIALS, BATCH, o_ms, device=card0)
    equal("run_point_node_sharded", p_node, p_ref)
    node["run_point_node_sharded"] = {"trials": NODE_POINT_TRIALS, "mesh": "2x2",
                                      "partials": as_stats(p_node), "seconds": s_node,
                                      "launches": launches_node}
    report["node_sharded"] = node

    # ---- (c) two processes sharing the card -------------------------------------
    report["two_process_cli"] = _two_process_cli(code)
    return report


def _many_ties(torch, scores, k, dev):
    """Scores whose row r has ``need_r`` = 1 + 37 r mod 500 of its ``k``
    flips left to take from ``n_at_r`` = need_r + 1 + 13 r mod 700 threshold
    ties at random positions (the smallest scores after the first k - need_r
    set equal), and second words drawn from four values (3, 2^31 - 1, 2^31,
    2^32 - 1 as uint32), so most ties share their second word with a
    hundred others across the row.  Returns (scores, second words, needs,
    n_ats)."""
    from qkd_ldpc_tpu_torch.channel.threefry import flip_sign

    B, n = scores.shape
    r = torch.arange(B, device=dev)
    need = 1 + (r * 37) % 500
    below = k - need
    n_at = need + 1 + (r * 13) % 700
    vals, idx = flip_sign(scores).sort(dim=1)
    j = torch.arange(n, device=dev)[None, :]
    tie = (j >= below[:, None]) & (j < (below + n_at)[:, None])
    vals = torch.where(tie, vals[r, below][:, None], vals)
    many = flip_sign(torch.empty_like(scores).scatter_(1, idx, vals))
    g = torch.Generator(device=dev).manual_seed(11)
    table = torch.tensor([3, 2**31 - 1, -2**31, -1], dtype=torch.int32, device=dev)
    second = table[torch.randint(0, 4, (B, n), generator=g, device=dev)]
    return many, second, need.tolist(), n_at.tolist()


def _device_loops(torch, np, dev, card, flush, code, point_key, key_c, opts_c, counted,
                  as_stats):
    """The port's device-resident control flow (``device_loops``): every
    flooding and layered decode leg as a captured CUDA graph against the
    eager kernel loop (z, iterations and verdicts bit for bit, and the same
    launches) and against the plain versions (min-sum equal, sum-product
    verdicts equal and at most 2 frames +-1 iteration); four host threads,
    a stream each, sharing one graph (each call its own batch's answer, no
    new capture); K2 in place over its input equal to K2 into a new buffer;
    the continuation program against its eager program (7/7, equal launches
    of every kernel); the tie
    path gated on the card against ``_uniform_ties`` on a forced-tie
    flagship batch and on rows of many ties that share their second words
    across the row (``_many_ties``), and untouched where no row has excess
    ties; ``point_batch_partials`` and the decodes under
    ``torch.cuda.set_sync_debug_mode("error")``; the Reconciler with a window
    of 1 and of 4 chunks in flight; the new kernels held to their plain
    versions and timed.  Returns (report, {kernel name: measurement})."""
    from qkd_ldpc_tpu_torch import Reconciler
    from qkd_ldpc_tpu_torch.channel import cuda_prng, cuda_select, keys
    from qkd_ldpc_tpu_torch.channel.cuda_prng import ALICE, SCORES, TIES
    from qkd_ldpc_tpu_torch.channel.threefry import flip_sign
    from qkd_ldpc_tpu_torch.codes import make_code
    from qkd_ldpc_tpu_torch.decoder import cuda_kernels, cuda_layered, device_loop
    from qkd_ldpc_tpu_torch.decoder.bp import DecodeOptions, bp_decode_batch_last
    from qkd_ldpc_tpu_torch.decoder.reconcile import apriori_llr
    from qkd_ldpc_tpu_torch.decoder.syndrome import syndrome
    from qkd_ldpc_tpu_torch.sim import run_point_continuation
    from qkd_ldpc_tpu_torch.sim.runner import point_batch_partials

    N = code.n_vars
    n_err = keys.num_errors_for(N, QBER)
    report = {"card": card}

    def inputs(c, qber, key):
        ne = keys.num_errors_for(c.n_vars, qber)
        alice, bob = keys.make_trial_batch(key, c.n_vars, BATCH, ne, 0)
        q32 = np.float32(ne) / np.float32(c.n_vars)
        return apriori_llr(bob, q32).T.contiguous(), syndrome(c, alice).T.contiguous()

    flagship = inputs(code, QBER, point_key)
    wide_dc = make_code(**RATE08_CODE)  # dc 15: K1/K2's loop instance with its scratch
    base = dict(max_iterations=100, clip_messages=True, message_threshold=100.0)
    sp, ms = dict(algorithm="sum-product", message_dtype="bfloat16"), dict(
        algorithm="min-sum", message_dtype="int8")
    legs = {
        # name: (code, inputs, options, regime)
        "flooding_sp_bf16": (code, flagship, dict(sp, compact_after=8, compact_lanes=128),
                             None),
        "flooding_ms_int8": (code, flagship, dict(ms, compact_after=8, compact_lanes=128),
                             None),
        "layered_sp_bf16": (code, flagship, dict(sp, schedule="layered", compact_after=4,
                                                 compact_lanes=128), None),
        "layered_ms_int8": (code, flagship, dict(ms, schedule="layered", compact_after=4,
                                                 compact_lanes=128), None),
        "flooding_phase_c_overflow": (code, flagship, dict(sp, compact_after=2,
                                                           compact_lanes=8), "overflow"),
        "layered_phase_c_overflow": (code, flagship, dict(sp, schedule="layered",
                                                          compact_after=1, compact_lanes=8),
                                     "overflow"),
        "flooding_all_in_phase_a": (code, flagship, dict(sp, compact_after=60,
                                                         compact_lanes=128), "phase_a"),
        "layered_all_in_phase_a": (code, flagship, dict(sp, schedule="layered",
                                                        compact_after=60, compact_lanes=128),
                                   "phase_a"),
        "flooding_dc15_sp_bf16": (wide_dc, inputs(wide_dc, 0.005, point_key),
                                  dict(sp, compact_after=8, compact_lanes=128), None),
    }
    K2, KV, K6 = cuda_kernels.KERNEL_FUSED, cuda_kernels.KERNEL_VARIABLE, cuda_layered.KERNEL_NAME
    KS, KW = device_loop.KERNEL_STEP, device_loop.KERNEL_SWEEP_STEP
    for name, (c, (llr, syn), kw, regime) in legs.items():
        o = DecodeOptions(**base, **kw)

        def decode(o=o, c=c, llr=llr, syn=syn):
            return bp_decode_batch_last(c, llr, syn, o)

        decode()  # capture
        with device_loop.eager_loops():
            decode()  # warm-up
        graph, graph_s, graph_counts = counted(decode)
        with device_loop.eager_loops():
            eager, eager_s, eager_counts = counted(decode)
        plain = bp_decode_batch_last(c, llr, syn, dataclasses.replace(o, backend="xla"))
        torch.cuda.synchronize()
        for what, a, b in zip(("z", "iterations", "verdicts"), graph, eager):
            if not torch.equal(a, b):
                raise AssertionError(f"device_loops {name}: graph and eager {what} differ")
        body = (K6, KW) if o.schedule == "layered" else (K2, KV, KS)
        if any(graph_counts.get(k, 0) != eager_counts.get(k, 0) for k in body) or (
                graph_counts.get(body[0], 0) <= 0):
            raise AssertionError(f"device_loops {name}: graph launches {graph_counts} "
                                 f"against eager {eager_counts}")
        z, it, ok = graph
        if o.algorithm == "min-sum":
            moved = [] if all(torch.equal(a, b) for a, b in zip(graph, plain)) else None
        else:
            same = it == plain[1]
            moved = (~same).nonzero().flatten().tolist()
            if not torch.equal(ok, plain[2]) or not torch.equal(z[:, same], plain[0][:, same]) \
                    or len(moved) > SP_ITERATION_SUM_ALLOWANCE or (
                    (it - plain[1]).abs().max() > 1):
                moved = None
        if moved is None:
            raise AssertionError(f"device_loops {name}: the graph decode breaks the rules "
                                 "against the plain versions")
        k, lanes = o.compact_after, o.compact_lanes
        if regime == "overflow" and not int((it > k).sum()) > lanes:
            raise AssertionError(f"device_loops {name}: no phase-C overflow")
        if regime == "phase_a" and not (bool(ok.all()) and int(it.max()) <= k):
            raise AssertionError(f"device_loops {name}: not every lane converged in phase A")
        report[name] = {
            "code": c.name, "batch": BATCH, "compact_after": k, "compact_lanes": lanes,
            "converged": int(ok.sum()), "max_iterations": int(it.max()),
            "lanes_past_compact_after": int((it > k).sum()),
            "graph_equals_eager": True, "sp_frames_moved_against_plain": moved,
            "graph_launches": graph_counts, "eager_launches": eager_counts,
            "graph_ms": graph_s * 1e3, "eager_ms": eager_s * 1e3}

    # ---- host threads sharing the card's decode graph --------------------------
    # four threads, each on a stream of its own, decode two batches with one
    # program at once, three times each: every call gets its own batch's
    # answer from the one graph (calls are serialised per card, and a call's
    # stream waits for the previous call's copies of the outputs)
    o = DecodeOptions(**base, **legs["flooding_sp_bf16"][2])
    batches = [flagship, inputs(code, QBER, key_c)] * 2
    alone = [bp_decode_batch_last(code, x, y, o) for x, y in batches]
    torch.cuda.synchronize()

    def on_a_thread(i):
        with torch.cuda.stream(torch.cuda.Stream(dev)):
            outs = [bp_decode_batch_last(code, *batches[i], o) for _ in range(3)]
            torch.cuda.current_stream().synchronize()
        return outs

    with _counting_calls(device_loop.Graph, "capture") as captures, \
            ThreadPoolExecutor(max_workers=4) as pool:
        shared = list(pool.map(on_a_thread, range(4)))
    wrong = sum(not all(torch.equal(a, b) for a, b in zip(out, alone[i]))
                for i in range(4) for out in shared[i])
    if captures[0] or wrong:
        raise AssertionError(f"threads sharing the card's graph: {captures[0]} captures, "
                             f"{wrong} of 12 decodes wrong")
    report["threads_share_the_graph"] = {"threads": 4, "decodes": 12, "captures": 0,
                                         "equal_to_alone": True}

    # ---- K2 in place over its input (the graphs' loop bodies) ------------------
    gen = torch.Generator(device=dev).manual_seed(99)
    in_place = {}
    for c in (code, wide_dc):
        maps = c.to_device(dev)
        for algorithm, dtype_name in (("sum-product", "bfloat16"), ("min-sum", "int8"),
                                      ("sum-product", "float32")):
            scale = 0.25 if dtype_name == "int8" else None
            x = _flooding_inputs(torch, dev, gen, c, BATCH, dtype_name, scale)
            kw = dict(threshold=100.0, clip=True, algorithm=algorithm, min_sum_alpha=0.8,
                      min_sum_beta=0.0, scale=scale, first=False)
            for fresh in (None, x["fresh"]):
                ref, ok_ref = cuda_kernels.check_update_cuda(
                    x["tot"], x["lrp"], x["syn"], maps, fresh=fresh, **kw)
                buf = x["lrp"].clone()
                got, ok_got = cuda_kernels.check_update_cuda(
                    x["tot"], buf, x["syn"], maps, fresh=fresh, out=buf, **kw)
                torch.cuda.synchronize()
                if got is not buf or not torch.equal(got, ref) or not torch.equal(ok_got,
                                                                                   ok_ref):
                    raise AssertionError(f"K2 in place differs: {c.name} {algorithm} "
                                         f"{dtype_name} fresh={fresh is not None}")
            in_place[f"{c.name}_{algorithm}_{dtype_name}"] = "equal"
    report["check_update_in_place"] = in_place

    # ---- the continuation program against its eager program -------------------
    def cont():
        return run_point_continuation(code, key_c, WATERFALL_QBER, 2 * BATCH, BATCH, opts_c,
                                      segment=SEGMENT, refill_frac=REFILL_FRAC)

    cont()  # the graph is captured (another trial count is another input, not a key)
    (p_graph, _), cont_s, cont_counts = counted(cont)
    with device_loop.eager_loops():
        cont()  # warm-up
        (p_eager, _), cont_eager_s, cont_eager_counts = counted(cont)
    if as_stats(p_graph) != as_stats(p_eager) or cont_counts != cont_eager_counts:
        raise AssertionError(f"continuation: graph {as_stats(p_graph)} / {cont_counts} "
                             f"against eager {as_stats(p_eager)} / {cont_eager_counts}")
    report["continuation_program_equals_eager"] = {
        "partials": as_stats(p_graph), "launches": cont_counts,
        "launches_equal_for_every_kernel": True, "graph_s": cont_s, "eager_s": cont_eager_s}

    # ---- the tie path, gated on the card ---------------------------------------
    alice, scores = cuda_prng.trial_words_cuda(point_key, N, range(0, BATCH),
                                               (ALICE, SCORES), dev)
    ties = scores.clone()
    vals, idx = flip_sign(ties).sort(dim=1)
    r = torch.arange(BATCH, device=dev)
    ties[r, idx[r, n_err]] = flip_sign(vals[r, n_err - 1])  # n_at = 2 > need = 1
    second = cuda_prng.trial_words_cuda(point_key, N, range(0, BATCH), (TIES,), dev)[0]
    thresh, bob_idx, excess = cuda_select.select_flip_cuda(ties, n_err, alice)
    gated = cuda_prng.trial_words_cuda(point_key, N, range(0, BATCH), (TIES,), dev,
                                       gate=excess)[0]
    got = keys._exact_weight_flip(ties, alice, n_err, lambda: second,
                                  gated_tie_scores=lambda e: gated)
    # k as one int32 on the card, as the captured chunk passes it to K3 and KT
    k_dev = torch.tensor([n_err], dtype=torch.int32, device=dev)
    got_k = keys._exact_weight_flip(ties, alice, k_dev, lambda: second,
                                    gated_tie_scores=lambda e: gated)
    want = alice ^ keys._uniform_ties(ties, thresh, n_err, second, "xla")
    torch.cuda.synchronize()
    tie_diff = int((got != want).sum()) + int((got_k != want).sum())
    if int(excess) != 1 or not torch.equal(gated, second) or tie_diff or torch.equal(
            got, bob_idx) or not bool(((got ^ alice).sum(dim=1) == n_err).all()):
        raise AssertionError(f"the gated tie path differs from _uniform_ties: {tie_diff} bits")
    # no excess: the gated kernels leave Bob's row as K3 made it
    t0, bob0, ex0 = cuda_select.select_flip_cuda(scores, n_err, alice)
    kept = bob0.clone()
    cuda_select.complete_ties_cuda(scores, t0, n_err, second, alice, bob0, ex0)
    torch.cuda.synchronize()
    if int(ex0) != 0 or not torch.equal(bob0, kept):
        raise AssertionError("the gated tie kernel touched a batch without excess ties")
    # many ties a row, their second words few repeated values: the ties at t2
    # lie in every 512-word chunk of the row and are taken in index order
    many, second_rep, needs, n_ats = _many_ties(torch, scores, n_err, dev)
    t_m, bob_m, ex_m = cuda_select.select_flip_cuda(many, n_err, alice)
    index_order = bob_m.clone()
    cuda_select.complete_ties_cuda(many, t_m, n_err, second_rep, alice, bob_m, ex_m)
    want_m = alice ^ keys._uniform_ties(many, t_m, n_err, second_rep, "xla")
    torch.cuda.synchronize()
    many_diff = int((bob_m != want_m).sum())
    rows_moved = int((bob_m != index_order).any(dim=1).sum())
    if int(ex_m) != 1 or many_diff or not bool(((bob_m ^ alice).sum(dim=1) == n_err).all()) \
            or rows_moved < BATCH // 2:
        raise AssertionError(f"many ties a row: {many_diff} bits off _uniform_ties, "
                             f"{rows_moved} rows off index order")
    bob_w = bob_idx.clone()
    tie_ms = _time_ms(torch, lambda: cuda_select.complete_ties_cuda(
        ties, thresh, k_dev, second, alice, bob_w, excess), flush)
    tie_host_k_ms = _time_ms(torch, lambda: cuda_select.complete_ties_cuda(
        ties, thresh, n_err, second, alice, bob_w, excess), flush)
    tie_plain_ms = _time_ms(torch, lambda: alice ^ keys._uniform_ties(
        ties, thresh, n_err, second, "xla"), flush, repeats=5, warmup=1)
    tie_bound, tie_by = _bound(BATCH * N * (4 + 4 + 1 + 1) + BATCH * 4 + 4,
                               OPS_PER_SCORE_SELECT * BATCH * N)
    report["tie_path"] = {"rows": BATCH, "n": N, "k": n_err, "bits_differing": tie_diff,
                          "k_on_card_ms": tie_ms, "k_as_argument_ms": tie_host_k_ms,
                          "gated_words_equal": True, "untouched_without_excess": True,
                          "many_ties": {"ties_a_row": [min(n_ats), max(n_ats)],
                                        "need": [min(needs), max(needs)],
                                        "bits_differing": many_diff,
                                        "rows_off_index_order": rows_moved}}
    max_tie_err = float(tie_diff + many_diff)
    measured = {cuda_select.KERNEL_TIES: dict(
        max_abs_err=max_tie_err, ms=tie_ms, plain_ms=tie_plain_ms, bound_ms=tie_bound,
        bound_by=tie_by, library_ms=None)}

    # ---- the bookkeeping kernels against their plain versions, timed -----------
    g2 = torch.Generator(device=dev).manual_seed(7)
    for mode, kernel in ((device_loop.ENTRY, device_loop.KERNEL_ENTRY),
                         (device_loop.FLOODING, device_loop.KERNEL_STEP),
                         (device_loop.LAYERED, device_loop.KERNEL_SWEEP_STEP)):
        state = dict(
            ok=torch.rand(BATCH, device=dev, generator=g2) < 0.5,
            done=torch.rand(BATCH, device=dev, generator=g2) < 0.3,
            active=torch.rand(BATCH, device=dev, generator=g2) < 0.6,
            frozen=torch.rand(BATCH, device=dev, generator=g2) < 0.2,
            it=torch.tensor([5], dtype=torch.int32, device=dev),
            iters=torch.randint(0, 9, (BATCH,), dtype=torch.int32, device=dev,
                                generator=g2),
            passes=torch.zeros((), dtype=torch.int64, device=dev),
            go=torch.zeros(1, dtype=torch.bool, device=dev))
        a = {k: v.clone() for k, v in state.items()}
        b = {k: v.clone() for k, v in state.items()}
        args = ("ok", "done", "active", "frozen", "it", "iters")
        device_loop.loop_step_cuda(mode, *(a[k] for k in args), 9, a["passes"], a["go"])
        device_loop.loop_step_plain(mode, *(b[k] for k in args), 9, b["passes"], b["go"])
        torch.cuda.synchronize()
        diff = sum(int((a[k] != b[k]).sum()) for k in a)
        if diff:
            raise AssertionError(f"{kernel} differs from its plain version: {diff}")
        ms = _time_ms(torch, lambda: device_loop.loop_step_cuda(
            mode, *(a[k] for k in args), 9, a["passes"], a["go"]), flush)
        plain_ms = _time_ms(torch, lambda: device_loop.loop_step_plain(
            mode, *(b[k] for k in args), 9, b["passes"], b["go"]), flush)
        # read ok, done, active, frozen (and iters); write done, active (and
        # iters); it read and written, passes, go
        n_bytes = BATCH * (4 + 2) + (8 * BATCH if mode == device_loop.LAYERED else 0) + 17
        bound_ms, bound_by = _bound(n_bytes, 6 * BATCH)
        measured[kernel] = dict(max_abs_err=float(diff), ms=ms, plain_ms=plain_ms,
                                bound_ms=bound_ms, bound_by=bound_by, library_ms=None)

    # ---- no host round trip: the trial step and the decodes under sync debug ---
    sync_legs = {}
    opts_f = DecodeOptions(**base, **legs["flooding_sp_bf16"][2])
    opts_l = DecodeOptions(**base, **legs["layered_sp_bf16"][2])
    for name, step in (
            ("point_batch_partials_flooding", lambda: point_batch_partials(
                code, point_key, n_err, 0, BATCH, BATCH, opts_f, "pallas")),
            ("point_batch_partials_layered", lambda: point_batch_partials(
                code, point_key, n_err, 0, BATCH, BATCH, opts_l, "pallas")),
            ("decode_flooding", lambda: bp_decode_batch_last(code, *flagship, opts_f)),
            ("decode_layered", lambda: bp_decode_batch_last(code, *flagship, opts_l))):
        step()  # captured outside the gate
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            step()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        sync_legs[name] = "no synchronising call"
    report["sync_debug_error_mode"] = sync_legs

    # ---- the Reconciler: one chunk in flight against four, in turns -----------
    rec = Reconciler(code, DecodeOptions(**base, **sp), lanes=128, device=dev).warmup()
    alice_h, bob_h = (x.cpu().numpy() for x in keys.make_trial_batch(
        point_key, N, PROTOCOL_FRAMES, n_err, 0))
    syn_h = rec.syndromes(alice_h)
    q = n_err / N
    walls, results = {1: [], 4: []}, {}
    for window in (1, 4, 4, 1) * 3:
        rec.max_inflight_chunks = window
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = rec.reconcile(bob_h, syn_h, q)
        walls[window].append(time.perf_counter() - t0)
        results.setdefault(window, res)
    if not all(np.array_equal(getattr(results[1], f), getattr(results[4], f))
               for f in results[1]._fields) or not results[4].syndromes_match.all():
        raise AssertionError("the Reconciler's window changed its results")
    report["reconciler_window_walls_s"] = {
        "frames": PROTOCOL_FRAMES, "lanes": 128, "window_1": walls[1], "window_4": walls[4]}
    return report, measured


def _continuation_kernels(torch, dev, flush, code):
    """The kernels of ``csrc/continuation.cu`` against their plain versions on
    the card, bit for bit (every tensor each writes), at the flagship (B = S
    = 512 lanes, K = 64, three points, N = 10240): the start, the refill
    loop's test on six carries, the stage step on the next block, a point's
    advance, the clamp at the last point and ids across 2**32, the stage fill
    of a real K4 / K3 block, refills of K trials, of a point's tail (n_new <
    K) and of none, the pass step on a segment's first and later passes, and
    the banking into three points; then each timed at the flagship.  Returns
    {kernel name: measurement}."""
    from qkd_ldpc_tpu_torch.channel import cuda_prng, cuda_select
    from qkd_ldpc_tpu_torch.channel.keys import derive_point_key, num_errors_for
    from qkd_ldpc_tpu_torch.sim import cuda_continuation as steps
    from qkd_ldpc_tpu_torch.sim.continuation import continuation_inputs

    B = S = BATCH
    K, P, max_it = int(BATCH * REFILL_FRAC), 3, 100
    N, M, dc = code.n_vars, code.n_checks, code.dc_max
    trials = N_BATCHES * BATCH
    maps = code.to_device(dev)
    g = torch.Generator(device=dev).manual_seed(12)
    keys = [derive_point_key(MASTER_SEED, i) for i in range(P)]
    n_errs = [num_errors_for(N, q) for q in (0.075, 0.08, WATERFALL_QBER)]
    i32, u8 = torch.int32, torch.uint8

    def inputs(offset=0, n=trials):
        return continuation_inputs(keys, n_errs, n, offset, 10**6, N).to(dev)

    def flags_(p):
        return torch.rand(B, device=dev, generator=g) < p

    def lanes():
        live = flags_(0.7)
        age = torch.randint(-1, max_it + 1, (B,), dtype=i32, device=dev, generator=g)
        done = live & flags_(0.3)
        return dict(live=live, run=live & ~done & (age < max_it), done=done,
                    fresh=live & flags_(0.1), age=age,
                    lane_p=torch.randint(0, P, (B,), dtype=i32, device=dev, generator=g))

    def carry(**slots):
        st = torch.zeros(steps.SLOTS, dtype=i32, device=dev)
        for name, v in slots.items():
            st[getattr(steps, name)] = v
        return st

    def lane_tuple(s):
        return tuple(s[k] for k in ("live", "run", "done", "fresh", "age", "lane_p"))

    def bits(t):
        return t.view(torch.int32) if t.dtype == torch.float32 else (
            t.view(torch.int16) if t.dtype == torch.bfloat16 else t)

    measured, report = {}, {}

    def hold(name, cases, kernel, plain, n_bytes, n_ops):
        """``cases``: {case: state dict}; ``kernel(state, case)`` and
        ``plain(state, case)`` write into the state.  Bit-equal on every
        tensor of the state, then timed on the first case with the state
        restored before each run."""
        diff = {}
        for case, state in cases.items():
            a = {k: v.clone() for k, v in state.items()}
            b = {k: v.clone() for k, v in state.items()}
            kernel(a, case)
            plain(b, case)
            torch.cuda.synchronize()
            diff[case] = sum(int((bits(a[k]) != bits(b[k])).sum()) for k in state)
        if any(diff.values()):
            raise AssertionError(f"{name} differs from its plain version: {diff}")
        case0, first = next(iter(cases.items()))
        work = {k: v.clone() for k, v in first.items()}

        def restore():
            for k, v in first.items():
                work[k].copy_(v)

        ms = _time_ms(torch, lambda: kernel(work, case0), flush, prepare=restore)
        plain_ms = _time_ms(torch, lambda: plain(work, case0), flush, repeats=5, warmup=1,
                            prepare=restore)
        bound_ms, bound_by = _bound(n_bytes, n_ops)
        measured[name] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                              bound_by=bound_by, library_ms=None)
        report[name] = {"cases": list(cases), "bits_differing": 0, "ms": ms,
                        "plain_ms": plain_ms, "bound_ms": bound_ms}

    flags0 = torch.zeros(4, dtype=u8, device=dev)
    acc0 = torch.randint(0, 50, (7, P), dtype=i32, device=dev, generator=g)

    # cont_start
    s = dict(x=inputs(), acc=acc0.clone(), st=carry(BASE=5, POS=3, OUTER=9),
             flags=flags0.clone(), **lanes())
    hold(steps.KERNEL_START, {"flagship": s},
         lambda t, c: steps.start_cuda(t["x"], t["acc"], t["st"], lane_tuple(t), S, max_it,
                                    t["flags"]),
         lambda t, c: steps.start_plain(t["x"], t["acc"], t["st"], lane_tuple(t), S, max_it,
                                     t["flags"]),
         B * 12 + 28 * P + 4 * steps.SLOTS + 1, B)

    # cont_want: ids left or not, lanes free or not, the block used up or not
    cases = {}
    for sp, nid, live_n, pos in ((0, 100, 300, 64), (2, trials, 300, 64), (2, 64, 480, 64),
                                 (2, 64, 0, S), (1, 2048, 449, S), (2, 64, 448, 128)):
        cases[f"sp{sp}_next{nid}_live{live_n}_pos{pos}"] = dict(
            x=inputs(), st=carry(SP=sp, NEXT_ID=nid, LIVE_N=live_n, POS=pos, INNER=3),
            flags=flags0.clone())
    hold(steps.KERNEL_WANT, cases,
         lambda t, c: steps.want_cuda(t["x"], t["st"], B, P, K, S, 40, False, t["flags"]),
         lambda t, c: steps.want_plain(t["x"], t["st"], B, P, K, S, 40, False, t["flags"]),
         4 * 6 + 3 + 4, 8)

    # stage_step: the next block, a point's advance, the clamp, ids across 2**32
    cases = {
        "next_block": dict(x=inputs(), st=carry(BASE=512, SP=0, NEXT_ID=900, POS=S, EXCESS=1)),
        "advance": dict(x=inputs(), st=carry(BASE=1536, SP=0, NEXT_ID=2048, POS=S)),
        "clamp_at_last_point": dict(x=inputs(), st=carry(BASE=1536, SP=2, POS=S)),
        "ids_across_2**32": dict(x=inputs(2**32 - 700), st=carry(BASE=0, SP=1, POS=S)),
    }
    hold(steps.KERNEL_STAGE, cases,
         lambda t, c: steps.stage_step_cuda(t["x"], t["st"], S, P),
         lambda t, c: steps.stage_step_plain(t["x"], t["st"], S, P),
         4 * (6 + 2 * steps.SLOTS), 12)

    # stage_fill on a real staging block: K4's Alice row and K3's Bob row
    alice_rows, scores = cuda_prng.trial_words_cuda(keys[2], N, range(0, S),
                                                    ("alice", "scores"), dev)
    _, bob, _ = cuda_select.select_flip_cuda(scores, n_errs[2], alice_rows)
    st_mag = carry()
    st_mag[steps.MAG] = inputs()[steps.KEYS + 3 * P + 2]
    s = dict(alice_rows=alice_rows, bob=bob, st=st_mag,
             llr_s=torch.zeros((N, S), device=dev), syn_s=torch.zeros((M, S), dtype=torch.int8,
                                                                     device=dev),
             alice_s=torch.zeros((N, S), dtype=torch.int8, device=dev))
    hold(steps.KERNEL_FILL, {"flagship_block": s},
         lambda t, c: steps.stage_fill_cuda(t["alice_rows"], t["bob"], maps, t["st"], t["llr_s"],
                                         t["syn_s"], t["alice_s"]),
         lambda t, c: steps.stage_fill_plain(t["alice_rows"], t["bob"], maps, t["st"], t["llr_s"],
                                          t["syn_s"], t["alice_s"]),
         2 * S * N + 8 * dc * M + N * S * 5 + M * S, S * (N * 2 + M * dc))

    # refill_lanes: K trials mid-point; of a point of 2000 trials, its tail
    # (n_new = 16 < K) and a refill past it (n_new = 0)
    def lanes_case(base, pos, n=trials):
        st = carry(BASE=base, POS=pos, SP=1, NEXT_ID=base + pos, LIVE_N=300)
        return dict(x=inputs(n=n), st=st, lane_of=torch.zeros(K, dtype=i32, device=dev),
                    **lanes())
    cases = {"k_trials": lanes_case(512, 128), "tail_n_new_16": lanes_case(1536, 448, 2000),
             "none_past_the_tail": lanes_case(1536, 480, 2000)}
    hold(steps.KERNEL_LANES, cases,
         lambda t, c: steps.refill_lanes_cuda(t["x"], t["st"], lane_tuple(t), t["lane_of"], K),
         lambda t, c: steps.refill_lanes_plain(t["x"], t["st"], lane_tuple(t), t["lane_of"], K),
         B + 4 * K + K * 12 + 4 * 8, B)

    # refill_copy: K staged columns into chosen lanes, and a tail of 20
    staged = dict(llr_s=torch.randn((N, S), device=dev, generator=g),
                  syn_s=torch.randint(0, 2, (M, S), dtype=torch.int8, device=dev, generator=g),
                  alice_s=torch.randint(0, 2, (N, S), dtype=torch.int8, device=dev,
                                        generator=g))

    def copy_case(n_new):
        pool = dict(llr=torch.randn((N, B), device=dev, generator=g),
                    syn=torch.randint(0, 2, (M, B), dtype=torch.int8, device=dev, generator=g),
                    alice=torch.randint(0, 2, (N, B), dtype=torch.int8, device=dev,
                                        generator=g),
                    Lr=torch.randn((dc, M, B), device=dev, generator=g).to(torch.bfloat16))
        lane_of = torch.full((K,), -1, dtype=i32, device=dev)
        lane_of[:n_new] = torch.randperm(B, device=dev, generator=g)[:n_new].sort().values.to(
            i32)
        return dict(st=carry(COL0=128, N_NEW=n_new), lane_of=lane_of, **staged, **pool)

    def copy(fn):
        return lambda t, c: fn(t["st"], t["lane_of"], (t["llr_s"], t["syn_s"], t["alice_s"]),
                            (t["llr"], t["syn"], t["alice"], t["Lr"]))
    hold(steps.KERNEL_COPY, {"k_columns": copy_case(K), "tail_20": copy_case(20)},
         copy(steps.refill_copy_cuda), copy(steps.refill_copy_plain),
         K * (2 * (4 * N + N + M) + 2 * dc * M) + 4 * K, K * (2 * N + M + dc * M))

    # pass_step: a segment's first pass (fresh cleared) and a later one
    def pass_case():
        s = lanes()
        return dict(ok=flags_(0.4), done=s["done"], run=s["run"], age=s["age"],
                    fresh=s["fresh"])

    def pass_(fn):
        return lambda t, c: fn(t["ok"], t["done"], t["run"], t["age"], t["fresh"], max_it,
                               c == "first_pass")
    hold(steps.KERNEL_PASS, {"first_pass": pass_case(), "later_pass": pass_case()},
         pass_(steps.pass_step_cuda), pass_(steps.pass_step_plain), B * 10, B * 4)

    # bank: three points, z against Alice's bits with mismatches on some lanes
    s = lanes()
    z = torch.randint(0, 2, (N, B), dtype=torch.int8, device=dev, generator=g)
    alice = z.clone()
    alice[torch.randint(0, N, (B,), device=dev, generator=g), torch.arange(B, device=dev)] ^= (
        flags_(0.2).to(torch.int8))
    s.pop("fresh")
    state = dict(x=inputs(), acc=acc0.clone(), st=carry(SP=1, NEXT_ID=100), z=z, alice=alice,
                 mis=torch.zeros(B, dtype=i32, device=dev), flags=flags0.clone(), **s)
    n_spr = int((s["live"] & ~s["run"] & s["done"]).sum())

    def bank(fn):
        return lambda t, c: fn(t["x"], t["acc"], t["st"],
                            (t["live"], t["run"], t["done"], t["age"], t["lane_p"]), t["z"],
                            t["alice"], t["mis"], max_it, t["flags"])
    hold(steps.KERNEL_BANK, {"three_points": state}, bank(steps.bank_cuda),
         bank(steps.bank_plain), B * 11 + 2 * N * n_spr + 28 * P + B + 8, B * 8 + N * n_spr)
    report[steps.KERNEL_BANK]["lanes_banking_a_success"] = n_spr
    return measured, report


def _pool_bytes(torch, graph):
    """Bytes of the segments of a captured graph's private memory pool, or
    None where the allocator's snapshot does not name the pool."""
    pool = tuple(graph.graph.pool())
    sizes = [seg["total_size"] for seg in torch.cuda.memory_snapshot()
             if "segment_pool_id" in seg and tuple(seg["segment_pool_id"]) == pool]
    return sum(sizes) if sizes else None


def _chunk_graph(torch, np, dev, card, code, names, point_key, key_c, opts, opts_l, opts_c,
                 counted, as_stats):
    """The trial chunk as one CUDA graph (``chunk_graph``): sweep A through
    ``batch_simulation`` (config.example.json, compaction 8) captures once per
    code and replays once per point; the chunk graph equals the eager chunk
    (``device_loop.eager_loops()``) 7/7 with equal launch counts per kernel,
    one replay per chunk, on the ``run_point`` legs (flooding and layered in
    SP/bf16 and min-sum/int8, the continuation's crossover point) and on a
    trial mesh of four shards on the card (also equal to ``run_point``); one
    captured graph replays for four inputs that differ in key, error count,
    first trial (one across 2**32) and tail, each equal to its eager chunk;
    nothing raises under ``torch.cuda.set_sync_debug_mode("error")`` across
    ``_dispatch_point`` (flooding and layered); and every graph captured here
    reports its capture time, node counts and pool bytes."""
    from qkd_ldpc_tpu_torch.channel import cuda_select
    from qkd_ldpc_tpu_torch.channel.keys import derive_point_key, num_errors_for
    from qkd_ldpc_tpu_torch.codes import list_matrix_files
    from qkd_ldpc_tpu_torch.config import load_config
    from qkd_ldpc_tpu_torch.decoder import device_loop
    from qkd_ldpc_tpu_torch.parallel import make_trial_mesh, run_point_sharded
    from qkd_ldpc_tpu_torch.sim import run_point, runner

    K1, K2, K3, K4, K5, K6, KV = names
    N = code.n_vars
    trials = N_BATCHES * BATCH
    report = {"card": card, "trials_per_leg": trials, "batch": BATCH}
    captured = []  # (what, graph, seconds) of each capture of this phase
    real_capture = device_loop.Graph.capture
    what = ["?"]

    def timed_capture(graph, *args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_capture(graph, *args, **kwargs)
        torch.cuda.synchronize()
        captured.append((what[0], graph, time.perf_counter() - t0))
        return out

    device_loop.Graph.capture = timed_capture
    tmp = Path(tempfile.mkdtemp(prefix="chunk_graph_"))
    try:
        # ---- sweep A: one capture a code, one replay a point -------------------
        what[0] = "sweep_A"
        _, example = _reference_alist_and_example()
        matrices = _matrix_dir(code, tmp / "matrices")
        (tmp / "config.json").write_text(json.dumps(dict(
            example, checkpoint_dir="", results_dir=str(tmp / "results"),
            matrix_dir=str(matrices), compact_after=8)))
        cfg = load_config(tmp / "config.json")
        inputs = runner.prepare_sim_inputs(list_matrix_files(matrices), cfg)
        points = sum(len(si.qber) for si in inputs)
        with _counting_calls(device_loop.Graph, "replay") as replays:
            t0 = time.perf_counter()
            results = runner.batch_simulation(inputs, cfg, progress=False, device=dev)
            torch.cuda.synchronize()
            sweep_s = time.perf_counter() - t0
        if len(results) != points or len(captured) != len(inputs) or replays[0] != points:
            raise AssertionError(f"sweep A: {len(captured)} captures for {len(inputs)} codes, "
                                 f"{replays[0]} replays for {points} points")
        report["sweep_A"] = {"codes": len(inputs), "points": points, "captures": len(captured),
                             "replays": replays[0], "first_run_s": sweep_s}

        # ---- the chunk graph against the eager chunk, leg by leg ----------------
        ms = dict(algorithm="min-sum", message_dtype="int8")
        mesh = make_trial_mesh([dev] * PARALLEL_SHARDS)
        legs = {
            "flooding_sp_bf16": (lambda: run_point(
                code, point_key, QBER, trials, BATCH, opts, prng="pallas"), 1),
            "flooding_ms_int8": (lambda: run_point(
                code, point_key, QBER, trials, BATCH, dataclasses.replace(opts, **ms),
                prng="pallas"), 1),
            "layered_sp_bf16": (lambda: run_point(
                code, point_key, QBER, trials, BATCH, opts_l, prng="pallas"), 1),
            "layered_ms_int8": (lambda: run_point(
                code, point_key, QBER, trials, BATCH, dataclasses.replace(opts_l, **ms),
                prng="pallas"), 1),
            "continuation_crossover_point": (lambda: run_point(
                code, key_c, WATERFALL_QBER, trials, BATCH, opts_c), 1),
            "trial_mesh_flooding_sp_bf16": (lambda: run_point_sharded(
                code, point_key, QBER, trials, BATCH, opts, mesh), PARALLEL_SHARDS),
        }
        kernels = (K1, K2, K3, K4, KV, K6, cuda_select.KERNEL_TIES, device_loop.KERNEL_ENTRY,
                   device_loop.KERNEL_STEP, device_loop.KERNEL_SWEEP_STEP)
        legs_report = {}
        for name, (step, chunks) in legs.items():
            what[0] = name
            step()  # captures the leg's graph where it is new
            with _counting_calls(device_loop.Graph, "replay") as replays:
                (p_graph, _), graph_s, graph_counts = counted(step)
            with device_loop.eager_loops():
                (p_eager, _), eager_s, eager_counts = counted(step)
            differing = {k: (graph_counts.get(k, 0), eager_counts.get(k, 0)) for k in kernels
                         if graph_counts.get(k, 0) != eager_counts.get(k, 0)}
            if as_stats(p_graph) != as_stats(p_eager) or differing or replays[0] != chunks:
                raise AssertionError(
                    f"chunk_graph {name}: graph {as_stats(p_graph)} against eager "
                    f"{as_stats(p_eager)}, launches differing {differing}, "
                    f"{replays[0]} replays for {chunks} chunks")
            # every shard's chunk runs N_BATCHES batches of its lanes
            batches = N_BATCHES * chunks
            if (graph_counts.get(K4, 0), graph_counts.get(K3, 0), graph_counts.get(K1, 0)) != (
                    2 * batches, batches, 0 if name.startswith("layered") else batches):
                raise AssertionError(f"chunk_graph {name}: launches {graph_counts} for "
                                     f"{batches} batches")
            legs_report[name] = {"partials": as_stats(p_graph), "replays": replays[0],
                                 "launches": graph_counts, "graph_s": graph_s,
                                 "eager_s": eager_s}
        if legs_report["trial_mesh_flooding_sp_bf16"]["partials"] != (
                legs_report["flooding_sp_bf16"]["partials"]):
            raise AssertionError("chunk_graph: the trial mesh differs from run_point")
        report["graph_equals_eager"] = legs_report

        # ---- one graph, four inputs: nothing of the first is frozen in ----------
        what[0] = "four_inputs"
        cases = (
            ("qber_0.05_from_0", point_key, num_errors_for(N, QBER), 0, 2 * BATCH),
            ("waterfall_across_2**32_tail", key_c, num_errors_for(N, WATERFALL_QBER),
             2**32 - 300, 2 * BATCH - 212),
            ("qber_0.03_tail", derive_point_key(MASTER_SEED, 5), num_errors_for(N, 0.03),
             12345, BATCH + 1),
            ("qber_0.06", derive_point_key(MASTER_SEED, 6), num_errors_for(N, 0.06), 7,
             2 * BATCH),
        )

        def chunk(key, n_err, first, valid):
            return runner._point_chunk(code, key, n_err, first, valid, BATCH, 2, opts,
                                       "pallas", dev)

        before = len(captured)
        with _counting_calls(device_loop.Graph, "replay") as replays:
            graph_out = [chunk(*c[1:]).tolist() for c in cases]
        with device_loop.eager_loops():
            eager_out = [chunk(*c[1:]).tolist() for c in cases]
        if graph_out != eager_out or len({tuple(o) for o in graph_out}) != len(cases) or (
                len(captured) - before != 1 or replays[0] != len(cases)):
            raise AssertionError(f"one graph, four inputs: graph {graph_out}, eager "
                                 f"{eager_out}, {len(captured) - before} captures, "
                                 f"{replays[0]} replays")
        report["one_graph_four_inputs"] = {
            c[0]: {"n_errors": c[2], "first": c[3], "valid": c[4], "partials": o}
            for c, o in zip(cases, graph_out)}

        # ---- no host synchronisation across _dispatch_point ----------------------
        sync = {}
        for name, o in (("flooding", opts), ("layered", opts_l)):
            want = as_stats(runner._collect_point(runner._dispatch_point(
                code, point_key, QBER, trials, BATCH, o, prng="pallas", device=dev)[0]))
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                futures, _ = runner._dispatch_point(code, point_key, QBER, trials, BATCH, o,
                                                    prng="pallas", device=dev)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            if as_stats(runner._collect_point(futures)) != want:
                raise AssertionError(f"_dispatch_point {name} under the sync gate differs")
            sync[name] = "no synchronising call"
        report["sync_debug_error_mode_dispatch_point"] = sync
    finally:
        device_loop.Graph.capture = real_capture
        shutil.rmtree(tmp, ignore_errors=True)

    # ---- what each capture cost ------------------------------------------------
    report["captures"] = [{
        "leg": leg, "seconds": seconds, "nodes": graph.nodes, "kernel_nodes": len(graph.outer),
        "while_nodes": len(graph.bodies), "while_body_kernels": sum(map(len, graph.bodies)),
        "loop_counters": int(graph.passes.shape[0]), "pool_bytes": _pool_bytes(torch, graph)}
        for leg, graph, seconds in captured]
    return report


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1

    from qkd_ldpc_tpu_torch import _build
    from qkd_ldpc_tpu_torch.channel import cuda_prng, cuda_select
    from qkd_ldpc_tpu_torch.channel.keys import (
        derive_point_key,
        make_trial_batch,
        num_errors_for,
    )
    from qkd_ldpc_tpu_torch.channel import threefry
    from qkd_ldpc_tpu_torch.codes import make_qc_code
    from qkd_ldpc_tpu_torch.decoder import cuda_kernels, cuda_layered, device_loop, layered
    from qkd_ldpc_tpu_torch.decoder.bp import DecodeOptions
    from qkd_ldpc_tpu_torch.decoder.reconcile import apriori_llr, reconcile
    from qkd_ldpc_tpu_torch.decoder.syndrome import syndrome
    from qkd_ldpc_tpu_torch.parallel import make_trial_mesh
    from qkd_ldpc_tpu_torch.sim import (
        continuation,
        cuda_continuation,
        dispatch_sweep_continuation,
        run_point,
        run_point_continuation,
    )
    from qkd_ldpc_tpu_torch.sim.continuation import run_point_continuation_sharded
    from qkd_ldpc_tpu_torch.sim.stats import STAT_KEYS, PointPartials, partials_from_stacked
    from qkd_ldpc_tpu_torch.utils import card_name_and_power_limit

    dev = torch.device("cuda")
    phase_seconds = {}
    clock = [None, time.perf_counter()]

    def phase_start(name):
        """Close the running phase's wall time and open ``name``'s."""
        torch.cuda.synchronize()
        now = time.perf_counter()
        if clock[0] is not None:
            phase_seconds[clock[0]] = now - clock[1]
        clock[:] = [name, now]
    torch.manual_seed(0)
    profiling = "--profile" in sys.argv[1:]

    # ---- phase 1: device, toolchain, build ---------------------------------
    phase_start("device_and_build")
    card = card_name_and_power_limit()
    _build.build_all()
    nvcc_release = subprocess.run(
        [_build.nvcc_path(), "--version"], check=True, capture_output=True, text=True
    ).stdout.strip().splitlines()[-2]
    # Zeroing 1 GiB flushes the 50 MB L2 and keeps the card busy long enough
    # for the host to queue the timed launch behind it (no host gap in the
    # event window of a single short kernel).
    flush = torch.empty(1 << 30, dtype=torch.uint8, device=dev)
    big_a = torch.empty(1 << 30, dtype=torch.uint8, device=dev)
    big_b = torch.empty_like(big_a)
    copy_ms = _time_ms(torch, lambda: big_b.copy_(big_a), flush, repeats=10)
    copy_bytes_per_s = 2 * big_a.numel() / (copy_ms * 1e-3)
    del big_a, big_b
    print(json.dumps({"device": {
        "card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
        "nvcc": nvcc_release, "build_seconds": round(_build.build_seconds, 2),
        "libraries": len(_build.LIBRARIES),
        "copy_bytes_per_s": copy_bytes_per_s,
        "datasheet_bytes_per_s": HBM_BYTES_PER_S,
    }}), flush=True)

    # ---- phase 2: every kernel against its plain version -------------------
    phase_start("kernels")
    code = make_qc_code(z=Z, nb=NB, mb=MB_ROWS, dv=DV, seed=CODE_SEED)
    N, M, dc = code.n_vars, code.n_checks, code.dc_max
    maps = code.to_device(dev)
    tables = layered.layer_tables(code, dev)
    ncells = tables.col.shape[0]
    n_err = num_errors_for(N, QBER)
    gen = torch.Generator(device=dev).manual_seed(1234)
    point_key = derive_point_key(MASTER_SEED, POINT_INDEX)

    # A mask with padded slots (slot 0 always real) for the correctness matrix;
    # the timings use the flagship code's own (full) mask.
    pad_mask = (torch.rand((dc, M), device=dev, generator=gen) < 0.9)
    pad_mask[0] = True
    maps_padded = dataclasses.replace(
        maps, chk_mask_T=pad_mask, chk_mask_T_i32=pad_mask.to(torch.int32))
    # The sweep's inputs: a real batch of the flagship point, and a mixed mask.
    alice, bob = make_trial_batch(point_key, N, BATCH, n_err, 0)
    llr0 = apriori_llr(bob, np.float32(n_err) / np.float32(N)).T
    syn0 = syndrome(code, alice).T
    act_mixed = torch.rand((BATCH,), device=dev, generator=gen) < 0.7
    act_all = torch.ones((BATCH,), dtype=torch.bool, device=dev)

    matrix = []
    main_entries = {}
    other_widths = []
    for algorithm in ("sum-product", "min-sum"):
        for dtype_name in ("float32", "bfloat16", "int8"):
            scale = 0.25 if dtype_name == "int8" else None
            mdt = cuda_kernels.STORAGE_DTYPES[dtype_name]
            is_main = (algorithm, dtype_name) == ("sum-product", "bfloat16")
            kw = dict(threshold=100.0, clip=True, algorithm=algorithm,
                      min_sum_alpha=0.8, min_sum_beta=0.0, scale=scale)
            x = _flooding_inputs(torch, dev, gen, code, BATCH, dtype_name, scale)
            itemsize = x["tot"].element_size()
            if min(cuda_kernels.vector_width(k, BATCH, mdt, x["tot"])
                   for k in ("check_update", "variable_update")) <= 1:
                raise AssertionError("the flagship batch does not take the vector instances")
            n_edge = dc * M * BATCH
            for name, first, mode in _check_modes(kw, x["fresh"]):
                worst, n_diff = 0.0, 0
                for code_maps in (maps, maps_padded):
                    err, nd = _compare_check(torch, x, code_maps, code_maps is maps,
                                             first, mode, dtype_name, algorithm, scale)
                    worst, n_diff = max(worst, err), n_diff + nd
                args = (x["tot"], None if first else x["lrp"], x["syn"], maps)
                # timed as the loops call it: the flag buffer comes set from
                # the variable update (here: set again before each run)
                buf = None if first else torch.ones((BATCH,), dtype=torch.bool, device=dev)
                ms = _time_ms(torch, lambda: cuda_kernels.check_update_cuda(
                    *args, ok=buf, **mode), flush,
                    prepare=None if first else lambda: buf.fill_(True))
                plain_ms = _time_ms(torch, lambda: cuda_kernels.check_update_plain(
                    *args, **mode), flush, repeats=5, warmup=1)
                # total read once, Lr read (not in iteration 1) and written, one
                # syndrome byte per (check, frame), the two index tables, ok
                # and fresh one byte per frame
                n_bytes = (N * BATCH * itemsize + (1 if first else 2) * n_edge * itemsize
                           + M * BATCH + 2 * dc * M * 4 + (0 if first else BATCH)
                           + (BATCH if "fresh" in mode else 0))
                bound_ms, bound_by = _bound(
                    n_bytes, (OPS_PER_EDGE[algorithm]
                              + (0 if first else OPS_PER_EDGE_SYNDROME)) * n_edge)
                entry = {
                    "name": name, "algorithm": algorithm, "storage": dtype_name,
                    "max_abs_err": worst, "entries_differing": n_diff,
                    "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                    "bound_by": bound_by, "bytes": n_bytes,
                    "bound_ms_at_copy_rate": n_bytes / copy_bytes_per_s * 1e3,
                }
                matrix.append(entry)
                if is_main:
                    main_entries[name] = entry
            if algorithm == "sum-product":  # the variable update has no algorithm
                worst, n_diff = _compare_variable(torch, x, maps, scale)
                z_w, count_w = x["z"].clone(), x["count"].clone()
                ms = _time_ms(torch, lambda: cuda_kernels.variable_update_cuda(
                    x["lrp"], x["llr"], z_w, count_w, act_all, maps, scale=scale), flush)
                plain_ms = _time_ms(torch, lambda: cuda_kernels.variable_update_plain(
                    x["lrp"], x["llr"], x["z"], x["count"], act_all, maps, scale=scale),
                    flush, repeats=5, warmup=1)
                # Lr and llr read, total and z written, the slot table, the
                # flags, the counts read and written
                n_bytes = (n_edge * itemsize + N * BATCH * 4 + N * BATCH * itemsize
                           + N * BATCH + DV * N * 4 + BATCH + 2 * BATCH * 4)
                bound_ms, bound_by = _bound(n_bytes, n_edge + OPS_PER_VARIABLE * N * BATCH)
                entry = {
                    "name": cuda_kernels.KERNEL_VARIABLE, "algorithm": None,
                    "storage": dtype_name, "max_abs_err": worst,
                    "entries_differing": n_diff, "active_frames": int(x["active"].sum()),
                    "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                    "bound_by": bound_by, "bytes": n_bytes,
                    "bound_ms_at_copy_rate": n_bytes / copy_bytes_per_s * 1e3,
                }
                matrix.append(entry)
                if is_main:
                    main_entries[cuda_kernels.KERNEL_VARIABLE] = entry
                del z_w, count_w
            del x

            # The same kernels at the compacted width (vector instances) and at
            # a ragged width (scalar instances), padded mask, correctness only.
            for width in (COMPACT_BATCH, RAGGED_BATCH):
                x = _flooding_inputs(torch, dev, gen, code, width, dtype_name, scale)
                vec = [cuda_kernels.vector_width(k, width, mdt, x["tot"])
                       for k in ("check_update", "variable_update")]
                if (min(vec) <= 1) == (width == COMPACT_BATCH) or (
                        max(vec) > 1) == (width == RAGGED_BATCH):
                    raise AssertionError(f"B = {width} took the wrong instances ({vec})")
                worst, n_diff = 0.0, 0
                for name, first, mode in _check_modes(kw, x["fresh"]):
                    err, nd = _compare_check(torch, x, maps_padded, False, first, mode,
                                             dtype_name, algorithm, scale)
                    worst, n_diff = max(worst, err), n_diff + nd
                err, nd = _compare_variable(torch, x, maps, scale)
                other_widths.append({
                    "batch": width, "frames_per_thread": vec, "algorithm": algorithm,
                    "storage": dtype_name, "max_abs_err": max(worst, err),
                    "entries_differing": n_diff + nd})
                del x

            # K6: one sweep from a state two (plain) sweeps into the decode of
            # a real batch, mixed act mask; then timed with every frame active.
            state = layered.initial_state(tables, llr0, syn0, mdt)
            t_s, lr_s, syn3 = state
            for _ in range(2):
                t_s, lr_s, _ = layered.layered_sweep_plain(
                    t_s, lr_s, syn3, act_all, tables, **kw)
            ref = layered.layered_sweep_plain(t_s, lr_s, syn3, act_mixed, tables, **kw)
            got = cuda_layered.layered_sweep_cuda(
                t_s.clone(), lr_s.clone(), syn3, act_mixed, tables, **kw)
            torch.cuda.synchronize()
            worst, n_diff = _compare_sweep(
                torch, got, ref, act_mixed, dtype_name, algorithm, scale, DV)
            # again on totals one float past a 16-byte boundary: the kernel then
            # copies them float by float
            t_off = torch.empty(t_s.numel() + 1, dtype=t_s.dtype, device=dev)[1:]
            t_off = t_off.view(t_s.shape).copy_(t_s)
            if (cuda_layered.copy_width(Z, t_s), cuda_layered.copy_width(Z, t_off)) != (4, 1):
                raise AssertionError("the sweep's copy width does not follow alignment")
            got = cuda_layered.layered_sweep_cuda(
                t_off, lr_s.clone(), syn3, act_mixed, tables, **kw)
            torch.cuda.synchronize()
            err_off, n_off = _compare_sweep(
                torch, got, ref, act_mixed, dtype_name, algorithm, scale, DV)
            worst, n_diff = max(worst, err_off), n_diff + n_off
            del got, ref, t_off
            t_w, lr_w = t_s.clone(), lr_s.clone()  # the timed sweeps run in place
            ms = _time_ms(torch, lambda: cuda_layered.layered_sweep_cuda(
                t_w, lr_w, syn3, act_all, tables, **kw), flush)
            plain_ms = _time_ms(torch, lambda: layered.layered_sweep_plain(
                t_s, lr_s, syn3, act_all, tables, **kw), flush, repeats=3, warmup=1)
            n_edge = ncells * Z * BATCH
            # per frame: t read and written, Lr read and written, one syndrome
            # byte per lifted check; act and ok one byte each
            n_bytes = BATCH * (2 * NB * Z * 4 + 2 * ncells * Z * lr_s.element_size()
                               + MB_ROWS * Z + 2)
            bound_ms, bound_by = _bound(
                n_bytes, (OPS_PER_EDGE[algorithm] + OPS_PER_EDGE_LAYERED_EXTRA) * n_edge)
            entry = {
                "name": cuda_layered.KERNEL_NAME, "algorithm": algorithm,
                "storage": dtype_name, "max_abs_err": worst,
                "entries_differing": n_diff, "active_frames": int(act_mixed.sum()),
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "bytes": n_bytes,
                "bound_ms_at_copy_rate": n_bytes / copy_bytes_per_s * 1e3,
            }
            matrix.append(entry)
            if is_main:
                main_entries[cuda_layered.KERNEL_NAME] = entry
            del state, t_s, lr_s, syn3, t_w, lr_w

    # K6 again on the wide code (all six cells): the frame's totals do not fit
    # shared memory, so the kernel updates them in global memory.
    wide = make_qc_code(z=Z, nb=WIDE_NB, mb=WIDE_MB, dv=DV, seed=WIDE_SEED)
    wide_tables = layered.layer_tables(wide, dev)
    if not cuda_layered.totals_in_shared_memory(NB, Z, MB_ROWS, ncells) or (
            cuda_layered.totals_in_shared_memory(WIDE_NB, Z)):
        raise AssertionError("the wide code does not reach the global-memory mode")
    wide_err = num_errors_for(wide.n_vars, QBER)
    k4, k3, channel_details = _channel_kernels(
        torch, dev, flush, point_key, N, n_err, wide.n_vars, wide_err, gen)
    a_w, b_w = make_trial_batch(point_key, wide.n_vars, WIDE_BATCH, wide_err, 0)
    llr_w = apriori_llr(b_w, np.float32(wide_err) / np.float32(wide.n_vars)).T
    syn_w = syndrome(wide, a_w).T
    act_w = torch.rand((WIDE_BATCH,), device=dev, generator=gen) < 0.7
    act_all_w = torch.ones_like(act_w)
    wide_cells = []
    for algorithm in ("sum-product", "min-sum"):
        for dtype_name in ("float32", "bfloat16", "int8"):
            scale = 0.25 if dtype_name == "int8" else None
            kw = dict(threshold=100.0, clip=True, algorithm=algorithm,
                      min_sum_alpha=0.8, min_sum_beta=0.0, scale=scale)
            t_s, lr_s, syn3 = layered.initial_state(
                wide_tables, llr_w, syn_w, cuda_kernels.STORAGE_DTYPES[dtype_name])
            t_s, lr_s, _ = layered.layered_sweep_plain(
                t_s, lr_s, syn3, act_all_w, wide_tables, **kw)
            ref = layered.layered_sweep_plain(t_s, lr_s, syn3, act_w, wide_tables, **kw)
            got = cuda_layered.layered_sweep_cuda(
                t_s.clone(), lr_s.clone(), syn3, act_w, wide_tables, **kw)
            torch.cuda.synchronize()
            worst, n_diff = _compare_sweep(
                torch, got, ref, act_w, dtype_name, algorithm, scale, DV)
            t_w = t_s.clone()
            wide_cells.append({
                "algorithm": algorithm, "storage": dtype_name, "max_abs_err": worst,
                "entries_differing": n_diff,
                "ms": _time_ms(torch, lambda: cuda_layered.layered_sweep_cuda(
                    t_w, lr_s, syn3, act_all_w, wide_tables, **kw),
                    flush, repeats=5, warmup=1),
            })
            del t_s, lr_s, syn3, ref, got, t_w
    # SP, clip, row degree 6, shared totals: one thread per lifted check
    sweep_threads = -(-Z // 32) * 32
    sweep_shared = NB * Z * 4 + -(-(MB_ROWS + 1 + 2 * ncells) * 4 // 16) * 16
    flagship_instance = ("Li0ELb1ELi6ELb1E", sweep_threads, sweep_shared)
    print(json.dumps({"kernel_matrix": matrix}), flush=True)
    print(json.dumps({"channel_kernels": dict(
        card=card, trial_words=k4, kth_smallest=k3, **channel_details)}), flush=True)
    print(json.dumps({"flooding_kernels_other_widths": other_widths}), flush=True)
    print(json.dumps({"layered_sweep_global_memory_mode": {
        "card": card, "code": wide.name, "n_vars": wide.n_vars,
        "batch": WIDE_BATCH, "active_frames": int(act_w.sum()),
        "totals_bytes_per_frame": WIDE_NB * Z * 4, "cells": wide_cells}}), flush=True)
    print(json.dumps({"layered_sweep_resources": dict(
        card=card, instance="sum-product, clip, row degree 6, bfloat16, shared totals",
        threads=sweep_threads, shared_bytes=sweep_shared,
        **_sweep_kernel_resources(_build.build_log("layered_sweep_bfloat16"),
                                  flagship_instance))}), flush=True)
    del wide, wide_tables, a_w, b_w, llr_w, syn_w
    del alice, bob, llr0, syn0

    # ---- phase 2b: every check degree (fault F1 closed) ----------------------
    phase_start("f1_degrees")
    f1_line, flooding_degrees, layered_degrees = _f1_degrees(
        torch, np, dev, gen, flush, card, copy_bytes_per_s)
    f1_line["flagship_dc6_ms"] = {K: main_entries[K]["ms"] for K in (
        cuda_kernels.KERNEL_FUSED, cuda_layered.KERNEL_NAME)}
    print(json.dumps({"f1_degrees": f1_line}), flush=True)

    # ---- phase 3: the main path (flooding) ---------------------------------
    phase_start("main_path")
    base = dict(max_iterations=100, clip_messages=True, message_threshold=100.0,
                message_dtype="bfloat16")
    opts = DecodeOptions(algorithm="sum-product", backend="auto", compact_after=8,
                         compact_lanes=BATCH // 4, **base)
    trials = N_BATCHES * BATCH
    names = (cuda_kernels.KERNEL_FIRST, cuda_kernels.KERNEL_FUSED,
             cuda_select.KERNEL_NAME, cuda_prng.KERNEL_NAME,
             cuda_kernels.KERNEL_FRESH, cuda_layered.KERNEL_NAME,
             cuda_kernels.KERNEL_VARIABLE)
    K1, K2, K3, K4, K5, K6, KV = names
    KT, KB = cuda_select.KERNEL_TIES, cuda_prng.KERNEL_BLOCK
    KE, KS, KW = device_loop.KERNEL_ENTRY, device_loop.KERNEL_STEP, device_loop.KERNEL_SWEEP_STEP
    (KC_START, KC_WANT, KC_STAGE, KC_FILL, KC_LANES, KC_COPY, KC_PASS,
     KC_BANK) = cuda_continuation.KERNELS

    def counted(step):
        """Drive one path with the launch counts set to 0 just before it and
        read just after; returns (result, seconds, counts).  The trial keys
        are K4's work on the card: the plain threefry tree must not run on a
        CUDA tensor in any counted run."""
        real = threefry.threefry2x32
        on_card = []

        def watched(k0, k1, x0, x1):
            if any(isinstance(x, torch.Tensor) and x.is_cuda for x in (k0, k1, x0, x1)):
                on_card.append(1)
            return real(k0, k1, x0, x1)

        torch.cuda.synchronize()
        _build.reset_launch_counts()
        threefry.threefry2x32 = watched
        try:
            t0 = time.perf_counter()
            result = step()
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        finally:
            threefry.threefry2x32 = real
        if on_card:
            raise AssertionError(f"the plain threefry tree ran {len(on_card)} times on the card")
        return result, seconds, _build.launch_counts()

    def channel_launches(path, counts, batches):
        """A batch of trials is K4 (Alice's bits and the scores), K3, and the
        second-word tie path gated on K3's flag on the card: K4's tie-row
        launch and the tie kernel, each once a batch, both doing nothing
        where the flag is 0 (no host read decides it)."""
        got = (counts.get(K4, 0), counts.get(K3, 0), counts.get(KT, 0))
        if got != (2 * batches, batches, batches):
            raise AssertionError(
                f"{path}: {got} trial_words, kth_smallest and complete_ties launches "
                f"for {batches} batches of trials")


    def as_stats(p):
        return {k: getattr(p, k) for k in STAT_KEYS}

    def replay_batches(o):
        """Decode the point's batches again (outside any counted run) to read
        each batch's iteration counts: (max iterations per batch, whether a
        batch overflowed its compaction lanes, [sum_it, n_sp, n_ldpc])."""
        worst, overflowed, total = [], False, None
        for i in range(N_BATCHES):
            a, b = make_trial_batch(point_key, N, BATCH, n_err, i * BATCH)
            # the float32 QBER the runner decodes with
            res = reconcile(code, a, b, np.float32(n_err) / np.float32(N), o)
            worst.append(int(res.iterations.max()))
            overflowed |= int((res.iterations > o.compact_after).sum()) > o.compact_lanes
            part = torch.stack([res.iterations.sum(), res.syndromes_match.sum(),
                                res.keys_match.sum()]).cpu()
            total = part if total is None else total + part
        return worst, overflowed, [int(x) for x in total]

    def flooding_step():
        return run_point(code, point_key, QBER, trials, BATCH, opts, prng="pallas")

    flooding_step()  # warm-up: captures the chunk's graph
    with _counting_calls(device_loop.Graph, "replay") as replays:
        (partials, actual_qber), seconds, launches = counted(flooding_step)
    replays_main = replays[0]
    if replays_main != 1:
        raise AssertionError(f"main path: {replays_main} graph replays for one chunk of "
                             f"{N_BATCHES} batches")
    # every batch's decode: one replay; its loops' bookkeeping on the card
    if launches.get(KE, 0) != 3 * N_BATCHES or launches.get(KS, 0) != launches.get(K2, 0):
        raise AssertionError(f"main path: loop kernels {launches}")

    stats = as_stats(partials)
    mean_it = partials.sum_it / max(partials.n_sp, 1)
    if not (partials.n_sp == partials.n_trials == partials.n_ldpc == trials):
        raise AssertionError(f"main path: not every trial decoded: {stats}")
    if not MEAN_ITERATIONS_GATE[0] <= mean_it <= MEAN_ITERATIONS_GATE[1]:
        raise AssertionError(f"main path: implausible mean iterations {mean_it}")
    for name in (K1, K2, K3, K4, KV):
        if launches.get(name, 0) <= 0:
            raise AssertionError(f"main path never launched kernel {name}")
    if launches[K1] != N_BATCHES:
        raise AssertionError(f"{K1}: {launches[K1]} launches, "
                             f"expected one per batch ({N_BATCHES})")
    channel_launches("main path", launches, N_BATCHES)

    # An iteration is one variable update and one check update (K2), whose
    # syndrome flag belongs to that iteration and whose messages are the next
    # one's (unused after a phase's last iteration): without compaction
    # overflow a batch costs max(iterations) launches of each.
    worst, overflowed, replay = replay_batches(opts)
    expected_fused = sum(worst)
    if replay != [int(partials.sum_it), trials, trials]:
        raise AssertionError("replayed batches disagree with run_point's partials")
    fused = launches[K2]
    if (fused < expected_fused) or (not overflowed and fused != expected_fused) or (
            launches[KV] != fused):
        raise AssertionError(
            f"check_update_fused launched {fused} times and variable_update "
            f"{launches[KV]} times, iteration counts say {expected_fused} "
            f"(overflow: {overflowed})")
    # The eager kernel loop (the version the graphs are held against) fetches
    # one flag per pass; on an idle stream that fetch costs this much (its
    # floor — in the loop it also waits for the pass's kernels).
    flag = torch.zeros(BATCH, dtype=torch.bool, device=dev)
    sync_times = []
    for _ in range(200):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        bool(flag.any())
        sync_times.append((time.perf_counter() - t1) * 1e3)
    print(json.dumps({"main_path": {
        "card": card, "code": code.name, "qber": actual_qber, "trials": trials,
        "batch": BATCH, "partials": stats, "mean_iterations": mean_it,
        "launches": launches, "expected_fused_launches": expected_fused,
        "graph_replays_per_chunk": replays_main, "batches_per_chunk": N_BATCHES,
        "compaction_overflow": overflowed, "seconds": seconds,
        "frames_per_s": trials / seconds,
        "ms_per_decode_iteration": seconds * 1e3 / fused,
        "idle_flag_fetch_ms": statistics.median(sync_times),
    }}), flush=True)

    # ---- phase 3b: the layered path ------------------------------------------
    phase_start("layered_path")
    opts_l = DecodeOptions(
        algorithm="sum-product", backend="auto", schedule="layered",
        compact_after=LAYERED_COMPACT_AFTER, compact_lanes=BATCH // 4, **base)

    def layered_step():
        return run_point(code, point_key, QBER, trials, BATCH, opts_l, prng="pallas")

    layered_step()  # warm-up: captures the chunk's graph
    (partials_l, _), seconds_l, launches_l = counted(layered_step)
    stats_l = as_stats(partials_l)
    mean_sweeps = partials_l.sum_it / max(partials_l.n_sp, 1)
    if not (partials_l.n_sp == partials_l.n_trials == partials_l.n_ldpc == trials):
        raise AssertionError(f"layered path: not every trial decoded: {stats_l}")
    if not MEAN_SWEEPS_GATE[0] <= mean_sweeps <= MEAN_SWEEPS_GATE[1]:
        raise AssertionError(f"layered path: implausible mean sweeps {mean_sweeps}")
    if any(launches_l.get(name, 0) for name in (K1, K2, K5, KV)):
        raise AssertionError(f"layered path launched a flooding kernel: {launches_l}")
    channel_launches("layered path", launches_l, N_BATCHES)
    # One launch per sweep: without compaction overflow a batch costs
    # max(iterations) sweeps (phase A's plus phase B's).
    worst_l, overflowed_l, replay_l = replay_batches(opts_l)
    if replay_l != [int(partials_l.sum_it), trials, trials]:
        raise AssertionError("replayed layered batches disagree with run_point")
    sweeps = launches_l.get(K6, 0)
    if sweeps <= 0 or sweeps < sum(worst_l) or (
            not overflowed_l and sweeps != sum(worst_l)):
        raise AssertionError(
            f"layered_sweep launched {sweeps} times, iteration counts say "
            f"{sum(worst_l)} (overflow: {overflowed_l})")
    if launches_l.get(KW, 0) != sweeps or launches_l.get(KE, 0) != 3 * N_BATCHES:
        raise AssertionError(f"layered path: loop kernels {launches_l}")
    print(json.dumps({"layered_path": {
        "card": card, "qber": actual_qber, "trials": trials, "batch": BATCH,
        "compact_after": LAYERED_COMPACT_AFTER, "partials": stats_l,
        "mean_sweeps": mean_sweeps, "launches": launches_l,
        "expected_sweep_launches": sum(worst_l), "max_sweeps_per_batch": worst_l,
        "compaction_overflow": overflowed_l, "seconds": seconds_l,
        "frames_per_s": trials / seconds_l,
        "flooding_seconds": seconds, "flooding_mean_iterations": mean_it,
    }}), flush=True)

    # ---- phase 3c: the continuation path --------------------------------------
    phase_start("continuation_path")
    opts_c = DecodeOptions(algorithm="sum-product", backend="auto", **base)
    key_c = derive_point_key(MASTER_SEED, WATERFALL_POINT_INDEX)

    def continuation_step(o=opts_c, n=trials):
        return run_point_continuation(
            code, key_c, WATERFALL_QBER, n, BATCH, o, segment=SEGMENT,
            refill_frac=REFILL_FRAC)

    # the first call captures the program's graph: time the capture
    captures_c = []
    real_capture = device_loop.Graph.capture

    def timed_capture(graph, *args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_capture(graph, *args, **kwargs)
        torch.cuda.synchronize()
        captures_c.append((graph, time.perf_counter() - t0))
        return out

    device_loop.Graph.capture = timed_capture
    try:
        continuation_step(n=BATCH)  # warm-up: captures the program's graph
    finally:
        device_loop.Graph.capture = real_capture
    with _counting_calls(device_loop.Graph, "replay") as replays_c:
        (partials_c, qber_c), seconds_c, launches_c = counted(continuation_step)
    loops_c = dict(continuation.last_loop_counts)  # read from the card with the result
    if replays_c[0] != 1 or len(captures_c) != 1:
        raise AssertionError(f"continuation path: {replays_c[0]} graph replays for one call, "
                             f"{len(captures_c)} captures")

    def waterfall_plain_step():
        return run_point(code, key_c, WATERFALL_QBER, trials, BATCH, opts_c)

    waterfall_plain_step()  # warm-up: captures the chunk's graph
    (plain_c, qber_p), seconds_p, launches_p = counted(waterfall_plain_step)
    stats_c, stats_p = as_stats(partials_c), as_stats(plain_c)
    if stats_c != stats_p or qber_c != qber_p:
        raise AssertionError(
            f"continuation {stats_c} != plain runner {stats_p} on the same point")
    if partials_c.n_trials != trials or not partials_c.max_it > partials_c.min_it:
        raise AssertionError(f"continuation path: implausible statistics {stats_c}")
    fresh_launches = launches_c.get(K5, 0)
    # Every pass of every outer step is one launch of each flooding kernel, and
    # the program counts its outer steps on the card; a trial costs its
    # iterations plus the pass that forms its a-priori totals, and the lanes
    # cannot have done more work than all of them busy in every pass.
    lane_iterations = int(partials_c.sum_it) + (trials - partials_c.n_sp) * 100
    if fresh_launches <= 0 or fresh_launches != SEGMENT * loops_c["outer_steps"] or (
            fresh_launches * BATCH < lane_iterations + trials) or (
            launches_c.get(KV, 0) != fresh_launches):
        raise AssertionError(
            f"check_update_fresh launched {fresh_launches} times and variable_update "
            f"{launches_c.get(KV, 0)} times in "
            f"{loops_c['outer_steps']} outer steps of {SEGMENT} iterations, for "
            f"{lane_iterations} lane-iterations")
    if loops_c["generations"] != N_BATCHES:
        raise AssertionError(f"continuation path: {loops_c} for {N_BATCHES} batches")
    channel_launches("continuation path", launches_c, loops_c["generations"])
    if launches_c.get(K1, 0) or launches_c.get(K2, 0) or launches_c.get(K6, 0):
        raise AssertionError(f"continuation path launched K1/K2/K6: {launches_c}")
    # the program's own steps, each as often as its loop ran
    expect_c = {KC_START: 1, KC_STAGE: loops_c["generations"], KC_FILL: loops_c["generations"],
                KC_LANES: launches_c.get(KC_COPY, 0), KC_PASS: fresh_launches,
                KC_BANK: loops_c["outer_steps"]}
    # cont_want: once before each refill loop and once after each of its passes
    expect_c[KC_WANT] = loops_c["outer_steps"] + loops_c["generations"] + launches_c.get(
        KC_LANES, 0)
    if any(launches_c.get(k, 0) != v for k, v in expect_c.items()) or (
            launches_c.get(KC_LANES, 0) < loops_c["refills"]):
        raise AssertionError(f"continuation path: step launches {launches_c} for {loops_c}")

    # no host read before the result: the call under the sync-debug gate
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        partials_sync, _ = continuation_step()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    if as_stats(partials_sync) != stats_p:
        raise AssertionError("continuation under the sync-debug gate differs")

    # three points as one program, each equal to the plain runner
    sweep_keys = [derive_point_key(MASTER_SEED, i) for i in range(len(CONTINUATION_QBERS))]
    with _counting_calls(device_loop.Graph, "replay") as replays_s:
        t0 = time.perf_counter()
        sweep_futures, _ = dispatch_sweep_continuation(
            code, sweep_keys, list(CONTINUATION_QBERS), trials, BATCH, opts_c,
            segment=SEGMENT, refill_frac=REFILL_FRAC)
        sweep_s = time.perf_counter() - t0
    loops_s = dict(continuation.last_loop_counts)
    sweep_points = {}
    for k_i, q_i, fut in zip(sweep_keys, CONTINUATION_QBERS, sweep_futures):
        got = as_stats(PointPartials().merge(partials_from_stacked(fut[0].fetch())))
        want = as_stats(run_point(code, k_i, q_i, trials, BATCH, opts_c)[0])
        if got != want:
            raise AssertionError(f"continuation sweep at QBER {q_i}: {got} != run_point {want}")
        sweep_points[str(q_i)] = got
    if replays_s[0] != 1 or loops_s["generations"] < len(CONTINUATION_QBERS) * N_BATCHES:
        raise AssertionError(f"continuation sweep: {replays_s[0]} replays, {loops_s}")

    # the sharded continuation: a trial mesh of two shards on the card
    mesh_c = make_trial_mesh([dev] * 2)
    with _counting_calls(device_loop.Graph, "replay") as replays_m:
        sharded_c, _ = run_point_continuation_sharded(
            code, key_c, WATERFALL_QBER, trials, BATCH, opts_c, mesh_c, segment=SEGMENT,
            refill_frac=REFILL_FRAC)
    if as_stats(sharded_c) != stats_p or replays_m[0] != 2:
        raise AssertionError(f"sharded continuation {as_stats(sharded_c)} against run_point "
                             f"{stats_p}, {replays_m[0]} replays for two shards")

    # the program's new kernels against their plain versions, bit for bit
    cont_kernels, cont_kernel_report = _continuation_kernels(torch, dev, flush, code)
    graph_c, capture_s = captures_c[0]
    print(json.dumps({"continuation_path": {
        "card": card, "qber": qber_c, "trials": trials, "batch": BATCH,
        "segment": SEGMENT, "refill_frac": REFILL_FRAC, "partials": stats_c,
        "equal_to_plain_runner": True, "launches": launches_c,
        "graph_replays_per_call": replays_c[0],
        "outer_steps": loops_c["outer_steps"], "refills": loops_c["refills"],
        "staging_generations": loops_c["generations"],
        "lane_iterations": lane_iterations,
        "lane_occupancy": lane_iterations / (fresh_launches * BATCH),
        "seconds": seconds_c, "frames_per_s": trials / seconds_c,
        "plain_runner_seconds": seconds_p, "plain_runner_frames_per_s": trials / seconds_p,
        "plain_runner_launches": launches_p,
        "sync_debug_error_mode": "no synchronising call before the result copy",
        "sweep_three_points": {"qbers": list(CONTINUATION_QBERS), "partials": sweep_points,
                               "equal_to_run_point": True, "replays": replays_s[0],
                               "loops": loops_s, "seconds": sweep_s},
        "sharded_two_shards": {"partials": as_stats(sharded_c), "equal_to_run_point": True,
                               "replays": replays_m[0]},
        "capture": {"seconds": capture_s, "nodes": graph_c.nodes,
                    "kernel_nodes": len(graph_c.outer),
                    "conditional_nodes": len(graph_c.bodies),
                    "while_nodes": graph_c.kinds.count(device_loop.WHILE),
                    "if_nodes": graph_c.kinds.count(device_loop.IF),
                    "body_kernels": [len(b) for b in graph_c.bodies],
                    "pool_bytes": _pool_bytes(torch, graph_c)},
        "kernels_held": cont_kernel_report,
    }}), flush=True)

    # The host's clock spreads and drifts (the machine's CPU cores are shared),
    # so the paths are timed again in turns: each round runs all four.
    # Each decode path also runs its eager kernel loop (one condition fetch a
    # pass, the segment passes launched one by one) beside its graphs.
    def eager(step):
        def run():
            with device_loop.eager_loops():
                return step()
        return run

    steps = {"flooding": flooding_step, "flooding_eager": eager(flooding_step),
             "layered": layered_step, "layered_eager": eager(layered_step),
             "continuation": continuation_step,
             "continuation_eager": eager(continuation_step),
             "waterfall_plain": waterfall_plain_step}
    for name, step in steps.items():  # the eager legs' warm-up
        if name.endswith("_eager"):
            step()
    rounds = {name: [] for name in steps}
    for _ in range(4):
        for name, step in steps.items():
            rounds[name].append(counted(step)[1])
    print(json.dumps({"wall_seconds_in_turns": dict(card=card, trials=trials, **rounds)}),
          flush=True)

    # ---- phase 3d: the device-resident control flow (device_loops) -----------
    phase_start("device_loops")
    loops_report, loop_kernels = _device_loops(
        torch, np, dev, card, flush, code, point_key, key_c, opts_c, counted, as_stats)
    print(json.dumps({"device_loops": loops_report}), flush=True)

    # ---- phase 3e: the trial chunk as one CUDA graph (chunk_graph) -------------
    phase_start("chunk_graph")
    print(json.dumps({"chunk_graph": _chunk_graph(
        torch, np, dev, card, code, names, point_key, key_c, opts, opts_l, opts_c,
        counted, as_stats)}), flush=True)

    # ---- phase 4: identity against the plain versions on the card ----------
    phase_start("identity")
    def seven(alg, backend, path):
        if path == "continuation":
            o = DecodeOptions(algorithm=alg, backend=backend, **base)
            p, _ = continuation_step(o)
        else:
            o = DecodeOptions(
                algorithm=alg, backend=backend, schedule=path, **base,
                compact_after=opts.compact_after if path == "flooding"
                else LAYERED_COMPACT_AFTER, compact_lanes=BATCH // 4)
            p, _ = run_point(code, point_key, QBER, trials, BATCH, o, prng="pallas")
        return as_stats(p)

    identity = {"allowance": SP_ITERATION_SUM_ALLOWANCE, "trials_per_leg": trials}
    for path, sp_kernel in (("flooding", stats), ("layered", stats_l),
                            ("continuation", stats_c)):
        ms_kernel, ms_plain = seven("min-sum", "auto", path), seven("min-sum", "xla", path)
        if ms_kernel != ms_plain:
            raise AssertionError(
                f"{path} min-sum: kernels {ms_kernel} != plain {ms_plain}")
        sp_plain = seven("sum-product", "xla", path)
        sp_diff = sp_plain["sum_it"] - sp_kernel["sum_it"]
        if (sp_plain["n_sp"], sp_plain["n_ldpc"]) != (
                sp_kernel["n_sp"], sp_kernel["n_ldpc"]) or (
                abs(sp_diff) > SP_ITERATION_SUM_ALLOWANCE):
            raise AssertionError(
                f"{path} sum-product: kernels {sp_kernel} vs plain {sp_plain}")
        identity[path] = {
            "min_sum_partials": ms_kernel, "min_sum_equal": True,
            "sum_product_plain_partials": sp_plain,
            "sum_product_iteration_sum_difference": sp_diff,
        }
    print(json.dumps({"identity": identity}), flush=True)

    # ---- phase 5: the sweep through the command line (cli_sweep) -------------
    phase_start("cli_sweep")
    wall_a = _cli_sweep(torch, np, dev, card, code, names)

    # ---- phase 6: the protocol surface (protocol) ------------------------------
    phase_start("protocol")
    protocol_report, block_kernel = _protocol(torch, np, dev, card, code, names)
    print(json.dumps({"protocol": protocol_report}),
          flush=True)

    # ---- phase 7: parallel/ on one card (parallel) --------------------------------
    phase_start("parallel")
    print(json.dumps({"parallel": _parallel(
        torch, np, dev, card, code, names, opts, opts_l, opts_c, point_key, key_c,
        counted, channel_launches, as_stats)}), flush=True)

    # ---- phase 8: the QC node-sharded decoder (qc_node) ------------------------
    phase_start("qc_node")
    print(json.dumps({"qc_node": _qc_node(
        torch, np, dev, card, code, names, counted, as_stats, point_key)}), flush=True)

    phase_start(None)
    print(json.dumps({"phase_seconds": dict(card=card, **phase_seconds)}), flush=True)

    # Tracing comes last: once the tracer has been attached, every later
    # launch of the process costs the host more, which would fall on the
    # walls timed above.
    if profiling:
        # One batch stage by stage, each ending in a synchronise (which the
        # runner does not do): what keygen and each schedule's decode cost.
        a, b = make_trial_batch(point_key, N, BATCH, n_err, 0)
        q32 = np.float32(n_err) / np.float32(N)

        def stage_ms(fn, n=10):
            return statistics.median(
                [counted(fn)[1] * 1e3 for _ in range(n + 1)][1:])

        print(json.dumps({"stages_ms_per_batch": {
            "card": card,
            "make_trial_batch": stage_ms(
                lambda: make_trial_batch(point_key, N, BATCH, n_err, 0)),
            "reconcile_flooding": stage_ms(lambda: reconcile(code, a, b, q32, opts)),
            "reconcile_layered": stage_ms(lambda: reconcile(code, a, b, q32, opts_l)),
        }}), flush=True)
        # Keygen apart: the launches of making one batch of trials, by the
        # number of batches (or staging blocks) a path makes.
        keygen = _profile_path(
            torch, "keygen_one_batch",
            lambda: make_trial_batch(point_key, N, BATCH, n_err, 0), card,
            stage_ms(lambda: make_trial_batch(point_key, N, BATCH, n_err, 0)))
        if keygen > KEYGEN_LAUNCH_LIMIT:
            raise AssertionError(f"one batch of trials took {keygen} launches on the card")
        # a trial chunk (flooding, layered) or an outer step's segment (the
        # continuation) is one graph replay: the marker opens each.  The two
        # trial paths are traced in chunks of two batches (two replays a run).
        starts = (device_loop.Graph, "replay")
        for path, o, wall_s in (("flooding", opts, seconds), ("layered", opts_l, seconds_l)):
            def two_chunks(o=o):
                return run_point(code, point_key, QBER, trials, BATCH, o, prng="pallas",
                                 max_batches_per_dispatch=N_BATCHES // 2)

            two_chunks()  # captures the two-batch chunk's graph
            _profile_path(torch, path, two_chunks, card, wall_s * 1e3, starts,
                          keygen * N_BATCHES)
        # the continuation is one replay a call: two calls a traced run (the
        # call before recaptures its graph if the cache of 8 dropped it)
        continuation_step()
        _profile_path(torch, "continuation", lambda: (continuation_step(), continuation_step()),
                      card, 2 * seconds_c * 1e3, starts, 2 * keygen * N_BATCHES)
        _trace_cli_sweep(torch, code, card, wall_a * 1e3)
        # The Reconciler (512 flagship frames, 128 lanes) with 1 and 4 chunks
        # in flight: how busy the card is says whether the window can help.
        from qkd_ldpc_tpu_torch import Reconciler

        rec = Reconciler(code, DecodeOptions(algorithm="sum-product", **base), lanes=128,
                         device=dev).warmup()
        ra, rb = (x.cpu().numpy() for x in make_trial_batch(
            point_key, N, PROTOCOL_FRAMES, n_err, 0))
        rsyn = rec.syndromes(ra)
        for window in (1, 4):
            rec.max_inflight_chunks = window
            _profile_path(torch, f"reconciler_window_{window}",
                          lambda: rec.reconcile(rb, rsyn, n_err / N), card,
                          stage_ms(lambda: rec.reconcile(rb, rsyn, n_err / N)))

    # ---- the contract's lines ----------------------------------------------
    def kernel_line(name, source, replaces, meas, counts):
        # the check degrees (K1/K2/K5/KV) and base-row degrees (K6) at which
        # the kernel was held to its plain version; the channel kernels have none
        degrees = {K6: sorted({6, *layered_degrees}), K3: None, K4: None, KT: None,
                   KB: None, KE: None, KS: None, KW: None,
                   **dict.fromkeys(cuda_continuation.KERNELS)}.get(name, flooding_degrees)
        return {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": counts[name], "max_abs_err": meas["max_abs_err"],
            "ms": meas["ms"], "plain_ms": meas["plain_ms"],
            "bound_ms": meas["bound_ms"], "bound_by": meas["bound_by"],
            "library_ms": meas.get("library_ms"), "degrees_held": degrees,
        }

    csrc = "qkd_ldpc_tpu_torch/csrc/"
    print(card, flush=True)
    print(json.dumps({"kernels": [
        kernel_line(K1, csrc + "check_update.cu",
                    "qkd_ldpc_tpu/decoder/pallas_kernels.py:210",
                    main_entries[K1], launches),
        kernel_line(K2, csrc + "check_update.cu",
                    "qkd_ldpc_tpu/decoder/pallas_kernels.py:245",
                    main_entries[K2], launches),
        kernel_line(K3, csrc + "kth_smallest.cu",
                    "qkd_ldpc_tpu/channel/pallas_select.py:66", k3, launches),
        kernel_line(K4, csrc + "threefry_words.cu",
                    "qkd_ldpc_tpu/channel/pallas_prng.py:38", k4, launches),
        kernel_line(K5, csrc + "check_update.cu",
                    "qkd_ldpc_tpu/decoder/pallas_kernels.py:310",
                    main_entries[K5], launches_c),
        # the tensor passes between two check updates of the JAX decoder
        kernel_line(KV, csrc + "check_update.cu",
                    "qkd_ldpc_tpu/decoder/bp.py:400", main_entries[KV], launches),
        kernel_line(K6, csrc + "layered_sweep.cu",
                    "qkd_ldpc_tpu/decoder/pallas_layered.py:266",
                    main_entries[K6], launches_l),
        # the control flow that the JAX package compiles into its programs
        kernel_line(KT, csrc + "kth_smallest.cu",
                    "qkd_ldpc_tpu/channel/keys.py:167", loop_kernels[KT], launches),
        # the protocol's key blocks; the tie block under lax.cond(has_excess)
        kernel_line(KB, csrc + "threefry_words.cu",
                    "qkd_ldpc_tpu/channel/keys.py:182", block_kernel,
                    protocol_report["keygen_launches"]),
        kernel_line(KE, csrc + "device_loop.cu",
                    "qkd_ldpc_tpu/decoder/bp.py:447", loop_kernels[KE], launches),
        kernel_line(KS, csrc + "device_loop.cu",
                    "qkd_ldpc_tpu/decoder/bp.py:434", loop_kernels[KS], launches),
        kernel_line(KW, csrc + "device_loop.cu",
                    "qkd_ldpc_tpu/decoder/layered.py:218", loop_kernels[KW], launches_l),
        # the continuation's outer loop, one program as JAX's _continuation_core
        *(kernel_line(name, csrc + "continuation.cu", f"qkd_ldpc_tpu/sim/continuation.py:{line}",
                      cont_kernels[name], launches_c)
          for name, line in zip(cuda_continuation.KERNELS,
                                (266, 205, 111, 132, 154, 179, 225, 242))),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
