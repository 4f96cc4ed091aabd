#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on the card.

Run ``python3 chip_smoke.py`` from the repository root on a machine with one
NVIDIA Hopper GPU, ``nvcc`` and PyTorch built for CUDA.  It

1. builds the CUDA kernels of ``qkd_ldpc_tpu_torch/csrc`` (all ``nvcc``
   processes in parallel) and prints the card, the toolchain and the build time;
2. holds every kernel against its plain PyTorch version on the card at the
   flagship shapes (``[6, 5120, 512]`` messages, ``[512, 10240]`` scores,
   k = 512) and times kernel, plain version and, where one PyTorch call
   computes the same function, that call;
3. drives ``run_point`` — keygen, exact-weight channel, syndrome, flooding BP
   decode with compaction, statistics — on the flagship quasi-cyclic code at
   its operating point and checks the statistics and the launch counts;
4. repeats the same trials through the plain versions (``backend="xla"``) and
   compares the seven partial sums.

Each phase prints one JSON object on a line of its own; any failure raises.
The last line is ``{"ok": true, "device": {...}}``.  The script exits non-zero
without a CUDA device.  Times are this card's, labelled with its name and power
limit; they are a smoke measurement, not a benchmark.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet: 80 GB of HBM at 3.35 TB/s
# Data-sheet float32 rate outside the tensor cores; also taken as the (generous)
# peak for the 32-bit integer work of the two channel kernels.
FP32_OPS_PER_S = 67e12

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
OPS_PER_WORD_THREEFRY = 95  # 20 rounds x (add, rotate, xor) + 5 key injections
OPS_PER_SCORE_KTH = 64  # 32 passes x (compare, add)

Z, NB, MB_ROWS, DV, CODE_SEED = 512, 20, 10, 3, 666
QBER, BATCH, N_BATCHES = 0.05, 512, 4
MASTER_SEED, POINT_INDEX = 777, 0
MEAN_ITERATIONS_GATE = (5.5, 8.0)
SP_ITERATION_SUM_ALLOWANCE = 2  # +-1-iteration boundary frames per run


def _time_ms(torch, fn, flush, repeats=20, warmup=3):
    """Median time of ``fn`` in ms by CUDA events, L2 flushed before each run."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(repeats):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _bound(n_bytes, n_ops):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_OPS_PER_S * 1e3
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


def _profile_main_path(torch, step, card, untraced_ms):
    """``--profile``: trace the main path and print the device time by kernel
    name and the device-busy share of the UNTRACED run's wall time (tracing
    slows the host, not the kernels).  The first traced run absorbs the
    tracer's start-up; both runs do the same work, so totals are halved."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            step()
            torch.cuda.synchronize()
    rows = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            ms, count = rows.get(ev.name, (0.0, 0))
            rows[ev.name] = (ms + ev.device_time / 1e3 / 2, count + 0.5)
    if not rows:
        raise AssertionError("the profiler recorded no device time")
    table = sorted(((ms, c, k) for k, (ms, c) in rows.items()), reverse=True)
    busy_ms = sum(r[0] for r in table)
    print(json.dumps({"profile": {
        "card": card, "untraced_wall_ms": untraced_ms, "device_busy_ms": busy_ms,
        "device_busy_share": busy_ms / untraced_ms,
        "kernel_launches": sum(r[1] for r in table),
        "by_kernel_ms_count_name": [[round(m, 4), c, k[:100]] for m, c, k in table[:30]],
    }}), flush=True)


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
    from qkd_ldpc_tpu_torch.channel.threefry import flip_sign, fold_in
    from qkd_ldpc_tpu_torch.codes import make_qc_code
    from qkd_ldpc_tpu_torch.decoder import cuda_kernels
    from qkd_ldpc_tpu_torch.decoder.bp import DecodeOptions
    from qkd_ldpc_tpu_torch.decoder.reconcile import reconcile
    from qkd_ldpc_tpu_torch.sim.runner import run_point
    from qkd_ldpc_tpu_torch.sim.stats import STAT_KEYS
    from qkd_ldpc_tpu_torch.utils import card_name_and_power_limit

    dev = torch.device("cuda")
    torch.manual_seed(0)

    # ---- phase 1: device, toolchain, build ---------------------------------
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
        "copy_bytes_per_s": copy_bytes_per_s,
        "datasheet_bytes_per_s": HBM_BYTES_PER_S,
    }}), flush=True)

    # ---- phase 2: every kernel against its plain version -------------------
    code = make_qc_code(z=Z, nb=NB, mb=MB_ROWS, dv=DV, seed=CODE_SEED)
    N, M, dc = code.n_vars, code.n_checks, code.dc_max
    maps = code.to_device(dev)
    n_err = num_errors_for(N, QBER)
    gen = torch.Generator(device=dev).manual_seed(1234)

    def storage(x, dtype_name, scale):
        return cuda_kernels._store(
            x, {"float32": torch.float32, "bfloat16": torch.bfloat16,
                "int8": torch.int8}[dtype_name], scale)

    syn_sign = torch.where(
        torch.rand((M, BATCH), device=dev, generator=gen) < 0.5, -1.0, 1.0)
    # A mask with padded slots (slot 0 always real) for the correctness matrix;
    # the timings use the flagship code's own (full) mask.
    pad_mask = (torch.rand((dc, M), device=dev, generator=gen) < 0.9)
    pad_mask[0] = True
    pad_mask = pad_mask.to(torch.int32)

    matrix = []
    main_entries = {}
    for algorithm in ("sum-product", "min-sum"):
        for dtype_name in ("float32", "bfloat16", "int8"):
            scale = 0.25 if dtype_name == "int8" else None
            tot = storage(4.0 * torch.randn((dc, M, BATCH), device=dev, generator=gen),
                          dtype_name, scale)
            lrp = storage(2.0 * torch.randn((dc, M, BATCH), device=dev, generator=gen),
                          dtype_name, scale)
            kw = dict(threshold=100.0, clip=True, algorithm=algorithm,
                      min_sum_alpha=0.8, min_sum_beta=0.0, scale=scale)
            for first in (True, False):
                name = (cuda_kernels.KERNEL_FIRST if first
                        else cuda_kernels.KERNEL_FUSED)
                args = (tot, None if first else lrp)
                worst, n_diff = 0.0, 0
                for mask in (maps.chk_mask_T_i32, pad_mask):
                    got = cuda_kernels.check_update_cuda(
                        *args, mask, syn_sign, first=first, **kw)
                    ref = cuda_kernels.check_update_plain(
                        *args, mask, syn_sign, first=first, **kw)
                    torch.cuda.synchronize()
                    err, nd = _compare_messages(
                        torch, got, ref, dtype_name, algorithm, scale)
                    worst, n_diff = max(worst, err), n_diff + nd
                ms = _time_ms(torch, lambda: cuda_kernels.check_update_cuda(
                    *args, maps.chk_mask_T_i32, syn_sign, first=first, **kw), flush)
                plain_ms = _time_ms(torch, lambda: cuda_kernels.check_update_plain(
                    *args, maps.chk_mask_T_i32, syn_sign, first=first, **kw),
                    flush, repeats=5, warmup=1)
                n_edge = dc * M * BATCH
                n_bytes = ((2 if first else 3) * n_edge * tot.element_size()
                           + M * BATCH * 4 + dc * M * 4)
                bound_ms, bound_by = _bound(n_bytes, OPS_PER_EDGE[algorithm] * n_edge)
                entry = {
                    "name": name, "algorithm": algorithm, "storage": dtype_name,
                    "max_abs_err": worst, "entries_differing": n_diff,
                    "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                    "bound_by": bound_by,
                    "bound_ms_at_copy_rate": n_bytes / copy_bytes_per_s * 1e3,
                }
                matrix.append(entry)
                if (algorithm, dtype_name) == ("sum-product", "bfloat16"):
                    main_entries[name] = entry
            del tot, lrp

    # K4: the trial bit blocks, from real per-trial keys.
    point_key = derive_point_key(MASTER_SEED, POINT_INDEX)
    trial_keys = fold_in(point_key.to(dev), torch.arange(BATCH, device=dev))
    keys = torch.stack([fold_in(trial_keys, 0), fold_in(trial_keys, 1)], dim=1)
    words = cuda_prng.trial_words_cuda(keys, N)
    words_ref = cuda_prng.trial_words_plain(keys, N)
    torch.cuda.synchronize()
    k4_err = int((words.to(torch.int64) - words_ref.to(torch.int64)).abs().max())
    if k4_err:
        raise AssertionError("trial_words kernel differs from its plain version")
    k4_bound, k4_by = _bound(words.numel() * 4 + keys.numel() * 4,
                             OPS_PER_WORD_THREEFRY * words.numel())
    k4 = {
        "max_abs_err": k4_err, "bound_ms": k4_bound, "bound_by": k4_by,
        "ms": _time_ms(torch, lambda: cuda_prng.trial_words_cuda(keys, N), flush),
        "plain_ms": _time_ms(torch, lambda: cuda_prng.trial_words_plain(keys, N),
                             flush, repeats=5, warmup=1),
        "library_ms": None,
    }

    # K3: the channel threshold on those scores (scalar k), plus per-row k.
    scores = words[:, 1].contiguous()
    thr = cuda_select.kth_smallest_cuda(scores, n_err)
    thr_ref = cuda_select.kth_smallest_plain(scores, n_err)
    k_rows = torch.randint(1, N + 1, (BATCH,), device=dev, generator=gen,
                           dtype=torch.int32)
    thr_rows = cuda_select.kth_smallest_cuda(scores, k_rows)
    thr_rows_ref = cuda_select.kth_smallest_plain(scores, k_rows)
    lib_thr = torch.kthvalue(flip_sign(scores), n_err, dim=-1, keepdim=True).values
    torch.cuda.synchronize()
    k3_err = max(
        int((thr.to(torch.int64) - thr_ref.to(torch.int64)).abs().max()),
        int((thr_rows.to(torch.int64) - thr_rows_ref.to(torch.int64)).abs().max()),
        int((flip_sign(thr).to(torch.int64) - lib_thr.to(torch.int64)).abs().max()),
    )
    if k3_err:
        raise AssertionError("kth_smallest kernel differs from its plain version")
    flipped = flip_sign(scores)
    k3_bound, k3_by = _bound(scores.numel() * 4 + BATCH * 8,
                             OPS_PER_SCORE_KTH * scores.numel())
    k3 = {
        "max_abs_err": k3_err, "bound_ms": k3_bound, "bound_by": k3_by,
        "ms": _time_ms(torch, lambda: cuda_select.kth_smallest_cuda(scores, n_err),
                       flush),
        "plain_ms": _time_ms(
            torch, lambda: cuda_select.kth_smallest_plain(scores, n_err), flush,
            repeats=5, warmup=1),
        "library_ms": _time_ms(
            torch, lambda: torch.kthvalue(flipped, n_err, dim=-1), flush,
            repeats=5, warmup=1),
    }
    print(json.dumps({"kernel_matrix": matrix}), flush=True)
    del words, words_ref, scores, flipped

    # ---- phase 3: the main path -------------------------------------------
    opts = DecodeOptions(
        max_iterations=100, clip_messages=True, message_threshold=100.0,
        algorithm="sum-product", message_dtype="bfloat16", backend="auto",
        compact_after=8, compact_lanes=BATCH // 4,
    )
    trials = N_BATCHES * BATCH
    run_point(code, point_key, QBER, BATCH, BATCH, opts, prng="pallas")  # warm-up
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    partials, actual_qber = run_point(
        code, point_key, QBER, trials, BATCH, opts, prng="pallas")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = _build.launch_counts()

    stats = {k: getattr(partials, k) for k in STAT_KEYS}
    mean_it = partials.sum_it / max(partials.n_sp, 1)
    if not (partials.n_sp == partials.n_trials == partials.n_ldpc == trials):
        raise AssertionError(f"main path: not every trial decoded: {stats}")
    if not MEAN_ITERATIONS_GATE[0] <= mean_it <= MEAN_ITERATIONS_GATE[1]:
        raise AssertionError(f"main path: implausible mean iterations {mean_it}")
    kernel_names = (cuda_kernels.KERNEL_FIRST, cuda_kernels.KERNEL_FUSED,
                    cuda_select.KERNEL_NAME, cuda_prng.KERNEL_NAME)
    for name in kernel_names:
        if launches.get(name, 0) <= 0:
            raise AssertionError(f"main path never launched kernel {name}")
    for name in kernel_names[:1] + kernel_names[2:]:
        if launches[name] != N_BATCHES:
            raise AssertionError(f"{name}: {launches[name]} launches, "
                                 f"expected one per batch ({N_BATCHES})")

    # K2 runs once per iteration after the first.  Decode the same batches
    # again (outside the counted run) to read each batch's iteration counts:
    # without compaction overflow a batch costs max(iterations) - 1 launches.
    expected_fused, overflowed, replay = 0, False, None
    for i in range(N_BATCHES):
        alice, bob = make_trial_batch(point_key, N, BATCH, n_err, i * BATCH)
        # the float32 QBER the runner decodes with
        res = reconcile(code, alice, bob, np.float32(n_err) / np.float32(N), opts)
        expected_fused += int(res.iterations.max()) - 1
        overflowed |= int((res.iterations > opts.compact_after).sum()) > opts.compact_lanes
        part = torch.stack([res.iterations.sum(), res.syndromes_match.sum(),
                            res.keys_match.sum()]).cpu()
        replay = part if replay is None else replay + part
    if [int(x) for x in replay] != [int(partials.sum_it), trials, trials]:
        raise AssertionError("replayed batches disagree with run_point's partials")
    fused = launches[cuda_kernels.KERNEL_FUSED]
    if (fused < expected_fused) or (not overflowed and fused != expected_fused):
        raise AssertionError(
            f"check_update_fused launched {fused} times, iteration counts say "
            f"{expected_fused} (overflow: {overflowed})")
    # The decode loop fetches one flag per iteration; on an idle stream that
    # fetch costs this much (its floor — in the loop it also waits for the
    # iteration's kernels).
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
        "compaction_overflow": overflowed, "seconds": seconds,
        "frames_per_s": trials / seconds,
        "ms_per_decode_iteration": seconds * 1e3 / (fused + N_BATCHES),
        "idle_flag_fetch_ms": statistics.median(sync_times),
    }}), flush=True)
    if "--profile" in sys.argv[1:]:
        _profile_main_path(
            torch, lambda: run_point(code, point_key, QBER, trials, BATCH, opts,
                                     prng="pallas"), card, seconds * 1e3)

    # ---- phase 4: identity against the plain versions on the card ----------
    def seven(alg, backend):
        o = DecodeOptions(
            max_iterations=100, algorithm=alg, message_dtype="bfloat16",
            backend=backend, compact_after=8, compact_lanes=BATCH // 4)
        p, _ = run_point(code, point_key, QBER, trials, BATCH, o, prng="pallas")
        return {k: getattr(p, k) for k in STAT_KEYS}

    ms_kernel, ms_plain = seven("min-sum", "auto"), seven("min-sum", "xla")
    if ms_kernel != ms_plain:
        raise AssertionError(f"min-sum: kernels {ms_kernel} != plain {ms_plain}")
    sp_plain = seven("sum-product", "xla")
    sp_diff = sp_plain["sum_it"] - stats["sum_it"]
    if (sp_plain["n_sp"], sp_plain["n_ldpc"]) != (stats["n_sp"], stats["n_ldpc"]) or (
            abs(sp_diff) > SP_ITERATION_SUM_ALLOWANCE):
        raise AssertionError(f"sum-product: kernels {stats} vs plain {sp_plain}")
    print(json.dumps({"identity": {
        "min_sum_partials": ms_kernel, "min_sum_equal": True,
        "sum_product_plain_partials": sp_plain,
        "sum_product_iteration_sum_difference": sp_diff,
        "allowance": SP_ITERATION_SUM_ALLOWANCE,
    }}), flush=True)

    # ---- the contract's lines ----------------------------------------------
    def kernel_line(name, source, replaces, meas):
        return {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": meas["max_abs_err"],
            "ms": meas["ms"], "plain_ms": meas["plain_ms"],
            "bound_ms": meas["bound_ms"], "bound_by": meas["bound_by"],
            "library_ms": meas.get("library_ms"),
        }

    csrc = "qkd_ldpc_tpu_torch/csrc/"
    print(card, flush=True)
    print(json.dumps({"kernels": [
        kernel_line(cuda_kernels.KERNEL_FIRST, csrc + "check_update.cu",
                    "qkd_ldpc_tpu/decoder/pallas_kernels.py:210",
                    main_entries[cuda_kernels.KERNEL_FIRST]),
        kernel_line(cuda_kernels.KERNEL_FUSED, csrc + "check_update.cu",
                    "qkd_ldpc_tpu/decoder/pallas_kernels.py:245",
                    main_entries[cuda_kernels.KERNEL_FUSED]),
        kernel_line(cuda_select.KERNEL_NAME, csrc + "kth_smallest.cu",
                    "qkd_ldpc_tpu/channel/pallas_select.py:66", k3),
        kernel_line(cuda_prng.KERNEL_NAME, csrc + "threefry_words.cu",
                    "qkd_ldpc_tpu/channel/pallas_prng.py:38", k4),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
