"""The yardstick's arithmetic and the per-layer readers, on synthetic
traces and runs."""

from __future__ import annotations

import pytest

from portbench import arith, harness, spec
from portbench.trace import TraceData


@pytest.mark.parametrize("intervals,lo,hi,want", [
    ([], 0, 10, []),
    ([(1, 3), (2, 5)], 0, 10, [(1, 5)]),  # overlapping
    ([(1, 3), (3, 4)], 0, 10, [(1, 4)]),  # touching
    ([(4, 6), (1, 2), (1.5, 1.8)], 0, 10, [(1, 2), (4, 6)]),  # nested, out of order
    ([(-2, 1), (9, 12)], 0, 10, [(0, 1), (9, 10)]),  # clipped to the slice
    ([(11, 12), (-3, -1)], 0, 10, []),  # outside
])
def test_union_of_intervals(intervals, lo, hi, want):
    assert arith.union(intervals, lo, hi) == want
    assert arith.busy(intervals, lo, hi) == pytest.approx(sum(e - s for s, e in want))


def test_gaps_and_idle_share():
    iv = [(1, 3), (2, 5), (7, 8)]
    assert arith.gaps(iv, 0, 10) == [(0, 1), (5, 7), (8, 10)]
    assert arith.idle_pct(iv, 0, 10) == pytest.approx(50.0)
    assert arith.idle_pct([], 0, 10) is None
    assert arith.idle_pct(iv, 5, 5) is None


def test_percentile_is_the_nearest_rank():
    xs = list(range(1, 101))
    assert arith.percentile(xs, 95) == 95
    assert arith.percentile(xs[::-1], 50) == 50
    assert arith.percentile([3.0], 95) == 3.0


def test_decode_bytes_of_the_flagship():
    # 2 x 30,720 edges x 2 B + 4 B LLR + 2 B total + 1 B decision per bit
    assert arith.decode_bytes_per_frame_iteration(10240, 30720, "bfloat16") == 194560
    assert arith.decode_bytes_per_frame_iteration(10, 30, "float32") == 240 + 40 + 40 + 10


def test_frame_iterations_count_the_cap_for_failures():
    s = dict(n_trials=10, n_sp=8, sum_it=40)
    assert arith.frame_iterations(s, 100) == 40 + 2 * 100


def _trace():
    dev = [(1.0, 3.0, "k2"), (2.0, 5.0, "kv"), (7.0, 8.0, "k2")]
    host = [(0.0, 10.0, "portbench.point"), (5.2, 6.9, "cudaStreamSynchronize")]
    return TraceData(lo=0.0, hi=9.5, device=dev, host=host)


def test_trace_breakdown():
    t = _trace()
    assert t.busy_s() == pytest.approx(5.0)
    assert sorted(t.top_ops()) == [["k2", 3.0], ["kv", 3.0]]
    # gaps (5, 7), (8, 9.5), (0, 1), longest first, each named by the
    # innermost host event open at its middle
    assert t.idle_gaps() == [["cudaStreamSynchronize", 2.0], ["portbench.point", 1.5],
                             ["portbench.point", 1.0]]


def _run(units, trace=None, slice_end=None, storage="bfloat16"):
    ctx = harness.Context(cell=spec.cell("mc_qc_flood_q050"),
                          config=spec.config("qc_n10240_r05"), seed=1, device=None,
                          storage=storage)
    return harness.Run(ctx=ctx, units=units, trace=trace, slice_end=slice_end)


def test_readers_read_what_is_there_and_nothing_else():
    units = [dict(t0=0.0, t1=4.0, lane_passes=2000,
                  stats=dict(n_trials=100, n_sp=90, sum_it=700)),
             dict(t0=4.0, t1=9.0, lane_passes=1000,
                  stats=dict(n_trials=100, n_sp=100, sum_it=500))]
    run = _run(units, _trace(), slice_end=4.5)
    assert spec.reader("mc.device_idle_pct")(run) == pytest.approx(100 * 4.5 / 9.5)
    bw = spec.reader("mc.decode_bw_pct")(run)
    need = (700 + 10 * 100) * 194560
    assert bw == pytest.approx(100 * need / arith.HBM_BYTES_PER_S / 5.0)
    occ = spec.reader("cont.lane_occupancy_pct")(run)
    assert occ == pytest.approx(100 * (1700 + 500) / 3000)
    assert spec.reader("serve.service_p50_ms")(run) == pytest.approx(4500.0)
    empty = _run([])
    for name in ("mc.device_idle_pct", "mc.decode_bw_pct", "cont.lane_occupancy_pct",
                 "serve.service_p50_ms", "serve.device_idle_pct", "sweep.device_idle_pct"):
        assert spec.reader(name)(empty) is None
