"""The long-frame configuration and its cells on the CPU: the reference's
quasi-cyclic construction against the program's rows, a point of the long
code's base shape through the runner against the plain reference, the two
new readers on hand-made traces, the new files through discovery, and the
blocked reference check of the new traffic kind on a tiny cell."""

import json
import time

import numpy as np
import pytest
import torch

from portbench import arith_check, harness, run, spec
from portbench.reference import channel, codes, stats, threefry
from portbench.reference.decode import Decoder
from portbench.tests import tiny
from portbench.trace import TraceData
from qkd_ldpc_tpu_torch.codes import make_qc_code
from qkd_ldpc_tpu_torch.decoder import DecodeOptions, device_loop
from qkd_ldpc_tpu_torch.decoder.bp import lane_bytes
from qkd_ldpc_tpu_torch.sim.runner import run_point

torch.set_num_threads(1)
CPU = torch.device("cpu")
LONG = "mc_qc262k_flood_q070"
SMALL_LIFT = dict(z=16, nb=128, mb=65, dv=3, seed=1)  # the long code's base shape


@pytest.mark.parametrize("z", [16, 2048])
def test_the_reference_builds_the_programs_check_rows(z):
    code = make_qc_code(**dict(SMALL_LIFT, z=z))
    g = codes.qc_graph(z, 128, 65, 3, 1)
    adj, mask = g.dense_adjacency()
    assert (g.n_vars, g.n_checks, g.n_edges) == (code.n_vars, code.n_checks, code.n_edges)
    np.testing.assert_array_equal(mask, code.chk_mask)
    np.testing.assert_array_equal(np.where(mask, adj, 0), np.where(mask, code.chk_adj, 0))


def test_a_point_of_the_base_shape_equals_the_reference_with_compaction():
    """``run_point`` on the plain path, compacted after 8 passes into a
    quarter of the lanes, gives the reference's point statistics exactly at
    QBER 0.07."""
    code = make_qc_code(**SMALL_LIFT)
    opts = DecodeOptions(max_iterations=100, message_dtype="bfloat16", compact_after=8,
                         compact_lanes=16)
    key = threefry.fold_in(threefry.key(2**31 + 99), 3)
    counter = device_loop.compaction_counter(CPU)
    before = counter.clone()
    got, _ = run_point(code, key, 0.07, 128, 64, opts, max_batches_per_dispatch=16,
                       device=CPU)
    counts = dict(zip(device_loop.COMPACTION_COUNTS, (counter - before).tolist()))
    g = codes.on_device(codes.qc_graph(16, 128, 65, 3, 1), CPU)
    n_err = channel.num_errors(g.n_vars, 0.07)
    dec = Decoder(max_iterations=100, threshold=100.0, clip=True, storage="bfloat16")
    want = stats.point(dec, g, key, n_err, 128, width=64)
    assert {k: getattr(got, k) for k in stats.KEYS} == want
    assert want["n_sp"] > 0 and counts["compaction_batches"] == 2
    assert device_loop.compaction_bytes(counts, lane_bytes(code, opts), 16) > 0


def _run(cell, trace, units=()):
    ctx = harness.Context(cell=spec.cell(cell), config=spec.config(spec.cell(cell)["config"]),
                          seed=1, device=None, storage="bfloat16")
    return harness.Run(ctx=ctx, units=list(units), trace=trace, slice_end=10.0)


def _trace():
    """A slice [0, 10] with 8 s of device work: check updates 4 s (one of
    them the loop instance, one reaching past the slice), the lane moves 1 s
    (two overlapping), a copy and other kernels."""
    dev = [(0.0, 2.0, "void check_update_kernel<0, true, 6, 4>(float)"),
           (2.0, 3.0, "void check_update_kernel_fold<0, 6, 4>(float)"),
           (9.5, 10.5, "void check_update_any_kernel_fold<0>(float)"),
           (3.0, 3.4, "compact_partition_kernel(Partition)"),
           (3.2, 3.8, "compact_gather_kernel(CopyPlan)"),
           (3.8, 4.0, "compact_scatter_kernel(CopyPlan)"),
           (4.0, 6.0, "variable_update_kernel<8>(float)"),
           (6.0, 6.5, "Memcpy HtoD (Pinned -> Device)"),
           (6.5, 8.5, "trial_rows_kernel(int)")]
    return TraceData(lo=0.0, hi=10.0, device=dev, host=[])


def test_the_check_update_reader():
    """Frame-iterations of the slice's points (the successes' sum and the cap
    for the failures) x the check update's bytes, over 3.35 TB/s and the 3.5 s
    of check-update kernels inside the slice."""
    units = [{"t1": 4.0, "stats": dict(n_trials=8192, n_sp=8000, sum_it=104000)},
             {"t1": 9.0, "stats": dict(n_trials=8192, n_sp=8192, sum_it=106000)},
             {"t1": 11.0, "stats": dict(n_trials=8192, n_sp=0, sum_it=0)}]
    per = arith_check.check_bytes_per_frame_iteration(262144, 133120, 786432, "bfloat16")
    assert per == 2 * 262144 + 2 * 2 * 786432 + 133120
    n = 104000 + 192 * 100 + 106000
    got = spec.reader("mc.check_bw_pct")(_run(LONG, _trace(), units))
    assert got == pytest.approx(100.0 * n * per / 3.35e12 / 3.5, rel=1e-12)
    assert spec.reader("mc.check_bw_pct")(_run(LONG, None, units)) is None
    assert spec.reader("mc.check_bw_pct")(_run(LONG, _trace(), units[2:])) is None


def test_the_compaction_reader():
    """The lane moves' union (3.0-4.0 s) over the device's busy time in the
    slice (0-8.5 s and 9.5-10 s)."""
    got = spec.reader("mc.compact_pct")(_run("mc_qc_flood_q0825", _trace()))
    assert got == pytest.approx(100.0 * 1.0 / 9.0, rel=1e-12)
    assert spec.reader("mc.compact_pct")(_run("mc_qc_flood_q0825", None)) is None
    idle = TraceData(lo=0.0, hi=1.0, device=[], host=[])
    assert spec.reader("mc.compact_pct")(_run("mc_qc_flood_q0825", idle)) is None


def test_the_new_files_load_through_discovery():
    cfg = spec.config("qc_n262144_r05")
    code = make_qc_code(**{k: cfg["code"][k] for k in ("z", "nb", "mb", "dv", "seed")})
    assert (code.n_vars, code.n_checks, code.n_edges) == tuple(
        cfg["code"][k] for k in ("n_vars", "n_checks", "n_edges"))
    assert cfg["decoder"] == spec.config("qc_n10240_r05")["decoder"] and cfg["reduced"] == []
    for name, kind, config, qber in ((LONG, "mc_point_blocked", "qc_n262144_r05", 0.07),
                                     ("mc_qc_layered_q0825", "mc_point_layered",
                                      "qc_n10240_r05", 0.0825)):
        cell = spec.cell(name)
        assert (cell["kind"], cell["config"], cell["params"]["qber"]) == (kind, config, qber)
        assert cell["check"]["limits"] == {"stats_gap": 0.0} and callable(spec.driver(kind))
    assert spec.cell(LONG)["params"]["trials"] == 16 * spec.cell(LONG)["params"]["batch"]


@pytest.fixture(scope="module")
def long_base(tmp_path_factory):
    """The tiny benchmark directory with a cell of the new kind on the long
    code's base shape."""
    base = tiny.make_base(tmp_path_factory.mktemp("portbench"))
    cfg = dict(spec.config("qc_n262144_r05"), name="tiny_long")
    cfg["code"] = dict(cfg["code"], z=16, n_vars=2048, n_checks=1040, n_edges=6144)
    (base / "configs" / "tiny_long.json").write_text(json.dumps(cfg))
    cell = dict(spec.cell(LONG), name="t_long", config="tiny_long", trace_slice_s=0.1,
                params=dict(spec.cell(LONG)["params"], trials=128, batch=64, compact_lanes=16,
                            warm_points=1))
    (base / "workloads" / "t_long.json").write_text(json.dumps(cell))
    return base


@pytest.mark.parametrize("control", [None, "int8"], ids=["sound", "int8-control"])
def test_the_blocked_check_judges_a_tiny_long_cell(long_base, control, monkeypatch):
    """The new kind's check is ``mc_point``'s with the reference decoding a
    batch of trials at a time, and it leaves ``stats.point`` as it was."""
    widths, point = [], stats.point

    def recorded(*args, width=4096, **kwargs):
        widths.append(width)
        return point(*args, width=width, **kwargs)

    monkeypatch.setattr(stats, "point", recorded)
    bench = spec.benchmark()
    bench["workloads"].append({"name": "t_long", "chips": 1})
    for m in bench["end_to_end"]:
        if LONG in m.get("workloads", []):
            m["workloads"] = m["workloads"] + ["t_long"]
    argv = ["--workload", "t_long", "--seed", str(2**31 + 11), "--seconds", "0.2",
            "--trace", "0"] + (["--control", control] if control else [])
    result, _ = run.run_cell(run.parse(argv), CPU, bench, base=long_base,
                             t_start=time.perf_counter())
    assert result["correct"] is (control is None), result["checks"]
    assert set(result["metrics"]) == {"trials_per_s", "setup_s"}
    assert widths == [64] and stats.point is recorded
