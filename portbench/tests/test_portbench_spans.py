"""The six readers of the program's spans (``qkd.*``): hand-computed values
on hand-made traces, None where a trace or its spans are missing, and a
tiny traced run of each traffic kind on the CPU."""

from __future__ import annotations

import pytest

from portbench import harness, spec
from portbench.tests import tiny
from portbench.trace import TraceData

READERS = ("mc.point_host_ms", "mc.replay_idle_pct", "mc.wait_idle_pct",
           "serve.host_p50_ms", "serve.wait_p50_ms", "sweep.pass_host_ms")


def _run(trace):
    ctx = harness.Context(cell=spec.cell("mc_qc_flood_q050"),
                          config=spec.config("qc_n10240_r05"), seed=1, device=None,
                          storage="bfloat16")
    return harness.Run(ctx=ctx, units=[], trace=trace, slice_end=None)


def _points():
    """A slice [0, 10] of three whole points (one a continuation call) and
    two that straddle its edges, with nested dispatches and replays,
    overlapping waits, and device operations across both edges."""
    host = [(0.0, 10.0, "portbench.point"),
            (-1.0, 1.0, "qkd.point.run"), (-1.0, 0.1, "qkd.graph.replay"),
            (1.0, 4.0, "qkd.point.run"), (1.0, 3.0, "qkd.point.dispatch"),
            (2.0, 2.5, "qkd.graph.replay"), (3.0, 3.5, "qkd.fetch.wait"),
            (3.2, 3.8, "qkd.fetch.wait"),
            (4.5, 9.0, "qkd.point.run"), (5.0, 6.0, "qkd.graph.replay"),
            (7.0, 8.5, "qkd.fetch.wait"),
            (9.2, 9.8, "qkd.cont.run"),
            (9.5, 11.0, "qkd.point.run"), (9.9, 10.5, "qkd.fetch.wait")]
    dev = [(-0.5, 0.02, "k"), (0.05, 1.5, "k"), (2.2, 2.4, "k"), (3.1, 3.3, "k"),
           (5.5, 7.5, "k"), (8.0, 12.0, "k")]
    return TraceData(lo=0.0, hi=10.0, device=dev, host=host)


def test_point_readers():
    run = _run(_points())
    # host a whole point: 3 - 0.8 (waits 3-3.8), 4.5 - 1.5, 0.6; the
    # straddling points left out
    assert spec.reader("mc.point_host_ms")(run) == pytest.approx(2200.0)
    # idle (0.02-0.05), (1.5-2.2), (2.4-3.1), (3.3-5.5), (7.5-8) of 10 s;
    # inside a replay: 0.03 + 0.2 + 0.1 + 0.5; inside a wait: 0.1 + 0.5 + 0.5
    assert spec.reader("mc.replay_idle_pct")(run) == pytest.approx(8.3)
    assert spec.reader("mc.wait_idle_pct")(run) == pytest.approx(11.0)


def _serve():
    host = [(0.2, 0.4, "qkd.serve.wait"),  # in no call
            (1.0, 4.0, "qkd.serve.reconcile"), (1.1, 1.4, "qkd.serve.fill"),
            (1.5, 2.0, "qkd.serve.wait"), (2.5, 3.0, "qkd.serve.wait"),
            (2.8, 3.2, "qkd.serve.wait"),
            (5.0, 6.0, "qkd.serve.reconcile"), (5.2, 5.3, "qkd.serve.wait"),
            (7.0, 9.5, "qkd.serve.reconcile"),
            (9.8, 10.4, "qkd.serve.reconcile"), (9.9, 10.1, "qkd.serve.wait")]
    return TraceData(lo=0.0, hi=10.0, device=[(0.0, 12.0, "k")], host=host)


def test_serve_readers():
    run = _run(_serve())
    # waits a whole call 0.5 + 0.7, 0.1, 0; host 1.8, 0.9, 2.5
    assert spec.reader("serve.host_p50_ms")(run) == pytest.approx(1800.0)
    assert spec.reader("serve.wait_p50_ms")(run) == pytest.approx(100.0)


def _sweep():
    host = [(-1.0, 0.3, "qkd.sweep.run"), (0.35, 0.45, "qkd.sweep.write"),
            (0.5, 3.0, "qkd.sweep.run"), (0.5, 0.6, "qkd.sweep.setup"),
            (1.0, 1.5, "qkd.fetch.wait"), (2.0, 2.2, "qkd.fetch.wait"),
            (3.1, 3.4, "qkd.sweep.write"),
            (4.0, 6.0, "qkd.sweep.run"), (5.0, 5.5, "qkd.fetch.wait"),
            (6.2, 6.3, "qkd.sweep.write"), (6.5, 6.6, "qkd.sweep.write"),
            (7.0, 9.0, "qkd.sweep.run"), (9.5, 10.5, "qkd.sweep.write")]
    return TraceData(lo=0.0, hi=10.0, device=[(-1.0, 11.0, "k")], host=host)


def test_sweep_reader():
    # passes: 2.5 - 0.7 + 0.3, 2 - 0.5 + 0.1, 2 (its write straddles the end)
    assert spec.reader("sweep.pass_host_ms")(_run(_sweep())) == pytest.approx(2000.0)


@pytest.mark.parametrize("name", READERS)
def test_a_reader_without_its_spans_reads_none(name):
    read = spec.reader(name)
    assert read(_run(None)) is None
    bare = TraceData(lo=0.0, hi=10.0, device=[(1.0, 2.0, "k")],
                     host=[(0.0, 10.0, "portbench.point"), (3.0, 4.0, "cudaGraphLaunch")])
    assert read(_run(bare)) is None
    other = {"mc": _serve, "serve": _points, "sweep": _serve}[name.split(".")[0]]
    assert read(_run(other())) is None  # another layer's spans only


@pytest.fixture(scope="module")
def base(tmp_path_factory):
    return tiny.make_base(tmp_path_factory.mktemp("portbench-spans"))


@pytest.mark.parametrize("name,want", [
    ("t_flood", ["mc.point_host_ms"]), ("t_cont", ["mc.point_host_ms"]),
    ("t_serve", ["serve.host_p50_ms", "serve.wait_p50_ms"]),
    ("t_sweep", ["sweep.pass_host_ms"])])
def test_a_tiny_traced_run_reports_the_span_readings(base, name, want):
    """On the CPU the program's spans are read in each traffic kind; it
    replays no graph and runs no device operation, so the idle splits stay
    silent there."""
    result, _ = tiny.run_tiny(base, tiny.bench_with_tiny(), name, trace=1)
    assert result["correct"] is True
    m = result["metrics"]
    for k in want:
        assert isinstance(m[k]["value"], float) and m[k]["value"] >= 0.0, (k, m)
    assert "mc.replay_idle_pct" not in m and "mc.wait_idle_pct" not in m


@pytest.mark.card
def test_every_cell_reports_its_span_readings_on_the_card():
    """Each cell traced briefly on the card: every span reading it lists
    beside the readings it had, and no ``qkd.*`` range among the device
    operations."""
    import json
    import subprocess
    import sys

    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    bench = spec.benchmark()
    for w in bench["workloads"]:
        out = subprocess.run([sys.executable, "portbench/run.py", "--workload", w["name"],
                              "--seed", "2147483999", "--seconds", "4", "--trace", "1"],
                             capture_output=True, text=True, cwd=harness.ROOT.parent,
                             timeout=900)
        assert out.returncode == 0, out.stderr[-2000:]
        result = json.loads(out.stdout.strip().splitlines()[-1])
        want = {m["name"] for m in spec.metrics_of(bench, "per_layer", w["name"])}
        assert want <= set(result["metrics"]), (w["name"], result["metrics"])
        assert not any(name.startswith("qkd.") for name, _ in result["breakdown"]["device_ops"])
