"""The benchmark's blind node cell (traffic kind ``serve_blind``) driven end
to end on the CPU at a tiny size, in a directory of its own beside the tiny
copies of the other cells: a run is judged correct, the program in int8
storage is not, and neither is a planted fault — reveals pinned at the wrong
positions, a revealed bit counted once in the leak, a frame's round off by
one, the final key length off by one.  Against a program whose endpoint has
no blind session the driver fails before any set-up.  The four ``blind.*``
readers read a recorded trace and counters; the plain runner's waterfall
cell is the QBER 0.05 cell's point at 0.0825."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from portbench import harness, spec
from portbench.tests import tiny
from portbench.trace import TraceData

torch.set_num_threads(1)
REAL = "serve_blind_secure_drift"
BLIND = {"d": 64, "seed": 3, "reveal_step": 16, "qber_hint": 0.06, "tag_bits": 64,
         "security_bits": 100}
PARAMS = dict(lanes=16, inflight_chunks=4, frames=32, qber_lo=0.05, qber_hi=0.09, pool=3,
              blocks_per_s=8.0)


@pytest.fixture(scope="module")
def base(tmp_path_factory):
    base = tiny.make_base(tmp_path_factory.mktemp("portbench"))
    qc = json.loads((base / "configs" / "tiny_qc.json").read_text())
    (base / "configs" / "tiny_blind.json").write_text(json.dumps(
        dict(qc, name="tiny_blind", blind=BLIND)))
    cell = dict(spec.cell(REAL), name="t_blind", config="tiny_blind", params=PARAMS,
                trace_slice_s=0.1)
    (base / "workloads" / "t_blind.json").write_text(json.dumps(cell))
    return base


@pytest.fixture(scope="module")
def bench():
    bench = spec.benchmark()
    bench["workloads"].append({"name": "t_blind", "chips": 1})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if REAL in m.get("workloads", []):
            m["workloads"] = m["workloads"] + ["t_blind"]
    return bench


@pytest.mark.parametrize("trace", [0, 1])
def test_a_run_is_correct(base, bench, trace):
    result, checks = tiny.run_tiny(base, bench, "t_blind", trace=trace)
    assert result["correct"] is True, result["checks"]
    assert result["failed"] == 0 and result["attempted"] > 0
    kind = "per_layer" if trace else "end_to_end"
    want = {m["name"] for m in spec.metrics_of(bench, kind, "t_blind")}
    if trace:  # no device trace on the CPU: the span and counter readers read
        assert set(result["metrics"]) == {"blind.turn_p50_ms", "blind.lane_fill_pct"}
        assert result["metrics"]["blind.turn_p50_ms"]["value"] > 0
        assert 0 < result["metrics"]["blind.lane_fill_pct"]["value"] < 100
        assert want == {"blind.device_idle_pct", "blind.decode_bw_pct",
                        "blind.turn_p50_ms", "blind.lane_fill_pct"}
    else:
        assert set(result["metrics"]) == want == {"frames_per_s", "setup_s"}
    (check, value, limit), = checks
    assert check == "blind_off" and value == 0.0 == limit
    json.dumps(result)


def test_the_int8_control_is_not_correct(base, bench):
    for seed in (5, 2**31 + 3):
        result, _ = tiny.run_tiny(base, bench, "t_blind", seed=seed, control="int8")
        assert result["correct"] is False, (seed, result["checks"])


def _wrong_positions(monkeypatch):
    """Alice's revealed bits pinned one place along the reveal order."""
    from qkd_ldpc_tpu_torch import serve

    real = serve._ServeProgram.__init__

    def init(self, *a, **kw):
        real(self, *a, **kw)
        if self.blind:
            self.mod_idx = torch.roll(self.mod_idx, 1)

    monkeypatch.setattr(serve._ServeProgram, "__init__", init)


def _leak_once(monkeypatch):
    from qkd_ldpc_tpu_torch import serve

    monkeypatch.setattr(serve, "blind_leak_bits", lambda m, d, revealed: (
        m - d + np.asarray(revealed)).astype(np.int32))


def _round_off(monkeypatch):
    """Frame 0's round one more than it took (its leak left as it was)."""
    from qkd_ldpc_tpu_torch import serve

    real = serve.BlindRounds.result

    def result(self):
        res = real(self)
        rounds = res.rounds.copy()
        rounds[0] += 1
        return res._replace(rounds=rounds)

    monkeypatch.setattr(serve.BlindRounds, "result", result)


def _final_length(monkeypatch):
    from qkd_ldpc_tpu_torch import serve

    real = serve.amplified_key_bits
    monkeypatch.setattr(serve, "amplified_key_bits", lambda *a: real(*a) - 1)


FAULTS = {"wrong_positions": _wrong_positions, "leak_once": _leak_once,
          "round_off": _round_off, "final_length": _final_length}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_planted_fault_is_not_correct(base, bench, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    result, checks = tiny.run_tiny(base, bench, "t_blind")
    (_, value, _), = checks
    assert result["correct"] is False and value > 0, result["checks"]


def test_a_program_without_blind_fails_before_set_up(base, monkeypatch):
    from qkd_ldpc_tpu_torch import serve

    monkeypatch.delattr(serve.Reconciler, "blind_session")
    made = []
    monkeypatch.setattr(harness, "reference_graph", lambda ctx: made.append(1))
    cell = spec.cell("t_blind", base)
    ctx = harness.Context(cell=cell, config=spec.config(cell["config"], base), seed=3,
                          device=torch.device("cpu"), storage="bfloat16", base=base)
    with pytest.raises(RuntimeError, match="blind_session"):
        spec.driver(cell["kind"], base)(ctx)
    assert not made


def test_the_blind_readers_read_a_recorded_trace_and_counters(base):
    """Device idle and the decode's share of its byte bound from device
    operations, the turn's median from the program's spans, the lanes' fill
    from the units' counters; each None where there is nothing to read."""
    from portbench import arith

    cell = spec.cell("t_blind", base)
    ctx = harness.Context(cell=cell, config=spec.config(cell["config"], base), seed=3,
                          device=torch.device("cpu"), storage="bfloat16", base=base)
    dev = [(0.0, 2.0, "void check_update_kernel<6>"), (2.0, 3.0, "Memcpy HtoD"),
           (4.0, 5.0, "void variable_update_kernel<8>"), (6.0, 7.0, "sgemm")]
    host = [(1.0, 1.5, "qkd.blind.turn"), (3.0, 3.25, "qkd.blind.turn"),
            (5.0, 6.0, "qkd.blind.turn"), (4.0, 4.5, "qkd.blind.round")]
    units = [dict(t1=5.0, frame_iterations=1000, live_frame_rounds=40, lanes_dispatched=64),
             dict(t1=9.0, frame_iterations=500, live_frame_rounds=10, lanes_dispatched=16)]
    run = harness.Run(ctx=ctx, units=units, trace=TraceData(lo=0.0, hi=10.0, device=dev,
                                                            host=host), slice_end=9.5)
    read = {n: spec.reader(n, base) for n in ("blind.device_idle_pct", "blind.decode_bw_pct",
                                              "blind.turn_p50_ms", "blind.lane_fill_pct")}
    assert read["blind.device_idle_pct"](run) == pytest.approx(50.0)
    per = arith.decode_bytes_per_frame_iteration(640, 1920, "bfloat16")
    assert read["blind.decode_bw_pct"](run) == pytest.approx(
        100.0 * 1500 * per / arith.HBM_BYTES_PER_S / 3.0)
    assert read["blind.turn_p50_ms"](run) == pytest.approx(500.0)
    assert read["blind.lane_fill_pct"](run) == pytest.approx(100.0 * 50 / 80)
    bare = harness.Run(ctx=ctx, units=[], trace=TraceData(lo=0.0, hi=10.0, device=[],
                                                          host=[]), slice_end=9.5)
    assert all(r(bare) is None for r in read.values())


def test_the_waterfall_cell_is_the_flood_point_at_0_0825():
    """``mc_qc_flood_q0825``: ``mc_qc_flood_q050``'s kind, configuration,
    parameters and limit, but QBER 0.0825 and one checked point."""
    low, high = spec.cell("mc_qc_flood_q050"), spec.cell("mc_qc_flood_q0825")
    assert high["kind"] == low["kind"] == "mc_point" and high["config"] == low["config"]
    assert high["params"] == dict(low["params"], qber=0.0825)
    assert high["check"] == {"points": 1, "limits": low["check"]["limits"]}
    bench = spec.benchmark()
    assert "mc_qc_flood_q0825" in next(m for m in bench["end_to_end"]
                                       if m["name"] == "trials_per_s")["workloads"]
    blind = next(w for w in bench["workloads"] if w["name"] == REAL)
    assert blind["chips"] == 1 and spec.cell(REAL)["params"]["blocks_per_s"] > 0
