"""The benchmark's two cells of the rate-adaptive secure node and the
layered schedule (traffic kinds ``serve_secure`` and ``mc_point_layered``)
driven end to end on the CPU at a tiny size, in a directory of their own
beside the tiny copies of the other cells: a run is judged correct, the
program in int8 storage is not, and neither is a planted fault — a wrong
rate step, a shortened position left as an erasure, the final key length
off by one (the program reports one length a call, so every frame of the
call), the layered messages left unchanged, one iteration count altered."""

from __future__ import annotations

import json

import pytest
import torch

from portbench import spec
from portbench.tests import tiny

torch.set_num_threads(1)
TINY = {  # tiny cell -> (the real cell it stands for, its configuration, params)
    "t_secure": ("serve_ra_secure_drift", "tiny_ra",
                 dict(lanes=32, inflight_chunks=4, frames=48, qber_lo=0.04, qber_hi=0.07,
                      pool=4, blocks_per_s=20.0)),
    "t_layered": ("mc_qc_layered_q050", "tiny_qc",
                  dict(qber=0.06, trials=64, batch=64, compact_after=4, compact_lanes=16,
                       max_batches_per_dispatch=64, warm_points=1)),
}
RATES = {"d": 64, "grid": 16, "seed": 3, "shared_seed": 7, "efficiency": 1.3,
         "tag_bits": 64, "security_bits": 100}


@pytest.fixture(scope="module")
def base(tmp_path_factory):
    base = tiny.make_base(tmp_path_factory.mktemp("portbench"))
    qc = json.loads((base / "configs" / "tiny_qc.json").read_text())
    (base / "configs" / "tiny_ra.json").write_text(json.dumps(
        dict(qc, name="tiny_ra", rate_adaptation=RATES)))
    for name, (real, config, params) in TINY.items():
        cell = dict(spec.cell(real), name=name, config=config, params=params,
                    trace_slice_s=0.1)
        (base / "workloads" / f"{name}.json").write_text(json.dumps(cell))
    return base


@pytest.fixture(scope="module")
def bench():
    bench = spec.benchmark()
    for name, (real, _, _) in TINY.items():
        bench["workloads"].append({"name": name, "chips": 1})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if real in m.get("workloads", []):
                m["workloads"] = m["workloads"] + [name]
    return bench


@pytest.mark.parametrize("name", sorted(TINY))
@pytest.mark.parametrize("trace", [0, 1])
def test_a_run_is_correct(base, bench, name, trace):
    result, checks = tiny.run_tiny(base, bench, name, trace=trace)
    assert result["correct"] is True, result["checks"]
    assert result["failed"] == 0 and result["attempted"] > 0
    kind = "per_layer" if trace else "end_to_end"
    want = {m["name"]: m["unit"] for m in spec.metrics_of(bench, kind, name)}
    if trace:  # no device trace on the CPU: the span reader alone reads
        assert set(result["metrics"]) <= set(want)
        if name == "t_secure":
            assert result["metrics"]["ra.amplify_p50_ms"]["value"] > 0
    else:
        assert set(result["metrics"]) == set(want) and "setup_s" in want
    (check, value, limit), = checks
    assert check == ("keys_off" if name == "t_secure" else "stats_gap") and value == 0.0
    json.dumps(result)


@pytest.mark.parametrize("name", sorted(TINY))
def test_the_int8_control_is_not_correct(base, bench, name):
    for seed in (5, 2**31 + 3, 977):
        result, _ = tiny.run_tiny(base, bench, name, seed=seed, control="int8")
        assert result["correct"] is False, (seed, result["checks"])


def _wrong_step(monkeypatch):
    from qkd_ldpc_tpu_torch.decoder.rate_adapt import RateFamily

    real = RateFamily.step
    monkeypatch.setattr(RateFamily, "step",
                        lambda self, q, f: (real(self, q, f) + 1) % self.steps)


def _erasure(monkeypatch):
    """The first shortened position of every step's template left at 0."""
    from qkd_ldpc_tpu_torch.decoder.rate_adapt import RateFamily

    real = RateFamily.pin_templates

    def templates(self, shared_seed, device):
        mod_idx, t = real(self, shared_seed, device)
        t = t.clone()
        for row in t:
            pinned = row.nonzero().flatten()
            if pinned.numel():
                row[pinned[0]] = 0.0
        return mod_idx, t

    monkeypatch.setattr(RateFamily, "pin_templates", templates)


def _final_length(monkeypatch):
    from qkd_ldpc_tpu_torch import serve

    real = serve.amplified_key_bits
    monkeypatch.setattr(serve, "amplified_key_bits", lambda *a: real(*a) - 1)


def _unchanged(monkeypatch):
    """Every layered sweep leaves the messages as it found them."""
    from qkd_ldpc_tpu_torch.decoder import layered

    real = layered.layered_sweep_plain

    def frozen(t, Lr, *a, **kw):
        keep = Lr.clone()
        out = real(t, Lr, *a, **kw)
        Lr.copy_(keep)
        return out

    monkeypatch.setattr(layered, "layered_sweep_plain", frozen)


def _altered(monkeypatch):
    """One frame's iteration count altered where the layered decode makes it."""
    from qkd_ldpc_tpu_torch.decoder import layered

    real = layered._layered_program

    def altered(*a, **kw):
        z, iters, done = real(*a, **kw)
        return z, iters + (torch.arange(iters.shape[0]) == 0).to(iters.dtype), done

    monkeypatch.setattr(layered, "_layered_program", altered)


FAULTS = {"t_secure": {"wrong_step": _wrong_step, "erasure": _erasure,
                       "final_length": _final_length},
          "t_layered": {"unchanged": _unchanged, "altered": _altered}}


@pytest.mark.parametrize("name,fault", [(n, f) for n in sorted(FAULTS) for f in FAULTS[n]])
def test_a_planted_fault_is_not_correct(base, bench, name, fault, monkeypatch):
    FAULTS[name][fault](monkeypatch)
    result, _ = tiny.run_tiny(base, bench, name)
    assert result["correct"] is False, result["checks"]
