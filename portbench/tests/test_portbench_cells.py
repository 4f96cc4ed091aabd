"""Every traffic kind driven end to end on the CPU at a tiny size: the last
line's schema, the correct answer judged correct, and the control and each
planted fault judged not correct."""

from __future__ import annotations

import json

import pytest
import torch

from portbench import run
from portbench.tests import tiny

KINDS = sorted(tiny.STANDS_FOR)


@pytest.fixture(scope="module")
def base(tmp_path_factory):
    return tiny.make_base(tmp_path_factory.mktemp("portbench"))


@pytest.fixture(scope="module")
def bench():
    return tiny.bench_with_tiny()


@pytest.mark.parametrize("name", KINDS)
@pytest.mark.parametrize("trace", [0, 1])
def test_a_run_prints_its_last_line(base, bench, name, trace):
    result, checks = tiny.run_tiny(base, bench, name, trace=trace)
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(result)[-1] == "checks"
    assert result["correct"] is True, result["checks"]
    assert result["failed"] == 0 and result["attempted"] > 0
    kind = "per_layer" if trace else "end_to_end"
    want = {m["name"]: m["unit"] for m in run_spec_metrics(bench, kind, name)}
    for k, m in result["metrics"].items():
        assert want[k] == m["unit"] and isinstance(m["value"], float)
    if not trace:
        assert set(result["metrics"]) == set(want) and "setup_s" in want
    dev = result["device"]
    assert dev["count"] == 1 and dev["memory_peak_bytes"] >= 0
    if trace:
        assert dev["window_s"] > 0 and "breakdown" in result
        assert all(len(result["breakdown"][k]) <= 10 for k in ("device_ops", "idle_gaps"))
    for name_, v, limit in checks:
        assert result["checks"][name_] == {"value": v, "limit": limit}
    json.dumps(result)


def run_spec_metrics(bench, kind, name):
    from portbench import spec

    return spec.metrics_of(bench, kind, name)


@pytest.mark.parametrize("name", KINDS)
def test_the_control_is_not_correct(base, bench, name):
    """The program in int8 storage, the next precision below the stated
    bfloat16, fails the comparison on every seed tried."""
    for seed in (5, 2**31 + 3, 977):
        result, _ = tiny.run_tiny(base, bench, name, seed=seed, control="int8")
        assert result["correct"] is False, (seed, result["checks"])


def _unchanged(monkeypatch):
    """Every check update after the first returns the messages it was given."""
    from qkd_ldpc_tpu_torch.decoder import cuda_kernels

    real = cuda_kernels.check_update_plain

    def frozen(total, lr_prev, syn, maps, *, first, out=None, **kw):
        if first:
            return real(total, lr_prev, syn, maps, first=first, out=out, **kw)
        keep = lr_prev.clone()
        Lr, flags = real(total, lr_prev, syn, maps, first=first, out=out, **kw)
        return Lr.copy_(keep), flags

    monkeypatch.setattr(cuda_kernels, "check_update_plain", frozen)


def _half(monkeypatch, name):
    """Half of each batch's trials or frames left out of the answer."""
    from qkd_ldpc_tpu_torch import serve
    from qkd_ldpc_tpu_torch.sim import continuation, runner

    real_reduce = runner.reduce_trials

    def reduce_half(ok, keys_match, iters, max_it, valid=None):
        half = torch.arange(ok.shape[0]) < ok.shape[0] // 2
        valid = half if valid is None else valid & half
        return real_reduce(ok, keys_match, iters, max_it, valid)

    monkeypatch.setattr(runner, "reduce_trials", reduce_half)
    real_shards = continuation._run_shards
    monkeypatch.setattr(continuation, "_run_shards",
                        lambda code, keys, n_errs, trials, *a: real_shards(
                            code, keys, n_errs, trials // 2, *a))
    real_serve = serve._ServeProgram.__call__

    def serve_half(self, inp, out, graph=None):
        real_serve(self, inp, out, graph)
        iters, ok, bits = self.outputs.views(out)
        for t in (iters, ok, bits):
            t[self.lanes // 2:] = 0

    monkeypatch.setattr(serve._ServeProgram, "__call__", serve_half)


def _altered(monkeypatch):
    """One frame's iteration count altered where the decode produces it."""
    from qkd_ldpc_tpu_torch.decoder import bp
    from qkd_ldpc_tpu_torch.sim import continuation

    real = bp._flooding_program

    def altered(*a, **kw):
        z, iters, done = real(*a, **kw)
        return z, iters + (torch.arange(iters.shape[0]) == 0).to(iters.dtype), done

    monkeypatch.setattr(bp, "_flooding_program", altered)
    real_core = continuation._continuation_core

    def core(*a, **kw):
        stats, counts = real_core(*a, **kw)
        stats = stats.clone()
        stats[3] += 1  # the iteration sum of every point
        return stats, counts

    monkeypatch.setattr(continuation, "_continuation_core", core)


@pytest.mark.parametrize("name", KINDS)
@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_a_planted_fault_is_not_correct(base, bench, name, fault, monkeypatch):
    if fault == "unchanged":
        _unchanged(monkeypatch)
    elif fault == "half":
        _half(monkeypatch, name)
    else:
        _altered(monkeypatch)
    result, _ = tiny.run_tiny(base, bench, name)
    assert result["correct"] is False, result["checks"]


def test_a_run_needs_a_card(capsys):
    """Without a card the command exits with another code than 0 and prints
    no result."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    rc = run.main(["--workload", "mc_qc_flood_q050", "--seed", "1", "--seconds", "1"])
    assert rc != 0 and capsys.readouterr().out == ""
