"""The port's host spans (``qkd_ldpc_tpu_torch.spans``) on the CPU: under a
profiler each layer emits its documented spans with their documented
nesting, read from the profiler's raw events as the benchmark's trace reader
reads them; with no profiler recording a span is the shared no-op and
records nothing; every result is bit-identical with the profiler on and off.
(The graph spans, ``qkd.graph.*``, need the card: the CPU replays no graph.)"""

import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest
from torch.autograd import profiler
from torch.profiler import ProfilerActivity, profile

import qkd_ldpc_tpu_torch
from qkd_ldpc_tpu_torch import spans
from qkd_ldpc_tpu_torch.channel.threefry import prng_key
from qkd_ldpc_tpu_torch.codes import make_qc_code
from qkd_ldpc_tpu_torch.config import Config, RQBERParams
from qkd_ldpc_tpu_torch.decoder.bp import DecodeOptions
from qkd_ldpc_tpu_torch.serve import Reconciler
from qkd_ldpc_tpu_torch.sim import continuation, runner, write_results

OPTS = DecodeOptions(max_iterations=30)
_code = {}


def _qc():
    if not _code:
        _code["qc"] = make_qc_code(z=32, nb=12, mb=6, dv=3, seed=5)  # N 384, rate 1/2
    return _code["qc"]


def traced(fn):
    """``fn()`` under a CPU profiler: its result and the ``qkd.*`` spans as
    ``(start, end, name)`` (ns), in order of their starts."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    evs = sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                 for e in prof.profiler.kineto_results.events() if e.name().startswith("qkd."))
    return out, evs


def named(evs, name, within=None):
    return [e for e in evs if e[2] == name
            and (within is None or within[0] <= e[0] and e[1] <= within[1])]


def one(evs, name, within=None):
    (e,) = named(evs, name, within)
    return e


def test_run_point_spans():
    """``qkd.point.run`` holds the point's one ``qkd.point.dispatch`` and,
    after it, one ``qkd.fetch.wait`` a chunk."""
    def point():
        return runner.run_point(_qc(), prng_key(3), 0.04, 96, 32, OPTS,
                                max_batches_per_dispatch=2, device="cpu")

    (got, q), evs = traced(point)
    run = one(evs, "qkd.point.run")
    disp = one(evs, "qkd.point.dispatch", run)
    waits = named(evs, "qkd.fetch.wait", run)
    assert len(waits) == 2 and all(w[0] >= disp[1] for w in waits)
    assert {e[2] for e in evs} == {"qkd.point.run", "qkd.point.dispatch", "qkd.fetch.wait"}
    want, q0 = point()
    assert dataclasses.asdict(got) == dataclasses.asdict(want) and q == q0


def test_continuation_spans():
    """``qkd.cont.run`` holds one ``qkd.cont.dispatch`` and, after it, the
    carry's ``qkd.fetch.wait``."""
    def point():
        return continuation.run_point_continuation(_qc(), prng_key(4), 0.06, 64, 32, OPTS,
                                                   segment=2, device="cpu")

    (got, q), evs = traced(point)
    run = one(evs, "qkd.cont.run")
    disp = one(evs, "qkd.cont.dispatch", run)
    assert one(evs, "qkd.fetch.wait", run)[0] >= disp[1]
    assert len(evs) == 3
    want, q0 = point()
    assert dataclasses.asdict(got) == dataclasses.asdict(want) and q == q0


def test_reconciler_spans():
    """Each call is one ``qkd.serve.syndromes`` or ``qkd.serve.reconcile``
    holding, a chunk, its fill and dispatch, then its wait and read."""
    code = _qc()
    rng = np.random.default_rng(11)
    alice = rng.integers(0, 2, (20, code.n_vars), dtype=np.uint8)
    bob = alice.copy()
    for row in bob:
        row[rng.choice(code.n_vars, 12, replace=False)] ^= 1
    rec = Reconciler(code, OPTS, lanes=8, device="cpu")
    rec.max_inflight_chunks = 2

    def calls():
        syn = rec.syndromes(alice)
        return syn, rec.reconcile(bob, syn, 12 / code.n_vars)

    (syn, res), evs = traced(calls)
    for call in ("qkd.serve.syndromes", "qkd.serve.reconcile"):
        outer = one(evs, call)
        fill, disp, wait, read = (named(evs, f"qkd.serve.{k}", outer)
                                  for k in ("fill", "dispatch", "wait", "read"))
        assert len(fill) == len(disp) == len(wait) == len(read) == 3  # 8 + 8 + 4 frames
        for k in range(3):
            assert fill[k][1] <= disp[k][0] and disp[k][1] <= wait[k][0]
            assert wait[k][1] <= read[k][0]
    assert len(evs) == 2 + 2 * 12
    syn0 = rec.syndromes(alice)
    res0 = rec.reconcile(bob, syn0, 12 / code.n_vars)
    assert np.array_equal(syn, syn0)
    for a, b in zip(res, res0):
        assert np.array_equal(a, b)
    assert res.syndromes_match.all() and np.array_equal(res.bits, alice)


@pytest.mark.parametrize("continuation_qber,n_cont", [(0.0, 0), (0.035, 2)])
def test_sweep_spans(tmp_path, continuation_qber, n_cont):
    """``qkd.sweep.run`` opens with ``qkd.sweep.setup``, then holds a
    dispatch and a wait a point (the ``n_cont`` waterfall points share one
    continuation call) and a ``qkd.sweep.checkpoint`` a point;
    ``qkd.sweep.write`` follows it."""
    code = _qc()
    cfg = Config(r_qber_parameters=(RQBERParams(0.58, 0.03, 0.045, 0.005),),
                 trials_number=32, simulation_seed=777, sum_product_max_iterations=30,
                 use_mesh=False, continuation_qber=continuation_qber)
    inputs = [runner.SimInput(code, "qc.alist", [0.03, 0.035, 0.04])]

    def sweep(tag):
        d = tmp_path / tag
        c = dataclasses.replace(cfg, checkpoint_dir=str(d / "ckpt")).validate()
        results = runner.batch_simulation(inputs, c, progress=False, device="cpu")
        return write_results(results, d, c.trials_number, c.sum_product_max_iterations,
                             c.simulation_seed).read_text()

    csv, evs = traced(lambda: sweep("on"))
    run = one(evs, "qkd.sweep.run")
    setup = one(evs, "qkd.sweep.setup", run)
    assert setup == min(e for e in evs if e != run and e[0] >= run[0])  # its first child
    cont = len(named(evs, "qkd.cont.dispatch", run))
    assert cont == (n_cont > 0)
    assert len(named(evs, "qkd.point.dispatch", run)) == 3 - n_cont
    assert len(named(evs, "qkd.fetch.wait", run)) == 3 - n_cont + cont
    assert len(named(evs, "qkd.sweep.checkpoint", run)) == 3
    assert one(evs, "qkd.sweep.write")[0] >= run[1]
    assert csv == sweep("off") and len(csv.splitlines()) == 4


def test_no_profiler_no_span(monkeypatch):
    """With no profiler recording, every span is the one shared no-op and
    nothing reaches the profiler's ranges."""
    assert not profiler._is_profiler_enabled
    assert spans.span("qkd.point.run") is spans.OFF is spans.span("qkd.serve.wait")

    def refuse(name, *a, **kw):
        raise AssertionError(f"{name} recorded with no profiler")

    monkeypatch.setattr(profiler, "record_function", refuse)
    P, _ = runner.run_point(_qc(), prng_key(5), 0.04, 32, 32, OPTS, device="cpu")
    assert P.n_trials == 32


def test_the_switch_is_the_profilers_flag():
    """The check :func:`spans.span` reads is the flag torch keeps while a
    profiler records (``torch.autograd.profiler._is_profiler_enabled``)."""
    assert profiler._is_profiler_enabled is False and spans.span("x") is spans.OFF
    with profile(activities=[ProfilerActivity.CPU]):
        assert profiler._is_profiler_enabled is True
        s = spans.span("qkd.point.run")
        assert isinstance(s, profiler.record_function) and s.name == "qkd.point.run"
    assert profiler._is_profiler_enabled is False and spans.span("x") is spans.OFF


def test_every_span_of_the_package_is_in_the_table():
    """The names the package's sources open are exactly :data:`spans.SPANS`."""
    root = Path(qkd_ldpc_tpu_torch.__file__).parent
    used = {m for p in root.rglob("*.py")
            for m in re.findall(r'\bspan\("([^"]+)"\)', p.read_text())}
    assert used == set(spans.SPANS)
