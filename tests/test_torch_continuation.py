"""The port's continuation runner (``sim/continuation.py``).

Port against port: refilling converged lanes with fresh trials must leave
all seven partial sums exactly those of the plain runner, for any (batch,
segment, refill) configuration — the cases of the JAX package's
``tests/test_continuation.py``, on its code and sizes.  In the port this
holds for sum-product as for min-sum: a fresh lane's ``tot - 0`` unclipped
is bit for bit the first iteration's input.

Port against the JAX package: the seven partials of
``run_point_continuation`` are equal for min-sum (exact) and for
sum-product at a point where the two packages' plain runners agree.

The plain version of the fresh-lane kernel is held against
``fused_update_fresh_pallas`` in ``tests/test_torch_kernels.py`` (the
``K5-fresh`` cases).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from qkd_ldpc_tpu import codes as jcodes
from qkd_ldpc_tpu.decoder import DecodeOptions as JaxDecodeOptions
from qkd_ldpc_tpu.sim.continuation import run_point_continuation as j_run_point_continuation
from qkd_ldpc_tpu_torch import codes as tcodes
from qkd_ldpc_tpu_torch.channel.threefry import fold_in, prng_key
from qkd_ldpc_tpu_torch.decoder.bp import DecodeOptions
from qkd_ldpc_tpu_torch.parallel import make_trial_mesh
from qkd_ldpc_tpu_torch.sim import (
    dispatch_sweep_continuation,
    run_point,
    run_point_continuation,
)
from qkd_ldpc_tpu_torch.sim.continuation import _refill_quantum
from qkd_ldpc_tpu_torch.sim.stats import PointPartials, partials_from_stacked

torch.set_num_threads(1)

# R~0.49 code small enough for the CPU; QBER 0.07-0.08 sits in its waterfall
# at a 30-iteration cap, so trials both converge and fail.
WF = dict(n=1024, m=523, dv=3, seed=3, name="wf-1024")


@pytest.fixture(scope="module")
def wf_code():
    return tcodes.make_code(**WF)


def plain_and_continuation(code, key, qber, trials, batch, opts, **kw):
    p1, q1 = run_point(code, key, qber, trials=trials, batch=trials, opts=opts,
                       device="cpu")
    p2, q2 = run_point_continuation(code, key, qber, trials=trials, batch=batch,
                                    opts=opts, device="cpu", **kw)
    assert q1 == q2
    assert dataclasses.astuple(p1) == dataclasses.astuple(p2), (p1, p2)
    return p2


@pytest.mark.parametrize("qber,max_it", [(0.075, 30), (0.03, 40)])
def test_continuation_matches_plain_runner(wf_code, qber, max_it):
    """Mixed converging/failing trials, several refill generations per lane
    (trials >> batch), ragged tail (trials not a batch multiple)."""
    p = plain_and_continuation(
        wf_code, fold_in(prng_key(777), 5), qber, 70, 16,
        DecodeOptions(max_iterations=max_it), segment=3, refill_frac=0.25)
    assert p.n_trials == 70
    if qber == 0.075:
        assert 0 < p.n_sp < 70 and p.max_it > p.min_it


def test_continuation_fresh_lane_clip_semantics(wf_code):
    """Tight message threshold (3.0 < |a-priori LLR| = 3.89): a refilled
    lane's first check update must see the UNCLIPPED a-priori LLRs, exactly
    like the peeled first iteration of the plain decoder."""
    key = fold_in(prng_key(3), 1)
    p = plain_and_continuation(
        wf_code, key, 0.02, 40, 8,
        DecodeOptions(max_iterations=30, message_threshold=3.0), segment=2)
    assert p.n_sp > 0  # meaningful case: trials actually converge


def test_continuation_no_success_corner(wf_code):
    """Threshold 2.5 at QBER 0.05 kills convergence entirely: the n_sp == 0
    min/max convention still compares bit-equal."""
    p = plain_and_continuation(
        wf_code, fold_in(prng_key(3), 1), 0.05, 20, 8,
        DecodeOptions(max_iterations=20, message_threshold=2.5), segment=4)
    assert p.n_sp == 0 and (p.min_it, p.max_it) == (0, 0)


@pytest.mark.parametrize("kw", [
    dict(algorithm="min-sum"), dict(message_dtype="bfloat16"),
    dict(message_dtype="int8"),
    dict(algorithm="min-sum", message_dtype="int8", min_sum_beta=0.2),
], ids=["min-sum", "bf16", "int8", "min-sum-int8-beta"])
def test_continuation_variants(wf_code, kw):
    plain_and_continuation(
        wf_code, fold_in(prng_key(9), 2), 0.06, 30, 10,
        DecodeOptions(max_iterations=30, **kw), segment=4)


def test_continuation_single_generation(wf_code):
    """trials <= batch: one generation, no refill after the first."""
    plain_and_continuation(
        wf_code, fold_in(prng_key(4), 0), 0.05, 12, 32,
        DecodeOptions(max_iterations=25), segment=5)


def test_continuation_loop_counts(wf_code, monkeypatch):
    """``last_loop_counts`` is what the loops really did: the fresh-lane
    update runs ``segment`` times per outer step, refills move every trial
    once, and one staging block is generated per ``batch`` trial ids."""
    from qkd_ldpc_tpu_torch.decoder.bp import _DecodeCore
    from qkd_ldpc_tpu_torch.sim import continuation

    calls = []
    real = _DecodeCore.check_update_fused

    def spy(self, total, Lr, syn, fresh=None, ok=None, **kw):
        calls.append(int(fresh.sum()))
        assert ok.all()  # the variable update hands over a set flag buffer
        Lr_new, ok = real(self, total, Lr, syn, fresh=fresh, ok=ok, **kw)
        assert not ok[fresh].any()  # a fresh lane has completed no iteration
        return Lr_new, ok

    monkeypatch.setattr(_DecodeCore, "check_update_fused", spy)
    p, _ = run_point_continuation(
        wf_code, fold_in(prng_key(777), 5), 0.075, trials=40, batch=8,
        opts=DecodeOptions(max_iterations=30), segment=3, refill_frac=0.25,
        device="cpu")
    counts = continuation.last_loop_counts
    assert p.n_trials == 40
    assert len(calls) == 3 * counts["outer_steps"] and counts["outer_steps"] > 1
    assert sum(calls) == 40  # every trial was fresh in exactly one update
    assert counts["refills"] == 40 // 2 and counts["generations"] == 40 // 8


def test_continuation_guards(wf_code):
    key = prng_key(0)
    with pytest.raises(ValueError, match="overflows the int32"):
        run_point_continuation(wf_code, key, 0.05, trials=1000, batch=8,
                               opts=DecodeOptions(max_iterations=100_000),
                               device="cpu")
    with pytest.raises(ValueError, match="too small for QBER"):
        run_point_continuation(wf_code, key, 0.0005, trials=4, batch=4,
                               opts=DecodeOptions(), device="cpu")
    # The JAX runner silently decodes flooding under schedule="layered";
    # the port refuses the combination itself.
    layered = DecodeOptions(schedule="layered")
    with pytest.raises(ValueError, match="flooding schedule only"):
        run_point_continuation(wf_code, key, 0.05, trials=4, batch=4, opts=layered,
                               device="cpu")
    with pytest.raises(ValueError, match="flooding schedule only"):
        dispatch_sweep_continuation(wf_code, [key], [0.05], 4, 4, layered,
                                    device="cpu")
    # ... on a trial mesh too (the sharded continuation, parallel/)
    with pytest.raises(ValueError, match="flooding schedule only"):
        dispatch_sweep_continuation(wf_code, [key], [0.05], 4, 4, layered,
                                    mesh=make_trial_mesh([torch.device("cpu")] * 2))
    if not torch.cuda.is_available():  # device=None means the card
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run_point_continuation(wf_code, key, 0.05, trials=4, batch=4,
                                   opts=DecodeOptions())


def test_refill_quantum_divides_the_batch():
    assert _refill_quantum(16, 0.25) == 4
    assert _refill_quantum(512, 0.125) == 64
    assert _refill_quantum(10, 0.25) == 2
    assert _refill_quantum(7, 0.9) == 1
    assert _refill_quantum(8, 0.01) == 1


def test_continuation_randomized_config_fuzz(wf_code):
    """Randomized (trials, batch, segment, refill, qber, algorithm, dtype):
    the continuation machinery has no tunable that may change results."""
    rng = np.random.default_rng(20260816)
    ticks = []
    for trial in range(6):
        trials = int(rng.integers(5, 60))
        opts = DecodeOptions(
            max_iterations=int(rng.integers(5, 35)),
            algorithm=str(rng.choice(["sum-product", "min-sum"])),
            message_dtype=str(rng.choice(["float32", "bfloat16", "int8"])),
        )
        plain_and_continuation(
            wf_code, fold_in(prng_key(99), trial),
            float(rng.choice([0.02, 0.05, 0.075])), trials,
            int(rng.integers(4, 24)), opts, segment=int(rng.integers(1, 7)),
            refill_frac=float(rng.uniform(0.1, 0.9)), tick=ticks.append)
        assert ticks[-1] == trials


@pytest.mark.parametrize("kw,qbers,trials,batch,segment", [
    (dict(), [0.07, 0.075, 0.078], 50, 16, 3),
    (dict(message_dtype="bfloat16", algorithm="min-sum"), [0.06, 0.075], 30, 4, 2),
    (dict(max_iterations=12), [0.02, 0.05, 0.07, 0.078], 9, 20, 5),
], ids=["three-points", "min-sum-bf16", "fewer-trials-than-lanes"])
def test_cross_point_sweep_matches_plain(wf_code, kw, qbers, trials, batch, segment):
    """Several waterfall points as ONE continuation (drained lanes of point p
    host point p+1's trials): every point's partials equal the plain
    runner's bit for bit, from one shared fetch."""
    opts = DecodeOptions(**{"max_iterations": 30, **kw})
    keys = [fold_in(prng_key(777), i) for i in range(len(qbers))]
    futs, actuals = dispatch_sweep_continuation(
        wf_code, keys, qbers, trials=trials, batch=batch, opts=opts,
        segment=segment, device="cpu")
    assert len(futs) == len(qbers)
    for key, qber, fut, aq in zip(keys, qbers, futs, actuals):
        p_ref, q_ref = run_point(wf_code, key, qber, trials=trials, batch=trials,
                                 opts=opts, device="cpu")
        stacked = fut[0].fetch()
        assert stacked.shape == (7,) and stacked.dtype == torch.int32
        p = PointPartials().merge(partials_from_stacked(stacked))
        assert aq == q_ref
        assert dataclasses.astuple(p) == dataclasses.astuple(p_ref)
        assert p.n_trials == trials


@pytest.mark.parametrize("name,kw,qber", [
    ("min-sum", dict(algorithm="min-sum"), 0.075),
    ("min-sum-bf16", dict(algorithm="min-sum", message_dtype="bfloat16"), 0.06),
    # sum-product: a point where the two packages' plain runners agree
    ("sum-product", dict(), 0.075),
], ids=["min-sum", "min-sum-bf16", "sum-product"])
def test_continuation_partials_equal_jax(wf_code, name, kw, qber):
    jc = jcodes.make_code(**WF)
    pj, qj = j_run_point_continuation(
        jc, jax.random.fold_in(jax.random.PRNGKey(777), 5), qber, trials=70,
        batch=16, opts=JaxDecodeOptions(max_iterations=30, **kw), segment=3)
    pt, qt = run_point_continuation(
        wf_code, fold_in(prng_key(777), 5), qber, trials=70, batch=16,
        opts=DecodeOptions(max_iterations=30, **kw), segment=3, device="cpu")
    assert qj == qt
    assert dataclasses.astuple(pj) == dataclasses.astuple(pt)
    assert pt.n_trials == 70 and 0 < pt.n_sp
