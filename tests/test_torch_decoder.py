"""Port vs JAX package: the flooding BP decoder (``decoder/bp.py``).

Min-sum has no transcendentals and every storage rounding point is pinned,
so bits, iteration counts and convergence flags must equal the JAX
package's exactly for float32, bfloat16 and int8 storage.  Sum-product is
matched on decisions and iteration counts on these fixed inputs.  ``tanh``
and ``log1p`` differ by ulps between PyTorch and XLA:CPU, and near
saturation an ulp decides between a message of about 16.6 (the largest
finite ``2 atanh(x)`` in float32) and +-inf clipped to the threshold, so a
frame can converge one iteration earlier or later.  Every such frame is
listed where it occurs (``plus_minus_one``) and asserted to differ by
exactly one iteration with the same decoded key; all others are exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qkd_ldpc_tpu.decoder import bp as jbp
from qkd_ldpc_tpu.decoder.reconcile import apriori_llr as j_apriori_llr
from qkd_ldpc_tpu.decoder.syndrome import syndrome as j_syndrome
from qkd_ldpc_tpu_torch.decoder import bp as tbp
from qkd_ldpc_tpu_torch.decoder.reconcile import apriori_llr, reconcile
from qkd_ldpc_tpu_torch.decoder.syndrome import syndrome

from tests._torch_port_common import code_pair, make_frames

torch.set_num_threads(1)

DTYPES = ["float32", "bfloat16", "int8"]
N_ERR = {"irregular": 10, "qc": 15}  # QBER ~0.039 on both codes


def decode_inputs(which, batch, n_err, seed):
    """numpy (alice, bob, llr, syndrome) with both packages' LLRs and
    syndromes asserted equal on the way."""
    jc, tc = code_pair(which)
    alice, bob = make_frames(jc.n_vars, batch, n_err, seed)
    q = n_err / jc.n_vars
    llr_j = np.asarray(j_apriori_llr(jnp.asarray(bob), q))
    llr_t = apriori_llr(torch.from_numpy(bob), q).numpy()
    np.testing.assert_array_equal(llr_j, llr_t)
    syn_j = np.asarray(j_syndrome(jc, jnp.asarray(alice)))
    syn_t = syndrome(tc, torch.from_numpy(alice)).numpy()
    np.testing.assert_array_equal(syn_j, syn_t)
    return alice, bob, llr_t, syn_t


def both_decode(which, llr, syn, **kw):
    jc, tc = code_pair(which)
    rj = jbp.decode(jc, jnp.asarray(llr), jnp.asarray(syn), jbp.DecodeOptions(**kw))
    rt = tbp.decode(tc, llr, syn, tbp.DecodeOptions(**kw), device="cpu")
    return rj, rt


def assert_same_result(rj, rt):
    np.testing.assert_array_equal(np.asarray(rj.bits), rt.bits.numpy())
    np.testing.assert_array_equal(np.asarray(rj.iterations), rt.iterations.numpy())
    np.testing.assert_array_equal(
        np.asarray(rj.syndromes_match), rt.syndromes_match.numpy()
    )
    assert rt.bits.dtype == torch.int8 and rt.iterations.dtype == torch.int32


def assert_same_decisions(rj, rt, plus_minus_one=()):
    """Sum-product criterion: equal keys and flags; iteration counts equal
    except in the listed frames, which differ by exactly one."""
    np.testing.assert_array_equal(np.asarray(rj.bits), rt.bits.numpy())
    np.testing.assert_array_equal(
        np.asarray(rj.syndromes_match), rt.syndromes_match.numpy()
    )
    diff = np.asarray(rj.iterations) - rt.iterations.numpy()
    assert sorted(np.flatnonzero(diff)) == sorted(plus_minus_one), diff
    assert (np.abs(diff) <= 1).all(), diff


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("which", ["irregular", "qc"])
def test_min_sum_decode_exact(which, dtype):
    _, _, llr, syn = decode_inputs(which, 12, N_ERR[which], seed=21)
    rj, rt = both_decode(which, llr, syn, algorithm="min-sum",
                         message_dtype=dtype, max_iterations=30)
    assert_same_result(rj, rt)
    assert rt.syndromes_match.any() and int(rt.iterations.max()) > 1


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("which", ["irregular", "qc"])
def test_sum_product_decode_decisions_and_iterations(which, dtype):
    alice, _, llr, syn = decode_inputs(which, 12, N_ERR[which], seed=22)
    rj, rt = both_decode(which, llr, syn, message_dtype=dtype, max_iterations=30)
    assert_same_result(rj, rt)
    ok = rt.syndromes_match.numpy()
    np.testing.assert_array_equal(rt.bits.numpy()[ok], alice[ok].astype(np.int8))


def test_offset_min_sum_and_no_clip_exact():
    _, _, llr, syn = decode_inputs("irregular", 8, 10, seed=23)
    rj, rt = both_decode("irregular", llr, syn, algorithm="min-sum",
                         min_sum_alpha=1.0, min_sum_beta=0.4, max_iterations=30)
    assert_same_result(rj, rt)
    rj, rt = both_decode("irregular", llr, syn, algorithm="min-sum",
                         clip_messages=False, message_threshold=2.5,
                         max_iterations=30)
    assert_same_result(rj, rt)
    rj, rt = both_decode("irregular", llr, syn, algorithm="min-sum",
                         message_threshold=2.5, max_iterations=30)
    assert_same_result(rj, rt)


@pytest.mark.parametrize("algorithm", ["min-sum", "sum-product"])
def test_decode_equals_jax_pallas_backend(algorithm):
    """The JAX decoder through its Pallas kernels (interpret mode off the
    TPU, as the JAX package's own tests run it) == the port's plain path."""
    _, _, llr, syn = decode_inputs("irregular", 4, 8, seed=24)
    jc, tc = code_pair("irregular")
    kw = dict(algorithm=algorithm, message_dtype="bfloat16", max_iterations=20)
    rj = jbp.decode(jc, jnp.asarray(llr), jnp.asarray(syn),
                    jbp.DecodeOptions(backend="pallas", **kw))
    rt = tbp.decode(tc, llr, syn, tbp.DecodeOptions(backend="auto", **kw),
                    device="cpu")
    if algorithm == "min-sum":
        assert_same_result(rj, rt)
    else:
        # Frame 3: JAX (Pallas and XLA alike) converges at iteration 7, the
        # port at 6; the trajectories part at iteration 4, where a
        # leave-one-out product rounds to 1 in one package and not the other.
        assert_same_decisions(rj, rt, plus_minus_one=[3])


# Each schedule's compaction cases: (code, frames, seed base, max_iterations,
# [(n_err, compact_after, compact_lanes)]).  The last case of each leaves more
# unconverged lanes than compact_lanes at compact_after (the overflow
# fallback, phase C); on the flooding code 5 errors converge inside phase A
# and 13 run the intended phase-B schedule.
COMPACTION = {
    "flooding": ("irregular", 32, 100, 40, [(5, 4, 8), (13, 4, 8), (23, 3, 4)]),
    "layered": ("qc", 24, 200, 30, [(8, 3, 6), (19, 3, 8), (24, 2, 4)]),
}


@pytest.mark.parametrize("schedule", sorted(COMPACTION))
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("algorithm", ["sum-product", "min-sum"])
def test_compaction_bit_identical(algorithm, dtype, schedule):
    """Residency compaction (``device_loop.run_schedule``, one for both
    schedules) is a schedule change only: phase-A lanes, compacted phase-B
    lanes and overflow lanes of the full-batch fallback (phase C) all equal
    the plain loop, port against port, as in the JAX package's own tests."""
    which, B, seed, max_it, cases = COMPACTION[schedule]
    _, tc = code_pair(which)
    for n_err, k1, b2 in cases:
        alice, bob = make_frames(tc.n_vars, B, n_err, seed=seed + n_err)
        llr = apriori_llr(torch.from_numpy(bob), n_err / tc.n_vars)
        syn = syndrome(tc, torch.from_numpy(alice))
        base = dict(max_iterations=max_it, algorithm=algorithm, message_dtype=dtype,
                    schedule=schedule)
        plain = tbp.decode(tc, llr, syn, tbp.DecodeOptions(**base), device="cpu")
        comp = tbp.decode(
            tc, llr, syn,
            tbp.DecodeOptions(**base, compact_after=k1, compact_lanes=b2),
            device="cpu",
        )
        assert torch.equal(plain.bits, comp.bits), (algorithm, dtype, n_err)
        assert torch.equal(plain.iterations, comp.iterations)
        assert torch.equal(plain.syndromes_match, comp.syndromes_match)
        if (n_err, k1, b2) == cases[-1]:  # more unconverged lanes than compact_lanes at k1
            assert int((plain.iterations > k1).sum()) > b2


def test_compaction_with_overflow_equals_jax():
    _, _, llr, syn = decode_inputs("irregular", 16, 22, seed=25)
    rj, rt = both_decode("irregular", llr, syn, algorithm="min-sum",
                         message_dtype="bfloat16", max_iterations=25,
                         compact_after=3, compact_lanes=4)
    assert_same_result(rj, rt)
    assert int((rt.iterations > 3).sum()) > 4


SCHEDULES = {
    # (n_err, compact_after, compact_lanes) on the irregular code, 16 frames
    "plain-loop": (13, 0, 0),
    "phase-b": (13, 4, 8),  # the unconverged minority fits the compacted lanes
    "phase-c-overflow": (22, 3, 4),  # more unconverged lanes than compact_lanes
}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
def test_two_kernel_loop_equals_jax_per_lane(schedule, dtype):
    """The port's loop runs variable update then check update and takes the
    syndrome flag from the check update; the JAX loop runs check update then
    ``after_check``.  Per lane the decisions, iteration counts and flags are
    the JAX decoder's, through compaction and the frozen-lane fallback."""
    n_err, k1, b2 = SCHEDULES[schedule]
    _, _, llr, syn = decode_inputs("irregular", 16, n_err, seed=30)
    rj, rt = both_decode("irregular", llr, syn, algorithm="min-sum",
                         message_dtype=dtype, max_iterations=25,
                         compact_after=k1, compact_lanes=b2)
    assert_same_result(rj, rt)
    assert rt.syndromes_match.any() and int(rt.iterations.max()) > max(k1, 1)
    if schedule == "phase-c-overflow":
        assert int((rt.iterations > k1).sum()) > b2


def test_decode_loop_carries_no_gathered_totals(monkeypatch):
    """One iteration is one variable update and one check update on
    ``total [N, B]``; the loop makes no ``[dc, M, B]`` copy of the totals
    and launches the check update once per iteration run."""
    _, tc = code_pair("irregular")
    _, _, llr, syn = decode_inputs("irregular", 8, 10, seed=21)
    shapes, updates = [], []
    real_c = tbp._DecodeCore.check_update_fused
    real_v = tbp._DecodeCore.variable_update

    def spy_c(self, total, Lr, syn_, **kw):
        shapes.append(tuple(total.shape))
        return real_c(self, total, Lr, syn_, **kw)

    def spy_v(self, Lr, llr_, z, count, active, **kw):
        updates.append(int(active.sum()))
        return real_v(self, Lr, llr_, z, count, active, **kw)

    monkeypatch.setattr(tbp._DecodeCore, "check_update_fused", spy_c)
    monkeypatch.setattr(tbp._DecodeCore, "variable_update", spy_v)
    res = tbp.decode(tc, llr, syn, tbp.DecodeOptions(algorithm="min-sum",
                                                     max_iterations=30), device="cpu")
    worst = int(res.iterations.max())
    assert shapes == [(tc.n_vars, 8)] * worst and len(updates) == worst
    assert updates[0] == 8 and sum(updates) == int(res.iterations.sum())


def test_waterfall_failed_frames_report_max_iterations():
    """Far above the code's threshold nothing converges: failed frames
    report iterations == max_iterations, in both packages."""
    _, _, llr, syn = decode_inputs("irregular", 8, 36, seed=26)
    rj, rt = both_decode("irregular", llr, syn, algorithm="min-sum",
                         max_iterations=12)
    assert_same_result(rj, rt)
    failed = ~rt.syndromes_match
    assert failed.any()
    assert (rt.iterations[failed] == 12).all()


def test_single_frame_and_reconcile_keys_match():
    _, tc = code_pair("qc")
    alice, bob, llr, syn = decode_inputs("qc", 4, 12, seed=27)
    batch = tbp.decode(tc, llr, syn, tbp.DecodeOptions(max_iterations=30), device="cpu")
    one = tbp.decode(tc, llr[0], syn[0], tbp.DecodeOptions(max_iterations=30),
                     device="cpu")
    assert one.bits.shape == (tc.n_vars,) and one.iterations.ndim == 0
    assert torch.equal(one.bits, batch.bits[0])
    assert int(one.iterations) == int(batch.iterations[0])
    res = reconcile(tc, alice, bob, 12 / tc.n_vars,
                    tbp.DecodeOptions(max_iterations=30), device="cpu")
    assert torch.equal(res.bits, batch.bits)
    np.testing.assert_array_equal(
        res.keys_match.numpy(), (batch.bits.numpy() == alice).all(axis=1)
    )
    assert res.keys_match.all()


def test_zero_error_converges_first_iteration():
    _, tc = code_pair("irregular")
    alice, _ = make_frames(tc.n_vars, 4, 1, seed=28)
    res = reconcile(tc, alice, alice, 0.01, tbp.DecodeOptions(), device="cpu")
    assert res.syndromes_match.all() and res.keys_match.all()
    assert (res.iterations == 1).all()


BAD_OPTIONS = [
    dict(max_iterations=0), dict(max_iterations=-3), dict(algorithm="bp"),
    dict(message_dtype="float16"), dict(message_dtype="int8", int8_scale=0.0),
    dict(backend="cuda"), dict(routing="scatter"), dict(compact_after=4),
    dict(compact_lanes=8), dict(compact_after=-1, compact_lanes=8),
    dict(schedule="serial"),
]


@pytest.mark.parametrize("kw", BAD_OPTIONS, ids=lambda kw: ",".join(kw))
def test_decode_options_validation_matches_jax(kw):
    with pytest.raises(ValueError) as ej:
        jbp.DecodeOptions(**kw)
    with pytest.raises(ValueError) as et:
        tbp.DecodeOptions(**kw)
    assert str(ej.value) == str(et.value)


def test_decode_options_fields_and_defaults_match_jax():
    import dataclasses

    jf = [(f.name, f.default) for f in dataclasses.fields(jbp.DecodeOptions)]
    tf_ = [(f.name, f.default) for f in dataclasses.fields(tbp.DecodeOptions)]
    assert jf == tf_
    o = tbp.DecodeOptions()
    assert o.resolve_backend("cpu") == "xla"
    assert tbp.DecodeOptions(backend="xla").resolve_backend("cuda") == "xla"
    assert tbp.DecodeOptions(backend="auto").resolve_backend("cuda") == "pallas"
    with pytest.raises(ValueError, match="CUDA"):
        tbp.DecodeOptions(backend="pallas").resolve_backend("cpu")


def test_routing_names_and_layered_schedule():
    _, tq = code_pair("qc")
    _, ti = code_pair("irregular")
    _, _, llr, syn = decode_inputs("qc", 4, 12, seed=29)
    base = dict(algorithm="min-sum", max_iterations=20)
    ref = tbp.decode(tq, llr, syn, tbp.DecodeOptions(**base), device="cpu")
    for routing in ("gather", "roll"):
        res = tbp.decode(tq, llr, syn, tbp.DecodeOptions(routing=routing, **base),
                         device="cpu")
        assert torch.equal(res.bits, ref.bits)
        assert torch.equal(res.iterations, ref.iterations)
    llr_i = np.zeros((2, ti.n_vars), np.float32) + 1.0
    syn_i = np.zeros((2, ti.n_checks), np.int8)
    with pytest.raises(ValueError, match="requires a QC code"):
        tbp.decode(ti, llr_i, syn_i, tbp.DecodeOptions(routing="roll"), device="cpu")
    # schedule="layered" is a decode of its own (another trajectory family):
    # same keys here, in fewer sweeps than flooding takes iterations.
    lay = tbp.decode(tq, llr, syn, tbp.DecodeOptions(schedule="layered", **base),
                     device="cpu")
    assert lay.syndromes_match.all() and torch.equal(lay.bits, ref.bits)
    assert int(lay.iterations.sum()) < int(ref.iterations.sum())
    with pytest.raises(ValueError, match="float32"):
        tbp.decode(tq, llr.astype(np.float64), syn, tbp.DecodeOptions(), device="cpu")
