"""Port vs JAX package: the slice as a whole — ``run_point`` and its parts.

The Monte-Carlo trial step (keygen -> exact-weight channel -> LLRs and
syndrome -> BP decode -> keys_match -> seven int32 partial sums) must give
the JAX package's partials 7/7: exactly for min-sum, and on these fixed
seeds for sum-product.
"""

import dataclasses
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qkd_ldpc_tpu import codes as jcodes
from qkd_ldpc_tpu.decoder import bp as jbp
from qkd_ldpc_tpu.decoder.reconcile import apriori_llr as j_apriori_llr
from qkd_ldpc_tpu.decoder.reconcile import reconcile as j_reconcile
from qkd_ldpc_tpu.sim import stats as jstats
from qkd_ldpc_tpu.sim.runner import run_point as j_run_point
from qkd_ldpc_tpu_torch import codes as tcodes
from qkd_ldpc_tpu_torch.channel.keys import make_trial_batch
from qkd_ldpc_tpu_torch.channel.threefry import fold_in, prng_key
from qkd_ldpc_tpu_torch.decoder import bp as tbp
from qkd_ldpc_tpu_torch.decoder.reconcile import apriori_llr, reconcile
from qkd_ldpc_tpu_torch.sim import stats as tstats
from qkd_ldpc_tpu_torch.sim.runner import run_point

from tests._torch_port_common import code_pair, make_frames

torch.set_num_threads(1)


def as_tuple(p):
    return dataclasses.astuple(p)


@pytest.fixture(scope="module")
def dryrun_codes():
    kw = dict(n=256, m=131, dv=3, seed=1, name="dryrun-n256")
    return jcodes.make_code(**kw), tcodes.make_code(**kw)


OPTION_SETS = {
    "sum-product-f32": dict(max_iterations=32),
    "min-sum-f32": dict(max_iterations=32, algorithm="min-sum"),
    "min-sum-bf16": dict(max_iterations=32, algorithm="min-sum",
                         message_dtype="bfloat16"),
    "min-sum-int8": dict(max_iterations=32, algorithm="min-sum",
                         message_dtype="int8"),
    "sum-product-bf16-compact": dict(max_iterations=32, message_dtype="bfloat16",
                                     compact_after=3, compact_lanes=4),
}


@pytest.mark.parametrize("name", sorted(OPTION_SETS))
def test_run_point_partials_equal_jax_dryrun_code(dryrun_codes, name):
    """The dry-run-size code and point of the JAX package's entry script,
    with a tail batch (20 trials in batches of 8)."""
    jc, tc = dryrun_codes
    kw = OPTION_SETS[name]
    pj, qj = j_run_point(jc, jax.random.PRNGKey(777), 0.03, trials=20, batch=8,
                         opts=jbp.DecodeOptions(**kw))
    pt, qt = run_point(tc, prng_key(777), 0.03, trials=20, batch=8,
                       opts=tbp.DecodeOptions(**kw), device="cpu")
    assert qj == qt
    assert as_tuple(pj) == as_tuple(pt)
    assert pt.n_trials == 20 and pt.n_sp > 0


@pytest.mark.parametrize("name", ["min-sum-bf16", "sum-product-bf16-compact"])
@pytest.mark.parametrize("prng", ["threefry", "pallas"])
def test_run_point_partials_equal_jax_qc_code(name, prng):
    """Min-sum at the waterfall point QBER 0.05 (failed frames included);
    sum-product at 0.04.  (At 0.05 trial 12 of this point wanders for more
    than 20 iterations and ulp differences decide its fate: the JAX package
    gives up at the cap of 32, the port converges at 23 — not a frame on
    which a sum-product match can be asked for.)"""
    jc, tc = code_pair("qc")
    kw = OPTION_SETS[name]
    qber = 0.05 if kw.get("algorithm") == "min-sum" else 0.04
    pj, qj = j_run_point(jc, jax.random.fold_in(jax.random.PRNGKey(777), 2), qber,
                         trials=16, batch=16, opts=jbp.DecodeOptions(**kw),
                         prng=prng)
    pt, qt = run_point(tc, fold_in(prng_key(777), 2), qber, trials=16, batch=16,
                       opts=tbp.DecodeOptions(**kw), prng=prng, device="cpu")
    assert qj == qt and as_tuple(pj) == as_tuple(pt)


def test_run_point_chunking_and_tick(dryrun_codes):
    """Chunks of one batch, several batches per chunk and one big batch see
    the same trials; tick reports the trial count."""
    _, tc = dryrun_codes
    opts = tbp.DecodeOptions(max_iterations=32, algorithm="min-sum")
    ticks = []
    base, _ = run_point(tc, prng_key(5), 0.04, trials=21, batch=21, opts=opts,
                        tick=ticks.append, device="cpu")
    assert ticks == [21]
    for batch, per_dispatch in [(8, 64), (8, 1), (4, 2)]:
        p, _ = run_point(tc, prng_key(5), 0.04, trials=21, batch=batch, opts=opts,
                         max_batches_per_dispatch=per_dispatch, device="cpu")
        assert as_tuple(p) == as_tuple(base), (batch, per_dispatch)


def test_run_point_guards(dryrun_codes):
    _, tc = dryrun_codes
    with pytest.raises(ValueError, match="too small for QBER"):
        run_point(tc, prng_key(1), 0.001, trials=4, batch=4,
                  opts=tbp.DecodeOptions(), device="cpu")
    with pytest.raises(ValueError, match="overflows the int32"):
        run_point(tc, prng_key(1), 0.03, trials=4, batch=2**20,
                  opts=tbp.DecodeOptions(max_iterations=100), device="cpu")


@pytest.mark.parametrize("n_err,n_bits", [(7, 256), (10, 256), (19, 384), (512, 10240)])
def test_apriori_llr_equals_jax(n_err, n_bits):
    """The a-priori LLR magnitude at the QBERs the tests and the flagship
    point use.  (XLA:CPU's log is one ulp off the correctly rounded value
    for about 3 % of ratios — e.g. 11/384 — so equality at every QBER is not
    attainable; the port uses the correctly rounded value.)"""
    bob = np.array([[0, 1, 1, 0]], np.uint8)
    q = np.float32(n_err) / np.float32(n_bits)
    want = np.asarray(j_apriori_llr(jnp.asarray(bob), q))
    got = apriori_llr(torch.from_numpy(bob), q)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(want, got.numpy())
    per_frame = apriori_llr(torch.from_numpy(np.repeat(bob, 2, 0)),
                            np.array([q, q], np.float32))
    np.testing.assert_array_equal(per_frame.numpy(), np.repeat(want, 2, 0))


def test_reconcile_equals_jax_including_keys_match():
    """A point past the waterfall edge: some frames fail, some converge —
    syndromes_match, keys_match, bits and iterations all equal."""
    jc, tc = code_pair("irregular")
    alice, bob = make_frames(jc.n_vars, 16, 19, seed=31)
    q = 19 / jc.n_vars
    kw = dict(algorithm="min-sum", message_dtype="bfloat16", max_iterations=15)
    rj = j_reconcile(jc, jnp.asarray(alice), jnp.asarray(bob), q, jbp.DecodeOptions(**kw))
    rt = reconcile(tc, alice, bob, q, tbp.DecodeOptions(**kw), device="cpu")
    for f in ("bits", "iterations", "syndromes_match", "keys_match"):
        np.testing.assert_array_equal(np.asarray(getattr(rj, f)), getattr(rt, f).numpy(), f)
    assert rt.syndromes_match.any() and not rt.syndromes_match.all()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_reduce_merge_finalize_equal_jax(seed):
    rng = np.random.default_rng(seed)
    B, cap = 24, 30
    sm = rng.random(B) < (0.0 if seed == 2 else 0.7)
    km = rng.random(B) < 0.8
    it = rng.integers(1, cap + 1, B).astype(np.int32)
    valid = np.arange(B) < 19
    rj = jstats.reduce_trials(jnp.asarray(sm), jnp.asarray(km), jnp.asarray(it),
                              cap, jnp.asarray(valid))
    rt = tstats.reduce_trials(torch.from_numpy(sm), torch.from_numpy(km),
                              torch.from_numpy(it), cap, torch.from_numpy(valid))
    assert tstats.STAT_KEYS == jstats.STAT_KEYS
    sj, st = np.asarray(jstats.stack_partials(rj)), tstats.stack_partials(rt)
    assert st.dtype == torch.int32
    np.testing.assert_array_equal(sj, st.numpy())
    pj, pt = jstats.partials_from_stacked(sj), tstats.partials_from_stacked(st)
    assert as_tuple(pj) == as_tuple(pt)
    other_j = jstats.PointPartials(5, 3, 2, 40.0, 600.0, 7, 21)
    other_t = tstats.PointPartials(5, 3, 2, 40.0, 600.0, 7, 21)
    mj, mt = pj.merge(other_j), pt.merge(other_t)
    assert as_tuple(mj) == as_tuple(mt)
    assert as_tuple(other_j.merge(pj)) == as_tuple(other_t.merge(pt))
    meta = dict(sim_number=3, matrix_filename="m.alist", is_regular=False,
                num_bit_nodes=256, num_check_nodes=131, initial_qber=0.03,
                max_iterations=cap)
    fj, ft = jstats.finalize_point(mj, **meta), tstats.finalize_point(mt, **meta)
    assert dataclasses.asdict(fj) == dataclasses.asdict(ft)
    assert fj.fer == ft.fer and fj.code_rate == ft.code_rate
    unmasked = tstats.reduce_trials(torch.from_numpy(sm), torch.from_numpy(km),
                                    torch.from_numpy(it), cap)
    assert int(unmasked["n_trials"]) == B


def test_import_leaves_jax_out():
    """Importing the port and every submodule of it pulls in neither jax nor
    the JAX package (checked in a fresh interpreter)."""
    prog = (
        "import importlib, pkgutil, sys\n"
        "import qkd_ldpc_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "assert len(names) >= 15, names\n"
        "protocol = {'serve', 'postprocess', 'decoder.rate_adapt', 'decoder.blind',\n"
        "            'examples.qkd_ldpc_example', 'examples.rate_adaptive_example',\n"
        "            'examples.secure_chain_example'}\n"
        "missing = {pkg.__name__ + '.' + n for n in protocol} - set(names)\n"
        "assert not missing, missing\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'jaxlib' or m == 'qkd_ldpc_tpu' or m.startswith('qkd_ldpc_tpu.')]\n"
        "assert not bad, bad\n"
        "print('clean', len(names))\n"
    )
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("clean")


def test_entry_points_default_to_the_card_and_raise_without_one(dryrun_codes):
    """device=None means cuda; on a machine without a GPU every entry point
    raises instead of carrying on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a CUDA device")
    _, tc = dryrun_codes
    alice, bob = make_frames(tc.n_vars, 2, 7, seed=1)
    opts = tbp.DecodeOptions(max_iterations=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_point(tc, prng_key(1), 0.03, trials=2, batch=2, opts=opts)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        reconcile(tc, alice, bob, 0.03, opts)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tbp.decode(tc, np.ones((2, tc.n_vars), np.float32),
                   np.zeros((2, tc.n_checks), np.int8), opts)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_trial_batch(prng_key(1), tc.n_vars, 2, 7)
    # the protocol surface
    from qkd_ldpc_tpu_torch import Reconciler, privacy_amplify
    from qkd_ldpc_tpu_torch.channel import generate_random_bits, introduce_errors
    from qkd_ldpc_tpu_torch.decoder import RateAdapter, blind_reconcile_sim
    from qkd_ldpc_tpu_torch.examples import rate_adaptive_example

    with pytest.raises(RuntimeError, match="no CUDA device"):
        Reconciler(tc, opts)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        generate_random_bits(prng_key(1), tc.n_vars, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        introduce_errors(prng_key(1), alice, 3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RateAdapter.make(tc, n_shortened=4).build_frames(alice[:, 4:], prng_key(2))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        blind_reconcile_sim(tc, alice[:, 8:], bob[:, 8:], n_punctured=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        privacy_amplify(alice, prng_key(3), 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rate_adaptive_example.main([])


# The JAX package's fixed-seed regression pins (tests/test_regression.py):
# exact (n_sp, n_ldpc, sum_it, sum_it2, min_it, max_it) for 8 trials with
# master seed 777 on the generated flagship-profile N=10240 code.
PINS = [
    (4, 0.03, (8, 8, 33, 137, 4, 5)),
    (6, 0.05, (8, 8, 50, 314, 6, 7)),
    (8, 0.07, (8, 8, 98, 1208, 11, 14)),
]


# builds the N=10240 code and decodes 8 trials on the CPU: a few seconds a case
@pytest.mark.parametrize("point,qber,expected", PINS)
def test_pinned_iteration_counts_through_the_port(point, qber, expected):
    code = tcodes.make_code(n=10240, m=5231, dv=3, seed=666, name="flagship-n10240")
    opts = tbp.DecodeOptions(max_iterations=100, clip_messages=True,
                             message_threshold=100.0)
    p, _ = run_point(code, fold_in(prng_key(777), point), qber, trials=8, batch=8,
                     opts=opts, device="cpu")
    got = (p.n_sp, p.n_ldpc, int(p.sum_it), int(p.sum_it2), p.min_it, p.max_it)
    assert got == expected
