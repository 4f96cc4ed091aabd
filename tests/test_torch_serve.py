"""Port vs JAX package: the serving endpoint ``Reconciler`` (Bob's side of
the protocol; Alice's syndromes and tags) on plain and rate-adapted
endpoints, its validation texts, and the secure chain.  Both interop
directions: a JAX Alice with a PyTorch Bob and the reverse."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qkd_ldpc_tpu import codes as jcodes
from qkd_ldpc_tpu import postprocess as jpp
from qkd_ldpc_tpu.channel import keys as jkeys
from qkd_ldpc_tpu.decoder import DecodeOptions as JOpts
from qkd_ldpc_tpu.decoder.rate_adapt import RateAdapter as JAdapter
from qkd_ldpc_tpu.serve import Reconciler as JReconciler
from qkd_ldpc_tpu_torch import Reconciler, privacy_amplify
from qkd_ldpc_tpu_torch import codes as tcodes
from qkd_ldpc_tpu_torch.decoder import DecodeOptions as TOpts
from qkd_ldpc_tpu_torch.decoder import RateAdapter

from tests._torch_port_common import tkey

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def medium():
    kw = dict(n=512, m=262, dv=3, seed=7, name="n512")
    return jcodes.make_code(**kw), tcodes.make_code(**kw)


def _trials(n_vars, qber, n, seed=7):
    n_err = jkeys.num_errors_for(n_vars, qber)
    alice, bob = jkeys.make_trial_batch(jax.random.PRNGKey(seed), n_vars, n,
                                        jnp.asarray(n_err, jnp.int32))
    return np.asarray(alice), np.asarray(bob), n_err / n_vars


@pytest.mark.parametrize("algorithm", ["sum-product", "min-sum"])
def test_reconciler_equals_jax_across_chunks(medium, algorithm):
    """20 frames through 8 lanes (three chunks, the last padded): syndromes
    and results equal the JAX endpoint's; 5 lanes (no vector width divides
    it) give the same results."""
    jc, tc = medium
    kw = dict(max_iterations=60, algorithm=algorithm)
    alice, bob, q = _trials(jc.n_vars, 0.03, 20)
    jrec = JReconciler(jc, JOpts(**kw), lanes=8)
    trec = Reconciler(tc, TOpts(**kw), lanes=8, device="cpu")
    syn = trec.syndromes(alice)
    np.testing.assert_array_equal(syn, jrec.syndromes(alice))
    want = jrec.reconcile(bob, syn, qber=q)
    for lanes in (8, 5):
        got = Reconciler(tc, TOpts(**kw), lanes=lanes, device="cpu").reconcile(
            bob, syn, qber=q)
        for f in want._fields:
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
    assert want.syndromes_match.all()
    np.testing.assert_array_equal(got.bits, alice)


def test_padding_independence_and_failure_flags(medium):
    """A frame decodes identically alone or in a padded chunk; deep-waterfall
    frames come back unverified at the iteration cap."""
    _, tc = medium
    rec = Reconciler(tc, TOpts(max_iterations=60), lanes=16, device="cpu")
    alice, bob, q = _trials(tc.n_vars, 0.03, 5, seed=3)
    syn = rec.syndromes(alice)
    all_out = rec.reconcile(bob, syn, qber=q)
    one = rec.reconcile(bob[2], syn[2], qber=q)
    np.testing.assert_array_equal(one.bits, all_out.bits[2])
    assert int(one.iterations) == int(all_out.iterations[2])
    small = Reconciler(tc, TOpts(max_iterations=60), lanes=4, device="cpu").reconcile(
        bob, syn, q)
    np.testing.assert_array_equal(small.bits, all_out.bits)
    np.testing.assert_array_equal(small.iterations, all_out.iterations)

    rec15 = Reconciler(tc, TOpts(max_iterations=15), lanes=8, device="cpu")
    alice, bob, q = _trials(tc.n_vars, 0.12, 8, seed=1)
    out = rec15.reconcile(bob, rec15.syndromes(alice), qber=q)
    assert not out.syndromes_match.all()
    assert (out.iterations[~out.syndromes_match] == 15).all()


def _message(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


@pytest.mark.parametrize("call", ["short-frames", "syndromes-shape", "qber",
                                  "alice-short-frames", "lanes", "tags-shape"])
def test_validation_messages_equal_jax(medium, call):
    jc, tc = medium
    good = np.zeros((2, jc.n_vars), np.uint8)
    syn = np.zeros((2, jc.n_checks), np.uint8)
    calls = {
        "short-frames": lambda rec, R, key: rec.reconcile(good[:, :-1], syn, qber=0.03),
        "syndromes-shape": lambda rec, R, key: rec.reconcile(good, syn[:1], qber=0.03),
        "qber": lambda rec, R, key: rec.reconcile(good, syn, qber=0.0),
        "alice-short-frames": lambda rec, R, key: rec.syndromes(good[:, :-1]),
        "lanes": lambda rec, R, key: R(lanes=0),
        "tags-shape": lambda rec, R, key: rec.reconcile_secure(
            good, syn, 0.03, np.zeros((2, 8), np.uint8), key, key),
    }
    want = _message(lambda: calls[call](JReconciler(jc), lambda **k: JReconciler(jc, **k),
                                        jax.random.PRNGKey(0)))
    got = _message(lambda: calls[call](
        Reconciler(tc, device="cpu"), lambda **k: Reconciler(tc, device="cpu", **k),
        tkey(jax.random.PRNGKey(0))))
    assert got == want
    assert Reconciler(tc, device="cpu").leak_bits == tc.n_checks


def test_adapter_binds_by_fingerprint_with_the_jax_text(medium):
    jc, tc = medium
    kw = dict(n=jc.n_vars, m=jc.n_checks, dv=3, seed=1234)
    j_other, t_other = jcodes.make_code(**kw), tcodes.make_code(**kw)
    assert t_other.fingerprint == j_other.fingerprint != tc.fingerprint
    want = _message(lambda: JReconciler(jc, adapter=JAdapter.make(j_other, n_shortened=16)))
    got = _message(lambda: Reconciler(tc, adapter=RateAdapter.make(t_other, n_shortened=16),
                                      device="cpu"))
    assert got == want and "fingerprint" in got
    # an equal-content copy (e.g. loaded from disk) is accepted
    copy = dataclasses.replace(tc)
    Reconciler(tc, adapter=RateAdapter.make(copy, n_shortened=16), device="cpu")


@pytest.mark.parametrize("p,s", [(0, 128), (64, 0)], ids=["shortened", "punctured"])
def test_adapted_endpoint_equals_jax(medium, p, s):
    """Payload-bit requests on a rate-adapted endpoint: syndromes (with
    Alice's private punctured bits from ``frame_key``) and results equal the
    JAX endpoint's, and the corrected payloads are Alice's."""
    jc, tc = medium
    kw = dict(max_iterations=60, algorithm="min-sum")
    jad = JAdapter.make(jc, n_punctured=p, n_shortened=s, seed=2)
    tad = RateAdapter.make(tc, n_punctured=p, n_shortened=s, seed=2)
    jrec = JReconciler(jc, JOpts(**kw), lanes=8, adapter=jad)
    trec = Reconciler(tc, TOpts(**kw), lanes=8, adapter=tad, device="cpu")
    assert trec.frame_bits == jrec.frame_bits and trec.leak_bits == jrec.leak_bits
    l = tad.payload_bits
    kk = jax.random.PRNGKey(5)
    alice = np.asarray(jkeys.generate_random_bits(kk, l, 10))
    n_err = jkeys.num_errors_for(l, 0.07 if s else 0.02)
    bob = np.asarray(jkeys.introduce_errors(jax.random.fold_in(kk, 1), alice, n_err))
    fk = jax.random.PRNGKey(1)
    syn = trec.syndromes(alice, frame_key=tkey(fk))
    np.testing.assert_array_equal(syn, jrec.syndromes(alice, frame_key=fk))
    want = jrec.reconcile(bob, syn, qber=n_err / l)
    got = trec.reconcile(bob, syn, qber=n_err / l)
    for f in want._fields:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
    assert got.syndromes_match.all()
    np.testing.assert_array_equal(got.bits, alice)
    if p:
        with pytest.raises(ValueError, match="frame_key"):
            trec.syndromes(alice)


def test_reconcile_secure_equals_jax(medium):
    """reconcile -> tags -> amplification in one call: the same verified
    flags, ledger and amplified keys as the JAX endpoint; a tampered tag
    fails its frame."""
    jc, tc = medium
    kw = dict(max_iterations=60)
    jrec = JReconciler(jc, JOpts(**kw), lanes=8)
    trec = Reconciler(tc, TOpts(**kw), lanes=8, device="cpu")
    alice, bob, q = _trials(jc.n_vars, 0.03, 10)
    syn = trec.syndromes(alice)
    tag_key, pa_key = jax.random.PRNGKey(11), jax.random.PRNGKey(12)
    a_tags = trec.tags(alice, tkey(tag_key))
    np.testing.assert_array_equal(a_tags, jrec.tags(alice, tag_key))
    a_tags[3, 0] ^= 1
    want = jrec.reconcile_secure(bob, syn, q, a_tags, tag_key, pa_key)
    got = trec.reconcile_secure(bob, syn, q, a_tags, tkey(tag_key), tkey(pa_key))
    for f in want._fields:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
    assert got.final_bits == trec.final_key_bits() > 0
    assert not got.verified[3] and got.verified[[0, 1, 2, 4]].all()
    np.testing.assert_array_equal(got.leak_bits, tc.n_checks + 64)
    one = trec.reconcile_secure(bob[0], syn[0], q, a_tags[0], tkey(tag_key), tkey(pa_key))
    assert one.verified and one.key.shape == (got.final_bits,)
    np.testing.assert_array_equal(one.key, got.key[0])


@pytest.mark.parametrize("direction", ["jax-alice", "torch-alice"])
def test_secure_chain_interop(medium, direction):
    """Alice on one package, Bob on the other: syndromes, tags and the
    amplified key agree — Bob's verified key equals Alice's amplification of
    her own key."""
    jc, tc = medium
    kw = dict(max_iterations=60)
    alice, bob, q = _trials(jc.n_vars, 0.03, 6, seed=13)
    tag_key, pa_key = jax.random.PRNGKey(21), jax.random.PRNGKey(22)
    jrec = JReconciler(jc, JOpts(**kw), lanes=8)
    trec = Reconciler(tc, TOpts(**kw), lanes=8, device="cpu")
    if direction == "jax-alice":
        syn, a_tags = jrec.syndromes(alice), jrec.tags(alice, tag_key)
        sec = trec.reconcile_secure(bob, syn, q, a_tags, tkey(tag_key), tkey(pa_key))
        a_key = np.asarray(jpp.privacy_amplify(jnp.asarray(alice), pa_key, sec.final_bits))
    else:
        syn, a_tags = trec.syndromes(alice), trec.tags(alice, tkey(tag_key))
        sec = jrec.reconcile_secure(bob, syn, q, a_tags, tag_key, pa_key)
        a_key = privacy_amplify(alice, tkey(pa_key), sec.final_bits, device="cpu").numpy()
    assert np.asarray(sec.verified).all()
    np.testing.assert_array_equal(np.asarray(sec.key), a_key)


def test_reconcile_secure_on_adapted_endpoint():
    """The chain composes with rate adaptation: tags and amplification over
    PAYLOAD bits, the ledger follows the adapter, keys equal JAX's."""
    kw = dict(n=2048, m=1046, dv=3, seed=5)
    jc, tc = jcodes.make_code(**kw), tcodes.make_code(**kw)
    jad = JAdapter.make(jc, n_shortened=96, seed=2)
    tad = RateAdapter.make(tc, n_shortened=96, seed=2)
    opts = dict(max_iterations=60, algorithm="min-sum")
    jrec = JReconciler(jc, JOpts(**opts), lanes=8, adapter=jad)
    trec = Reconciler(tc, TOpts(**opts), lanes=8, adapter=tad, device="cpu")
    l = tad.payload_bits
    kk = jax.random.PRNGKey(6)
    alice = np.asarray(jkeys.generate_random_bits(kk, l, 6))
    n_err = jkeys.num_errors_for(l, 0.05)
    bob = np.asarray(jkeys.introduce_errors(jax.random.fold_in(kk, 1), alice, n_err))
    tk, pk = jax.random.PRNGKey(8), jax.random.PRNGKey(9)
    syn = trec.syndromes(alice)
    a_tags = trec.tags(alice, tkey(tk))
    got = trec.reconcile_secure(bob, syn, n_err / l, a_tags, tkey(tk), tkey(pk))
    want = jrec.reconcile_secure(bob, syn, n_err / l, a_tags, tk, pk)
    for f in want._fields:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
    assert got.verified.all()
    np.testing.assert_array_equal(got.leak_bits, np.full(6, tad.leak_bits + 64))
    np.testing.assert_array_equal(
        got.key, privacy_amplify(alice, tkey(pk), got.final_bits, device="cpu").numpy())


@pytest.mark.parametrize("name,expect", [
    ("qkd_ldpc_example", "Device decoder (cpu): Alice's key in 1 iteration(s)."),
    ("rate_adaptive_example", "8/8 frames corrected via Reconciler"),
    ("secure_chain_example", "Alice's and Bob's amplified keys are IDENTICAL"),
])
def test_example_programs_run_on_the_host(name, expect, capsys):
    """The three example programs of the port (``python -m
    qkd_ldpc_tpu_torch.examples.<name>``), here with ``--device cpu``."""
    import importlib

    importlib.import_module(f"qkd_ldpc_tpu_torch.examples.{name}").main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert expect in out
    if name == "rate_adaptive_example":
        assert "shortened s=512" in out and "blind (d=256 punctured" in out


def test_inflight_window_default_is_the_jax_endpoints(medium):
    jc, tc = medium
    assert Reconciler(tc, device="cpu").max_inflight_chunks == 4
    assert JReconciler(jc).max_inflight_chunks == 4


@pytest.mark.parametrize("window", [1, 2, 4])
@pytest.mark.parametrize("n_frames", [24, 21], ids=["whole-chunks", "ragged"])
def test_inflight_window_keeps_the_results(medium, window, n_frames):
    """A window of 1, 2 or 4 chunks in flight, on a request that ``lanes``
    divides and on one it does not: every frame equals the JAX endpoint's."""
    jc, tc = medium
    kw = dict(max_iterations=60, algorithm="min-sum")
    alice, bob, q = _trials(jc.n_vars, 0.04, n_frames, seed=9)
    jrec = JReconciler(jc, JOpts(**kw), lanes=4)
    trec = Reconciler(tc, TOpts(**kw), lanes=4, device="cpu")
    trec.max_inflight_chunks = window
    syn = trec.syndromes(alice)
    want = jrec.reconcile(bob, syn, qber=q)
    got = trec.reconcile(bob, syn, qber=q)
    for f in want._fields:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)


@pytest.mark.parametrize("window", [1, 3])
def test_inflight_window_on_the_adapted_endpoint(medium, window):
    jc, tc = medium
    kw = dict(max_iterations=60, algorithm="min-sum")
    jad = JAdapter.make(jc, n_punctured=32, n_shortened=64, seed=4)
    tad = RateAdapter.make(tc, n_punctured=32, n_shortened=64, seed=4)
    jrec = JReconciler(jc, JOpts(**kw), lanes=4, adapter=jad)
    trec = Reconciler(tc, TOpts(**kw), lanes=4, adapter=tad, device="cpu")
    trec.max_inflight_chunks = window
    kk = jax.random.PRNGKey(8)
    alice = np.asarray(jkeys.generate_random_bits(kk, tad.payload_bits, 11))
    n_err = jkeys.num_errors_for(tad.payload_bits, 0.03)
    bob = np.asarray(jkeys.introduce_errors(jax.random.fold_in(kk, 1), alice, n_err))
    fk = jax.random.PRNGKey(2)
    syn = trec.syndromes(alice, frame_key=tkey(fk))
    want = jrec.reconcile(bob, syn, qber=n_err / tad.payload_bits)
    got = trec.reconcile(bob, syn, qber=n_err / tad.payload_bits)
    for f in want._fields:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)


def test_inflight_window_must_be_positive(medium):
    _, tc = medium
    trec = Reconciler(tc, device="cpu")
    trec.max_inflight_chunks = 0
    with pytest.raises(ValueError, match="max_inflight_chunks"):
        trec.reconcile(np.zeros((2, tc.n_vars), np.uint8),
                       np.zeros((2, tc.n_checks), np.int8), qber=0.02)
