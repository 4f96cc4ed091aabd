"""Port vs JAX package: blind reconciliation (all-punctured start, reveals
on failure, frozen verified frames) and its secure chain.

Per frame, rounds, leakage, keys and iterations equal the JAX package's:
exactly for min-sum, on decisions (keys, verification, rounds) and
iterations for sum-product."""

import jax
import numpy as np
import pytest
import torch

from qkd_ldpc_tpu import codes as jcodes
from qkd_ldpc_tpu import postprocess as jpp
from qkd_ldpc_tpu.channel import keys as jkeys
from qkd_ldpc_tpu.decoder import DecodeOptions as JOpts
from qkd_ldpc_tpu.decoder import blind as jblind
from qkd_ldpc_tpu.decoder.rate_adapt import RateAdapter as JAdapter
from qkd_ldpc_tpu_torch import codes as tcodes
from qkd_ldpc_tpu_torch.decoder import (
    BlindSession,
    RateAdapter,
    blind_reconcile,
    blind_reconcile_sim,
)
from qkd_ldpc_tpu_torch.decoder import DecodeOptions as TOpts

from tests._torch_port_common import tkey

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def mother():
    kw = dict(n=1024, m=523, dv=3, seed=3, name="mother-1024")
    return jcodes.make_code(**kw), tcodes.make_code(**kw)


def _keys(d, qbers, batch, seed, n=1024):
    """Alice's payloads and Bob's copies, frames split over ``qbers``."""
    l = n - d
    kk = jax.random.PRNGKey(seed)
    alice = jkeys.generate_random_bits(kk, l, batch)
    parts = np.array_split(np.arange(batch), len(qbers))
    bob = np.concatenate([
        np.asarray(jkeys.introduce_errors(jax.random.fold_in(kk, 1 + i), alice[idx],
                                          jkeys.num_errors_for(l, q)))
        for i, (idx, q) in enumerate(zip(parts, qbers))])
    return np.asarray(alice), bob


@pytest.mark.parametrize("algorithm", ["min-sum", "sum-product"])
@pytest.mark.parametrize("d,qbers,step", [(128, (0.02,), 32), (256, (0.02, 0.06), 64),
                                          (64, (0.14,), 32)],
                         ids=["round-zero", "reveals", "hopeless"])
def test_blind_sim_equals_jax(mother, algorithm, d, qbers, step):
    jc, tc = mother
    alice, bob = _keys(d, qbers, 6, seed=9)
    kw = dict(max_iterations=40, algorithm=algorithm)
    jres, jkm = jblind.blind_reconcile_sim(jc, alice, bob, n_punctured=d,
                                           qber_hint=0.06, opts=JOpts(**kw),
                                           reveal_step=step)
    tres, tkm = blind_reconcile_sim(tc, alice, bob, n_punctured=d, qber_hint=0.06,
                                    opts=TOpts(**kw), reveal_step=step, device="cpu")
    for f in jres._fields:
        np.testing.assert_array_equal(getattr(tres, f), np.asarray(getattr(jres, f)),
                                      err_msg=f)
    np.testing.assert_array_equal(tkm, np.asarray(jkm))
    if qbers == (0.14,):
        assert not tres.ok.any()  # never a silently wrong key
    else:
        assert tres.ok.all() and tkm.all()
    if len(qbers) > 1:
        assert (tres.rounds > 0).any() and (tres.rounds == 0).any()
        np.testing.assert_array_equal(
            tres.leak_bits, tc.n_checks - d + 2 * np.minimum(tres.rounds * step, d))


def test_session_reproduces_callback_loop_and_rejects_misuse(mother):
    _, tc = mother
    d = 256
    alice, bob = _keys(d, (0.06,), 4, seed=17)
    ad = RateAdapter.make(tc, n_punctured=d, seed=0)
    frames = ad.build_frames(alice, tkey(jax.random.PRNGKey(1)), device="cpu").numpy()
    syn = ad.syndromes(torch.from_numpy(frames)).numpy()
    opts = TOpts(max_iterations=60, algorithm="min-sum")
    ref = blind_reconcile(ad, bob, syn, lambda p: frames[:, p], qber_hint=0.06,
                          opts=opts, reveal_step=64, device="cpu")
    s = BlindSession(ad, bob, syn, qber_hint=0.06, opts=opts, reveal_step=64,
                     device="cpu")
    pos, n_messages = s.begin(), 0
    while pos is not None:
        n_messages += 1
        pos = s.provide(frames[:, pos])
    out = s.result()
    for f in out._fields:
        np.testing.assert_array_equal(getattr(out, f), getattr(ref, f), err_msg=f)
    assert n_messages == int(ref.rounds.max())
    with pytest.raises(RuntimeError):
        s.begin()
    with pytest.raises(RuntimeError):
        s.provide(frames[:, :1])
    s2 = BlindSession(ad, bob, syn, qber_hint=0.06, opts=opts, reveal_step=64,
                      device="cpu")
    with pytest.raises(RuntimeError):
        s2.result()


def test_validation_messages_equal_jax(mother):
    jc, tc = mother
    for blind, adapter, code, kw in (
            (jblind.blind_reconcile, JAdapter, jc, {}),
            (blind_reconcile, RateAdapter, tc, dict(device="cpu"))):
        ad_short = adapter.make(code, n_shortened=8)
        with pytest.raises(ValueError, match="all-punctured"):
            blind(ad_short, np.zeros((1, ad_short.payload_bits)),
                  np.zeros((1, code.n_checks)), lambda p: None, **kw)
        with pytest.raises(ValueError, match="budget"):
            blind(adapter.make(code), np.zeros((1, code.n_vars)),
                  np.zeros((1, code.n_checks)), lambda p: None, **kw)


def test_finalize_equals_jax(mother):
    """The secure chain on a finished session: tags, the per-frame ledger,
    ragged final lengths and the amplified keys equal the JAX package's, and
    equal Alice's amplification of her own payload on verified frames."""
    jc, tc = mother
    d = 256
    alice, bob = _keys(d, (0.02, 0.06), 6, seed=17)
    jad = JAdapter.make(jc, n_punctured=d, seed=0)
    tad = RateAdapter.make(tc, n_punctured=d, seed=0)
    fk = jax.random.PRNGKey(1)
    frames = np.asarray(jad.build_frames(alice, fk))
    syn = np.asarray(jad.syndromes(frames))
    kw = dict(max_iterations=60, algorithm="min-sum")
    tag_key, pa_key = jax.random.PRNGKey(100), jax.random.PRNGKey(200)
    a_tags = np.array(jpp.verification_tags(alice, tag_key, 64))
    a_tags[0, 3] ^= 1  # frame 0's tag is corrupted on the channel

    js = jblind.BlindSession(jad, bob, syn, qber_hint=0.06, opts=JOpts(**kw),
                             reveal_step=64)
    ts = BlindSession(tad, bob, syn, qber_hint=0.06, opts=TOpts(**kw), reveal_step=64,
                      device="cpu")
    for s in (js, ts):
        pos = s.begin()
        while pos is not None:
            pos = s.provide(frames[:, pos])
    want = js.finalize(a_tags, tag_key, pa_key)
    got = ts.finalize(a_tags, tkey(tag_key), tkey(pa_key))
    for f in want._fields:
        np.testing.assert_array_equal(getattr(got, f), np.asarray(getattr(want, f)),
                                      err_msg=f)
    assert not got.verified[0] and got.final_bits[0] == 0 and got.verified[1:].all()
    a_key = np.asarray(jpp.privacy_amplify(alice, pa_key, got.key.shape[1]))
    for i in np.flatnonzero(got.verified):
        n = got.final_bits[i]
        np.testing.assert_array_equal(got.key[i, :n], a_key[i, :n])
    with pytest.raises(ValueError, match="alice_tags"):
        ts.finalize(a_tags[:, :8], tkey(tag_key), tkey(pa_key))
