"""Port vs JAX package: rate-adaptive reconciliation (puncturing and
shortening over one mother code).

Positions, frames, syndromes, the shortened pattern and the LLRs are equal
bit for bit; min-sum decodes are equal exactly, sum-product decodes on
decisions and iterations.  Both interop directions: a JAX Alice with a
PyTorch Bob, and a PyTorch Alice with a JAX Bob."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qkd_ldpc_tpu import codes as jcodes
from qkd_ldpc_tpu.channel import keys as jkeys
from qkd_ldpc_tpu.decoder import DecodeOptions as JOpts
from qkd_ldpc_tpu.decoder.rate_adapt import RateAdapter as JAdapter
from qkd_ldpc_tpu_torch import codes as tcodes
from qkd_ldpc_tpu_torch.decoder import DecodeOptions as TOpts
from qkd_ldpc_tpu_torch.decoder import RateAdapter as TAdapter
from qkd_ldpc_tpu_torch.decoder import rate_adapt as trate

from tests._torch_port_common import tkey

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def mother():
    kw = dict(n=1024, m=523, dv=3, seed=3, name="mother-1024")
    return jcodes.make_code(**kw), tcodes.make_code(**kw)


@pytest.mark.parametrize("p,s,seed", [(0, 0, 0), (128, 64, 1), (256, 0, 4), (0, 256, 2)])
def test_positions_and_accounting_equal_jax(mother, p, s, seed):
    jc, tc = mother
    ja = JAdapter.make(jc, n_punctured=p, n_shortened=s, seed=seed)
    ta = TAdapter.make(tc, n_punctured=p, n_shortened=s, seed=seed)
    for f in ("key_idx", "punct_idx", "short_idx"):
        np.testing.assert_array_equal(getattr(ta, f), getattr(ja, f))
    for f in ("payload_bits", "effective_rate", "leak_bits"):
        assert getattr(ta, f) == getattr(ja, f)
    assert trate._KNOWN_LLR == 64.0


@pytest.mark.parametrize("kw, match", [
    (dict(n_punctured=1024), "payload"),
    (dict(punctured=[1, 2], shortened=[2, 3]), "overlap"),
    (dict(punctured=[1024]), "range"),
], ids=["payload", "overlap", "range"])
def test_validation_messages_equal_jax(mother, kw, match):
    for adapter, code in ((JAdapter, mother[0]), (TAdapter, mother[1])):
        with pytest.raises(ValueError, match=match):
            adapter.make(code, **kw)


def _alice(adapter, seed, batch=6):
    kk = jax.random.PRNGKey(seed)
    return kk, jkeys.generate_random_bits(kk, adapter.payload_bits, batch)


@pytest.mark.parametrize("shared_seed", [0, 5])
def test_frames_syndromes_pattern_and_llr_equal_jax(mother, shared_seed):
    jc, tc = mother
    ja = JAdapter.make(jc, n_punctured=96, n_shortened=64, seed=11)
    ta = TAdapter.make(tc, n_punctured=96, n_shortened=64, seed=11)
    kk, alice = _alice(ja, 3)
    fk = jax.random.fold_in(kk, 2)
    np.testing.assert_array_equal(ta.short_pattern(shared_seed, "cpu").numpy(),
                                  np.asarray(ja.short_pattern(shared_seed)))
    jf = np.asarray(ja.build_frames(alice, fk, shared_seed))
    tf = ta.build_frames(np.asarray(alice), tkey(fk), shared_seed, device="cpu")
    assert tf.dtype == torch.uint8
    np.testing.assert_array_equal(tf.numpy(), jf)
    np.testing.assert_array_equal(ta.syndromes(tf).numpy(),
                                  np.asarray(ja.syndromes(jnp.asarray(jf))))
    bob = np.asarray(jkeys.introduce_errors(jax.random.fold_in(kk, 1), alice, 19))
    q = np.float32(19) / np.float32(256)  # a QBER whose LLR both logs round alike
    np.testing.assert_array_equal(
        ta.llr(bob, q, shared_seed, device="cpu").numpy(),
        np.asarray(ja.llr(jnp.asarray(bob), q, shared_seed)))


def test_llr_uploads_the_plan_once_per_device_and_seed(mother):
    """The positions and a shared seed's pinned LLRs are made once per
    device: repeated calls, and a second seed after the first, still give
    JAX's LLRs."""
    jc, tc = mother
    ja = JAdapter.make(jc, n_punctured=96, n_shortened=64, seed=11)
    ta = TAdapter.make(tc, n_punctured=96, n_shortened=64, seed=11)
    kk, alice = _alice(ja, 4)
    bob = np.asarray(jkeys.introduce_errors(jax.random.fold_in(kk, 1), alice, 19))
    q = np.float32(19) / np.float32(256)
    for shared_seed in (0, 5, 0):
        np.testing.assert_array_equal(
            ta.llr(bob, q, shared_seed, device="cpu").numpy(),
            np.asarray(ja.llr(jnp.asarray(bob), q, shared_seed)))
    assert ta._index("key_idx", "cpu") is ta._index("key_idx", torch.device("cpu"))
    assert len(ta._on_device) == 4  # key and short positions, two seeds' pins
    frames = torch.arange(2 * tc.n_vars).view(2, tc.n_vars)
    np.testing.assert_array_equal(ta.payload(frames).numpy(),
                                  frames.numpy()[:, ja.key_idx])


def _decode_both(jc, tc, jopts, topts, p, s, qber_err, seed, batch=6):
    """One rate-adapted round through both packages on the same frames."""
    ja = JAdapter.make(jc, n_punctured=p, n_shortened=s, seed=seed)
    ta = TAdapter.make(tc, n_punctured=p, n_shortened=s, seed=seed)
    kk, alice = _alice(ja, seed + 10, batch)
    n_err = qber_err
    bob = jkeys.introduce_errors(jax.random.fold_in(kk, 1), alice, n_err)
    syn = np.asarray(ja.syndromes(ja.build_frames(alice, jax.random.fold_in(kk, 2))))
    q = n_err / ja.payload_bits
    jk, ji, jo = (np.asarray(x) for x in ja.reconcile(bob, syn, q, jopts))
    tk, ti, to = (x.numpy() for x in ta.reconcile(np.asarray(bob), syn, q, topts,
                                                  device="cpu"))
    return np.asarray(alice), (jk, ji, jo), (tk, ti, to)


@pytest.mark.parametrize("p,s,n_err", [(256, 0, 15), (0, 256, 73), (128, 64, 40)],
                         ids=["punctured", "shortened", "both"])
@pytest.mark.parametrize("algorithm", ["min-sum", "sum-product"])
def test_reconcile_equals_jax(mother, p, s, n_err, algorithm):
    """Erasures (LLR 0) and +-64 pins through the decoder: min-sum equal
    exactly; sum-product equal on decisions and iterations."""
    jc, tc = mother
    kw = dict(max_iterations=40, algorithm=algorithm)
    alice, (jk, ji, jo), (tk, ti, to) = _decode_both(
        jc, tc, JOpts(**kw), TOpts(**kw), p, s, n_err, seed=4)
    np.testing.assert_array_equal(tk, jk)
    np.testing.assert_array_equal(to, jo)
    np.testing.assert_array_equal(ti, ji)
    assert to.any()  # the point decodes


def test_shortening_extends_reach(mother):
    """At QBER 0.095 the R=0.49 mother fails outright; shortening 256 bits
    (R_eff = 0.32) makes the same channel decodable, to the exact keys."""
    _, tc = mother
    opts = TOpts(max_iterations=60)
    plain = TAdapter.make(tc)
    short = TAdapter.make(tc, n_shortened=256, seed=2)
    assert short.effective_rate < 0.35 and plain.payload_bits == tc.n_vars
    for ad, expect in ((plain, False), (short, True)):
        kk, alice = _alice(ad, 5, 8)
        n_err = int(ad.payload_bits * 0.095)
        bob = jkeys.introduce_errors(jax.random.fold_in(kk, 1), alice, n_err)
        frames = ad.build_frames(np.asarray(alice), tkey(jax.random.fold_in(kk, 2)),
                                 device="cpu")
        key, _, ok = ad.reconcile(np.asarray(bob), ad.syndromes(frames),
                                  n_err / ad.payload_bits, opts, device="cpu")
        assert bool(ok.all()) == expect and bool(ok.any()) == expect
        if expect:
            np.testing.assert_array_equal(key.numpy(), np.asarray(alice))


def test_rate_adaptation_composes_with_layered_schedule():
    """A QC mother keeps its layered schedule (the sweep kernel on the
    card): shortened frames (R_eff 1/3) decode with schedule='layered' at
    QBER 0.095, equal to the JAX package's layered decode (min-sum, exact)."""
    kw = dict(z=32, nb=16, mb=8, dv=3, seed=11)
    jc, tc = jcodes.make_qc_code(**kw), tcodes.make_qc_code(**kw)
    opts = dict(max_iterations=60, schedule="layered", algorithm="min-sum")
    alice, (jk, ji, jo), (tk, ti, to) = _decode_both(
        jc, tc, JOpts(**opts), TOpts(**opts), 0, 128, int(384 * 0.095), seed=4, batch=8)
    np.testing.assert_array_equal(tk, jk)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(to, jo)
    assert to.all()
    np.testing.assert_array_equal(tk, alice)


@pytest.mark.parametrize("direction", ["jax-alice", "torch-alice"])
def test_interop_between_packages(mother, direction):
    """One side runs one package, the other side the other: the frames and
    syndromes Alice sends are the ones the other package would send, and
    Bob recovers her payload."""
    jc, tc = mother
    ja = JAdapter.make(jc, n_punctured=64, n_shortened=128, seed=9)
    ta = TAdapter.make(tc, n_punctured=64, n_shortened=128, seed=9)
    kk, alice = _alice(ja, 21, 4)
    fk = jax.random.fold_in(kk, 2)
    n_err = 20
    bob = np.asarray(jkeys.introduce_errors(jax.random.fold_in(kk, 1), alice, n_err))
    q = n_err / ja.payload_bits
    opts = dict(max_iterations=60, algorithm="min-sum")
    if direction == "jax-alice":
        syn = np.asarray(ja.syndromes(ja.build_frames(alice, fk)))
        key, _, ok = ta.reconcile(bob, syn, q, TOpts(**opts), device="cpu")
        key, ok = key.numpy(), ok.numpy()
    else:
        syn = ta.syndromes(ta.build_frames(np.asarray(alice), tkey(fk), device="cpu"))
        key, _, ok = ja.reconcile(bob, syn.numpy(), q, JOpts(**opts))
        key, ok = np.asarray(key), np.asarray(ok)
    assert ok.all()
    np.testing.assert_array_equal(key, np.asarray(alice))
