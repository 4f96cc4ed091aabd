"""Shared helpers of the tests/test_torch_*.py files: the same inputs, made
from a seed with numpy, go to the JAX package and to the PyTorch port."""

import numpy as np

from qkd_ldpc_tpu import codes as jcodes
from qkd_ldpc_tpu_torch import codes as tcodes

CODE_SPECS = {
    "regular": ("make_code", dict(n=120, m=60, dv=3, seed=2)),  # rows 6, columns 3
    "irregular": ("make_code", dict(n=256, m=131, dv=3, seed=1)),
    "qc": ("make_qc_code", dict(z=32, nb=12, mb=6, dv=3, seed=5)),
    # base rows of 15 cells (R = 0.8): above the unrolled sweep instances
    "qc15": ("make_qc_code", dict(z=32, nb=20, mb=4, dv=3, seed=5)),
    "dc12": ("make_code", dict(n=92, m=24, dv=3, seed=3)),  # rows 11 and 12
}
_cache = {}


def _ragged_matrix(n=48, m=24, seed=7):
    """A dense H whose column weights (2..4) and row weights both vary, so
    the variable side and the check side both have padded slots."""
    rng = np.random.default_rng(seed)
    H = np.zeros((m, n), np.uint8)
    for v in range(n):
        H[rng.choice(m, 2 + v % 3, replace=False), v] = 1
    assert H.sum(axis=1).min() >= 2
    return H


def code_pair(which):
    """(JAX package's code, port's code) built by each package's own
    generator from the same seed."""
    if which == "ragged" and which not in _cache:
        H = _ragged_matrix()
        _cache[which] = (jcodes.from_dense(H), tcodes.from_dense(H))
    if which not in _cache:
        fn, kw = CODE_SPECS[which]
        _cache[which] = (getattr(jcodes, fn)(**kw), getattr(tcodes, fn)(**kw))
    return _cache[which]


def make_frames(n_bits, batch, n_err, seed):
    """Alice's keys and Bob's copies with exactly n_err flips each (uint8)."""
    rng = np.random.default_rng(seed)
    alice = rng.integers(0, 2, (batch, n_bits), dtype=np.uint8)
    bob = alice.copy()
    for b in range(batch):
        bob[b, rng.choice(n_bits, n_err, replace=False)] ^= 1
    return alice, bob


def tkey(jax_key):
    """The port's key for a JAX key (carried across as numpy words)."""
    from qkd_ldpc_tpu_torch.channel.threefry import key_from_words

    return key_from_words(np.asarray(jax_key))


def decode_frames(code, n_err, batch, seed):
    """Numpy a-priori LLRs and target syndromes of ``batch`` frames with
    ``n_err`` flips each (float32 ``[B, N]``, int8 ``[B, M]``)."""
    alice, bob = make_frames(code.n_vars, batch, n_err, seed)
    q = np.float32(n_err) / np.float32(code.n_vars)
    mag = np.float32(np.log(np.float64((np.float32(1) - q) / q)))
    llr = np.where(bob == 1, -mag, mag).astype(np.float32)
    syn = ((alice.astype(np.int64) @ code.dense.T.astype(np.int64)) % 2).astype(np.int8)
    return llr, syn


def assert_equal(a, b):
    """Two decodes' ``(bits, iterations, syndromes_match)`` equal bit for bit."""
    np.testing.assert_array_equal(a[1], b[1])  # iterations
    np.testing.assert_array_equal(a[2], b[2])  # syndromes_match
    np.testing.assert_array_equal(a[0], b[0])  # bits


def assert_sp_close(a, b, frames, shift):
    """Sum-product across formulations: every verdict equal; iterations and
    bits equal on every frame but at most ``frames``, whose iteration counts
    differ by at most ``shift`` (None: any).  Such frames are ROADMAP C
    drift entries (float32 ``tanh``/``log`` rounding, which int8 messages
    amplify to whole quanta)."""
    np.testing.assert_array_equal(a[2], b[2])
    moved = np.nonzero(a[1] != b[1])[0]
    assert len(moved) <= frames, (moved, a[1][moved], b[1][moved])
    if shift is not None:
        assert np.all(np.abs(a[1][moved].astype(int) - b[1][moved]) <= shift)
    same = a[1] == b[1]
    np.testing.assert_array_equal(a[0][same], b[0][same])
