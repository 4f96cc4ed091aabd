"""Port vs JAX package: verification hashing and privacy amplification.

Every method (dense, blocked, blocked-xor, blocked-diag) must equal the
JAX package's dense hash, the port's own dense hash and a numpy GF(2)
product bit for bit, for the same seed key — including frames whose row
sums exceed 256, where a product rounded to bf16 would lose its parity."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qkd_ldpc_tpu import postprocess as jpp
from qkd_ldpc_tpu_torch import postprocess as tpp

from tests._torch_port_common import tkey

torch.set_num_threads(1)

METHODS = ("dense", "blocked", "blocked-xor", "blocked-diag")


def _gf2(bits, key, n_out):
    """numpy oracle: y_i = parity(sum_j s[i - j + n_in - 1] x_j)."""
    n_in = bits.shape[1]
    s = np.asarray(jax.random.bernoulli(key, 0.5, (n_in + n_out - 1,))).astype(np.int64)
    i, j = np.arange(n_out)[:, None], np.arange(n_in)[None, :]
    T = s[i - j + n_in - 1]
    return (bits.astype(np.int64) @ T.T) % 2, T


def test_toeplitz_matrix_equals_jax():
    key = jax.random.PRNGKey(7)
    want = np.asarray(jpp.toeplitz_matrix(key, 40, 16)).astype(np.int64)
    got = tpp.toeplitz_matrix(tkey(key), 40, 16, device="cpu")
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy().astype(np.int64), want)
    np.testing.assert_array_equal(want[:-1, :-1], want[1:, 1:])  # Toeplitz
    _, T = _gf2(np.zeros((1, 40), np.uint8), key, 16)
    np.testing.assert_array_equal(want, T)


@pytest.mark.parametrize("n_in,n_out,bo", [
    (700, 300, 128),   # ragged both axes
    (512, 512, 512),   # exact single block
    (1000, 900, 256),  # multiple row blocks
    (64, 700, 256),    # n_out > n_in, block larger than dims
    (333, 1000, 64),   # many ragged row blocks
    (300, 75, 20),     # a block whose width no int8 product takes (float32 path)
])
@pytest.mark.parametrize("method", METHODS)
def test_every_method_equals_dense_jax_and_numpy(n_in, n_out, bo, method):
    rng = np.random.default_rng(n_in + n_out)
    key = jax.random.PRNGKey(42)
    bits = rng.integers(0, 2, (3, n_in), dtype=np.uint8)
    bits[1] = 1  # row sums near n_in / 2: above 256 for the wide frames
    want, _ = _gf2(bits, key, n_out)
    jax_dense = np.asarray(jpp.toeplitz_hash(bits, key, n_out, method="dense"))
    np.testing.assert_array_equal(jax_dense, want)
    got = tpp.toeplitz_hash(bits, tkey(key), n_out, block_out=bo, method=method,
                            device="cpu")
    assert got.dtype == torch.uint8 and got.shape == (3, n_out)
    np.testing.assert_array_equal(got.numpy(), want)


def test_row_sums_above_256_keep_their_parity():
    """The bf16 trap: a product rounded to bf16 holds integers exactly only
    up to 256.  Here every row sum of the all-ones frame is above 256, and
    rounding them to bf16 changes some parities; the port's hash does not."""
    n_in, n_out = 1500, 200
    key = jax.random.PRNGKey(5)
    bits = np.ones((2, n_in), np.uint8)
    want, T = _gf2(bits, key, n_out)
    sums = bits.astype(np.int64) @ T.T
    assert sums.min() > 256
    rounded = torch.from_numpy(sums.astype(np.float32)).to(torch.bfloat16).to(torch.int64)
    assert ((rounded.numpy() % 2) != want).any()  # what the trap would do
    for method in METHODS:
        got = tpp.toeplitz_hash(bits, tkey(key), n_out, method=method, device="cpu")
        np.testing.assert_array_equal(got.numpy(), want, err_msg=method)


def test_auto_method_and_one_dimensional_frames():
    key = jax.random.PRNGKey(9)
    bits = np.random.default_rng(2).integers(0, 2, 600, dtype=np.uint8)
    want = np.asarray(jpp.toeplitz_hash(jnp.asarray(bits), key, 90))
    got = tpp.toeplitz_hash(bits, tkey(key), 90, device="cpu")
    assert got.shape == (90,)
    np.testing.assert_array_equal(got.numpy(), want)
    assert tpp._BLOCKED_DEFAULT in tpp._BLOCKED_KERNELS
    assert tpp._DENSE_LIMIT == jpp._DENSE_LIMIT
    with pytest.raises(ValueError, match="Unknown method"):
        tpp.toeplitz_hash(bits, tkey(key), 9, method="fft", device="cpu")


def test_tags_amplification_and_accounting_equal_jax():
    key, pkey = jax.random.PRNGKey(5), jax.random.PRNGKey(123)
    bits = np.asarray(jax.random.bernoulli(jax.random.fold_in(key, 1), 0.5, (8, 512))
                      ).astype(np.uint8)
    np.testing.assert_array_equal(
        tpp.verification_tags(bits, tkey(key), device="cpu").numpy(),
        np.asarray(jpp.verification_tags(jnp.asarray(bits), key)))
    np.testing.assert_array_equal(
        tpp.privacy_amplify(bits, tkey(pkey), 300, device="cpu").numpy(),
        np.asarray(jpp.privacy_amplify(jnp.asarray(bits), pkey, 300)))
    corrupted = bits.copy()
    corrupted[:, 37] ^= 1
    tags_a = tpp.verification_tags(bits, tkey(key), device="cpu").numpy()
    tags_c = tpp.verification_tags(corrupted, tkey(key), device="cpu").numpy()
    assert (tags_c != tags_a).any(axis=1).all()
    for args in [(10240, 5231), (1000, 900), (2048, 1046, 32, 50)]:
        assert tpp.amplified_key_bits(*args) == jpp.amplified_key_bits(*args)
    with pytest.raises(ValueError, match="no key material"):
        tpp.privacy_amplify(np.zeros((1, 100), np.uint8), tkey(key), 0, device="cpu")


def test_large_frame_streaming_methods_agree_with_numpy_rows():
    """A frame whose dense T would hold 2**31 entries: the three streaming
    methods agree with each other and with a numpy GF(2) oracle on
    spot-checked rows."""
    n_in, n_out = 1 << 16, 1 << 15
    rng = np.random.default_rng(1)
    key = jax.random.PRNGKey(7)
    bits = rng.integers(0, 2, (1, n_in), dtype=np.uint8)
    outs = {m: tpp.toeplitz_hash(bits, tkey(key), n_out, block_out=512, method=m,
                                 device="cpu").numpy() for m in METHODS[1:]}
    auto = tpp.toeplitz_hash(bits, tkey(key), n_out, device="cpu").numpy()
    np.testing.assert_array_equal(outs["blocked"], auto)
    for m in METHODS[2:]:
        np.testing.assert_array_equal(outs[m], outs["blocked"], err_msg=m)
    s = np.asarray(jax.random.bernoulli(key, 0.5, (n_in + n_out - 1,))).astype(np.int64)
    j = np.arange(n_in)
    for i in (0, 1, n_out // 2, n_out - 1):
        want = (s[i - j + n_in - 1] @ bits[0].astype(np.int64)) & 1
        assert outs["blocked"][0, i] == want, i
