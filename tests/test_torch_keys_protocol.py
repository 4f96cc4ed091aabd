"""Port vs JAX package: the protocol's keys — one ``[B, N]`` block from one
key (``generate_random_bits``, ``introduce_errors``), the 1-D Bernoulli
blocks of the shortened pattern and the Toeplitz seeds, and the JAX keys
carried across with ``threefry.key_from_words``.  All exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qkd_ldpc_tpu.channel import keys as jkeys
from qkd_ldpc_tpu_torch.channel import generate_random_bits, introduce_errors
from qkd_ldpc_tpu_torch.channel.keys import block_words
from qkd_ldpc_tpu_torch.channel.threefry import (
    bernoulli_half,
    fold_in,
    key_from_words,
    prng_key,
)

from tests._torch_port_common import tkey

torch.set_num_threads(1)


@pytest.mark.parametrize("seed", [0, 1, 7, 2**31 + 5, 2**32 - 1])
def test_key_from_words_equals_prng_key_and_fold_in(seed):
    jk = jax.random.PRNGKey(seed)
    assert tkey(jk).tolist() == prng_key(seed).tolist()
    jf = jax.random.fold_in(jk, 12345)
    assert tkey(jf).tolist() == fold_in(prng_key(seed), 12345).tolist()
    # a batch of keys keeps its shape
    both = np.stack([np.asarray(jk), np.asarray(jf)])
    assert key_from_words(both).shape == (2, 2)


@pytest.mark.parametrize("bad", [np.zeros(3, np.uint32), np.array([0.5, 1.0]),
                                 np.array([-1, 2]), np.array([0, 2**32])],
                         ids=["shape", "float", "negative", "wide"])
def test_key_from_words_refuses_what_is_no_key(bad):
    with pytest.raises(ValueError, match="key"):
        key_from_words(bad)


@pytest.mark.parametrize("shape", [(1, 7), (3, 5), (4, 1024), (9, 300)])
def test_two_dimensional_block_is_the_flat_block_reshaped(shape):
    """JAX's ``bits(key, (B, N))`` and ``bernoulli(key, 0.5, (B, N))`` count a
    2-D block by its flat row-major index: the port's flat B*N block,
    reshaped, is the same block — pinned here, not assumed."""
    jk = jax.random.fold_in(jax.random.PRNGKey(3), shape[1])
    want = np.asarray(jax.random.bits(jk, shape, jnp.uint32))
    got = block_words(tkey(jk), shape, "cpu").numpy().view(np.uint32)
    np.testing.assert_array_equal(got, want)
    want_b = np.asarray(jax.random.bernoulli(jk, 0.5, shape)).astype(np.uint8)
    np.testing.assert_array_equal(bernoulli_half(torch.from_numpy(got.view(np.int32))).numpy(),
                                  want_b)
    np.testing.assert_array_equal(
        generate_random_bits(tkey(jk), shape[1], shape[0], device="cpu").numpy(),
        np.asarray(jkeys.generate_random_bits(jk, shape[1], shape[0])))


@pytest.mark.parametrize("n", [1, 64, 1023])
def test_one_dimensional_bernoulli_block(n):
    """The shortened pattern and the Toeplitz seed are 1-D blocks."""
    jk = jax.random.PRNGKey(n)
    want = np.asarray(jax.random.bernoulli(jk, 0.5, (n,))).astype(np.uint8)
    np.testing.assert_array_equal(
        bernoulli_half(block_words(tkey(jk), (n,), "cpu")).numpy(), want)


@pytest.mark.parametrize("B,N,k", [(1, 64, 1), (4, 512, 15), (3, 1000, 123),
                                   (8, 256, 0), (2, 96, 96)])
def test_introduce_errors_equals_jax(B, N, k):
    """Bob's bits: exactly k flips per frame at JAX's positions (scores from
    the block of ``key``, ties ranked by the block of ``fold_in(key, 1)``)."""
    jk = jax.random.PRNGKey(B * 1000 + N)
    alice = jkeys.generate_random_bits(jax.random.fold_in(jk, 9), N, B)
    want = np.asarray(jkeys.introduce_errors(jk, alice, k))
    got = introduce_errors(tkey(jk), np.asarray(alice), k, device="cpu")
    assert got.dtype == torch.uint8 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want)
    assert ((got.numpy() ^ np.asarray(alice)).sum(axis=1) == k).all()
    # a tensor stays where it is
    again = introduce_errors(tkey(jk), torch.from_numpy(np.asarray(alice)), k)
    np.testing.assert_array_equal(again.numpy(), want)


def test_introduce_errors_tie_path_equals_jax():
    """Scores crafted so that rows hold more ties at the threshold than they
    need: the second-word ranking (``fold_in(key, 1)``'s block) decides, as
    in JAX's ``_exact_weight_mask``."""
    from qkd_ldpc_tpu_torch.channel.keys import _exact_weight_flip

    B, N, k = 3, 40, 5
    rng = np.random.default_rng(4)
    scores = rng.integers(0, 2**32, (B, N), dtype=np.uint64).astype(np.uint32)
    scores[:, ::3] = 77  # 14 ties at the smallest value: k of them flip
    alice = rng.integers(0, 2, (B, N), dtype=np.uint8)
    ties = rng.integers(0, 2**32, (B, N), dtype=np.uint64).astype(np.uint32)
    mask = np.asarray(jkeys._exact_weight_mask(
        jnp.asarray(scores), k, tie_scores_fn=lambda: jnp.asarray(ties)))
    got = _exact_weight_flip(torch.from_numpy(scores.view(np.int32)),
                             torch.from_numpy(alice), k,
                             lambda: torch.from_numpy(ties.view(np.int32)))
    np.testing.assert_array_equal(got.numpy(), np.where(mask, alice ^ 1, alice))
