"""Port vs JAX package: threefry key tree, bit blocks, exact-weight channel.

Everything here is integer work and must match ``jax.random`` and
``qkd_ldpc_tpu.channel`` exactly.  The port runs with ``device="cpu"``, i.e.
through the plain versions of kernels K3 (threshold) and K4 (bit blocks).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qkd_ldpc_tpu.channel import keys as jkeys
from qkd_ldpc_tpu.channel.pallas_select import kth_smallest_pallas
from qkd_ldpc_tpu_torch.channel import keys as tkeys
from qkd_ldpc_tpu_torch.channel import threefry as tf
from qkd_ldpc_tpu_torch.channel.cuda_prng import trial_words, trial_words_plain
from qkd_ldpc_tpu_torch.channel.cuda_select import kth_smallest, kth_smallest_plain

torch.set_num_threads(1)


def u32(t: torch.Tensor) -> np.ndarray:
    """int32 raw words -> numpy uint32."""
    return t.numpy().view(np.uint32)


def raw(a: np.ndarray) -> torch.Tensor:
    """numpy uint32 -> the port's int32 raw words."""
    return torch.from_numpy(np.ascontiguousarray(a, np.uint32).view(np.int32))


def key_np(k) -> np.ndarray:
    return np.asarray(jax.random.key_data(k) if hasattr(k, "dtype") and
                      jax.dtypes.issubdtype(k.dtype, jax.dtypes.prng_key) else k)


@pytest.mark.parametrize("seed", [0, 1, 777, 2**31 + 5, 2**32 - 1])
def test_prng_key_and_fold_in(seed):
    jk = jax.random.PRNGKey(seed)
    tk = tf.prng_key(seed)
    np.testing.assert_array_equal(key_np(jk), tk.numpy())
    for d in (0, 1, 12345, 2**32 - 1):
        np.testing.assert_array_equal(
            key_np(jax.random.fold_in(jk, d)), tf.fold_in(tk, d).numpy()
        )
    # vectorised fold_in over trial ids == per-id fold_in
    ids = torch.tensor([0, 3, 2**31, 2**32 - 1], dtype=torch.int64)
    vec = tf.fold_in(tk, ids).numpy()
    ref = np.stack([key_np(jax.random.fold_in(jk, int(i))) for i in ids])
    np.testing.assert_array_equal(vec, ref)


@pytest.mark.parametrize("n", [1, 7, 1000])
def test_bits_and_bernoulli(n):
    jk = jax.random.fold_in(jax.random.PRNGKey(42), 9)
    tk = tf.fold_in(tf.prng_key(42), 9)
    words = tf.random_bits(tk, n)
    assert words.dtype == torch.int32
    np.testing.assert_array_equal(
        np.asarray(jax.random.bits(jk, (n,), jnp.uint32)), u32(words)
    )
    np.testing.assert_array_equal(
        np.asarray(jax.random.bernoulli(jk, 0.5, (n,))).astype(np.uint8),
        tf.bernoulli_half(words).numpy(),
    )


def test_golden_vector():
    """Committed words of fold_in(PRNGKey(777), 0): a later change of
    jax.random's stream shows up here even if both sides move together."""
    key = tf.fold_in(tf.prng_key(777), 0)
    assert key.tolist() == [3152365877, 432660891]
    assert u32(tf.random_bits(key, 8)).tolist() == [
        1867298337, 1420043536, 2386203011, 1139503447,
        1431282132, 174634783, 1636412017, 4004023492,
    ]
    assert tf.bernoulli_half(tf.random_bits(key, 16)).tolist() == [
        1, 1, 0, 1, 1, 1, 1, 0, 0, 0, 0, 1, 0, 0, 1, 0,
    ]
    jk = jax.random.fold_in(jax.random.PRNGKey(777), 0)
    np.testing.assert_array_equal(key_np(jk), key.numpy())


def test_prng_key_rejects_wide_seed():
    with pytest.raises(ValueError):
        tf.prng_key(2**32)
    with pytest.raises(ValueError):
        tf.prng_key(-1)


def test_trial_words_plain_equals_jax_bits_per_trial():
    """Plain K4: row r of trial b is jax.random.bits(key[b, r], (n,))."""
    B, n = 5, 300
    pk = jkeys.derive_point_key(777, 2)
    tk = tkeys.derive_point_key(777, 2)
    jt = [jax.random.fold_in(pk, t) for t in range(B)]
    tt = tf.fold_in(tk, torch.arange(B))
    keys = torch.stack([tf.fold_in(tt, 0), tf.fold_in(tt, 1)], dim=1)
    words = trial_words_plain(keys, n)
    assert words.shape == (B, 2, n) and words.dtype == torch.int32
    for b in range(B):
        for r in (0, 1):
            k = jax.random.fold_in(jt[b], r)
            np.testing.assert_array_equal(
                np.asarray(jax.random.bits(k, (n,), jnp.uint32)), u32(words[b, r])
            )
        np.testing.assert_array_equal(
            np.asarray(jax.random.bernoulli(jax.random.fold_in(jt[b], 0), 0.5, (n,))),
            tf.bernoulli_half(words[b, 0]).numpy().astype(bool),
        )
    # the dispatcher takes the plain version for a CPU tensor
    assert torch.equal(trial_words(keys, n, backend="auto"), words)
    assert torch.equal(trial_words(keys, n, backend="xla"), words)


def _kth_cases():
    rng = np.random.default_rng(0)
    cases = []
    for B, N in [(4, 256), (3, 100), (8, 1000)]:
        s = rng.integers(0, 2**32, (B, N), dtype=np.uint32)
        cases.append((f"random-{B}x{N}", s, (1, 2, N // 2, N - 1, N)))
    ties = rng.integers(0, 16, (4, 512), dtype=np.uint32) << 28
    cases.append(("ties", ties.astype(np.uint32), (1, 7, 200, 511)))
    ext = np.full((2, 128), 0xFFFFFFFF, np.uint32)
    ext[0, 5] = 0
    ext[1, :3] = [7, 7, 9]
    cases.append(("extremes", ext, (1, 2, 128)))
    return cases


@pytest.mark.parametrize("name,scores,ks", _kth_cases(), ids=lambda c: c if isinstance(c, str) else "")
def test_kth_smallest_plain_equals_jax(name, scores, ks):
    """Plain K3 == the Pallas kernel (interpret mode) == the XLA search, on
    the cases of the JAX package's own test (ties, k=1, k=N, ragged N,
    extremes)."""
    js = jnp.asarray(scores)
    ts = raw(scores)
    for k in ks:
        ref = np.asarray(jkeys._kth_smallest(js, jnp.asarray(k, jnp.int32)))
        pal = np.asarray(kth_smallest_pallas(js, jnp.asarray(k, jnp.int32),
                                             interpret=True))
        got = u32(kth_smallest_plain(ts, k))
        np.testing.assert_array_equal(pal, ref)
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(
            got[:, 0], np.sort(scores, axis=1)[:, k - 1]
        )
        assert torch.equal(kth_smallest(ts, k, backend="auto"),
                           kth_smallest_plain(ts, k))


def test_kth_smallest_per_row_k_and_leading_dims():
    rng = np.random.default_rng(3)
    scores = rng.integers(0, 2**32, (6, 200), dtype=np.uint32)
    ks = np.array([1, 2, 50, 199, 200, 77], np.int32)
    got = u32(kth_smallest_plain(raw(scores), torch.from_numpy(ks)))
    want = np.sort(scores, axis=1)[np.arange(6), ks - 1]
    np.testing.assert_array_equal(got[:, 0], want)
    ref = np.asarray(jkeys._kth_smallest(jnp.asarray(scores), jnp.asarray(ks)))
    np.testing.assert_array_equal(got, ref)
    one_row = u32(kth_smallest_plain(raw(scores[0]), 5))
    assert one_row.shape == (1,) and one_row[0] == np.sort(scores[0])[4]


def test_kernel_backend_raises_on_cpu_tensor():
    """backend='pallas' selects the CUDA kernel and must not fall back."""
    s = raw(np.arange(8, dtype=np.uint32)[None])
    with pytest.raises(ValueError, match="CUDA"):
        kth_smallest(s, 2, backend="pallas")
    with pytest.raises(ValueError, match="CUDA"):
        trial_words(torch.zeros((1, 1, 2), dtype=torch.int64), 4, backend="pallas")
    with pytest.raises(ValueError, match="Unknown backend"):
        kth_smallest(s, 2, backend="cuda")


@pytest.mark.parametrize("point", [0, 3, 11])
@pytest.mark.parametrize("offset,batch", [(0, 8), (5, 16), (2**32 - 4, 8)])
def test_make_trial_batch_equals_jax(point, offset, batch):
    n_bits, n_err = 384, 19
    ja, jb = jkeys.make_trial_batch(
        jkeys.derive_point_key(777, point), n_bits, batch,
        jnp.asarray(n_err, jnp.int32), trial_offset=jnp.uint32(offset),
    )
    ta, tb = tkeys.make_trial_batch(
        tkeys.derive_point_key(777, point), n_bits, batch, n_err,
        trial_offset=offset, device="cpu",
    )
    assert ta.dtype == torch.uint8 and tb.dtype == torch.uint8
    np.testing.assert_array_equal(np.asarray(ja), ta.numpy())
    np.testing.assert_array_equal(np.asarray(jb), tb.numpy())
    assert ((ta ^ tb).sum(dim=1) == n_err).all()


def test_make_trials_from_ids_equals_jax_for_both_contract_names():
    ids = np.array([9, 0, 4000000000, 17, 17], dtype=np.uint32)
    pk, tk = jkeys.derive_point_key(777, 1), tkeys.derive_point_key(777, 1)
    ja, jb = jkeys.make_trials_from_ids(pk, 256, jnp.asarray(ids),
                                        jnp.asarray(12, jnp.int32))
    for prng in ("threefry", "pallas"):
        ta, tb = tkeys.make_trials_from_ids(
            tk, 256, torch.from_numpy(ids.astype(np.int64)), 12, prng=prng,
            device="cpu",
        )
        np.testing.assert_array_equal(np.asarray(ja), ta.numpy())
        np.testing.assert_array_equal(np.asarray(jb), tb.numpy())
    assert torch.equal(tb[3], tb[4])  # a trial depends on its id only


def test_chunk_invariance():
    tk = tkeys.derive_point_key(777, 6)
    a16, b16 = tkeys.make_trial_batch(tk, 256, 16, 12, device="cpu")
    a0, b0 = tkeys.make_trial_batch(tk, 256, 8, 12, trial_offset=0, device="cpu")
    a1, b1 = tkeys.make_trial_batch(tk, 256, 8, 12, trial_offset=8, device="cpu")
    assert torch.equal(torch.cat([a0, a1]), a16)
    assert torch.equal(torch.cat([b0, b1]), b16)


@pytest.mark.parametrize("k", [1, 4, 9, 37])
def test_forced_ties_take_the_second_word_path(k):
    """Quantised scores force ties at the threshold: both packages must
    complete them by the same second-word ranking (and not by index order)."""
    rng = np.random.default_rng(11)
    scores = (rng.integers(0, 4, (6, 64), dtype=np.uint32) << 30).astype(np.uint32)
    second = rng.integers(0, 2**32, (6, 64), dtype=np.uint32)
    second[2] = second[2] >> 29 << 29  # ties in the second word too
    calls = []

    def tie_scores():
        calls.append(1)
        return raw(second)

    want = np.asarray(jkeys._exact_weight_mask(
        jnp.asarray(scores), k, tie_scores_fn=lambda: jnp.asarray(second)))
    got = tkeys._exact_weight_mask(raw(scores), k, tie_scores, backend="xla")
    assert calls, "the tie path did not fire"
    np.testing.assert_array_equal(want, got.numpy())
    assert (got.sum(dim=1) == k).all()
    index_order = tkeys._exact_weight_mask(raw(scores), k)
    np.testing.assert_array_equal(
        np.asarray(jkeys._exact_weight_mask(jnp.asarray(scores), k)),
        index_order.numpy(),
    )
    assert not torch.equal(index_order, got)


def test_no_ties_never_draws_the_second_word():
    rng = np.random.default_rng(5)
    scores = rng.permutation(2**20)[: 16 * 256].reshape(16, 256).astype(np.uint32)

    def tie_scores():
        raise AssertionError("second word drawn without excess ties")

    got = tkeys._exact_weight_mask(raw(scores), 17, tie_scores)
    want = np.asarray(jkeys._exact_weight_mask(jnp.asarray(scores), 17))
    np.testing.assert_array_equal(want, got.numpy())
    assert not tkeys._exact_weight_mask(raw(scores), 0).any()


def test_unknown_prng_contract_rejected():
    tk = tkeys.derive_point_key(777, 0)
    with pytest.raises(ValueError, match="Unknown prng contract"):
        tkeys.make_trials_from_ids(tk, 64, torch.arange(4), 3, prng="Pallas",
                                   device="cpu")
    with pytest.raises(ValueError, match="prng impl"):
        tkeys.master_key(777, "rbg")
    assert torch.equal(tkeys.master_key(777), tkeys.master_key(777, "pallas"))


@pytest.mark.parametrize("n,q", [(10240, 0.05), (256, 0.03), (10, 0.05), (384, 0.0999)])
def test_num_errors_for(n, q):
    assert tkeys.num_errors_for(n, q) == jkeys.num_errors_for(n, q)
