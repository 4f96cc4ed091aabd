"""Sifted-key generation and the exact-weight binary channel.

Counterpart of ``qkd_ldpc_tpu/channel/keys.py``:

- Alice's key: uniform i.i.d. bits from the counter-based threefry
  generator — reproducible regardless of how trials are batched.
- Bob's key: **exact-weight** error injection — exactly ``floor(N * qber)``
  bit flips at uniformly random positions.  Per-bit uniform uint32 scores
  are drawn, the k-th smallest found (bitwise search, no sort), everything
  strictly below it flips, and the count is completed from the threshold
  ties.  A rank permutation of i.i.d. scores is a uniform random
  permutation, so the flip set has the law of a Fisher-Yates shuffle.

Determinism contract: the master seed and the sweep point index derive a
point key via ``fold_in``; trial t within the point uses
``fold_in(point_key, t)``.  Results are bit-for-bit reproducible for a
given seed, independent of batch size, and equal to the JAX package's.

Keys are int64 ``[..., 2]`` tensors and bit blocks int32 raw words (see
``channel/threefry.py``).  On the card a batch of trials is two kernel
launches: K4 (``channel/cuda_prng.py``) derives every trial's keys from the
point key and writes Alice's bits and the error scores, K3
(``channel/cuda_select.py``) selects the threshold, writes Bob's bits and
an excess-ties flag; the second-word tie path (JAX's ``lax.cond``) is
taken on the card: K4's tie-row launch and the tie-completion kernel read
the flag from device memory and return at once where it is 0, so a batch of
trials is four launches and no host read.  Off the card (and under
``backend="xla"``) the flag is read and the plain passes run only when it is
set.  The point key, the first trial id and the error count may lie on the
card (a captured trial chunk's inputs): the kernels read them there.

The protocol's keys (:func:`generate_random_bits`, :func:`introduce_errors`)
are one ``[B, N]`` block drawn from one key, not a batch of trials, which
the JAX package draws with ``jax.random`` outside any Pallas kernel.  On the
card the port draws such a block with the flat-block kernel of
``csrc/threefry_words.cu`` (:func:`block_words`); Bob's flips are K3's, and
the tie block of :func:`introduce_errors` is drawn only where K3's flag is
set, read on the card (JAX's ``lax.cond(has_excess)``).
"""


from __future__ import annotations

import math

import torch

from qkd_ldpc_tpu_torch.channel import cuda_prng
from qkd_ldpc_tpu_torch.channel.cuda_prng import (
    ALICE,
    SCORES,
    TIES,
    DeviceRange,
    trial_words,
    trial_words_cuda,
)
from qkd_ldpc_tpu_torch import _build
from qkd_ldpc_tpu_torch.channel.cuda_select import (
    complete_ties_cuda,
    kth_smallest,
    select_flip,
)
from qkd_ldpc_tpu_torch.channel.cuda_select import (
    kth_smallest_plain as _kth_smallest,  # noqa: F401  (the JAX package's name)
)
from qkd_ldpc_tpu_torch.channel.threefry import (
    bernoulli_half,
    flip_sign,
    fold_in,
    prng_key,
)
from qkd_ldpc_tpu_torch.utils import resolve_device, tensor_on


def master_key(seed: int, impl: str = "threefry") -> torch.Tensor:
    """Master PRNG key.  Both contract names of the JAX package share the
    threefry key-derivation tree; in the port they also share the bit
    blocks (see :func:`make_trials_from_ids`)."""
    if impl not in ("threefry", "pallas"):
        raise ValueError(f"Unknown prng impl {impl!r}")
    return prng_key(seed)


def derive_point_key(master_seed: int, sweep_index: int,
                     impl: str = "threefry") -> torch.Tensor:
    """PRNG key for one (matrix, QBER) sweep point."""
    return fold_in(master_key(master_seed, impl), sweep_index)


def num_errors_for(n_bits: int, qber: float) -> int:
    """Exact error count floor(N * q) — 0 means the key is too small for
    this QBER, which callers treat as fatal."""
    return int(n_bits * qber)


def block_words(key: torch.Tensor, shape: tuple, device, gate=None) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)`` as int32 raw words on
    ``device`` (the flat block of ``prod(shape)`` words, reshaped): the
    flat-block kernel on the card, where ``gate`` (int32 ``[1]`` there) may
    skip it; plain threefry elsewhere."""
    return cuda_prng.block_words(key, math.prod(shape), device, gate=gate).view(shape)


def generate_random_bits(key: torch.Tensor, n_bits: int, batch: int,
                         device=None) -> torch.Tensor:
    """Alice's sifted keys: [batch, n_bits] uint8 i.i.d. uniform bits
    (``jax.random.bernoulli(key, 0.5, (batch, n_bits))``).  ``device=None``
    means the card and raises when there is none."""
    return bernoulli_half(block_words(key, (batch, n_bits), resolve_device(device)))


def introduce_errors(key: torch.Tensor, bits, num_errors,
                     device=None) -> torch.Tensor:
    """Flip exactly ``num_errors`` uniformly random positions per frame of
    ``bits`` [B, N] uint8 (a tensor stays on its device; anything else goes
    to ``device``, None = the card).  The scores are one ``[B, N]`` block of
    ``key``, the threshold ties ranked by the block of ``fold_in(key, 1)``;
    the selection and the flip are K3's on the card.  The tie block is drawn
    only where some row has excess ties: on the card the flat-block kernel
    reads K3's flag there and writes nothing where it is 0 (no host read),
    elsewhere the flag is read first."""
    bits = tensor_on(bits, device, torch.uint8)
    B, N = bits.shape
    scores = block_words(key, (B, N), bits.device)
    tie_key = fold_in(key, 1)
    return _exact_weight_flip(
        scores, bits.contiguous(), num_errors,
        lambda: block_words(tie_key, (B, N), bits.device),
        gated_tie_scores=lambda excess: block_words(tie_key, (B, N), bits.device, excess))


def _exact_weight_flip(scores: torch.Tensor, alice: torch.Tensor, num_errors,
                       tie_scores_fn=None, backend: str = "auto",
                       gated_tie_scores=None) -> torch.Tensor:
    """Bob's bits: ``alice`` with exactly ``num_errors`` bits flipped per row,
    uniformly placed, from i.i.d. raw-uint32 ``scores`` [..., N].

    Selection by threshold: find the k-th smallest score, flip everything
    strictly below it, and complete the count from the threshold ties
    (:func:`~qkd_ldpc_tpu_torch.channel.cuda_select.select_flip`, one kernel
    on the card).

    Tie handling: a collision *at the threshold value* — the only case
    where a choice exists — occurs with probability about (N-1)/2^32 per
    frame.  When ``tie_scores_fn`` is given (a thunk returning an
    independent score tensor shaped like ``scores``), such ties are
    completed by a second-word ranking instead of index order, which makes
    the flip-set law exactly uniform.  On the card the second word is
    ranked by the tie-completion kernel, which reads the excess-ties flag
    there and does nothing where it is 0 (``gated_tie_scores(flag)``, when
    given, replaces the thunk there: K4 generates the words under the same
    gate); elsewhere the flag is read and the plain passes run only when it
    is set.  Without ``tie_scores_fn``, ties complete in index order.
    ``num_errors`` is an int or an int32 ``[1]`` tensor (on the card: read
    there by the kernels).
    """
    k = num_errors if isinstance(num_errors, torch.Tensor) else int(num_errors)
    thresh, bob, excess = select_flip(scores, k, alice, backend)
    # A choice among ties exists only when more scores sit at the
    # threshold than are needed; rows where n_at == need take all ties in
    # both branches, so batching cannot change any trial's outcome.
    if tie_scores_fn is None:
        return bob
    if _build.use_kernel(backend, scores.device):
        second = tie_scores_fn() if gated_tie_scores is None else gated_tie_scores(excess)
        return complete_ties_cuda(scores, thresh, k, second, alice, bob, excess)
    if not bool(excess):
        return bob
    return alice ^ _uniform_ties(scores, thresh, k, tie_scores_fn(), backend)


def _uniform_ties(scores, thresh, k, tie_scores, backend) -> torch.Tensor:
    """The second-word tie path, plain passes: the flip mask (uint8) whose
    threshold ties are ranked by ``tie_scores``, then by index."""
    s, t = flip_sign(scores), flip_sign(thresh)
    below, at = s < t, s == t
    need = k - below.sum(dim=-1, keepdim=True, dtype=torch.int32)
    s2 = torch.where(at, tie_scores, -1)  # non-ties rank last (0xFFFFFFFF)
    t2 = flip_sign(kth_smallest(s2, need[..., 0].clamp_min(1), backend))
    s2 = flip_sign(s2)
    below2 = at & (s2 < t2)
    at2 = at & (s2 == t2)
    rank2 = at2.cumsum(dim=-1, dtype=torch.int32) - 1
    need2 = need - below2.sum(dim=-1, keepdim=True, dtype=torch.int32)
    return (below | below2 | (at2 & (rank2 < need2))).to(torch.uint8)


def make_trials_from_ids(
    point_key: torch.Tensor,
    n_bits: int,
    trial_ids,  # [B] global trial indices (uint32 values), or a range
    num_errors,
    prng: str = "threefry",
    backend: str = "auto",
    device=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Generate (alice, bob) uint8 key batches for explicit global trial ids.

    Each trial gets its own derived key, so the stream depends only on
    (master seed, sweep point, trial index) — a sweep chunked as 2x512 or
    1x1024 sees identical trials.  ``trial_ids`` is a ``[B]`` integer tensor
    or a ``range`` of step 1 (ids taken mod 2**32; on the card it needs no
    ids tensor), or a :class:`~qkd_ldpc_tpu_torch.channel.cuda_prng.DeviceRange`
    (its base on the card).  ``point_key`` and ``num_errors`` (an int32
    ``[1]`` tensor) may lie on the card, where the kernels read them.

    ``prng`` keeps the JAX package's two contract names.  ``"pallas"``
    there is the TPU's hardware generator, which no other machine can
    reproduce, and off the TPU the JAX package itself gives the threefry
    stream for it.  In the port both names give the threefry stream.
    """
    if prng not in ("threefry", "pallas"):
        # Anything unknown must NOT silently fall into the threefry
        # stream — a typo'd contract name would otherwise be unobservable.
        raise ValueError(
            f"Unknown prng contract {prng!r}: expected 'threefry' (v1) "
            "or 'pallas' (v2)"
        )
    device = resolve_device(device)
    if not isinstance(trial_ids, (range, DeviceRange)):
        trial_ids = torch.as_tensor(trial_ids)
    alice, scores = trial_words(point_key, n_bits, trial_ids, (ALICE, SCORES),
                                backend, device)

    def tie_scores():
        return trial_words(point_key, n_bits, trial_ids, (TIES,), backend, device)[0]

    def gated_tie_scores(excess):  # on the card: written only where excess is set
        return trial_words_cuda(point_key, n_bits, trial_ids, (TIES,), device,
                                gate=excess)[0]

    bob = _exact_weight_flip(scores, alice, num_errors, tie_scores, backend,
                             gated_tie_scores)
    return alice, bob


def make_trial_batch(
    point_key: torch.Tensor,
    n_bits: int,
    batch: int,
    num_errors,
    trial_offset=0,
    prng: str = "threefry",
    backend: str = "auto",
    device=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Generate (alice, bob) key batches for trials [offset, offset+batch)
    (ids mod 2**32).

    ``device=None`` means the card and raises when there is none.
    """
    offset = int(trial_offset)
    return make_trials_from_ids(
        point_key, n_bits, range(offset, offset + batch), num_errors, prng,
        backend, device
    )
