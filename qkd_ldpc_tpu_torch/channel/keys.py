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
``channel/threefry.py``).  The ``[B]``-sized key tree is plain PyTorch on
every device; the ``[B, N]`` bit blocks and the threshold search go to the
CUDA kernels on the card (``backend`` as in ``DecodeOptions.backend``).
"""

from __future__ import annotations

import torch

from qkd_ldpc_tpu_torch.channel.cuda_prng import trial_words
from qkd_ldpc_tpu_torch.channel.cuda_select import kth_smallest
from qkd_ldpc_tpu_torch.channel.cuda_select import (
    kth_smallest_plain as _kth_smallest,  # noqa: F401  (the JAX package's name)
)
from qkd_ldpc_tpu_torch.channel.threefry import (
    bernoulli_half,
    flip_sign,
    fold_in,
    prng_key,
)
from qkd_ldpc_tpu_torch.utils import resolve_device


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


def _exact_weight_mask(scores: torch.Tensor, num_errors, tie_scores_fn=None,
                       backend: str = "auto") -> torch.Tensor:
    """Boolean mask with exactly ``num_errors`` True per row, uniformly
    placed, from i.i.d. raw-uint32 ``scores`` [..., N].

    Selection by threshold: find the k-th smallest score, flip everything
    strictly below it, and complete the count from the threshold ties.

    Tie handling: a collision *at the threshold value* — the only case
    where a choice exists — occurs with probability about (N-1)/2^32 per
    frame.  When ``tie_scores_fn`` is given (a thunk returning an
    independent score tensor shaped like ``scores``), such ties are
    completed by a second-word ranking instead of index order, which makes
    the flip-set law exactly uniform.  The second word is generated and
    ranked only when some row actually has excess ties (a fetched flag, one
    host sync per call).  Without ``tie_scores_fn``, ties complete in index
    order.
    """
    k = int(num_errors)
    if k <= 0:
        return torch.zeros_like(scores, dtype=torch.bool)
    thresh = flip_sign(kth_smallest(scores, k, backend))
    s = flip_sign(scores)  # signed order == the scores' unsigned order
    below = s < thresh
    at = s == thresh
    n_below = below.sum(dim=-1, keepdim=True, dtype=torch.int32)
    tie_rank = at.cumsum(dim=-1, dtype=torch.int32) - 1
    need = k - n_below
    if tie_scores_fn is None:
        return below | (at & (tie_rank < need))

    n_at = at.sum(dim=-1, keepdim=True, dtype=torch.int32)
    # A choice among ties exists only when more scores sit at the
    # threshold than are needed; rows where n_at == need take all ties in
    # both branches, so batching cannot change any trial's outcome.
    if not bool((n_at > need).any()):
        return below | (at & (tie_rank < need))

    s2 = torch.where(at, tie_scores_fn(), -1)  # non-ties rank last (0xFFFFFFFF)
    t2 = flip_sign(kth_smallest(s2, need[..., 0].clamp_min(1), backend))
    s2 = flip_sign(s2)
    below2 = at & (s2 < t2)
    at2 = at & (s2 == t2)
    rank2 = at2.cumsum(dim=-1, dtype=torch.int32) - 1
    need2 = need - below2.sum(dim=-1, keepdim=True, dtype=torch.int32)
    return below | below2 | (at2 & (rank2 < need2))


def make_trials_from_ids(
    point_key: torch.Tensor,
    n_bits: int,
    trial_ids: torch.Tensor,  # [B] global trial indices (uint32 values)
    num_errors,
    prng: str = "threefry",
    backend: str = "auto",
    device=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Generate (alice, bob) uint8 key batches for explicit global trial ids.

    Each trial gets its own derived key, so the stream depends only on
    (master seed, sweep point, trial index) — a sweep chunked as 2x512 or
    1x1024 sees identical trials.

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
    point_key = point_key.to(device)
    trial_ids = torch.as_tensor(trial_ids).to(device=device, dtype=torch.int64)
    trial_keys = fold_in(point_key, trial_ids)  # [B, 2]
    alice_keys = fold_in(trial_keys, 0)
    error_keys = fold_in(trial_keys, 1)

    words = trial_words(
        torch.stack([alice_keys, error_keys], dim=1), n_bits, backend
    )  # [B, 2, N]: Alice's bit words, the error scores
    alice = bernoulli_half(words[:, 0])
    scores = words[:, 1].contiguous()

    def tie_scores():
        tie_keys = fold_in(error_keys, 1)
        return trial_words(tie_keys[:, None], n_bits, backend)[:, 0]

    flip = _exact_weight_mask(scores, num_errors, tie_scores, backend)
    return alice, alice ^ flip.to(torch.uint8)


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
    """Generate (alice, bob) key batches for trials [offset, offset+batch).

    ``device=None`` means the card and raises when there is none.
    """
    trial_ids = (torch.arange(batch, dtype=torch.int64) + int(trial_offset)) & 0xFFFFFFFF
    return make_trials_from_ids(
        point_key, n_bits, trial_ids, num_errors, prng, backend, device
    )
