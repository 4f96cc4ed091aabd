"""Blind reconciliation: interactive rate adaptation without a QBER estimate.

Counterpart of ``qkd_ldpc_tpu/decoder/blind.py`` (Martinez-Mateo,
Elkouss, Martin, "Blind reconciliation", QIC 2012).  Start with all d
modulated positions PUNCTURED (the highest rate); on decode failure Alice
progressively REVEALS punctured bits — converting them into shortened
(known) positions — until Bob's decode verifies or the budget is
exhausted.  Leakage is adaptive per frame, accounted conservatively as
``M - d + 2 * revealed_i``.

The rounds run through the serving endpoint (``serve.Reconciler.
blind_session``): a session here is a :class:`~qkd_ldpc_tpu_torch.serve.
BlindRounds` on an endpoint of its own over the adapter, so round 0 decodes
every frame and each later round only the frames not yet verified, with
the bits revealed so far pinned, through the endpoint's one blind program
(on the card a captured graph).  Bookkeeping is numpy on the host, as in the
JAX package (``device=None`` = the card, which raises without one).
"""

from __future__ import annotations

from typing import Callable

import numpy as np

from qkd_ldpc_tpu_torch.channel.threefry import prng_key
from qkd_ldpc_tpu_torch.codes.ldpc_code import LDPCCode
from qkd_ldpc_tpu_torch.decoder.bp import DecodeOptions
from qkd_ldpc_tpu_torch.decoder.rate_adapt import RateAdapter
# the results are the endpoint's (re-exported here, where the JAX package has them)
from qkd_ldpc_tpu_torch.serve import BlindResult, BlindRounds, Reconciler, SecureBlindResult
from qkd_ldpc_tpu_torch.utils import host, resolve_device

# The endpoint's decode width for a session's block: its frames, up to this.
SESSION_LANES = 128


class BlindSession(BlindRounds):
    """Endpoint-shaped Bob-side blind reconciliation, with control
    INVERTED for serving: the caller owns the classical channel::

        s = BlindSession(adapter, bob_payload, alice_syndromes)
        pos = s.begin()                 # None, or positions to request
        while pos is not None:
            pos = s.provide(values)     # Alice's bits for `pos`, [B, k]
        out = s.result()                # BlindResult

    ``adapter`` must be all-punctured (``n_shortened == 0``): its punctured
    positions are the reveal budget.  ``qber_hint`` only shapes the channel
    LLR magnitude.  The session runs on a ``serve.Reconciler`` of its own
    (``adapter=adapter``, lanes the block's frames up to
    :data:`SESSION_LANES`); ``Reconciler.blind_session`` runs sessions on a
    long-lived endpoint instead.
    """

    def __init__(
        self,
        adapter: RateAdapter,
        bob_payload,  # [B, l] Bob's noisy payload bits
        alice_syndromes,  # [B, M]
        qber_hint: float = 0.05,
        opts: DecodeOptions = DecodeOptions(),
        reveal_step: int | None = None,
        max_rounds: int | None = None,
        device=None,
    ):
        frames = np.atleast_2d(host(bob_payload)).shape[0]
        rec = Reconciler(adapter.code, opts, lanes=min(SESSION_LANES, max(frames, 1)),
                         adapter=adapter, device=resolve_device(device))
        super().__init__(rec, bob_payload, alice_syndromes, qber_hint, reveal_step,
                         max_rounds)


def blind_reconcile(
    adapter: RateAdapter,
    bob_payload,  # [B, l] Bob's noisy payload bits
    alice_syndromes,  # [B, M]
    reveal: Callable[[np.ndarray], np.ndarray],
    qber_hint: float = 0.05,
    opts: DecodeOptions = DecodeOptions(),
    reveal_step: int | None = None,
    max_rounds: int | None = None,
    device=None,
) -> BlindResult:
    """Bob-side blind reconciliation loop (callback form).  ``reveal(positions)``
    is the Alice oracle: given frame positions (a [k] index array into the
    mother frame), return the true bits [B, k]."""
    s = BlindSession(
        adapter, bob_payload, alice_syndromes, qber_hint=qber_hint, opts=opts,
        reveal_step=reveal_step, max_rounds=max_rounds, device=device,
    )
    return s.run(lambda positions, frames: reveal(positions))


def blind_reconcile_sim(
    code: LDPCCode,
    alice_payload,  # [B, l]
    bob_payload,  # [B, l]
    n_punctured: int,
    qber_hint: float = 0.05,
    opts: DecodeOptions = DecodeOptions(),
    reveal_step: int | None = None,
    seed: int = 0,
    frame_key=None,
    device=None,
) -> tuple[BlindResult, np.ndarray]:
    """Simulation convenience: plays Alice (private punctured bits keyed by
    ``frame_key``, default ``PRNGKey(seed + 1)``; truthful reveals) and
    returns (result, keys_match oracle)."""
    device = resolve_device(device)
    adapter = RateAdapter.make(code, n_punctured=n_punctured, seed=seed)
    alice = np.atleast_2d(host(alice_payload, np.uint8))
    if frame_key is None:
        frame_key = prng_key(seed + 1)
    frames = adapter.build_frames(alice, frame_key, device=device)
    syn = adapter.syndromes(frames).cpu().numpy()
    frames_np = frames.cpu().numpy()

    def reveal(positions: np.ndarray) -> np.ndarray:
        return frames_np[:, positions]

    res = blind_reconcile(
        adapter, bob_payload, syn, reveal, qber_hint=qber_hint, opts=opts,
        reveal_step=reveal_step, device=device,
    )
    keys_match = (res.key == alice).all(axis=1) & res.ok
    return res, keys_match
