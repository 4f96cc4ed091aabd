"""Blind reconciliation: interactive rate adaptation without a QBER estimate.

Counterpart of ``qkd_ldpc_tpu/decoder/blind.py`` (Martinez-Mateo,
Elkouss, Martin, "Blind reconciliation", QIC 2012).  Start with all d
modulated positions PUNCTURED (the highest rate); on decode failure Alice
progressively REVEALS punctured bits — converting them into shortened
(known) positions — until Bob's decode verifies or the budget is
exhausted.  Leakage is adaptive per frame, accounted conservatively as
``M - d + 2 * revealed_i``.

Each round is one batched decode (``decoder.bp.decode``, the kernels on
the card) with updated LLRs; frames that already verified decode from
their pinned decisions in later rounds (they converge on the first
iteration) and their keys and leakage stop changing.  Bookkeeping is
numpy on the host, as in the JAX package; the LLRs live on the session's
device (``device=None`` = the card, which raises without one).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from qkd_ldpc_tpu_torch.channel.threefry import prng_key
from qkd_ldpc_tpu_torch.codes.ldpc_code import LDPCCode
from qkd_ldpc_tpu_torch.decoder.bp import DecodeOptions, decode
from qkd_ldpc_tpu_torch.decoder.rate_adapt import RateAdapter, pinned_llr
from qkd_ldpc_tpu_torch.decoder.reconcile import apriori_llr
from qkd_ldpc_tpu_torch.postprocess import privacy_amplify, toeplitz_hash
from qkd_ldpc_tpu_torch.utils import host, resolve_device


class BlindResult(NamedTuple):
    key: np.ndarray  # [B, l] uint8 corrected payload
    ok: np.ndarray  # [B] bool — verified frames (use ONLY these)
    rounds: np.ndarray  # [B] int32 — reveal rounds consumed per frame
    leak_bits: np.ndarray  # [B] int32 — per-frame disclosure
    iterations: np.ndarray  # [B] int32 — decode iterations of the final round


class SecureBlindResult(NamedTuple):
    """Outcome of the full blind post-processing chain.  Frames carry RAGGED
    final key lengths: row i's key material is ``key[i, :final_bits[i]]``,
    everything past it is zeroed (a prefix of Toeplitz rows is itself a
    2-universal Toeplitz hash)."""

    key: np.ndarray  # [B, max(final_bits)] uint8 amplified key material
    final_bits: np.ndarray  # [B] int32 per-frame length (0 if unverified)
    verified: np.ndarray  # [B] bool: syndromes AND tags matched
    rounds: np.ndarray  # [B] int32 reveal rounds consumed
    leak_bits: np.ndarray  # [B] int32 ledger: syndrome net of punctured
    # entropy + 2x reveals + tag bits
    iterations: np.ndarray  # [B] int32


class BlindSession:
    """Endpoint-shaped Bob-side blind reconciliation, with control
    INVERTED for serving: the caller owns the classical channel::

        s = BlindSession(adapter, bob_payload, alice_syndromes)
        pos = s.begin()                 # None, or positions to request
        while pos is not None:
            pos = s.provide(values)     # Alice's bits for `pos`, [B, k]
        out = s.result()                # BlindResult

    ``adapter`` must be all-punctured (``n_shortened == 0``): its punctured
    positions are the reveal budget.  ``qber_hint`` only shapes the channel
    LLR magnitude.
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
        if adapter.short_idx.size:
            raise ValueError("blind reconciliation starts all-punctured")
        self.d = d = adapter.punct_idx.size
        if d == 0:
            raise ValueError("adapter has no punctured budget to reveal")
        self.adapter = adapter
        self.opts = opts
        self.device = resolve_device(device)
        self.step = reveal_step or max(1, d // 4)
        self.n_rounds = max_rounds if max_rounds is not None else -(-d // self.step)

        bob = torch.atleast_2d(torch.as_tensor(host(bob_payload, np.uint8)))
        self.syn = torch.atleast_2d(torch.as_tensor(host(alice_syndromes))).to(
            self.device)
        B = bob.shape[0]
        self._key_idx = torch.as_tensor(adapter.key_idx, device=self.device)
        self.llr = torch.zeros((B, adapter.code.n_vars), dtype=torch.float32,
                               device=self.device)
        self.llr[:, self._key_idx] = apriori_llr(bob.to(self.device), qber_hint)

        self.key = np.zeros((B, adapter.payload_bits), np.uint8)
        self.ok = np.zeros((B,), bool)
        self.rounds = np.zeros((B,), np.int32)
        self.iters = np.zeros((B,), np.int32)
        self.revealed = 0
        self.r = 0
        self._pending: np.ndarray | None = None
        self._finished = False
        # Pinned decisions of verified frames ([B, N]): later rounds decode a
        # verified frame from them, so it converges on the first iteration
        # and stops extending the batch's loop.  Bookkeeping only ever reads
        # a frame's FIRST verifying round, so results are unchanged.
        self._frozen_llr = None

    def begin(self) -> np.ndarray | None:
        """Run round 0; returns positions to request from Alice, or None
        when every frame already verified (or no budget/rounds)."""
        if self.r != 0 or self._pending is not None:
            raise RuntimeError("begin() must be the first call, once")
        return self._decode_round()

    def provide(self, values) -> np.ndarray | None:
        """Feed Alice's bits [B, k] for the last requested positions; runs
        the next round.  Returns the next request or None (done)."""
        if self._pending is None:
            raise RuntimeError("no pending reveal request")
        pos = self._pending
        self._pending = None
        values = torch.as_tensor(host(values, np.uint8), device=self.device)
        self.llr[:, torch.as_tensor(pos, device=self.device)] = pinned_llr(values)
        self.revealed += pos.size
        self.r += 1
        return self._decode_round()

    def result(self) -> BlindResult:
        if not self._finished:
            raise RuntimeError("session still has pending rounds")
        # Per-frame leakage: syndrome entropy net of the still-secret
        # punctured bits at the frame's finishing round, plus the revealed
        # values themselves.
        M = self.adapter.code.n_checks
        leak = M - self.d + 2 * np.minimum(self.rounds * self.step, self.d).astype(np.int32)
        return BlindResult(key=self.key, ok=self.ok, rounds=self.rounds,
                           leak_bits=leak, iterations=self.iters)

    def finalize(self, alice_tags, tag_key, pa_key, tag_bits: int = 64,
                 security_bits: int = 100) -> SecureBlindResult:
        """Complete the secure chain on a finished session: verification
        tags (compared against Alice's) -> privacy amplification, with the
        per-frame ADAPTIVE leakage ledger (reveals included) setting each
        frame's final key length.  All frames hash through the same
        max-length Toeplitz matrix; frame i keeps its first
        ``final_bits[i]`` output bits."""
        res = self.result()  # raises unless finished
        B = res.key.shape[0]
        a_tags = np.atleast_2d(host(alice_tags, np.uint8))
        if a_tags.shape != (B, tag_bits):
            raise ValueError(f"expected alice_tags [{B}, {tag_bits}], got {a_tags.shape}")
        bob_tags = toeplitz_hash(res.key, tag_key, tag_bits, device=self.device)
        verified = res.ok & (bob_tags.cpu().numpy() == a_tags).all(axis=-1)

        # Per-frame ledger: reconciliation disclosure (syndrome net of
        # still-punctured entropy + 2x reveals) + the tag.
        leak = res.leak_bits + tag_bits
        payload = self.adapter.payload_bits
        final = np.maximum(payload - leak - security_bits, 0).astype(np.int32)
        final[~verified] = 0
        max_bits = int(final.max()) if B else 0
        if max_bits > 0:
            key = privacy_amplify(res.key, pa_key, max_bits, device=self.device)
            col = np.arange(max_bits)[None, :]
            key = np.where(col < final[:, None], key.cpu().numpy(), 0).astype(np.uint8)
        else:
            key = np.zeros((B, 0), np.uint8)
        return SecureBlindResult(
            key=key, final_bits=final, verified=verified, rounds=res.rounds,
            leak_bits=leak, iterations=res.iterations,
        )

    def _decode_round(self) -> np.ndarray | None:
        llr_use = self.llr if self._frozen_llr is None else torch.where(
            torch.as_tensor(self.ok, device=self.device)[:, None], self._frozen_llr,
            self.llr)
        res = decode(self.adapter.code, llr_use, self.syn, self.opts, device=self.device)
        ok_now = res.syndromes_match.cpu().numpy()
        iters_now = res.iterations.cpu().numpy()
        newly = ok_now & ~self.ok
        if newly.any():
            key_hat = res.bits[:, self._key_idx].to(torch.uint8).cpu().numpy()
            self.key[newly] = key_hat[newly]
            self.rounds[newly] = self.r
            self.iters[newly] = iters_now[newly]
            self.ok |= newly
            pinned = pinned_llr(res.bits)
            self._frozen_llr = pinned if self._frozen_llr is None else torch.where(
                torch.as_tensor(newly, device=self.device)[:, None], pinned,
                self._frozen_llr)
        if self.ok.all() or self.revealed >= self.d or self.r == self.n_rounds:
            self.iters[~self.ok] = iters_now[~self.ok]
            self.rounds[~self.ok] = self.r
            self._finished = True
            return None
        self._pending = np.asarray(
            self.adapter.punct_idx[self.revealed:self.revealed + self.step])
        return self._pending


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
    pos = s.begin()
    while pos is not None:
        pos = s.provide(reveal(pos))
    return s.result()


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
