"""Rate-adaptive reconciliation: puncturing + shortening over one code.

Counterpart of ``qkd_ldpc_tpu/decoder/rate_adapt.py``.  A production QKD
post-processor holds ONE mother code and adapts its effective rate to the
drifting channel with the standard puncturing/shortening construction
(Elkouss et al., "Rate compatible protocol for information
reconciliation"; Martinez-Mateo et al.).  Rate adaptation is pure LLR
bookkeeping over the unmodified decoder:

- An N-bit mother-code frame is split into ``key`` positions (the
  payload, l = N - p - s), ``punctured`` positions (p bits Alice fills
  from her PRIVATE randomness; Bob knows nothing about them — erasures,
  LLR 0 — and recovers them through the code constraints), and
  ``shortened`` positions (s bits both sides derive from a SHARED seed —
  known, LLR +-64).
- Alice transmits the M-bit syndrome of the full frame; Bob decodes his
  noisy payload toward it and takes the corrected key from the payload
  positions.
- Effective rate on the payload channel: ``R_eff = 1 - (M - p) / (N - p -
  s)``; the conservative leakage is ``M - p`` bits per frame.

A link whose QBER drifts changes rate block by block with a
:class:`RateFamily`: a fixed number ``d = p + s`` of modulated positions
whose split between punctured and shortened moves on a grid, the split
chosen by both sides from the QBER estimate (:func:`rate_step`).  Its members
share the payload positions, so one serving program takes the step as data
(``serve.Reconciler(rates=...)``).

Both sides derive the positions from a seeded numpy permutation and the
random bits from the threefry stream of ``channel/threefry.py`` — the same
positions and bits as the JAX package for the same seeds and keys, so a
JAX Alice and a PyTorch Bob (or the reverse) agree.  Keys are the port's
int64 keys (``threefry.key_from_words`` converts a JAX key).  Tensors stay
on the device they come in on; numpy inputs go to ``device`` (``None`` =
the card, which raises without one).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from qkd_ldpc_tpu_torch.channel.keys import block_words
from qkd_ldpc_tpu_torch.channel.threefry import bernoulli_half, prng_key
from qkd_ldpc_tpu_torch.codes.ldpc_code import LDPCCode
from qkd_ldpc_tpu_torch.decoder.bp import DecodeOptions, decode
from qkd_ldpc_tpu_torch.decoder.reconcile import apriori_llr
from qkd_ldpc_tpu_torch.decoder.syndrome import syndrome as syndrome_fn
from qkd_ldpc_tpu_torch.utils import resolve_device, tensor_on

# LLR magnitude pinning a shortened (known) bit.  Large enough to dominate
# any channel LLR, small enough to stay exact in bf16 and below the default
# +-100 message clip.
_KNOWN_LLR = 64.0


def pinned_llr(bits: torch.Tensor) -> torch.Tensor:
    """Known bits -> their pinned LLRs (float32): -64 for a 1, +64 for a 0."""
    return torch.where(bits == 1, -_KNOWN_LLR, _KNOWN_LLR).to(torch.float32)


@dataclasses.dataclass(frozen=True)
class RateAdapter:
    """Puncturing/shortening plan over a mother code (both sides build the
    identical plan from ``(code, n_punctured, n_shortened, seed)``)."""

    code: LDPCCode
    key_idx: np.ndarray  # [l] payload positions
    punct_idx: np.ndarray  # [p] punctured positions
    short_idx: np.ndarray  # [s] shortened positions
    # Device tensors made from the plan, by (what, device): the index arrays
    # and the pinned LLRs of a shared seed's short pattern, uploaded once.
    _on_device: dict = dataclasses.field(default_factory=dict, init=False, repr=False,
                                         compare=False)

    @staticmethod
    def make(
        code: LDPCCode,
        n_punctured: int = 0,
        n_shortened: int = 0,
        seed: int = 0,
        punctured: np.ndarray | None = None,
        shortened: np.ndarray | None = None,
    ) -> "RateAdapter":
        N = code.n_vars
        if punctured is not None or shortened is not None:
            p_idx = np.asarray(punctured if punctured is not None else [], np.int64)
            s_idx = np.asarray(shortened if shortened is not None else [], np.int64)
        else:
            d = n_punctured + n_shortened
            if d >= N:
                raise ValueError("punctured + shortened must leave payload bits")
            perm = np.random.default_rng(seed).permutation(N)
            p_idx = np.sort(perm[:n_punctured])
            s_idx = np.sort(perm[n_punctured:d])
        both = np.concatenate([p_idx, s_idx])
        if both.size != np.unique(both).size:
            raise ValueError("punctured and shortened positions overlap")
        if both.size and (both.min() < 0 or both.max() >= N):
            raise ValueError("position out of range")
        mask = np.ones(N, bool)
        mask[both] = False
        return RateAdapter(
            code=code,
            key_idx=np.flatnonzero(mask),
            punct_idx=np.asarray(p_idx, np.int64),
            short_idx=np.asarray(s_idx, np.int64),
        )

    # --- accounting --------------------------------------------------------

    @property
    def payload_bits(self) -> int:
        return self.key_idx.size

    @property
    def effective_rate(self) -> float:
        """R_eff = 1 - (M - p) / (N - p - s) on the payload channel."""
        return 1.0 - (self.code.n_checks - self.punct_idx.size) / self.payload_bits

    @property
    def leak_bits(self) -> int:
        """Syndrome bits minus punctured entropy: the (conservative)
        disclosure per frame for privacy amplification."""
        return self.code.n_checks - self.punct_idx.size

    def _cached(self, what, device, make) -> torch.Tensor:
        key = (what, torch.device(device))
        t = self._on_device.get(key)
        if t is None:
            t = self._on_device[key] = make()
        return t

    def _index(self, name: str, device) -> torch.Tensor:
        """The positions ``name`` (``"key_idx"``, ...) as int64 on ``device``."""
        return self._cached(name, device, lambda: torch.as_tensor(
            getattr(self, name), dtype=torch.int64, device=device))

    def payload(self, frames: torch.Tensor) -> torch.Tensor:
        """The payload positions of full frames: [B, N] -> [B, l]."""
        return frames[:, self._index("key_idx", frames.device)]

    # --- frame construction (Alice side / simulation) ----------------------

    def build_frames(self, key_bits, frame_key: torch.Tensor, shared_seed: int = 0,
                     device=None) -> torch.Tensor:
        """Assemble full N-bit frames [B, l] -> [B, N] (uint8); the punctured
        bits are ``bernoulli(frame_key, 0.5, (B, p))``, Alice's private
        randomness."""
        key_bits = tensor_on(key_bits, device, torch.uint8)
        dev = key_bits.device
        B = key_bits.shape[0]
        frame = torch.zeros((B, self.code.n_vars), dtype=torch.uint8, device=dev)
        frame[:, self._index("key_idx", dev)] = key_bits
        if self.punct_idx.size:
            pb = bernoulli_half(block_words(frame_key, (B, self.punct_idx.size), dev))
            frame[:, self._index("punct_idx", dev)] = pb
        if self.short_idx.size:
            frame[:, self._index("short_idx", dev)] = self.short_pattern(
                shared_seed, dev)[None, :]
        return frame

    def short_pattern(self, shared_seed: int = 0, device=None) -> torch.Tensor:
        """The shared known bit pattern for the shortened positions
        (``bernoulli(PRNGKey(shared_seed), 0.5, (s,))``), uint8 on ``device``
        (None = the card)."""
        dev = resolve_device(device)
        if not self.short_idx.size:
            return torch.zeros((0,), dtype=torch.uint8, device=dev)
        return bernoulli_half(block_words(prng_key(shared_seed), (self.short_idx.size,), dev))

    def syndromes(self, frames) -> torch.Tensor:
        """Alice -> Bob transmission: syndromes of the full frames."""
        return syndrome_fn(self.code, tensor_on(frames))

    # --- Bob side -----------------------------------------------------------

    def llr(self, bob_key_bits, qber, shared_seed: int = 0, device=None) -> torch.Tensor:
        """Full-frame LLRs: channel LLRs at payload positions, 0 at
        punctured (erasure), +-_KNOWN_LLR at shortened (known bits).  The
        positions and the pinned LLRs are made once per device (and seed),
        so on the card a call queues its work without a host round trip."""
        bob = tensor_on(bob_key_bits, device, torch.uint8)
        dev = bob.device
        llr = torch.zeros((bob.shape[0], self.code.n_vars), dtype=torch.float32, device=dev)
        llr[:, self._index("key_idx", dev)] = apriori_llr(bob, qber)
        if self.short_idx.size:
            llr[:, self._index("short_idx", dev)] = self._cached(
                ("short_llr", shared_seed), dev,
                lambda: pinned_llr(self.short_pattern(shared_seed, dev)))[None, :]
        return llr

    def reconcile(self, bob_key_bits, alice_syndromes, qber,
                  opts: DecodeOptions = DecodeOptions(), shared_seed: int = 0,
                  device=None):
        """Bob: decode toward Alice's syndromes; returns (key [.., l] uint8,
        iterations, syndromes_match)."""
        bob = tensor_on(bob_key_bits, device, torch.uint8)
        single = bob.ndim == 1
        bob = torch.atleast_2d(bob)
        syn = torch.atleast_2d(tensor_on(alice_syndromes, bob.device))
        res = decode(self.code, self.llr(bob, qber, shared_seed), syn, opts,
                     device=bob.device)
        key = self.payload(res.bits).to(torch.uint8)
        if single:
            return key[0], res.iterations[0], res.syndromes_match[0]
        return key, res.iterations, res.syndromes_match


def binary_entropy(q: float) -> float:
    """``h(q) = -q log2 q - (1 - q) log2 (1 - q)`` for ``0 < q < 1``."""
    if not 0.0 < q < 1.0:
        raise ValueError("qber must be in (0, 1)")
    return -q * math.log2(q) - (1.0 - q) * math.log2(1.0 - q)


def rate_step(n_vars: int, n_checks: int, d: int, grid: int, qber: float,
              efficiency: float) -> int:
    """The step of a rate family for a QBER estimate: the punctured count
    ``p = M - f h(q) (N - d)`` that makes ``R_eff = 1 - f h(q)``, rounded
    DOWN to the grid (the lower rate, the safe side) and clamped to
    ``[0, d]``; returns ``p // grid``.  Both sides call it with the same
    arguments."""
    if efficiency <= 0:
        raise ValueError("efficiency must be positive")
    p = n_checks - efficiency * binary_entropy(qber) * (n_vars - d)
    p = math.floor(p / grid) * grid
    return min(max(p, 0), d) // grid


@dataclasses.dataclass(frozen=True)
class RateFamily:
    """Rate-compatible members over one mother code and one set of ``d``
    modulated positions: member ``i`` punctures ``p_i = i * grid`` of them and
    shortens the other ``d - p_i``, exactly
    ``RateAdapter.make(code, n_punctured=p_i, n_shortened=d - p_i, seed)``.
    The modulated positions are the seeded permutation's first ``d`` whatever
    the split, so every member has the same payload positions and differs
    only in which modulated positions are erasures and which are pins.  A
    family of one member (:meth:`single`) is that adapter."""

    code: LDPCCode
    d: int
    grid: int
    members: tuple  # RateAdapter of step i at index i

    @staticmethod
    def make(code: LDPCCode, d: int, seed: int = 0, grid: int = 64) -> "RateFamily":
        if grid < 1 or d < 0 or d % grid:
            raise ValueError("the grid must be a positive divisor of d")
        members = tuple(RateAdapter.make(code, n_punctured=p, n_shortened=d - p, seed=seed)
                        for p in range(0, d + 1, grid))
        return RateFamily(code=code, d=d, grid=grid, members=members)

    @staticmethod
    def single(adapter: RateAdapter) -> "RateFamily":
        """The family whose one member (step 0) is ``adapter``."""
        d = adapter.punct_idx.size + adapter.short_idx.size
        return RateFamily(code=adapter.code, d=d, grid=max(d, 1), members=(adapter,))

    @property
    def steps(self) -> int:
        return len(self.members)

    @property
    def key_idx(self) -> np.ndarray:
        return self.members[0].key_idx

    @property
    def payload_bits(self) -> int:
        return self.members[0].payload_bits

    def member(self, step: int) -> RateAdapter:
        if not 0 <= step < self.steps:
            raise ValueError(f"rate step {step} outside [0, {self.steps})")
        return self.members[step]

    def step(self, qber: float, efficiency: float) -> int:
        """:func:`rate_step` for this family's code, ``d`` and grid."""
        if self.steps == 1:
            return 0
        return rate_step(self.code.n_vars, self.code.n_checks, self.d, self.grid, qber,
                         efficiency)

    def pin_templates(self, shared_seed: int, device) -> tuple[torch.Tensor, torch.Tensor]:
        """``(mod_idx [d] int64, templates [steps, d] float32)`` on ``device``:
        the modulated positions in ascending order and, for each step, the
        LLR each of them takes — 0 where the member punctures it (an
        erasure), the shared seed's pinned +-64 where it shortens it."""
        mod = np.sort(np.concatenate([self.members[0].punct_idx,
                                      self.members[0].short_idx]))
        mod_idx = torch.as_tensor(mod, dtype=torch.int64, device=device)
        templates = torch.zeros((self.steps, self.code.n_vars), dtype=torch.float32,
                                device=device)
        for i, ad in enumerate(self.members):
            if ad.short_idx.size:
                templates[i, ad._index("short_idx", device)] = pinned_llr(
                    ad.short_pattern(shared_seed, device))
        return mod_idx, templates.index_select(1, mod_idx).contiguous()
