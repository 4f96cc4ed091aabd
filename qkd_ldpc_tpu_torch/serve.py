"""Production serving wrapper for the reconciliation step.

Counterpart of ``qkd_ldpc_tpu/serve.py``.  A deployed QKD post-processing
node is ONE side of the protocol with a network boundary in between; this
module packages that boundary as a long-lived object with a
serving-shaped contract:

- **Any request size**: requests are padded and chunked to ``lanes``
  frames, so every decode has the same shape.  Up to
  ``max_inflight_chunks`` chunks are in flight: chunk k+1 is dispatched
  (host-to-card copy through pinned memory, LLRs, one replay of the decode
  graph, a copy back into pinned memory behind a CUDA event) before chunk k
  is fetched, so the host's dispatch hides under the card's decode and the
  card's memory stays bounded by the window, not the request.
- **Host-friendly IO**: NumPy in, NumPy out.
- **Both roles**: :meth:`Reconciler.syndromes` is Alice's side,
  :meth:`Reconciler.reconcile` Bob's; ``leak_bits`` reports the
  information disclosed per frame for the privacy-amplification budget.
- **Full post-processing chain**: :meth:`Reconciler.reconcile_secure` runs
  reconcile -> verification tags -> privacy amplification in one call,
  with a per-frame leakage ledger (syndrome + tag bits) driving the final
  key length (``postprocess``); :meth:`Reconciler.tags` serves the Alice
  side of verification.
- **Rate adaptation**: ``adapter=RateAdapter(...)`` serves an adapted rate
  over the mother code — requests then carry payload bits, punctured
  positions are decoder-recovered erasures, and the leakage accounting
  follows the adapter.  Adapters bind to the endpoint's code by CONTENT
  fingerprint (``LDPCCode.fingerprint``), not shape.

``device=None`` means the card and raises without one; keys are the port's
int64 keys (``channel.threefry.key_from_words`` converts a JAX key).

Example::

    rec = Reconciler(code, DecodeOptions(message_dtype="bfloat16"))
    syn = rec.syndromes(alice_bits)     # Alice -> (classical channel)
    out = rec.reconcile(bob_bits, syn, qber=0.04)   # Bob
    corrected, ok = out.bits, out.syndromes_match
"""

from __future__ import annotations

import collections
from typing import NamedTuple

import numpy as np
import torch

from qkd_ldpc_tpu_torch.channel.threefry import prng_key
from qkd_ldpc_tpu_torch.codes.ldpc_code import LDPCCode
from qkd_ldpc_tpu_torch.decoder.bp import DecodeOptions, bp_decode_batch_last
from qkd_ldpc_tpu_torch.decoder.rate_adapt import RateAdapter
from qkd_ldpc_tpu_torch.decoder.reconcile import apriori_llr
from qkd_ldpc_tpu_torch.decoder.syndrome import syndrome as syndrome_fn
from qkd_ldpc_tpu_torch.postprocess import (
    amplified_key_bits,
    privacy_amplify,
    toeplitz_hash,
)
from qkd_ldpc_tpu_torch.utils import host, resolve_device


class ServeResult(NamedTuple):
    """Host-side reconciliation outcome (NumPy)."""

    bits: np.ndarray  # [n, frame_bits] uint8 corrected key (payload
    # bits on a rate-adapted endpoint)
    iterations: np.ndarray  # [n] int32
    syndromes_match: np.ndarray  # [n] bool — verify before using the key!


class SecureResult(NamedTuple):
    """Outcome of the full post-processing chain (NumPy)."""

    key: np.ndarray  # [n, final_bits] uint8 amplified key material
    verified: np.ndarray  # [n] bool: syndromes matched AND tags matched.
    # Use key[i] ONLY where verified[i].
    iterations: np.ndarray  # [n] int32
    syndromes_match: np.ndarray  # [n] bool (pre-verification)
    leak_bits: np.ndarray  # [n] int32 per-frame disclosure ledger
    final_bits: int  # columns of `key`


class Reconciler:
    """Long-lived reconciliation endpoint bound to one code + options.

    ``lanes`` is the decode batch width; requests of any size are
    padded/chunked to it (any ``lanes >= 1``: a width the kernels' vectors
    do not divide runs their scalar instances)."""

    def __init__(
        self,
        code: LDPCCode,
        opts: DecodeOptions = DecodeOptions(),
        lanes: int = 128,
        adapter: RateAdapter | None = None,
        shared_seed: int = 0,
        device=None,
    ):
        """``adapter`` serves an adapted rate over the mother ``code``:
        requests then carry PAYLOAD bits (``adapter.payload_bits`` per
        frame), punctured positions are erasures recovered by the decoder,
        and ``shared_seed`` fixes the shortened pattern both sides derive."""
        if lanes < 1:
            raise ValueError("lanes must be >= 1")
        if adapter is not None and adapter.code is not code:
            if adapter.code.fingerprint != code.fingerprint:
                raise ValueError(
                    "adapter was built for a different code (parity-check "
                    f"fingerprint {adapter.code.fingerprint} != "
                    f"{code.fingerprint})"
                )
        self.device = resolve_device(device)
        self.code = code
        self.opts = opts
        self.lanes = lanes
        self.adapter = adapter
        self.shared_seed = shared_seed
        # Chunks allowed in flight before the oldest is fetched: enough to
        # hide the host's dispatch and fetch under the card's decode, small
        # enough that device memory stays constant in the request size.
        self.max_inflight_chunks = 4
        code.to_device(self.device)  # the index tensors, once

    @property
    def frame_bits(self) -> int:
        """Bits per request frame (payload bits when rate-adapted)."""
        if self.adapter is not None:
            return self.adapter.payload_bits
        return self.code.n_vars

    @property
    def syndrome_bits(self) -> int:
        return self.code.n_checks

    @property
    def leak_bits(self) -> int:
        """Information disclosed per frame by RECONCILIATION (syndrome
        bits, net of punctured entropy when rate-adapted).  The secure
        chain adds tag bits on top (``reconcile_secure``)."""
        if self.adapter is not None:
            return self.adapter.leak_bits
        return self.code.n_checks

    def final_key_bits(self, tag_bits: int = 64, security_bits: int = 100) -> int:
        """Post-amplification key length per verified frame."""
        return amplified_key_bits(self.frame_bits, self.leak_bits, tag_bits,
                                  security_bits)

    def warmup(self) -> "Reconciler":
        """Run both directions once now (on the card this builds the
        kernels and captures the decode graph, which the first call would
        otherwise pay for)."""
        bob = np.zeros((1, self.frame_bits), np.uint8)
        syn = self.syndromes(bob, frame_key=prng_key(0))
        self.reconcile(bob, syn, qber=0.01)
        return self

    def _frames(self, bits) -> tuple[np.ndarray, bool]:
        arr = host(bits, np.uint8)
        single = arr.ndim == 1
        if single:
            arr = arr[None]
        if arr.shape[-1] != self.frame_bits:
            raise ValueError(
                f"expected {self.frame_bits}-bit frames, got {arr.shape[-1]}"
            )
        return arr, single

    def syndromes(self, bits, frame_key=None) -> np.ndarray:
        """Alice side: syndromes [n, M] of key frames [n, frame_bits] (or
        1-D).  Rate-adapted endpoints assemble the full mother-code frame
        first; ``frame_key`` supplies Alice's PRIVATE randomness for
        punctured positions (required when the adapter punctures)."""
        arr, single = self._frames(bits)
        x = torch.as_tensor(arr, device=self.device)
        if self.adapter is not None:
            if self.adapter.punct_idx.size and frame_key is None:
                raise ValueError(
                    "frame_key (Alice's private randomness for punctured "
                    "bits) is required on a punctured endpoint"
                )
            x = self.adapter.build_frames(
                x, frame_key if frame_key is not None else prng_key(0),
                self.shared_seed)
        out = syndrome_fn(self.code, x).cpu().numpy()
        return out[0] if single else out

    def tags(self, bits, tag_key, tag_bits: int = 64) -> np.ndarray:
        """Verification tags over key frames (either side; Alice transmits
        hers alongside the syndromes).  ``tag_key`` is shared protocol
        randomness — fresh per exchange."""
        arr, single = self._frames(bits)
        out = toeplitz_hash(arr, tag_key, tag_bits, device=self.device).cpu().numpy()
        return out[0] if single else out

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        """A host array on the endpoint's device; onto the card through
        pinned memory without waiting (torch keeps the pinned block until
        the copy has run)."""
        x = torch.from_numpy(np.ascontiguousarray(arr))
        if self.device.type != "cuda":
            return x.to(self.device)
        return x.pin_memory().to(self.device, non_blocking=True)

    def _dispatch(self, bob: np.ndarray, syn: np.ndarray, qber: float):
        """Queue one padded chunk: decode on the device and the copy of its
        results back to the host; returns what :meth:`_fetch` needs."""
        b = self._to_device(bob)
        s = self._to_device(syn).to(torch.int8)
        if self.adapter is not None:
            llr = self.adapter.llr(b, qber, self.shared_seed)
        else:
            llr = apriori_llr(b, qber)
        z, iters, ok = bp_decode_batch_last(self.code, llr.T, s.T, self.opts)
        bits = z.T
        if self.adapter is not None:
            bits = self.adapter.payload(bits)
        outs = (bits.to(torch.uint8), iters, ok)
        if self.device.type != "cuda":
            return outs, None
        host_outs = tuple(torch.empty(o.shape, dtype=o.dtype, pin_memory=True) for o in outs)
        for h, o in zip(host_outs, outs):
            h.copy_(o, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return host_outs, done

    @staticmethod
    def _fetch(pending) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        outs, done = pending
        if done is not None:
            done.synchronize()
        return tuple(o.numpy() for o in outs)

    def reconcile(self, bob_bits, alice_syndromes, qber: float) -> ServeResult:
        """Bob side: correct noisy frames toward received syndromes.

        ``syndromes_match[i]`` False means frame i did NOT verify — it must
        be discarded (or retried at a lower rate), never used as key
        material."""
        bob, single = self._frames(bob_bits)
        syn = host(alice_syndromes)
        if single:
            syn = syn[None]
        if syn.shape != (bob.shape[0], self.syndrome_bits):
            raise ValueError(
                f"expected syndromes [{bob.shape[0]}, {self.syndrome_bits}], "
                f"got {syn.shape}"
            )
        if not (0.0 < qber < 1.0):
            raise ValueError("qber must be in (0, 1)")
        if self.max_inflight_chunks < 1:
            raise ValueError("max_inflight_chunks must be >= 1")

        n = bob.shape[0]
        bits = np.empty((n, self.frame_bits), np.uint8)
        iters = np.empty((n,), np.int32)
        ok = np.empty((n,), bool)
        # A bounded window of chunks in flight (each with output tensors of
        # its own): chunk k+1's dispatch hides under chunk k's decode.
        pending = collections.deque()

        def fetch_one():
            off, chunk, work = pending.popleft()
            z, it, okc = self._fetch(work)
            bits[off:off + chunk] = z[:chunk]
            iters[off:off + chunk] = it[:chunk]
            ok[off:off + chunk] = okc[:chunk]

        for off in range(0, n, self.lanes):
            chunk = min(self.lanes, n - off)
            pad = ((0, self.lanes - chunk), (0, 0))
            pending.append((off, chunk, self._dispatch(
                np.pad(bob[off:off + chunk], pad), np.pad(syn[off:off + chunk], pad),
                qber)))
            if len(pending) >= self.max_inflight_chunks:
                fetch_one()
        while pending:
            fetch_one()
        res = ServeResult(bits=bits, iterations=iters, syndromes_match=ok)
        if single:
            res = ServeResult(res.bits[0], res.iterations[0], res.syndromes_match[0])
        return res

    def reconcile_secure(self, bob_bits, alice_syndromes, qber: float, alice_tags,
                         tag_key, pa_key, tag_bits: int = 64,
                         security_bits: int = 100) -> SecureResult:
        """The full Bob-side post-processing chain in one call: reconcile ->
        verification tags (compare against Alice's) -> privacy
        amplification, with the per-frame leakage ledger (syndrome
        disclosure + tag bits) setting the final key length.

        ``alice_tags`` [n, tag_bits] arrive over the classical channel;
        ``tag_key``/``pa_key`` are the shared hash seeds (fresh per
        exchange).  Returns amplified key material; use row i only where
        ``verified[i]``."""
        res = self.reconcile(bob_bits, alice_syndromes, qber)
        single = host(bob_bits).ndim == 1
        bits = np.atleast_2d(res.bits)
        syn_ok = np.atleast_1d(res.syndromes_match)
        a_tags = np.atleast_2d(host(alice_tags, np.uint8))
        n = bits.shape[0]
        if a_tags.shape != (n, tag_bits):
            raise ValueError(
                f"expected alice_tags [{n}, {tag_bits}], got {a_tags.shape}"
            )
        x = torch.as_tensor(bits, device=self.device)
        bob_tags = toeplitz_hash(x, tag_key, tag_bits).cpu().numpy()
        verified = syn_ok & (bob_tags == a_tags).all(axis=-1)

        final_bits = self.final_key_bits(tag_bits, security_bits)
        key = privacy_amplify(x, pa_key, final_bits).cpu().numpy()
        leak = np.full((n,), self.leak_bits + tag_bits, np.int32)
        out = SecureResult(
            key=key, verified=verified, iterations=np.atleast_1d(res.iterations),
            syndromes_match=syn_ok, leak_bits=leak, final_bits=final_bits,
        )
        if single:
            out = SecureResult(out.key[0], out.verified[0], out.iterations[0],
                               out.syndromes_match[0], out.leak_bits[0], final_bits)
        return out
