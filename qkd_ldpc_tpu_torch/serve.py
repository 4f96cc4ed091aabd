"""Production serving wrapper for the reconciliation step.

Counterpart of ``qkd_ldpc_tpu/serve.py``.  A deployed QKD post-processing
node is ONE side of the protocol with a network boundary in between; this
module packages that boundary as a long-lived object with a
serving-shaped contract:

- **One program, any request size**: a chunk of ``lanes`` frames is one
  device program (:class:`_ServeProgram`, JAX's ``_serve_step`` /
  ``_serve_step_adapted``; :class:`_SyndromeProgram`, its
  ``_syndrome_step``) over static buffers.  On the card under the kernel
  backend each endpoint captures it once as a CUDA graph that the endpoint
  owns (not ``device_loop.run_graph``'s shared cache, so a sweep on the same
  card cannot evict it); the LLR magnitude and the chunk's valid lanes are
  read from the chunk's input on the card, so neither a new channel
  estimate nor a ragged request captures again.
- **Pipelined chunks**: up to ``max_inflight_chunks`` chunks are in flight,
  each through a slot of pinned host memory: its rows are copied into the
  slot, then one copy to the card, one replay, one copy back into the slot
  and one CUDA event; a slot is refilled only after its chunk was fetched.
  The host's work hides under the card's decode, and the card's memory stays
  constant in the request size.
- **Host-friendly IO**: NumPy in, NumPy out.
- **Both roles**: :meth:`Reconciler.syndromes` is Alice's side,
  :meth:`Reconciler.reconcile` Bob's; ``leak_bits`` reports the
  information disclosed per frame for the privacy-amplification budget.
- **Full post-processing chain**: :meth:`Reconciler.reconcile_secure` runs
  reconcile -> verification tags -> privacy amplification in one call,
  with a per-frame leakage ledger (syndrome + tag bits) driving the final
  key length (``postprocess``); :meth:`Reconciler.tags` serves the Alice
  side of verification.
- **Rate adaptation**: ``rates=RateFamily(...)`` serves every member of a
  rate family over the mother code from one program — requests then carry
  payload bits, punctured positions are decoder-recovered erasures, and the
  leakage accounting follows the member.  The chunk's header carries the
  step, and the program takes that step's erasures and pins from a template
  on the card, so a change of rate captures nothing; a family of several
  members names its step in each call (``rate=``).  ``adapter=RateAdapter(...)``
  serves one adapted rate as the family of that one member
  (``RateFamily.single``, step 0).  A family binds to the endpoint's code by
  CONTENT fingerprint (``LDPCCode.fingerprint``), not shape.  The LLR
  assembly and the payload gather are part of the chunk's program.

``device=None`` means the card and raises without one; keys are the port's
int64 keys (``channel.threefry.key_from_words`` converts a JAX key).  The
CPU and ``backend="xla"`` run the same programs eagerly with the plain
versions, ``device_loop.eager_loops()`` eagerly with the kernels.

Example::

    rec = Reconciler(code, DecodeOptions(message_dtype="bfloat16"))
    rec.warmup()                        # optional: capture both programs now
    syn = rec.syndromes(alice_bits)     # Alice -> (classical channel)
    out = rec.reconcile(bob_bits, syn, qber=0.04)   # Bob
    corrected, ok = out.bits, out.syndromes_match
"""

from __future__ import annotations

import collections
import threading
import weakref
from typing import NamedTuple

import numpy as np
import torch

from qkd_ldpc_tpu_torch import _build
from qkd_ldpc_tpu_torch.channel.threefry import prng_key
from qkd_ldpc_tpu_torch.codes.ldpc_code import LDPCCode
from qkd_ldpc_tpu_torch.decoder import device_loop
from qkd_ldpc_tpu_torch.decoder.bp import DecodeOptions, decode_program
from qkd_ldpc_tpu_torch.decoder.rate_adapt import RateAdapter, RateFamily
from qkd_ldpc_tpu_torch.decoder.reconcile import llr_magnitude
from qkd_ldpc_tpu_torch.decoder.syndrome import syndrome as syndrome_fn
from qkd_ldpc_tpu_torch.postprocess import (
    amplified_key_bits,
    privacy_amplify,
    toeplitz_hash,
)
from qkd_ldpc_tpu_torch.spans import span
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


_TORCH_DTYPES = {np.dtype(np.uint8): torch.uint8, np.dtype(np.int8): torch.int8,
                 np.dtype(np.int32): torch.int32, np.dtype(bool): torch.bool}


class _Layout:
    """Fields ``(dtype, shape)`` of one byte buffer, each at a 16-byte
    aligned offset: a chunk's inputs or outputs, so that one copy moves them
    all.  :meth:`views` cuts a tensor (on the card) or a numpy array (a
    pinned host slot) into the fields."""

    def __init__(self, *fields):
        self.fields, offset = [], 0
        for dtype, shape in fields:
            dtype = np.dtype(dtype)
            n = int(np.prod(shape)) * dtype.itemsize
            self.fields.append((offset, n, dtype, shape))
            offset += -(-n // 16) * 16
        self.nbytes = offset

    def views(self, buf) -> list:
        if isinstance(buf, torch.Tensor):
            return [buf[o:o + n].view(_TORCH_DTYPES[d]).reshape(s)
                    for o, n, d, s in self.fields]
        return [buf[o:o + n].view(d).reshape(s) for o, n, d, s in self.fields]


# The int32 header of a chunk's input: the float32 bits of the a-priori LLR
# magnitude, the chunk's valid lanes and, on a rate-adapted endpoint, the step.
MAG, VALID, STEP = 0, 1, 2


def chunk_header(qber: float, valid: int, step: int | None = None) -> np.ndarray:
    """The int32 header of a chunk: the bits of
    ``reconcile.llr_magnitude(qber)`` (so the rounding is ``apriori_llr``'s)
    and the valid lane count (``[2]``), then the rate step where one is given
    (``[3]``)."""
    mag = np.asarray(llr_magnitude(qber), np.float32).reshape(1)
    head = [mag.view(np.int32)[0], valid] + ([] if step is None else [step])
    return np.array(head, np.int32)


class ServeCounters:
    """An endpoint's cumulative counts since it was made or :meth:`reset`:
    blocks (calls of ``reconcile``) by rate step (``None`` on an endpoint
    that serves one rate), frames, frame-iterations (a frame's iterations, the
    cap for a frame that did not converge), and from ``reconcile_secure``
    the frames verified and the final key bits of the verified frames."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.blocks_by_rate: dict = {}
        self.frames = self.frame_iterations = 0
        self.frames_verified = self.final_key_bits = 0


class _ServeProgram:
    """JAX's ``_serve_step`` / ``_serve_step_adapted``
    (``qkd_ldpc_tpu/serve.py:96-121``) over one chunk of ``lanes`` frames, on
    static byte buffers: eager (``graph=None``) or captured into a
    :class:`~qkd_ldpc_tpu_torch.decoder.device_loop.Graph`.

    Input (:attr:`inputs`): the header (:func:`chunk_header`, with the step
    where ``rates`` is a family), Bob's bits
    ``[lanes, frame_bits]`` uint8 and Alice's syndromes ``[lanes, M]``;
    output (:attr:`outputs`): iterations int32, flags bool and the corrected
    bits uint8 (payload bits on an adapted endpoint).  Lanes at or past the
    valid count decode zeros toward a zero syndrome, as JAX's padding does,
    and so converge at once whatever the buffer held before.  Everything that
    varies per chunk is read on the device, so one capture serves every
    request, QBER and rate step.

    With ``rates`` (a :class:`RateFamily`; ``None`` is the mother code) the
    LLRs are the step's member's: 0 at its punctured positions, the shared
    seed's +-64 at its shortened ones (both one row of
    ``RateFamily.pin_templates``, selected by the header's step on the
    device) and the channel's at the payload positions, which every member
    shares."""

    def __init__(self, code, opts, lanes, rates, shared_seed, device):
        self.decode, self.use_kernel, _ = decode_program(code, opts, device)
        self.code, self.lanes, self.rates = code, lanes, rates
        if rates is not None:
            F = rates.payload_bits
            self.key_idx = torch.as_tensor(rates.key_idx, dtype=torch.int64, device=device)
            self.mod_idx, self.templates = rates.pin_templates(shared_seed, device)
        else:
            F = code.n_vars
        self.inputs = _Layout((np.int32, (2 if rates is None else 3,)), (np.uint8, (lanes, F)),
                              (np.uint8, (lanes, code.n_checks)))
        self.outputs = _Layout((np.int32, (lanes,)), (bool, (lanes,)),
                               (np.uint8, (lanes, F)))
        self.lane = torch.arange(lanes, dtype=torch.int32, device=device)

    def __call__(self, inp: torch.Tensor, out: torch.Tensor, graph=None) -> None:
        x, bob, syn = self.inputs.views(inp)
        iters_out, ok_out, bits_out = self.outputs.views(out)
        mag = x[MAG:MAG + 1].view(torch.float32)
        keep = self.lane < x[VALID]
        channel = torch.where((bob.T == 1) & keep, -mag, mag)  # [frame_bits, B]
        if self.rates is None:
            llr = channel.contiguous()
        else:  # the channel, then the step's erasures and pins
            llr = torch.zeros((self.code.n_vars, self.lanes), dtype=torch.float32,
                              device=inp.device)
            llr.index_copy_(0, self.key_idx, channel)
            pins = self.templates.index_select(0, x[STEP:STEP + 1])  # [1, d]
            llr.index_copy_(0, self.mod_idx, pins.T.expand(-1, self.lanes).contiguous())
        s = torch.where(keep, syn.T, 0).to(torch.int8).contiguous()  # [M, B]
        z, iters, ok = self.decode(llr, s, graph)
        if self.rates is not None:
            z = z.index_select(0, self.key_idx)
        bits_out.copy_(z.T)
        iters_out.copy_(iters)
        ok_out.copy_(ok)


class _SyndromeProgram:
    """JAX's ``_syndrome_step`` (``qkd_ldpc_tpu/serve.py:123-125``) over one
    chunk of ``lanes`` full frames: input ``[lanes, N]`` uint8, output the
    syndromes ``[lanes, M]`` int8."""

    def __init__(self, code, opts, lanes, device):
        self.code = code
        # torch's ops only, captured where the endpoint's backend runs kernels
        self.use_kernel = _build.use_kernel(opts.backend, device)
        self.inputs = _Layout((np.uint8, (lanes, code.n_vars)))
        self.outputs = _Layout((np.int8, (lanes, code.n_checks)))

    def __call__(self, inp: torch.Tensor, out: torch.Tensor, graph=None) -> None:
        (bits,), (syn,) = self.inputs.views(inp), self.outputs.views(out)
        syn.copy_(syndrome_fn(self.code, bits))


class _Slot:
    """One chunk's host side: its input and output bytes (pinned when the
    endpoint is on the card, with numpy views of both) and the event
    recorded after its output copy."""

    def __init__(self, program, device):
        pin = device.type == "cuda"
        self.inp = torch.zeros(program.inputs.nbytes, dtype=torch.uint8, pin_memory=pin)
        self.out = torch.zeros(program.outputs.nbytes, dtype=torch.uint8, pin_memory=pin)
        self.inp_views = program.inputs.views(self.inp.numpy())
        self.out_views = program.outputs.views(self.out.numpy())
        self.event = torch.cuda.Event() if pin else None


class _Runner:
    """One program of an endpoint, its static buffers on the device and the
    ring of host slots that feeds it.

    On the card under the kernel backend (outside ``eager_loops()``) the
    program is captured at its first chunk into a ``device_loop.Graph`` that
    this runner owns for its lifetime; every chunk is then one copy in, one
    replay, one copy out and one event.  Otherwise it runs eagerly on the
    same buffers.  A capture that fails raises."""

    def __init__(self, program, device, loops):
        self.program, self.device, self.loops = program, device, loops
        self.static_in = torch.zeros(program.inputs.nbytes, dtype=torch.uint8, device=device)
        self.static_out = torch.zeros(program.outputs.nbytes, dtype=torch.uint8,
                                      device=device)
        self.graph = None
        self.slots: list[_Slot] = []

    def ring(self, n: int) -> list[_Slot]:
        """The first ``n`` slots (made at first need, then kept)."""
        while len(self.slots) < n:
            self.slots.append(_Slot(self.program, self.device))
        return self.slots[:n]

    def dispatch(self, slot: _Slot, rows: torch.Tensor | None = None) -> None:
        """Queue one chunk: the slot's input (or ``rows``, a contiguous tensor
        on the device) into the static input, the program, the static output
        into the slot's output, the slot's event.  Synchronises nothing once
        the program is captured."""
        src = slot.inp if rows is None else rows.reshape(-1)
        self.static_in[:src.numel()].copy_(src, non_blocking=True)
        if device_loop.graphs_on(self.program.use_kernel, self.device):
            if self.graph is None:
                self.graph = self._capture()
            self.graph.replay()
        else:
            self.program(self.static_in, self.static_out)
        slot.out.copy_(self.static_out, non_blocking=True)
        if slot.event is not None:
            slot.event.record()

    def fetch(self, slot: _Slot) -> list:
        """The slot's output fields (numpy), once its chunk has run."""
        with span("qkd.serve.wait"):
            if slot.event is not None:
                slot.event.synchronize()
        return slot.out_views

    def _capture(self) -> device_loop.Graph:
        program, static_in, static_out = self.program, self.static_in, self.static_out
        graph = device_loop.Graph(self.device, self.loops).capture(
            lambda g: program(static_in, static_out, g))
        graph.keep = (static_in, static_out, program)
        # when the endpoint goes, its graph's body counts join the host's
        weakref.finalize(self, graph.release).atexit = False
        return graph


class Reconciler:
    """Long-lived reconciliation endpoint bound to one code + options.

    ``lanes`` is the decode batch width; requests of any size are
    padded/chunked to it (any ``lanes >= 1``: a width the kernels' vectors
    do not divide runs their scalar instances).  Calls on one endpoint are
    serialised (its programs' buffers are shared)."""

    def __init__(
        self,
        code: LDPCCode,
        opts: DecodeOptions = DecodeOptions(),
        lanes: int = 128,
        adapter: RateAdapter | None = None,
        shared_seed: int = 0,
        device=None,
        rates: RateFamily | None = None,
    ):
        """``rates`` serves every member of a rate family over the mother
        ``code``, one program for all of them: requests then carry PAYLOAD
        bits (``rates.payload_bits`` per frame), punctured positions are
        erasures recovered by the decoder, ``shared_seed`` fixes the
        shortened pattern both sides derive, and each call of a family of
        several members names its step (``rate=``).  ``adapter`` serves one
        adapted rate: the family of that one member."""
        if lanes < 1:
            raise ValueError("lanes must be >= 1")
        if adapter is not None and rates is not None:
            raise ValueError("pass an adapter or a rate family, not both")
        if adapter is not None:
            rates = RateFamily.single(adapter)
        if rates is not None and rates.code is not code:
            if rates.code.fingerprint != code.fingerprint:
                raise ValueError(
                    "adapter was built for a different code (parity-check "
                    f"fingerprint {rates.code.fingerprint} != "
                    f"{code.fingerprint})"
                )
        self.device = resolve_device(device)
        self.code = code
        self.opts = opts
        self.lanes = lanes
        self.rates = rates
        self.shared_seed = shared_seed
        self.counters = ServeCounters()
        # Chunks allowed in flight before the oldest is fetched: enough to
        # hide the host's dispatch and fetch under the card's decode, small
        # enough that device memory stays constant in the request size.
        self.max_inflight_chunks = 4
        code.to_device(self.device)  # the index tensors, once
        self._lock = threading.Lock()
        self._runners: dict = {}

    @property
    def agile(self) -> bool:
        """Whether the endpoint serves several rate steps (a family of more
        than one member): its calls then name their step."""
        return self.rates is not None and self.rates.steps > 1

    @property
    def adapter(self) -> RateAdapter | None:
        """The one adapter of an endpoint that serves one adapted rate (else
        ``None``)."""
        return None if self.rates is None or self.agile else self.rates.members[0]

    @property
    def frame_bits(self) -> int:
        """Bits per request frame (payload bits when rate-adapted)."""
        return self.code.n_vars if self.rates is None else self.rates.payload_bits

    @property
    def syndrome_bits(self) -> int:
        return self.code.n_checks

    def _step(self, rate) -> int | None:
        """The call's rate step, checked: an agile endpoint needs one in
        ``[0, steps)``; any other endpoint takes none (one that serves a
        family of one member also takes 0)."""
        if self.agile:
            if rate is None:
                raise ValueError("a rate-agile endpoint needs the block's step (rate=)")
            if isinstance(rate, bool) or int(rate) != rate:
                raise ValueError(f"rate step {rate!r} is not a whole number")
            self.rates.member(int(rate))  # raises outside [0, steps)
            return int(rate)
        if rate is not None and not (self.rates is not None and rate == 0):
            raise ValueError("this endpoint serves one rate: pass no rate=")
        return None

    def _member(self, step: int | None) -> RateAdapter | None:
        """The family's member at ``step`` (step 0 for a family of one), or
        ``None`` on the mother code."""
        return None if self.rates is None else self.rates.member(step or 0)

    def leak(self, rate: int | None = None) -> int:
        """Information disclosed per frame by RECONCILIATION at ``rate``
        (syndrome bits, net of punctured entropy when rate-adapted: ``M -
        p``).  The secure chain adds tag bits on top (``reconcile_secure``)."""
        ad = self._member(self._step(rate))
        return self.code.n_checks if ad is None else ad.leak_bits

    @property
    def leak_bits(self) -> int:
        """:meth:`leak` of an endpoint that serves one rate (a rate-agile
        endpoint raises: its leak is the step's, ``leak(rate)``)."""
        return self.leak()

    def final_key_bits(self, tag_bits: int = 64, security_bits: int = 100,
                       rate: int | None = None) -> int:
        """Post-amplification key length per verified frame (at ``rate``)."""
        return amplified_key_bits(self.frame_bits, self.leak(rate), tag_bits,
                                  security_bits)

    def warmup(self) -> "Reconciler":
        """Run both directions once now (on the card this builds the
        kernels and captures both programs, which the first calls would
        otherwise pay for)."""
        bob = np.zeros((1, self.frame_bits), np.uint8)
        rate = 0 if self.agile else None
        syn = self.syndromes(bob, frame_key=prng_key(0), rate=rate)
        self.reconcile(bob, syn, qber=0.01, rate=rate)
        return self

    def _runner(self, kind: str) -> _Runner:
        """The endpoint's program ``kind`` ("serve" or "syndrome"): one per
        (schedule and options, lanes, family, shared seed), kept for the
        endpoint's lifetime (a program holds its family, so the id in the key
        stays unique)."""
        key = (kind, self.opts, self.lanes, id(self.rates), self.shared_seed)
        runner = self._runners.get(key)
        if runner is None:
            if kind == "serve":
                runner = _Runner(_ServeProgram(self.code, self.opts, self.lanes, self.rates,
                                               self.shared_seed, self.device),
                                 self.device, device_loop.LOOPS_PER_DECODE)
            else:
                runner = _Runner(_SyndromeProgram(self.code, self.opts, self.lanes, self.device),
                                 self.device, 0)
            self._runners[key] = runner
        return runner

    def _stream(self, runner: _Runner, n: int, fill, read) -> None:
        """Rows ``[0, n)`` through ``runner`` a chunk of ``lanes`` at a time,
        ``max_inflight_chunks`` in flight: ``fill(input views, off, chunk)``
        writes a chunk into its slot (or returns its rows on the device),
        ``read(output views, off, chunk)`` takes its results."""
        window = self.max_inflight_chunks
        if window < 1:
            raise ValueError("max_inflight_chunks must be >= 1")
        ring = runner.ring(window)
        pending = collections.deque()

        def fetch_oldest():
            off, chunk, slot = pending.popleft()
            views = runner.fetch(slot)
            with span("qkd.serve.read"):
                read(views, off, chunk)

        for k, off in enumerate(range(0, n, self.lanes)):
            chunk = min(self.lanes, n - off)
            slot = ring[k % window]  # its previous chunk was fetched
            with span("qkd.serve.fill"):
                rows = fill(slot.inp_views, off, chunk)
            with span("qkd.serve.dispatch"):
                runner.dispatch(slot, rows)
            pending.append((off, chunk, slot))
            if len(pending) == window:
                fetch_oldest()
        while pending:
            fetch_oldest()

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

    def syndromes(self, bits, frame_key=None, rate: int | None = None) -> np.ndarray:
        """Alice side: syndromes [n, M] of key frames [n, frame_bits] (or
        1-D).  Rate-adapted endpoints assemble the full mother-code frame
        first (a rate-agile one with the member of step ``rate``);
        ``frame_key`` supplies Alice's PRIVATE randomness for punctured
        positions (required when the adapter punctures)."""
        with span("qkd.serve.syndromes"):
            adapter = self._member(self._step(rate))
            arr, single = self._frames(bits)
            frames = None
            if adapter is not None:
                if adapter.punct_idx.size and frame_key is None:
                    raise ValueError(
                        "frame_key (Alice's private randomness for punctured "
                        "bits) is required on a punctured endpoint"
                    )
                frames = adapter.build_frames(
                    torch.as_tensor(arr, device=self.device),
                    frame_key if frame_key is not None else prng_key(0), self.shared_seed)
            out = np.empty((arr.shape[0], self.code.n_checks), np.int8)

            def fill(views, off, chunk):
                if frames is not None:
                    return frames[off:off + chunk]
                views[0][:chunk] = arr[off:off + chunk]
                return None

            def read(views, off, chunk):
                out[off:off + chunk] = views[0][:chunk]

            with self._lock:
                self._stream(self._runner("syndrome"), arr.shape[0], fill, read)
            return out[0] if single else out

    def tags(self, bits, tag_key, tag_bits: int = 64) -> np.ndarray:
        """Verification tags over key frames (either side; Alice transmits
        hers alongside the syndromes).  ``tag_key`` is shared protocol
        randomness — fresh per exchange."""
        arr, single = self._frames(bits)
        out = toeplitz_hash(arr, tag_key, tag_bits, device=self.device).cpu().numpy()
        return out[0] if single else out

    def reconcile(self, bob_bits, alice_syndromes, qber: float,
                  rate: int | None = None) -> ServeResult:
        """Bob side: correct noisy frames toward received syndromes (a
        rate-agile endpoint at the block's step ``rate``).

        ``syndromes_match[i]`` False means frame i did NOT verify — it must
        be discarded (or retried at a lower rate), never used as key
        material."""
        with span("qkd.serve.reconcile"):
            step = self._step(rate)
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

            n = bob.shape[0]
            bits = np.empty((n, self.frame_bits), np.uint8)
            iters = np.empty((n,), np.int32)
            ok = np.empty((n,), bool)

            head = chunk_header(qber, 0, None if self.rates is None else step or 0)

            def fill(views, off, chunk):
                header, b, s = views
                head[VALID] = chunk
                header[:] = head
                b[:chunk] = bob[off:off + chunk]
                s[:chunk] = syn[off:off + chunk]

            def read(views, off, chunk):
                it, okc, z = views
                bits[off:off + chunk] = z[:chunk]
                iters[off:off + chunk] = it[:chunk]
                ok[off:off + chunk] = okc[:chunk]

            with self._lock:
                self._stream(self._runner("serve"), n, fill, read)
                c = self.counters
                c.blocks_by_rate[step] = c.blocks_by_rate.get(step, 0) + 1
                c.frames += n
                c.frame_iterations += int(np.where(ok, iters, self.opts.max_iterations).sum(
                    dtype=np.int64))
            res = ServeResult(bits=bits, iterations=iters, syndromes_match=ok)
            if single:
                res = ServeResult(res.bits[0], res.iterations[0], res.syndromes_match[0])
            return res

    def reconcile_secure(self, bob_bits, alice_syndromes, qber: float, alice_tags,
                         tag_key, pa_key, tag_bits: int = 64,
                         security_bits: int = 100, rate: int | None = None) -> SecureResult:
        """The full Bob-side post-processing chain in one call: reconcile ->
        verification tags (compare against Alice's) -> privacy
        amplification, with the per-frame leakage ledger (syndrome
        disclosure + tag bits) setting the final key length (on a rate-agile
        endpoint, those of the block's step ``rate``).

        ``alice_tags`` [n, tag_bits] arrive over the classical channel;
        ``tag_key``/``pa_key`` are the shared hash seeds (fresh per
        exchange).  Returns amplified key material; use row i only where
        ``verified[i]``."""
        with span("qkd.serve.secure"):
            res = self.reconcile(bob_bits, alice_syndromes, qber, rate=rate)
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
            with span("qkd.secure.tags"):
                bob_tags = toeplitz_hash(x, tag_key, tag_bits).cpu().numpy()
                verified = syn_ok & (bob_tags == a_tags).all(axis=-1)

            final_bits = self.final_key_bits(tag_bits, security_bits, rate)
            with span("qkd.secure.amplify"):
                key = privacy_amplify(x, pa_key, final_bits).cpu().numpy()
            leak = np.full((n,), self.leak(rate) + tag_bits, np.int32)
            with self._lock:
                n_ok = int(verified.sum())
                self.counters.frames_verified += n_ok
                self.counters.final_key_bits += n_ok * final_bits
            out = SecureResult(
                key=key, verified=verified, iterations=np.atleast_1d(res.iterations),
                syndromes_match=syn_ok, leak_bits=leak, final_bits=final_bits,
            )
            if single:
                out = SecureResult(out.key[0], out.verified[0], out.iterations[0],
                                   out.syndromes_match[0], out.leak_bits[0], final_bits)
            return out
