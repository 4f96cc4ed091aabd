"""Batched syndrome-target belief-propagation decoding (flooding schedule;
``schedule="layered"`` dispatches to ``decoder/layered.py``).

Counterpart of ``qkd_ldpc_tpu/decoder/bp.py``; the design is the JAX
package's, restated for PyTorch:

- **One code path** for regular and irregular codes: padded index tensors
  + masks.
- **Scatter-free routing**: both directions of message exchange are
  ``index_select`` gathers with the code's static index tensors.
- **dc-first edge layout** ``[dc_max, M, B]`` with the frame axis last, so
  every plane of a slot is contiguous and the kernels' accesses coalesce
  along B.
- **An iteration is two kernels** (``decoder/cuda_kernels.py``): the
  variable update turns the check messages ``Lr`` into the totals ``total
  [N, B]``, the decisions and the iteration counts of the active frames;
  the check update reads ``total`` through the check adjacency, recomputes
  ``Lq = clip(total - Lr)`` in registers, writes the next ``Lr`` and
  returns the decision syndrome of the totals it read.  The loop carries
  ``Lr`` alone from one iteration to the next; no gathered ``[dc, M, B]``
  copy of the totals is made and no tensor pass touches the messages.  The
  JAX package orders an iteration check-then-variable; here it is
  variable-then-check, so the syndrome flag arrives in the iteration it
  belongs to and the launch that yields it already holds the next
  iteration's messages (unused after the last one).  The first check
  update is peeled so its inputs are the *unclipped* a-priori LLRs.
- **One loop for both backends**: under ``backend="xla"`` and on the CPU
  the same calls run the plain versions.
- **Early exit** with per-frame convergence masks: frame b stops counting
  on the iteration where its decision syndrome first equals the target.
  The loop and the residency compaction around it are
  ``device_loop.run_schedule``, which the layered schedule shares; this
  module supplies the flooding pass and state (``_Lanes``).
- **One device program per decode**, as the JAX package's ``jit``: on the
  card the kernel backend captures the whole decode (peeled K1, the loops,
  the compaction's ops) as one CUDA graph per (code, B, options, card)
  and replays it, so a decode makes no host round trip between its input
  and its output; a trial chunk (``sim/runner.py``) captures the same
  program once per batch inside its own graph (:func:`decode_program`).
  ``lax.while_loop`` becomes a WHILE node whose condition the pass's check
  update sets on the card (its last block runs the loop's bookkeeping),
  ``lax.cond`` (phase C) a WHILE node whose entry test is the cond's
  predicate (``decoder/device_loop.py``).
  The same program runs eagerly on the CPU, under ``backend="xla"``, and in
  ``device_loop.eager_loops()`` (the eager kernel loop the graph is held
  against); there the loop fetches its condition after every pass.

The decision rule is ``total <= 0 -> bit = 1``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from qkd_ldpc_tpu_torch import _build
from qkd_ldpc_tpu_torch.codes.ldpc_code import LDPCCode
from qkd_ldpc_tpu_torch.decoder import cuda_kernels, device_loop
from qkd_ldpc_tpu_torch.decoder.layered import layered_program
from qkd_ldpc_tpu_torch.utils import resolve_device


class DecodeResult(NamedTuple):
    """Per-frame decode outcome (batch-first)."""

    bits: torch.Tensor  # [B, N] int8 hard decisions
    iterations: torch.Tensor  # [B] int32; == max_iterations when not converged
    syndromes_match: torch.Tensor  # [B] bool


@dataclasses.dataclass(frozen=True)
class DecodeOptions:
    """Static decoder knobs — the JAX package's fields and validation, as an
    own copy, so one config runs on both packages.

    What differs in meaning here:

    - ``backend``: ``"xla"`` = the plain PyTorch versions, ``"pallas"`` =
      the hand-written CUDA kernels (raises for CPU tensors), ``"auto"`` =
      the kernels on ``cuda``, plain on ``cpu``.
    - ``routing``: all three accepted values take the index gather; the
      block-roll path of the JAX package exists for the TPU's gather cost
      and is bit-identical to the gather there.  ``"roll"`` still requires
      a QC code.
    - ``schedule="layered"`` (QC codes only) runs ``decoder/layered.py``;
      under it ``backend`` chooses between the CUDA sweep kernel and the
      plain loop by the same rule; every check degree and base-row
      degree from 2 up runs on the kernels.
    """

    max_iterations: int = 100
    clip_messages: bool = True
    message_threshold: float = 100.0
    algorithm: str = "sum-product"  # "sum-product" | "min-sum"
    min_sum_alpha: float = 0.8  # normalized min-sum scaling
    min_sum_beta: float = 0.0  # offset min-sum (0 disables)
    # Storage dtype of the edge-message state (Lr and the gathered totals);
    # transcendentals and totals compute in float32.  "int8" stores
    # uniformly quantized fixed point, int8_scale LLR units per LSB,
    # saturating at +-127*scale.
    message_dtype: str = "float32"  # "float32" | "bfloat16" | "int8"
    int8_scale: float = 0.25
    backend: str = "auto"  # "auto" | "xla" | "pallas"
    routing: str = "auto"  # "auto" | "gather" | "roll"
    # Residency compaction: a batch pays its MAX iteration count.  With
    # compact_after=k > 0 the loop runs k iterations, gathers the
    # unconverged minority into compact_lanes lanes and finishes only
    # those; a full-batch fallback covers more unconverged lanes than
    # compact_lanes.  Trajectories, decisions and iteration counts are
    # bit-identical to the plain loop for every lane.
    compact_after: int = 0  # iterations before compaction (0 = off)
    compact_lanes: int = 0  # compacted batch width (e.g. B // 4)
    schedule: str = "flooding"  # "flooding" | "layered"

    def __post_init__(self):
        if self.max_iterations < 1:
            # The first iteration is peeled (it always runs), so a cap
            # below 1 would report iterations=1 > cap.
            raise ValueError("max_iterations must be >= 1")
        if self.algorithm not in ("sum-product", "min-sum"):
            raise ValueError(f"Unknown algorithm {self.algorithm!r}")
        if self.message_dtype not in ("float32", "bfloat16", "int8"):
            raise ValueError(f"Unknown message_dtype {self.message_dtype!r}")
        if self.message_dtype == "int8" and self.int8_scale <= 0:
            raise ValueError("int8_scale must be > 0")
        if self.backend not in ("auto", "xla", "pallas"):
            raise ValueError(f"Unknown backend {self.backend!r}")
        if self.routing not in ("auto", "gather", "roll"):
            raise ValueError(f"Unknown routing {self.routing!r}")
        if self.compact_after < 0 or self.compact_lanes < 0:
            raise ValueError("compaction parameters must be >= 0")
        if (self.compact_after > 0) != (self.compact_lanes > 0):
            raise ValueError(
                "compact_after and compact_lanes must be set together"
            )
        if self.schedule not in ("flooding", "layered"):
            raise ValueError(f"Unknown schedule {self.schedule!r}")

    def resolve_backend(self, device) -> str:
        """``"pallas"`` (CUDA kernels) or ``"xla"`` (plain) for ``device``."""
        use = _build.use_kernel(self.backend, torch.device(device))
        return "pallas" if use else "xla"


class _DecodeCore:
    """The pieces of one decode iteration on ``device``: the two kernels
    (or their plain versions) bound to a code and its decode options."""

    def __init__(self, code: LDPCCode, opts: DecodeOptions, device):
        self.device = torch.device(device)
        self.backend = opts.resolve_backend(self.device)
        self.mdt = cuda_kernels.STORAGE_DTYPES[opts.message_dtype]
        self.scale = opts.int8_scale if opts.message_dtype == "int8" else None
        if opts.routing == "roll" and code.qc is None:
            raise ValueError("routing='roll' requires a QC code (codes.qc)")
        self.maps = code.to_device(self.device)
        self.kernel_args = dict(
            backend=self.backend, threshold=opts.message_threshold,
            clip=opts.clip_messages, algorithm=opts.algorithm,
            min_sum_alpha=opts.min_sum_alpha, min_sum_beta=opts.min_sum_beta,
            scale=self.scale,
        )

    def to_storage(self, x):
        """Float compute value -> message storage dtype."""
        return cuda_kernels._store(x, self.mdt, self.scale)

    @property
    def use_kernel(self) -> bool:
        return self.backend == "pallas"

    def scratch(self, B: int):
        """The check kernel's loop-instance scratch for ``B`` frames, or None
        (the plain versions and the unrolled degrees need none)."""
        dc, M = self.maps.chk_mask_T.shape
        shape = (cuda_kernels.check_scratch_shape(dc, M, B, self.kernel_args["algorithm"],
                                                  self.mdt)
                 if self.use_kernel else None)
        return None if shape is None else torch.empty(
            shape, dtype=torch.float32, device=self.device)

    def check_update_first(self, total0, syn, scratch=None):
        """Iteration-1 check update on the (unclipped) a-priori LLRs, given
        in storage type ``[N, B]``; returns ``Lr``."""
        return cuda_kernels.check_update_first(
            total0, syn, self.maps, scratch=scratch, **self.kernel_args
        )

    def check_update_fused(self, total, Lr_prev, syn, fresh=None, ok=None, out=None,
                           scratch=None, step=None):
        """Bit-node update (Lq = clip(total - Lr), in registers) + check
        update + decision syndrome of ``total``; returns ``(Lr, ok)``.

        ``fresh`` ([B] bool, optional) marks lanes whose (total, Lr=0) state
        encodes a FIRST iteration: their recomputed Lq skips the clip, so a
        fresh lane's trajectory is identical to the peeled first iteration
        (the a-priori LLRs are never clipped), and their ``ok`` is False.
        Used by the continuation runner, where refilled lanes restart
        mid-batch.  ``ok`` is the all-True flag buffer that
        :meth:`variable_update` returned (the kernel clears flags in it).
        ``step`` (``device_loop.LoopTail``) is the loop's bookkeeping over
        those flags, run after the update.
        """
        return cuda_kernels.check_update_fused(
            total, Lr_prev, syn, self.maps, fresh=fresh, ok=ok, out=out,
            scratch=scratch, step=step, **self.kernel_args
        )

    def variable_update(self, Lr, llr, z, count, active, out=None, fold=None):
        """Route -> totals -> decision: ``(total, z, count, ok)`` with ``z``
        and ``count`` moved on the ``active`` frames only (in place by the
        kernel) and ``ok`` all True, for the check update to clear.  Decisions and the syndrome that the next check update
        returns derive from the SAME storage-rounded totals, so they are
        exactly consistent.  ``fold`` (``cuda_kernels.PassFold``) runs the
        previous pass's bookkeeping first (the continuation's segment)."""
        return cuda_kernels.variable_update(
            Lr, llr, z, count, active, self.maps, backend=self.backend,
            scale=self.scale, out=out, fold=fold,
        )


class _Lanes(device_loop.Lanes):
    """A batch's flooding state on its lanes: messages ``Lr``, the totals
    buffer, decisions ``z``, counts ``iters``, the loop's flags, and the
    inputs they decode."""

    mode = device_loop.FLOODING

    def __init__(self, core, llr, syn, Lr, z, iters, done, it):
        self.core, self.llr, self.syn = core, llr, syn
        self.Lr, self.z, self.iters = Lr, z, iters
        super().__init__(done, it, core.use_kernel)
        self.total = torch.empty(llr.shape, dtype=core.mdt, device=llr.device)
        self.scratch = core.scratch(llr.shape[1])

    def pass_(self, tail):
        """One iteration: variable update (z and iters move on the active
        lanes), then the check update IN PLACE over ``Lr``, whose flags land
        in ``loop.ok`` and which runs the loop's bookkeeping ``tail`` after
        them.  Allocates nothing."""
        core, loop = self.core, self.loop
        core.variable_update(self.Lr, self.llr, self.z, self.iters, loop.active,
                             out=(self.total, loop.ok))
        core.check_update_fused(self.total, self.Lr, self.syn, ok=loop.ok, out=self.Lr,
                                scratch=self.scratch, step=tail)

    def gather(self, idx, done):
        return _Lanes(self.core, self.llr.index_select(1, idx), self.syn.index_select(1, idx),
                      self.Lr.index_select(2, idx), self.z.index_select(1, idx),
                      self.iters.index_select(0, idx), done.index_select(0, idx),
                      self.loop.it.clone())

    def scatter(self, idx, part):
        self.z.index_copy_(1, idx, part.z)
        self.iters.index_copy_(0, idx, part.iters)


def _flooding_program(core, llr, syn, opts, graph):
    """The flooding decode of ``llr [N, B]`` float32 toward ``syn [M, B]``
    int8: eagerly (``graph=None``) or as the capture into ``graph``.
    Returns ``(z [N, B] int8, iters [B] int32, done [B] bool)``."""
    N, B = llr.shape
    dev = llr.device

    def zeros(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=dev)

    # ---- peeled first check update: its inputs are the raw a-priori LLRs
    # (never clipped).  Every frame then runs iteration 1 in the loop.
    lanes = _Lanes(core, llr, syn, None, zeros((N, B), torch.int8),
                   zeros((B,), torch.int32), zeros((B,), torch.bool),
                   zeros((1,), torch.int32))
    lanes.Lr = core.check_update_first(core.to_storage(llr), syn, scratch=lanes.scratch)
    device_loop.run_schedule(lanes, opts, graph)
    done = lanes.loop.done
    # Frames that never converged report max_iterations.
    return lanes.z, torch.where(done, lanes.iters, opts.max_iterations), done


def decode_program(code: LDPCCode, opts: DecodeOptions, device):
    """The decode of ``opts.schedule`` on ``device`` as one program:
    ``(run, use_kernel, keep)``, ``run(llr [N, B] float32, syn [M, B] int8,
    graph)`` decoding eagerly (``graph=None``) or as the capture into
    ``graph`` (which may hold other work too: a trial chunk captures one
    decode per batch), ``keep`` what its captured pointers point into."""
    if opts.schedule == "layered":
        return layered_program(code, opts, device)
    core = _DecodeCore(code, opts, device)

    def run(llr, syn, graph):
        return _flooding_program(core, llr, syn, opts, graph)

    return run, core.use_kernel, core


def bp_decode_batch_last(
    code: LDPCCode,
    llr: torch.Tensor,  # [N, B] float32 a-priori LLRs (batch last)
    syndrome: torch.Tensor,  # [M, B] int target syndrome (batch last)
    opts: DecodeOptions,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Core batched decode loop of ``opts.schedule`` on the tensors' device;
    returns (z [N,B] int8, iters [B] int32, ok [B] bool).  On the card under
    the kernel backend the decode is one replay of a captured CUDA graph."""
    return device_loop.batch_last_decode(opts.schedule, decode_program, code, llr, syndrome,
                                         opts)


def decode(
    code: LDPCCode,
    llr,  # [B, N] or [N] float32
    syndrome,  # [B, M] or [M]
    opts: DecodeOptions = DecodeOptions(),
    device=None,
) -> DecodeResult:
    """Decode a batch of frames toward target syndromes (batch-first API).

    ``device=None`` means the card and raises when there is none.
    """
    device = resolve_device(device)
    llr = torch.as_tensor(llr).to(device)
    syndrome = torch.as_tensor(syndrome).to(device)
    single = llr.ndim == 1
    if single:
        llr, syndrome = llr[None, :], syndrome[None, :]
    z, iters, ok = bp_decode_batch_last(code, llr.T, syndrome.T, opts)
    res = DecodeResult(bits=z.T, iterations=iters, syndromes_match=ok)
    if single:
        res = DecodeResult(res.bits[0], res.iterations[0], res.syndromes_match[0])
    return res
