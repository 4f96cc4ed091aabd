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
  ``lax.while_loop`` becomes a Python ``while`` that fetches one flag per
  iteration (one host sync each; its cost is in PERF.md), ``lax.cond`` a
  Python ``if`` on a fetched flag.

The decision rule is ``total <= 0 -> bit = 1``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from qkd_ldpc_tpu_torch import _build
from qkd_ldpc_tpu_torch.codes.ldpc_code import LDPCCode
from qkd_ldpc_tpu_torch.decoder import cuda_kernels
from qkd_ldpc_tpu_torch.decoder.layered import layered_decode_batch_last
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

    def check_update_first(self, total0, syn):
        """Iteration-1 check update on the (unclipped) a-priori LLRs, given
        in storage type ``[N, B]``; returns ``Lr``."""
        return cuda_kernels.check_update_first(
            total0, syn, self.maps, **self.kernel_args
        )

    def check_update_fused(self, total, Lr_prev, syn, fresh=None, ok=None):
        """Bit-node update (Lq = clip(total - Lr), in registers) + check
        update + decision syndrome of ``total``; returns ``(Lr, ok)``.

        ``fresh`` ([B] bool, optional) marks lanes whose (total, Lr=0) state
        encodes a FIRST iteration: their recomputed Lq skips the clip, so a
        fresh lane's trajectory is identical to the peeled first iteration
        (the a-priori LLRs are never clipped), and their ``ok`` is False.
        Used by the continuation runner, where refilled lanes restart
        mid-batch.  ``ok`` is the all-True flag buffer that
        :meth:`variable_update` returned (the kernel clears flags in it).
        """
        return cuda_kernels.check_update_fused(
            total, Lr_prev, syn, self.maps, fresh=fresh, ok=ok, **self.kernel_args
        )

    def variable_update(self, Lr, llr, z, count, active):
        """Route -> totals -> decision: ``(total, z, count, ok)`` with ``z``
        and ``count`` moved on the ``active`` frames only (in place by the
        kernel) and ``ok`` all True, for the check update to clear.  Decisions and the syndrome that the next check update
        returns derive from the SAME storage-rounded totals, so they are
        exactly consistent."""
        return cuda_kernels.variable_update(
            Lr, llr, z, count, active, self.maps, backend=self.backend,
            scale=self.scale,
        )


def _decode_loop(core, llr, syn, init, limit, frozen=None):
    """The shared early-exit iteration loop from a prepared carry
    ``(Lr, z_out, iters, done, it)``: ``Lr`` holds the check messages of
    iteration ``it + 1``, whose variable update is still to run.

    ``frozen`` ([B] bool, optional) marks lanes whose bookkeeping must
    never change (their z/iters/done are final) even though their stale
    message state is recomputed — the full-batch fallback phase of the
    compaction schedule runs with the compacted lanes frozen.
    """
    Lr, z_out, iters, done, it = init
    while it < limit:
        active = ~done if frozen is None else ~(done | frozen)
        if not bool(active.any()):  # the per-iteration host sync
            break
        total, z_out, iters, ok = core.variable_update(Lr, llr, z_out, iters, active)
        Lr, ok = core.check_update_fused(total, Lr, syn, ok=ok)
        done = torch.where(active, ok, done)
        it += 1
    return Lr, z_out, iters, done, it


def bp_decode_batch_last(
    code: LDPCCode,
    llr: torch.Tensor,  # [N, B] float32 a-priori LLRs (batch last)
    syndrome: torch.Tensor,  # [M, B] int target syndrome (batch last)
    opts: DecodeOptions,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Core batched decode loop on the tensors' device; returns
    (z [N,B] int8, iters [B] int32, ok [B] bool)."""
    if opts.schedule == "layered":
        return layered_decode_batch_last(code, llr, syndrome, opts)
    if llr.dtype != torch.float32 or llr.ndim != 2:
        raise ValueError("llr must be float32 [N, B]")
    B = llr.shape[1]
    core = _DecodeCore(code, opts, llr.device)
    llr = llr.contiguous()
    syn = syndrome.to(torch.int8).contiguous()  # [M, B] target bits

    # ---- peeled first check update: its inputs are the raw a-priori LLRs
    # (never clipped).  Every frame then runs iteration 1 in the loop.
    Lr1 = core.check_update_first(core.to_storage(llr), syn)
    init = (
        Lr1, torch.zeros((code.n_vars, B), dtype=torch.int8, device=llr.device),
        torch.zeros((B,), dtype=torch.int32, device=llr.device),
        torch.zeros((B,), dtype=torch.bool, device=llr.device), 0,
    )

    B2 = opts.compact_lanes
    if not (0 < B2 < B and opts.compact_after < opts.max_iterations):
        _, z_out, iters, done, _ = _decode_loop(
            core, llr, syn, init, opts.max_iterations
        )
        # Frames that never converged report max_iterations.
        iters = torch.where(done, iters, opts.max_iterations)
        return z_out, iters, done

    # ---- residency-compaction schedule.  Phase A runs compact_after
    # iterations on the full batch; phase B gathers the unconverged
    # minority into compact_lanes lanes and finishes only those; phase C
    # (a full-batch fallback that runs only if more than compact_lanes
    # lanes were unconverged) continues any overflow lanes from their
    # phase-A state with the compacted lanes' bookkeeping frozen.  Every
    # lane's trajectory is the plain loop's, merely re-scheduled.
    Lr_a, z_a, it_a, done_a, itc_a = _decode_loop(
        core, llr, syn, init, opts.compact_after
    )

    # Unconverged lanes first (the sort is stable: ties keep lane order);
    # when fewer than compact_lanes are unconverged the tail picks
    # already-done lanes, which the loop's masks keep inert.
    idx = torch.argsort(done_a.to(torch.int32), stable=True)[:B2]
    init_c = (
        Lr_a.index_select(2, idx), z_a.index_select(1, idx), it_a[idx],
        done_a[idx], itc_a,
    )
    _, z_b, it_b, done_b, _ = _decode_loop(
        core, llr.index_select(1, idx), syn.index_select(1, idx), init_c,
        opts.max_iterations,
    )

    # z_a / it_a / done_a are dead after this point: update them in place
    # instead of cloning [N, B] once more.
    z_full = z_a.index_copy_(1, idx, z_b)
    it_full = it_a.index_copy_(0, idx, it_b)
    done_full = done_a.index_copy_(0, idx, done_b)
    frozen = torch.zeros((B,), dtype=torch.bool, device=llr.device)
    frozen[idx] = True

    if bool((~done_full & ~frozen).any()):  # overflow: phase C
        carry = (Lr_a, z_full, it_full, done_full, itc_a)
        _, z_full, it_full, done_full, _ = _decode_loop(
            core, llr, syn, carry, opts.max_iterations, frozen=frozen,
        )
    iters = torch.where(done_full, it_full, opts.max_iterations)
    return z_full, iters, done_full


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
