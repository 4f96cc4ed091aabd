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
- **Fused bit-node update**: the loop carries ``(tot_chk, Lr)`` instead of
  the bit-to-check messages; ``Lq = clip(tot_chk - Lr)`` is recomputed in
  registers inside the check kernel.  The first iteration is peeled so its
  check inputs are the *unclipped* a-priori LLRs.
- **Early exit** with per-frame convergence masks: frame b records
  ``iterations = it + 1`` on the iteration where its decision syndrome
  first equals the target.  ``lax.while_loop`` becomes a Python ``while``
  that fetches one flag per iteration (one host sync each; its cost is in
  PERF.md), ``lax.cond`` a Python ``if`` on a fetched flag.

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
      plain loop by the same rule; a base-row degree the kernel has no
      instance for raises (``cuda_layered.refusal``), as ``dc_max`` does
      for the flooding kernels.
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
    """The pieces of one dc-first decode iteration for a batch of width B."""

    def __init__(self, code: LDPCCode, opts: DecodeOptions, B: int, device):
        self.code, self.opts, self.B = code, opts, B
        self.N, self.M = code.n_vars, code.n_checks
        self.dv, self.dc = code.dv_max, code.dc_max
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

    def from_storage(self, q):
        """Message storage dtype -> float compute value."""
        return cuda_kernels._load(q, self.scale)

    def gather_chk(self, x):
        """[N, B] -> [dc, M, B] via the check adjacency."""
        return x.index_select(0, self.maps.chk_adj_T).view(self.dc, self.M, self.B)

    def route_var(self, Lr):
        """[dc, M, B] check messages -> [dv, N, B] variable-major."""
        flat = Lr.view(self.dc * self.M, self.B)
        if self.maps.var_has_pad:
            # Padded variable slots index the sentinel row dc*M: a zero.
            flat = torch.cat([flat, flat.new_zeros((1, self.B))], dim=0)
        return flat.index_select(0, self.maps.var_slot_T).view(
            self.dv, self.N, self.B
        )

    def check_update_first(self, Lq, syn_sign):
        """Iteration-1 check update on the (unclipped) a-priori gathers."""
        return cuda_kernels.check_update_first(
            Lq, self.maps.chk_mask_T_i32, syn_sign, **self.kernel_args
        )

    def check_update_fused(self, tot_chk, Lr_prev, syn_sign, fresh=None):
        """Bit-node update (Lq = clip(tot - Lr), in registers) + check update.

        ``fresh`` ([B] bool, optional) marks lanes whose (tot, Lr=0) state
        encodes a FIRST iteration: their recomputed Lq skips the clip, so a
        fresh lane's trajectory is identical to the peeled first iteration
        (the a-priori LLRs are never clipped).  Used by the continuation
        runner, where refilled lanes restart mid-batch.
        """
        return cuda_kernels.check_update_fused(
            tot_chk, Lr_prev, self.maps.chk_mask_T_i32, syn_sign, fresh=fresh,
            **self.kernel_args,
        )

    def after_check(self, Lr, llr, syndrome):
        """Route -> totals -> decision -> decision syndrome -> gathered totals.

        Decisions and the syndrome derive from the SAME storage-rounded
        totals (z on the variable side, parities on the gathered check
        side), so they are exactly consistent.
        """
        Lr_var = self.from_storage(self.route_var(Lr))
        acc = Lr_var[0]
        for k in range(1, self.dv):  # explicit adds in slot order
            acc = acc + Lr_var[k]
        total = self.to_storage(llr + acc)
        z = (total <= 0).to(torch.int8)  # total <= 0 -> bit 1
        tot_chk = self.gather_chk(total)
        z_chk = (tot_chk <= 0) & self.maps.chk_mask_T[:, :, None]
        syn_hat = z_chk.sum(dim=0, dtype=torch.int32) & 1
        ok = (syn_hat == syndrome).all(dim=0)  # [B]
        return tot_chk, z, ok


def _decode_loop(core, llr, syndrome, syn_sign, init, limit, frozen=None):
    """The shared early-exit iteration loop from a prepared carry.

    ``frozen`` ([B] bool, optional) marks lanes whose bookkeeping must
    never change (their z/iters/done are final) even though their stale
    message state is recomputed — the full-batch fallback phase of the
    compaction schedule runs with the compacted lanes frozen.
    """
    tot_chk, Lr, z_out, iters, done, it = init
    while it < limit:
        active = ~done if frozen is None else ~done & ~frozen
        if not bool(active.any()):  # the per-iteration host sync
            break
        Lr = core.check_update_fused(tot_chk, Lr, syn_sign)
        tot_chk, z, ok = core.after_check(Lr, llr, syndrome)
        z_out = torch.where(active[None, :], z, z_out)
        iters = torch.where(active, it + 1, iters)
        done = done | (active & ok)
        it += 1
    return tot_chk, Lr, z_out, iters, done, it


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
    core = _DecodeCore(code, opts, B, llr.device)
    llr = llr.contiguous()
    syndrome = syndrome.to(torch.int32).contiguous()
    syn_sign = torch.where(syndrome == 1, -1.0, 1.0)  # [M, B] float32

    # ---- peeled iteration 1: check inputs are the raw a-priori LLRs
    # (never clipped).
    Lq0 = core.gather_chk(core.to_storage(llr))
    Lr1 = core.check_update_first(Lq0, syn_sign)
    tot1, z1, ok1 = core.after_check(Lr1, llr, syndrome)
    ones = torch.ones((B,), dtype=torch.int32, device=llr.device)
    init = (tot1, Lr1, z1, ones, ok1, 1)  # every frame ran iteration 1

    B2 = opts.compact_lanes
    if not (0 < B2 < B and opts.compact_after < opts.max_iterations):
        *_, z_out, iters, done, _ = _decode_loop(
            core, llr, syndrome, syn_sign, init, opts.max_iterations
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
    tot_a, Lr_a, z_a, it_a, done_a, itc_a = _decode_loop(
        core, llr, syndrome, syn_sign, init, opts.compact_after
    )

    # Unconverged lanes first (the sort is stable: ties keep lane order);
    # when fewer than compact_lanes are unconverged the tail picks
    # already-done lanes, which the loop's masks keep inert.
    idx = torch.argsort(done_a.to(torch.int32), stable=True)[:B2]
    core_c = _DecodeCore(code, opts, B2, llr.device)
    init_c = (
        tot_a.index_select(2, idx), Lr_a.index_select(2, idx),
        z_a.index_select(1, idx), it_a[idx], done_a[idx], itc_a,
    )
    _, _, z_b, it_b, done_b, _ = _decode_loop(
        core_c, llr.index_select(1, idx), syndrome.index_select(1, idx),
        syn_sign.index_select(1, idx), init_c, opts.max_iterations,
    )

    # z_a / it_a / done_a are dead after this point: update them in place
    # instead of cloning [N, B] once more.
    z_full = z_a.index_copy_(1, idx, z_b)
    it_full = it_a.index_copy_(0, idx, it_b)
    done_full = done_a.index_copy_(0, idx, done_b)
    frozen = torch.zeros((B,), dtype=torch.bool, device=llr.device)
    frozen[idx] = True

    if bool((~done_full & ~frozen).any()):  # overflow: phase C
        carry = (tot_a, Lr_a, z_full, it_full, done_full, itc_a)
        *_, z_full, it_full, done_full, _ = _decode_loop(
            core, llr, syndrome, syn_sign, carry, opts.max_iterations,
            frozen=frozen,
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
