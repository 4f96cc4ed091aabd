"""Intra-frame node-sharded BP decoding: one frame's variables split over
the devices of a mesh row.

Counterpart of ``qkd_ldpc_tpu/parallel/node_sharded.py``, with its design:

- The variable nodes of a frame are split into contiguous blocks over the
  ``node`` axis; N is padded with isolated dummy variables (no edges, LLR
  pinned at +1), so any code runs on any mesh.  Every per-variable tensor
  lives on its shard in variable-major layout: a-priori LLRs ``[Nl, B]``,
  totals ``[Nl, B]`` and check messages ``Lr [Nl, dv, B]``.  The loop
  carries ``(total, Lr)`` and recomputes ``Lq = clip(total - Lr)``; totals
  and ``Lr`` round through the message storage type (float32, bfloat16, or
  int8 fixed point ``round(x / scale)``) at the single-device loop's points,
  and ``Lq`` never does.
- A check's update needs all its edges, which straddle shards.  Each shard
  reduces its own edges into per-check partials ``[M, B]`` (JAX's
  ``segment_sum``/``segment_min``: here one gather of the shard's edges into
  check-major slots ``[dc, M, B]`` and a reduction over the slots, which adds
  floats in the same order on every run where an atomic ``index_add_`` on
  the card would not), and one collective a check update completes them:
  for sum-product the sum of the log-magnitude and sign-count rows, for
  min-sum a gather of every shard's top-2 candidates (value as monotonic
  int32 float bits, plus the check-major slot of the minimum, so the
  excluded edge is the FIRST occurrence of the row minimum as in the
  single-device decoder).  A second, integer collective sums the decision
  parities for the syndrome check.
- A collective is :func:`parallel.mesh.row_gather`: every shard's partial
  on each device of the row, reduced there in shard order (within a
  process explicit copies, none where the shards share a card; across
  processes one gloo ``all_gather`` of the partials' bytes over the row's
  group).  Every process of a row thus reduces the same bits in the same
  order, and a row that spans processes gives the bits of one process's.

Min-sum is bit-identical to the single-device decoder on any mesh: its
reductions (minima, integer sign counts) are exact.  Sum-product forms the
leave-one-out product as ``exp`` of a log-sum (no product across shards
exists without logs) where the single-device kernels multiply prefix and
suffix products, so the two agree to float32 rounding: decisions and
iterations are held equal, and a rare boundary frame may converge one
iteration earlier or later (ROADMAP C).

The JAX module has no Pallas kernel: it is XLA there and plain PyTorch here.
Flooding only; the compaction fields of ``DecodeOptions`` are ignored.
"""

from __future__ import annotations

import weakref

import numpy as np
import torch

from qkd_ldpc_tpu_torch.codes.ldpc_code import LDPCCode
from qkd_ldpc_tpu_torch.decoder.bp import DecodeOptions, DecodeResult
from qkd_ldpc_tpu_torch.decoder.cuda_kernels import STORAGE_DTYPES, _load, _store
from qkd_ldpc_tpu_torch.parallel.mesh import (
    NODE_AXIS,
    TRIAL_AXIS,
    Mesh,
    Row,
    all_gather_cat,
    process_count,
    row_gather,
    run_on_shards,
    trial_sharding,
)

_TINY = 1e-30
_INF_BITS = 0x7F800000  # float bits of +inf: the cap of every minimum


def _sum(x):
    return x.sum(0)


def _sum_i32(x):
    return x.sum(0, dtype=torch.int32)


def _min(x):
    return x.amin(0)


class _Shard:
    """The static tensors of one node shard on its device."""

    def __init__(self, plan, s, device):
        def put(x, dtype):
            return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype).to(device)

        rows = slice(s * plan["n_local"], (s + 1) * plan["n_local"])
        mask = plan["var_mask"][rows]
        self.device = device
        self.n_local, self.m = plan["n_local"], plan["m"]
        self.mask3 = put(mask[:, :, None], torch.bool)  # [Nl, dv, 1]
        self.jslot3 = put(plan["jslot"][rows][:, :, None], torch.int32)
        # check of each local edge (0 at padded slots: a valid row to gather)
        self.adj = put(np.where(mask, plan["var_adj"][rows], 0).reshape(-1), torch.int64)
        # local edge of each check-major slot (j, c), or the sentinel row Nl*dv
        first = s * plan["n_local"] * plan["dv"]
        edge = plan["chk_edge"] - first
        own = (plan["chk_edge"] >= first) & (edge < plan["n_local"] * plan["dv"])
        self.chk_edge = put(np.where(own, edge, plan["n_local"] * plan["dv"]).reshape(-1),
                            torch.int64)

    def to_checks(self, x, neutral, reduce):
        """``[Nl, dv, B]`` edge values -> ``[M, B]`` per-check partial of this
        shard's edges (``reduce`` over the check-major slots; ``neutral`` for
        slots whose edge lies on another shard or is padding)."""
        nl, dv, b = x.shape
        ext = torch.cat([x.reshape(nl * dv, b), x.new_full((1, b), neutral)])
        return reduce(ext.index_select(0, self.chk_edge).view(-1, self.m, b))

    def to_edges(self, rows):
        """``[M, B]`` per-check rows -> ``[Nl, dv, B]`` on this shard's edges."""
        return rows.index_select(0, self.adj).view(self.n_local, -1, rows.shape[1])


_plans: "weakref.WeakKeyDictionary[LDPCCode, dict]" = weakref.WeakKeyDictionary()


def _shard_plan(code: LDPCCode, n_node: int) -> dict:
    """Host arrays of the split of ``code``'s variables into ``n_node``
    contiguous blocks (cached per code and shard count)."""
    per_code = _plans.setdefault(code, {})
    if n_node in per_code:
        return per_code[n_node]
    N, M, dc, dv = code.n_vars, code.n_checks, code.dc_max, code.dv_max
    n_pad = (-N) % n_node

    def pad(a, fill):
        return np.concatenate([a, np.full((n_pad,) + a.shape[1:], fill, a.dtype)])

    # Global var-major edge v*dv + k of each check-major slot c*dc + j.
    chk_edge = np.full(M * dc, -1, np.int64)
    v, k = np.nonzero(code.var_mask)
    chk_edge[code.var_slot[v, k].astype(np.int64)] = v.astype(np.int64) * dv + k
    plan = dict(
        n_local=(N + n_pad) // n_node, dv=dv, m=M,
        var_adj=pad(code.var_adj.astype(np.int64), 0),
        var_mask=pad(code.var_mask.astype(bool), False),
        jslot=pad((code.var_slot % dc).astype(np.int32), 0),
        chk_edge=chk_edge.reshape(M, dc).T.copy(),  # [dc, M]
        shards={},
    )
    per_code[n_node] = plan
    return plan


def _shards(code: LDPCCode, row: Row) -> list[_Shard]:
    """This process's shards of ``row`` (cached per code, shard count, node
    position and device)."""
    plan = _shard_plan(code, row.n_node)
    out = []
    for s, d in zip(row.nodes, row.devices):
        key = (s, d)
        if key not in plan["shards"]:
            plan["shards"][key] = _Shard(plan, s, d)
        out.append(plan["shards"][key])
    return out


def _row_sum(row: Row, parts: list, devices=None) -> dict:
    """``{device: sum of every shard's partial in node order}`` on each of
    ``devices`` (default: this process's devices of the row)."""
    out = {}
    for d, full in row_gather(row, parts, devices).items():
        acc = full[0]
        for p in full[1:]:
            acc = acc + p
        out[d] = acc
    return out


def merge_top2(allc: torch.Tensor, sentinel: int) -> torch.Tensor:
    """The row-wide min-sum statistics from every shard's ``[n, 4, ...]``
    candidates (int32 float bits of the minimum, its slot, the second
    minimum, the sign count): the minimum, its FIRST slot (``sentinel``
    marks none), the second minimum with that one occurrence excluded, and
    the row's sign count — the single-device tie rule, exact on any mesh."""
    c_min1, c_slot1, c_min2, c_neg = allc[:, 0], allc[:, 1], allc[:, 2], allc[:, 3]
    min1_g = c_min1.amin(0)
    slot1_g = torch.where(c_min1 == min1_g, c_slot1, sentinel).amin(0)
    ex1 = (c_min1 == min1_g) & (c_slot1 == slot1_g)
    min2_g = torch.minimum(torch.where(ex1, _INF_BITS, c_min1).amin(0), c_min2.amin(0))
    return torch.stack([min1_g, slot1_g, min2_g, _sum_i32(c_neg)])


def _decode_row(code: LDPCCode, llr, syn, opts: DecodeOptions, row: Row):
    """Decode the frames ``llr [N, b]``, ``syn [M, b]`` on one mesh row (this
    process's shards of it: ``row.nodes`` on ``row.devices``); returns ``(z
    [N, b] int8, iters [b] int32, ok [b] bool)`` on the first of those
    devices, the same on every process of the row."""
    shards = _shards(code, row)
    head = shards[0].device
    N, dc, dv = code.n_vars, code.dc_max, code.dv_max
    n_local, b = shards[0].n_local, llr.shape[1]
    mdt = STORAGE_DTYPES[opts.message_dtype]
    scale = opts.int8_scale if opts.message_dtype == "int8" else None
    alpha, beta = opts.min_sum_alpha, opts.min_sum_beta
    threshold = opts.message_threshold

    llr = llr.to(torch.float32)
    n_pad = n_local * row.n_node - N
    if n_pad:
        llr = torch.cat([llr, llr.new_ones((n_pad, b))])
    llr_s = [llr[s * n_local:(s + 1) * n_local].to(sh.device)
             for s, sh in zip(row.nodes, shards)]
    syn_head = syn.to(head, torch.int32)
    syn_sign = [torch.where(syn_head == 1, -1.0, 1.0).to(sh.device) for sh in shards]

    def clip(x):
        return torch.clamp(x, -threshold, threshold) if opts.clip_messages else x

    def sum_product(Lqs):
        ctx, parts = [], []
        for sh, Lq in zip(shards, Lqs):
            t = torch.where(sh.mask3, torch.tanh(Lq * 0.5), 1.0)
            mag = torch.clamp_min(t.abs(), _TINY)
            logmag = torch.where(sh.mask3, torch.log(mag), 0.0)
            neg = torch.where(sh.mask3, (t < 0).to(torch.float32), 0.0)
            parts.append(torch.stack([sh.to_checks(logmag, 0.0, _sum),
                                      sh.to_checks(neg, 0.0, _sum)]))
            ctx.append((mag, neg))
        sums = _row_sum(row, parts)
        out = []
        for sh, sgn, (mag, neg) in zip(shards, syn_sign, ctx):
            rows = sums[sh.device]
            loo_neg = (sh.to_edges(rows[1]) - neg).to(torch.int32) & 1
            sign = torch.where(loo_neg == 1, -1.0, 1.0) * sh.to_edges(sgn)
            q = torch.clamp_max(sh.to_edges(torch.exp(rows[0])) / mag, 1.0)
            out.append(sign * torch.log1p(2.0 * q / (1.0 - q)))
        return out

    def min_sum(Lqs):
        ctx, parts = [], []
        for sh, Lq in zip(shards, Lqs):
            bits = torch.where(sh.mask3, Lq.abs(), float("inf")).view(torch.int32)
            neg = (sh.mask3 & (Lq < 0)).to(torch.int32)
            min1 = torch.clamp_max(sh.to_checks(bits, _INF_BITS, _min), _INF_BITS)
            at_min1 = bits == sh.to_edges(min1)
            slot1 = sh.to_checks(torch.where(at_min1, sh.jslot3, dc), dc, _min)
            own = at_min1 & (sh.jslot3 == sh.to_edges(slot1))
            min2 = torch.clamp_max(
                sh.to_checks(torch.where(own, _INF_BITS, bits), _INF_BITS, _min), _INF_BITS)
            parts.append(torch.stack([min1, slot1, min2, sh.to_checks(neg, 0, _sum_i32)]))
            ctx.append((at_min1, neg))
        merged = {d: merge_top2(torch.stack(full), dc)
                  for d, full in row_gather(row, parts).items()}
        out = []
        for sh, sgn, (at_min1, neg) in zip(shards, syn_sign, ctx):
            m1, s1, m2, row_neg = merged[sh.device]
            own_g = at_min1 & (sh.jslot3 == sh.to_edges(s1))
            loo = torch.where(own_g, sh.to_edges(m2), sh.to_edges(m1)).view(torch.float32)
            loo_neg = (sh.to_edges(row_neg) - neg) & 1
            sign = torch.where(loo_neg == 1, -1.0, 1.0) * sh.to_edges(sgn)
            if beta:
                loo = torch.clamp_min(loo - beta, 0.0)
            out.append(alpha * sign * loo)
        return out

    check_to_var = min_sum if opts.algorithm == "min-sum" else sum_product

    def check_update(Lqs):
        return [_store(clip(x), mdt, scale) for x in check_to_var(Lqs)]

    def after_check(Lrs):
        """Totals (storage-rounded), decisions and the decision syndrome."""
        totals, zs, parts = [], [], []
        for sh, Lr, l in zip(shards, Lrs, llr_s):
            Lr_f = torch.where(sh.mask3, _load(Lr, scale), 0.0)
            acc = Lr_f[:, 0]
            for k in range(1, dv):  # explicit adds in slot order, as the variable update
                acc = acc + Lr_f[:, k]
            total = _store(l + acc, mdt, scale)
            z = (total <= 0).to(torch.int8)
            z_edge = torch.where(sh.mask3, z[:, None, :].to(torch.int32), 0)
            parts.append(sh.to_checks(z_edge, 0, _sum_i32))
            totals.append(total)
            zs.append(z)
        ok = ((_row_sum(row, parts, (head,))[head] & 1) == syn_head).all(dim=0)
        return totals, zs, ok

    # Peeled iteration 1: the check inputs are the storage-rounded, UNCLIPPED
    # a-priori LLRs.
    Lrs = check_update([_load(_store(l, mdt, scale), scale)[:, None, :].expand(-1, dv, -1)
                        for l in llr_s])
    totals, z_out, done = after_check(Lrs)
    iters = torch.ones((b,), dtype=torch.int32, device=head)
    it = 1
    while it < opts.max_iterations and not bool(done.all()):  # the one flag fetch
        Lqs = [clip(_load(t, scale)[:, None, :] - _load(Lr, scale))
               for t, Lr in zip(totals, Lrs)]
        Lrs = check_update(Lqs)
        totals, zs, ok = after_check(Lrs)
        active = ~done
        z_out = [torch.where(active.to(sh.device)[None, :], z, zo)
                 for sh, z, zo in zip(shards, zs, z_out)]
        iters = torch.where(active, it + 1, iters)
        done = done | ok
        it += 1
    iters = torch.where(done, iters, opts.max_iterations).to(torch.int32)
    z = torch.cat(row_gather(row, z_out, (head,))[head])[:N]
    return z, iters, done


def _check_options(opts: DecodeOptions) -> None:
    if opts.schedule != "flooding":
        raise ValueError(
            "node-sharded decoding implements the flooding schedule only; "
            f"schedule={opts.schedule!r} runs on the single-device or "
            "trial-sharded paths (decoder/layered.py)"
        )


def bp_decode_node_sharded(
    code: LDPCCode,
    llr: torch.Tensor,  # [N, B] a-priori LLRs (batch last)
    syndrome: torch.Tensor,  # [M, B] target syndrome (batch last)
    opts: DecodeOptions,
    mesh: Mesh,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Node-sharded decode; returns ``(z [N, B] int8, iters [B], ok [B])`` on
    ``llr``'s device.

    ``mesh`` must carry a ``node`` axis; a ``trial`` axis, if present,
    splits the batch (``B`` a multiple of it): each trial row decodes its
    lanes, and across processes every process gets every row's lanes.
    Flooding only (``schedule='layered'`` raises); the compaction fields are
    ignored.
    """
    _check_options(opts)
    return decode_rows(_decode_row, code, llr, syndrome, opts, mesh)


def decode_rows(decode_row, code: LDPCCode, llr: torch.Tensor, syndrome: torch.Tensor,
                opts: DecodeOptions, mesh: Mesh):
    """``decode_row(code, llr, syn, opts, row)`` on every row this process
    holds shards of, each on its lanes; returns every row's ``(z [N, B],
    iters [B], ok [B])`` on ``llr``'s device, in lane order (across
    processes each row's from the process that leads it)."""
    if NODE_AXIS not in mesh.axis_names:
        raise ValueError(f"node-sharded decoding needs a mesh with a {NODE_AXIS!r} axis")
    B = llr.shape[1]
    n_trial = mesh.shape.get(TRIAL_AXIS, 1)
    if B % n_trial:
        raise ValueError(f"batch {B} is not a multiple of the {n_trial} trial shards")
    shards = trial_sharding(mesh, B)
    rows = run_on_shards(
        lambda sh: decode_row(code, llr[:, sh.lanes], syndrome[:, sh.lanes], opts, sh.row),
        shards,
    )
    led = [r for sh, r in zip(shards, rows) if sh.row.leader]
    dev = llr.device
    z = torch.cat([r[0].to(dev) for r in led] or [llr.new_empty((code.n_vars, 0), dtype=torch.int8)],
                  dim=1)
    iters = torch.cat([r[1].to(dev) for r in led] or [llr.new_empty((0,), dtype=torch.int32)])
    ok = torch.cat([r[2].to(dev) for r in led] or [llr.new_empty((0,), dtype=torch.bool)])
    if process_count() > 1:
        z, iters, ok = (all_gather_cat(z, 1).to(dev), all_gather_cat(iters).to(dev),
                        all_gather_cat(ok).to(dev))
    return z, iters, ok


def batch_first(bp_decode, code: LDPCCode, llr, syndrome, opts: DecodeOptions,
                mesh: Mesh) -> DecodeResult:
    """``bp_decode(code, llr [N, B], syndrome [M, B], opts, mesh)`` from
    batch-first inputs (``[B, N]`` or one frame ``[N]``), as
    ``decoder.bp.decode`` takes them.

    Pads the batch to a multiple of the mesh's ``trial`` axis with inert
    frames (LLR +1, syndrome 0), sliced off on return, so any request size
    works.  Results are on ``llr``'s device (a tensor) or this process's
    first device of the mesh (anything else).
    """
    if not isinstance(llr, torch.Tensor):
        llr = torch.as_tensor(llr).to(mesh.local_devices[0])
    syndrome = torch.as_tensor(syndrome).to(llr.device)
    single = llr.ndim == 1
    if single:
        llr, syndrome = llr[None, :], syndrome[None, :]
    B = llr.shape[0]
    pad = (-B) % mesh.shape.get(TRIAL_AXIS, 1)
    if pad:
        llr = torch.cat([llr, llr.new_ones((pad, llr.shape[1]))])
        syndrome = torch.cat([syndrome, syndrome.new_zeros((pad, syndrome.shape[1]))])
    z, iters, ok = bp_decode(code, llr.T, syndrome.T, opts, mesh)
    res = DecodeResult(bits=z.T[:B], iterations=iters[:B], syndromes_match=ok[:B])
    if single:
        res = DecodeResult(res.bits[0], res.iterations[0], res.syndromes_match[0])
    return res


def decode_node_sharded(
    code: LDPCCode,
    llr,  # [B, N] or [N]
    syndrome,  # [B, M] or [M]
    opts: DecodeOptions,
    mesh: Mesh,
) -> DecodeResult:
    """Batch-first wrapper of :func:`bp_decode_node_sharded` (mirrors
    ``decoder.bp.decode``; see :func:`batch_first`)."""
    return batch_first(bp_decode_node_sharded, code, llr, syndrome, opts, mesh)
