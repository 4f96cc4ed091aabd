"""QC-structured intra-frame node-sharded BP decoding, flooding and layered.

Counterpart of ``qkd_ldpc_tpu/parallel/qc_node_sharded.py``, with its design:

- Shard ``s`` of a row owns a CONTIGUOUS range of base columns (``nb_s =
  ceil(nb / n_node)`` blocks, ``Nl = nb_s * z`` variables).  A check row's
  cells within one shard's columns are then consecutive in its check-major
  slot order, so each shard holds a compact slot range of every check row:
  ``u`` slots, the most cells any (shard, row) pair owns.  Codes whose
  ``nb`` the row does not divide pad with edgeless dummy blocks (LLR pinned
  at +1).
- Flooding state per shard is the check-major mirror of the single-device
  loop: ``(tot_chk, Lr)`` of shape ``[u, M, B]`` in the message storage
  type, ``Lq = clip(tot - Lr)`` recomputed every iteration, the first
  iteration peeled on storage-rounded, unclipped a-priori LLRs — the
  single-device loop's quantization points.
- Routing: the JAX module rolls blocks with doubled-block ``dynamic_slice``
  loops because XLA on the TPU must not emit gathers.  Here the shifts are
  host integers, so each shard gets at plan time one int64 index per
  direction (variable rows -> ``[u*M]`` compact slots, ``[u*M]`` ->
  ``[dv*Nl]`` variable slots), each with a sentinel row that reads zero, and
  routing is one ``index_select`` each way: every value is copied exactly.
- Sum-product leave-one-out without logs: each shard forms exclusive prefix
  and suffix products over its ``u`` slots (left to right, as the
  single-device kernels) and its full product ``P_s``; one gather of every
  shard's ``P`` closes the leave-one-out with the product of the others'
  in shard order.  The grouping differs from the single device's only at
  shard boundaries, so sum-product is held on decisions and iterations.
- Min-sum is bit-identical to the single device on any mesh: float-bits
  minima and integer sign counts are exact, and the tie rule (exclude the
  FIRST row minimum in global slot order) runs on each cell's global slot
  rank (``chk_gslot``; the largest rank is the "none" sentinel).
- Layered (one sweep = ``mb`` serial layers, a layer = one base row): per
  layer each shard gathers its ``u`` cells of the row, forms ``Lq = clip(t
  - Lr)``, one gather of a ``[z, B]`` partial (``[4, z, B]`` for min-sum)
  closes the leave-one-out, ``Lr`` is stored and the masked delta is added
  into the shard's own totals before the next layer.  Totals stay float32;
  only ``Lr`` rounds to storage; there is no peeled sweep.

Collectives (``parallel.mesh.row_gather``) per flooding iteration: one
gather of the check partials and one integer parity sum; per layered sweep:
``mb`` gathers of ``[z, B]`` partials and one parity sum.  The JAX module
has no Pallas kernel: it is XLA there and plain PyTorch here.  The
compaction fields of ``DecodeOptions`` are ignored, as in JAX.
"""

from __future__ import annotations

import dataclasses
import weakref

import numpy as np
import torch

from qkd_ldpc_tpu_torch.codes.ldpc_code import LDPCCode
from qkd_ldpc_tpu_torch.codes.qc import qc_cells
from qkd_ldpc_tpu_torch.decoder.bp import DecodeOptions, DecodeResult
from qkd_ldpc_tpu_torch.decoder.cuda_kernels import STORAGE_DTYPES, _load, _store
from qkd_ldpc_tpu_torch.parallel.mesh import Mesh, Row, row_gather
from qkd_ldpc_tpu_torch.parallel.node_sharded import (
    _INF_BITS,
    _row_sum,
    batch_first,
    decode_rows,
    merge_top2,
)

NOT_QC_MESSAGE = "QC node-sharding requires a QC code (codes.qc)"


@dataclasses.dataclass(frozen=True)
class QCShardPlan:
    """Static shape info + per-shard routing tables for one (code, n_node),
    stacked per shard on axis 0 — the JAX package's plan, field for field."""

    z: int
    nb: int  # real column blocks (before padding)
    mb: int
    nb_s: int  # column blocks per shard (after padding)
    u: int  # compact check-major slots per shard
    dv: int  # variable-side slots (== code.dv_max)
    # [n, u, mb]: local column block / circulant shift / global slot rank of
    # each shard's compact check cell (-1 / 0 / max row degree when the
    # (shard, row) pair owns fewer than u cells).
    chk_col: np.ndarray
    chk_shift: np.ndarray
    chk_gslot: np.ndarray
    # [n, dv, nb_s]: compact slot / base row / shift of each local variable
    # block's k-th edge in ascending check order (-1 / 0 / 0 padded).
    var_t: np.ndarray
    var_i: np.ndarray
    var_shift: np.ndarray


def build_qc_shard_plan(qc: tuple, n_node: int) -> QCShardPlan:
    """Partition a QC layout into ``n_node`` contiguous column-block shards;
    see the module docstring for why contiguity matters."""
    z, nb, mb, cells = qc_cells(qc)
    nb_s = -(-nb // n_node)

    row_cols: dict[int, list[int]] = {}
    col_rows: dict[int, list[int]] = {}
    for (i, j) in cells:
        row_cols.setdefault(i, []).append(j)
        col_rows.setdefault(j, []).append(i)
    row_cols = {i: sorted(js) for i, js in row_cols.items()}
    col_rows = {j: sorted(rs) for j, rs in col_rows.items()}
    dv = max(len(rs) for rs in col_rows.values())

    counts = np.zeros((n_node, mb), np.int64)
    slot_of: dict[tuple[int, int], int] = {}
    for i, js in row_cols.items():
        for j in js:  # ascending j => compact slots keep global order
            s = j // nb_s
            slot_of[(i, j)] = int(counts[s, i])
            counts[s, i] += 1
    u = int(counts.max())

    chk_col = np.full((n_node, u, mb), -1, np.int32)
    chk_shift = np.zeros((n_node, u, mb), np.int32)
    chk_gslot = np.full((n_node, u, mb), max(len(js) for js in row_cols.values()),
                        np.int32)
    for i, js in row_cols.items():
        for rank, j in enumerate(js):
            s, t = j // nb_s, slot_of[(i, j)]
            chk_col[s, t, i] = j - s * nb_s
            chk_shift[s, t, i] = cells[(i, j)]
            chk_gslot[s, t, i] = rank

    var_t = np.full((n_node, dv, nb_s), -1, np.int32)
    var_i = np.zeros((n_node, dv, nb_s), np.int32)
    var_shift = np.zeros((n_node, dv, nb_s), np.int32)
    for j, rs in col_rows.items():
        s, jl = j // nb_s, j % nb_s
        for k, i in enumerate(rs):
            var_t[s, k, jl] = slot_of[(i, j)]
            var_i[s, k, jl] = i
            var_shift[s, k, jl] = cells[(i, j)]

    return QCShardPlan(z=z, nb=nb, mb=mb, nb_s=nb_s, u=u, dv=dv,
                       chk_col=chk_col, chk_shift=chk_shift,
                       chk_gslot=chk_gslot, var_t=var_t, var_i=var_i,
                       var_shift=var_shift)


class _QCShard:
    """The routing tensors of node shard ``s`` of a plan on its device.  The
    sentinel row of each index (``Nl`` of the totals, ``u*M`` of the
    messages) is a zero row the caller appends; no index is ever -1."""

    def __init__(self, plan: QCShardPlan, s: int, device):
        def put(x, dtype=torch.int64):
            return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype).to(device)

        z, mb, u, nb_s = plan.z, plan.mb, plan.u, plan.nb_s
        Nl, M = nb_s * z, mb * z
        r = np.arange(z, dtype=np.int64)
        col, shift = plan.chk_col[s].astype(np.int64), plan.chk_shift[s].astype(np.int64)
        valid = col >= 0  # [u, mb]
        # slot t, lifted row i*z + r reads variable col*z + (r + shift) mod z
        chk = np.where(valid[:, :, None], col[:, :, None] * z
                       + (r + shift[:, :, None]) % z, Nl)  # [u, mb, z]
        vt, vi = plan.var_t[s].astype(np.int64), plan.var_i[s].astype(np.int64)
        vsh = plan.var_shift[s].astype(np.int64)
        # edge k of variable jl*z + r reads message slot t, lifted row
        # i*z + (r - shift) mod z (the inverse rotation)
        var = np.where((vt >= 0)[:, :, None], vt[:, :, None] * M + vi[:, :, None] * z
                       + (r - vsh[:, :, None]) % z, u * M)  # [dv, nb_s, z]
        self.device = device
        self.chk_idx = put(chk.reshape(-1))
        self.var_idx = put(var.reshape(-1))
        self.mask3 = put(np.repeat(valid, z, axis=1)[:, :, None], torch.bool)  # [u, M, 1]
        self.gslot3 = put(np.repeat(plan.chk_gslot[s], z, axis=1)[:, :, None], torch.int32)
        # layer i: the u cells (sentinel at invalid slots), their validity
        # and global ranks [u, 1, 1], and the valid cells alone (slots, and
        # the totals they write back to: the same positions they read)
        self.layer_idx = [put(chk[:, i].reshape(-1)) for i in range(mb)]
        self.layer_v3 = [put(valid[:, i, None, None], torch.bool) for i in range(mb)]
        self.layer_gslot3 = [put(plan.chk_gslot[s][:, i, None, None], torch.int32)
                             for i in range(mb)]
        self.layer_slots = [None if valid[:, i].all() else put(np.nonzero(valid[:, i])[0])
                            for i in range(mb)]
        self.layer_dst = [put(chk[valid[:, i], i].reshape(-1)) if valid[:, i].any() else None
                          for i in range(mb)]


_plans: "weakref.WeakKeyDictionary[LDPCCode, dict]" = weakref.WeakKeyDictionary()


def _shards(code: LDPCCode, row: Row) -> tuple[QCShardPlan, list[_QCShard]]:
    """The plan of ``code`` over ``row.n_node`` shards and this process's
    shards of ``row`` (cached per code, shard count, node position and
    device)."""
    per_code = _plans.setdefault(code, {})
    if row.n_node not in per_code:
        per_code[row.n_node] = (build_qc_shard_plan(code.qc, row.n_node), {})
    plan, cache = per_code[row.n_node]
    out = []
    for s, d in zip(row.nodes, row.devices):
        if (s, d) not in cache:
            cache[(s, d)] = _QCShard(plan, s, d)
        out.append(cache[(s, d)])
    return plan, out


def _exclusive_cumprod(t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(prefix, suffix) exclusive products along axis 0, multiplied left to
    right and right to left as the single-device decoder's."""
    one = torch.ones_like(t[0])
    pre, suf = [one], [one]
    for j in range(1, t.shape[0]):
        pre.append(pre[-1] * t[j - 1])
    for j in range(t.shape[0] - 2, -1, -1):
        suf.append(suf[-1] * t[j + 1])
    return torch.stack(pre), torch.stack(suf[::-1])


def _sum_product(row: Row, Lqs, masks, sgns) -> list:
    """Tanh-rule leave-one-out of each local shard's ``Lq [u, R, b]`` over the
    whole row: local prefix/suffix products and one gather of the shards'
    full products ``[R, b]``."""
    ctx, parts = [], []
    for Lq, m in zip(Lqs, masks):
        t = torch.where(m, torch.tanh(Lq * 0.5), 1.0)
        pre, suf = _exclusive_cumprod(t)
        parts.append(pre[-1] * t[-1])
        ctx.append((pre, suf))
    every = row_gather(row, parts)
    out = []
    for s, dev, (pre, suf), sgn in zip(row.nodes, row.devices, ctx, sgns):
        others = None
        for k, P in enumerate(every[dev]):
            if k != s:
                others = P if others is None else others * P
        if others is None:  # a row of one shard
            others = torch.ones_like(pre[0])
        x = pre * suf * (others * sgn)[None]
        out.append(torch.log1p(2.0 * x / (1.0 - x)))
    return out


def _min_sum(row: Row, Lqs, masks, gslots, sgns, sentinel: int, alpha: float,
             beta: float) -> list:
    """Normalized / offset min-sum of each local shard's ``Lq [u, R, b]`` over
    the whole row: int32 float-bits top-2 over the local slots, one gather of
    the shards' ``[4, R, b]`` candidates, the merge with the global-slot tie
    rule (``merge_top2``), ``beta`` after the merge."""
    ctx, parts = [], []
    for Lq, m, g in zip(Lqs, masks, gslots):
        bits = torch.where(m, Lq.abs(), float("inf")).view(torch.int32)
        neg = (m & (Lq < 0)).to(torch.int32)
        min1 = torch.clamp_max(bits.amin(0), _INF_BITS)
        at1 = bits == min1
        slot1 = torch.where(at1, g, sentinel).amin(0)
        own = at1 & (g == slot1)
        min2 = torch.clamp_max(torch.where(own, _INF_BITS, bits).amin(0), _INF_BITS)
        parts.append(torch.stack([min1, slot1, min2, neg.sum(0, dtype=torch.int32)]))
        ctx.append((at1, neg, g))
    merged = {d: merge_top2(torch.stack(every), sentinel)
              for d, every in row_gather(row, parts).items()}
    out = []
    for dev, (at1, neg, g), sgn in zip(row.devices, ctx, sgns):
        m1, s1, m2, row_neg = merged[dev]
        loo = torch.where(at1 & (g == s1), m2, m1).view(torch.float32)
        loo_neg = (row_neg - neg) & 1
        sign = torch.where(loo_neg == 1, -1.0, 1.0) * sgn
        if beta:
            loo = torch.clamp_min(loo - beta, 0.0)
        out.append(alpha * sign * loo)
    return out


def _decode_row(code: LDPCCode, llr, syn, opts: DecodeOptions, row: Row):
    """Decode the frames ``llr [N, b]``, ``syn [M, b]`` on one mesh row (this
    process's shards of it); returns ``(z [N, b] int8, iters [b] int32, ok
    [b] bool)`` on the first of this process's devices of the row, the same
    on every process of the row."""
    if code.qc is None:
        raise ValueError(NOT_QC_MESSAGE)
    plan, shards = _shards(code, row)
    z, mb, nb_s, u = plan.z, plan.mb, plan.nb_s, plan.u
    N, M, Nl, b = code.n_vars, mb * plan.z, nb_s * plan.z, llr.shape[1]
    head = shards[0].device
    mdt = STORAGE_DTYPES[opts.message_dtype]
    scale = opts.int8_scale if opts.message_dtype == "int8" else None
    threshold = opts.message_threshold
    sentinel = int(plan.chk_gslot.max())

    llr = llr.to(torch.float32)
    n_pad = Nl * row.n_node - N  # edgeless dummy variable blocks
    if n_pad:
        llr = torch.cat([llr, llr.new_ones((n_pad, b))])
    llr_s = [llr[s * Nl:(s + 1) * Nl].to(sh.device) for s, sh in zip(row.nodes, shards)]
    syn_head = syn.to(head, torch.int32)
    sgn = torch.where(syn_head == 1, -1.0, 1.0)

    def clip(x):
        return torch.clamp(x, -threshold, threshold) if opts.clip_messages else x

    def check_to_var(Lqs, masks, gslots, sgns):
        if opts.algorithm == "min-sum":
            return _min_sum(row, Lqs, masks, gslots, sgns, sentinel, opts.min_sum_alpha,
                            opts.min_sum_beta)
        return _sum_product(row, Lqs, masks, sgns)

    def with_zero_row(x):
        return torch.cat([x, x.new_zeros((1, x.shape[-1]))])

    def syndrome_ok(gathered):
        """Decision syndrome == target per frame, from each shard's totals in
        its check slots ``[u, M, b]``: local slot parities, one integer sum
        over the row."""
        parts = [((g <= 0) & sh.mask3).sum(0, dtype=torch.int32)
                 for sh, g in zip(shards, gathered)]
        return ((_row_sum(row, parts, (head,))[head] & 1) == syn_head).all(dim=0)

    def finish(zs, iters, done):
        z_out = torch.cat(row_gather(row, zs, (head,))[head])[:N]
        return z_out, iters.to(torch.int32), done

    if opts.schedule == "layered":
        return finish(*_layered(opts, row, shards, llr_s, syn_head, sgn, plan, b, mdt, scale,
                                clip, check_to_var, syndrome_ok))

    sgns = [sgn.to(sh.device) for sh in shards]

    def gather_chk(sh, x):
        """``[Nl, b]`` variable rows -> ``[u, M, b]`` compact check slots."""
        return with_zero_row(x).index_select(0, sh.chk_idx).view(u, M, b)

    def check_update(Lqs):
        out = check_to_var(Lqs, [sh.mask3 for sh in shards], [sh.gslot3 for sh in shards],
                           sgns)
        return [_store(clip(x), mdt, scale) for x in out]

    def after_check(Lrs):
        """Route -> totals -> decisions -> syndrome -> gathered totals."""
        tots, zs = [], []
        for sh, Lr, l in zip(shards, Lrs, llr_s):
            Lr_var = with_zero_row(_load(Lr, scale).view(u * M, b)).index_select(
                0, sh.var_idx).view(plan.dv, Nl, b)
            acc = Lr_var[0]
            for k in range(1, plan.dv):  # explicit adds in slot order
                acc = acc + Lr_var[k]
            total = _store(l + acc, mdt, scale)
            zs.append((total <= 0).to(torch.int8))
            tots.append(total)
        tot_chk = [gather_chk(sh, t) for sh, t in zip(shards, tots)]
        return tot_chk, zs, syndrome_ok(tot_chk)

    # Peeled iteration 1: check inputs are the storage-rounded but UNCLIPPED
    # a-priori LLRs.
    Lrs = check_update([_load(gather_chk(sh, _store(l, mdt, scale)), scale)
                        for sh, l in zip(shards, llr_s)])
    tot_chk, z_out, done = after_check(Lrs)
    iters = torch.ones((b,), dtype=torch.int32, device=head)
    it = 1
    while it < opts.max_iterations and not bool(done.all()):  # the one flag fetch
        Lrs = check_update([clip(_load(t, scale) - _load(Lr, scale))
                            for t, Lr in zip(tot_chk, Lrs)])
        tot_chk, zs, ok = after_check(Lrs)
        active = ~done
        z_out = [torch.where(active.to(sh.device)[None, :], zd, zo)
                 for sh, zd, zo in zip(shards, zs, z_out)]
        iters = torch.where(active, it + 1, iters)
        done = done | ok
        it += 1
    return finish(z_out, torch.where(done, iters, opts.max_iterations), done)


def _layered(opts, row, shards, llr_s, syn_head, sgn, plan, b, mdt, scale, clip,
             check_to_var, syndrome_ok):
    """The layered schedule on the shard plan; returns ``(decisions per local
    shard [Nl, b], iters, done)``."""
    z, mb, u = plan.z, plan.mb, plan.u
    Nl = plan.nb_s * z
    head = shards[0].device
    # totals [Nl + 1, b] float32 with a zero sentinel row (never written)
    tots = [torch.cat([l, l.new_zeros((1, b))]) for l in llr_s]
    Lrs = [torch.zeros((u, mb, z, b), dtype=mdt, device=sh.device) for sh in shards]
    sgn_rows = [sgn.view(mb, z, b).to(sh.device) for sh in shards]
    iters = torch.zeros((b,), dtype=torch.int32, device=head)
    done = torch.zeros((b,), dtype=torch.bool, device=head)
    it = 0
    while it < opts.max_iterations and not bool(done.all()):  # the one flag fetch
        act = ~done
        acts = {d: act.to(d) for d in dict.fromkeys(row.devices)}
        for i in range(mb):
            cells = [t.index_select(0, sh.layer_idx[i]).view(u, z, b)
                     for sh, t in zip(shards, tots)]
            olds = [_load(Lr[:, i], scale) for Lr in Lrs]
            Lqs = [clip(c - o) for c, o in zip(cells, olds)]
            outs = check_to_var(Lqs, [sh.layer_v3[i] for sh in shards],
                                [sh.layer_gslot3[i] for sh in shards],
                                [s[i] for s in sgn_rows])
            for sh, t, Lr, c, old, out in zip(shards, tots, Lrs, cells, olds, outs):
                new_q = _store(clip(out), mdt, scale)
                gact = sh.layer_v3[i] & acts[sh.device][None, None, :]
                delta = torch.where(gact, _load(new_q, scale) - old, 0.0)
                if sh.layer_dst[i] is not None:
                    upd = c + delta
                    if sh.layer_slots[i] is not None:
                        upd = upd.index_select(0, sh.layer_slots[i])
                    t.index_copy_(0, sh.layer_dst[i], upd.view(-1, b))
                Lr[:, i] = torch.where(gact, new_q, Lr[:, i])
        it += 1
        newly = act & syndrome_ok([t.index_select(0, sh.chk_idx).view(u, mb * z, b)
                                   for sh, t in zip(shards, tots)])
        iters = torch.where(newly, it, iters)
        done = done | newly
    zs = [(t[:Nl] <= 0).to(torch.int8) for t in tots]
    return zs, torch.where(done, iters.clamp_min(1), opts.max_iterations), done


def bp_decode_qc_node_sharded(
    code: LDPCCode,
    llr: torch.Tensor,  # [N, B] a-priori LLRs (batch last)
    syndrome: torch.Tensor,  # [M, B] target syndrome (batch last)
    opts: DecodeOptions,
    mesh: Mesh,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """QC node-sharded decode; returns ``(z [N, B] int8, iters [B], ok [B])``
    on ``llr``'s device.

    ``code`` must carry a QC layout (``code.qc``); ``mesh`` must carry a
    ``node`` axis (a ``trial`` axis additionally splits the batch).
    ``opts.schedule='flooding'`` mirrors the single-device flooding loop
    (update order, early-exit bookkeeping, clamp placement, peeled unclipped
    first iteration, storage quantization points); ``'layered'`` mirrors
    ``decoder.layered`` (serial per-layer total updates, no peeled sweep).
    The compaction fields are ignored: they re-schedule lanes of the
    single-device loop, whose results they do not change.
    """
    if code.qc is None:
        raise ValueError(NOT_QC_MESSAGE)
    return decode_rows(_decode_row, code, llr, syndrome, opts, mesh)


def decode_qc_node_sharded(
    code: LDPCCode,
    llr,  # [B, N] or [N]
    syndrome,  # [B, M] or [M]
    opts: DecodeOptions,
    mesh: Mesh,
) -> DecodeResult:
    """Batch-first wrapper of :func:`bp_decode_qc_node_sharded` (mirrors
    ``decoder.bp.decode``): pads the batch to a multiple of the mesh's
    ``trial`` axis with inert frames and slices them off on return."""
    return batch_first(bp_decode_qc_node_sharded, code, llr, syndrome, opts, mesh)
