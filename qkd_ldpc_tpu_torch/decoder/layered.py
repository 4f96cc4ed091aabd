"""Serial check-layered BP schedule for quasi-cyclic codes.

Counterpart of ``qkd_ldpc_tpu/decoder/layered.py``.  The flooding schedule
updates every check from the previous iteration's messages; the layered
schedule sweeps the checks in groups and updates the total LLRs right after
each group, so later layers of a sweep already see the corrections of
earlier ones and the decode converges in about half the sweeps at equal
FER.  One layer is one base row of the lift, i.e. ``z`` independent lifted
checks.  Per layer and per base cell ``(i, j, shift s)``::

    Lq  = clip(rot(t[j], s) - Lr_cell)             # bit -> check
    Lr' = check_update(all Lq of the row, syn_i)   # leave-one-out
    t[j] += rot^-1(Lr' - Lr_cell)                  # immediate update

Semantics, as in the JAX package: one "iteration" is one full sweep over
all ``mb`` layers; the decision syndrome is checked after each sweep,
converged frames freeze, failures report ``max_iterations``; both message
directions clip (there is no unclipped first iteration); storage type,
min-sum alpha/beta and the int8 quantization points follow
``DecodeOptions``; residency compaction is the flooding schedule's
(``device_loop.run_schedule``: phase A, then phase B or the ladder of
halving widths) and is bit-identical to the
plain loop per lane.  Trajectories differ from flooding's by construction.

State layout: ``t [nb, B, z]`` float32 totals, ``Lr [ncells, B, z]``
messages in storage type, ``syn [mb, B, z]`` int8 — frames in the middle,
``z`` last.  It is the layout of the CUDA sweep kernel
(``decoder/cuda_layered.py``).  :func:`layered_program` takes ``[N, B]``
``llr``/``syndrome``, converts them to it once per decode and the decisions
back; :func:`layered_state_program` takes and returns the state in this
layout, as the trial chunk stages it.  Compaction selects along the frame
axis.  Cells are numbered by ``(i, j)`` in lexicographic order.

:func:`layered_sweep_plain` is the plain PyTorch version of the kernel and
what runs for CPU tensors and under ``backend="xla"``.  The early-exit loop
and the compaction are ``decoder.device_loop.run_schedule`` over the sweep's
lanes (``_SweepLanes``), with the layered carry: on the card the
kernel backend captures the whole decode as one CUDA graph (one WHILE node a
loop, the carry and the condition kept by the sweep kernel's last block),
elsewhere the same program runs eagerly and fetches the condition after
every sweep.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from qkd_ldpc_tpu_torch import _build
from qkd_ldpc_tpu_torch.codes.ldpc_code import LDPCCode
from qkd_ldpc_tpu_torch.codes.qc import qc_cells
from qkd_ldpc_tpu_torch.decoder import cuda_kernels, cuda_layered, device_loop
from qkd_ldpc_tpu_torch.decoder.cuda_kernels import _load, _store


def _row_tables(qc) -> tuple[int, int, int, list[list[tuple[int, int, int]]]]:
    """Static per-layer cell tables: row i -> [(cell_index, j, shift)].

    Cell indices order the flat [ncells, B, z] message store by (i, j) —
    ascending j within a row matches the check-major slot order of the
    flooding layout."""
    z, nb, mb, cells = qc_cells(qc)
    order = sorted(cells)  # (i, j) lexicographic
    index = {ij: ci for ci, ij in enumerate(order)}
    rows: list[list[tuple[int, int, int]]] = [[] for _ in range(mb)]
    for (i, j) in order:
        rows[i].append((index[(i, j)], j, cells[(i, j)]))
    return z, nb, mb, rows


@dataclasses.dataclass(frozen=True)
class LayerTables:
    """A QC code's static layer tables, as Python tuples for the plain loop
    and as int32 device tensors (CSR over the base rows) for the kernel."""

    z: int
    nb: int
    mb: int
    rows: tuple  # rows[i] = ((cell_index, j, shift), ...)
    max_row_degree: int
    row_ptr: torch.Tensor  # [mb + 1] int32: row i owns cells row_ptr[i]..row_ptr[i+1]
    col: torch.Tensor  # [ncells] int32 base column j of each cell
    shift: torch.Tensor  # [ncells] int32 circulant shift s of each cell


def layer_tables(code: LDPCCode, device) -> LayerTables:
    """The layer tables of ``code`` on ``device`` (built once per device)."""
    device = torch.device(device)
    key = ("layers", device)
    cached = code._device_cache.get(key)
    if cached is not None:
        return cached
    z, nb, mb, rows = _row_tables(code.qc)
    flat = [cell for row in rows for cell in row]
    # Cells are numbered row by row, and a base matrix has one entry per
    # (i, j): the cells of a row touch distinct columns, and a shift below z
    # makes r -> (r + s) mod z a bijection, so within a layer each position
    # of t belongs to one lifted check.  The kernel relies on it: whichever
    # thread owns a check is the only one of its layer to touch those
    # positions, however many checks a thread owns.
    assert [ci for ci, _, _ in flat] == list(range(len(flat)))
    assert all(len({j for _, j, _ in row}) == len(row) for row in rows)
    assert all(0 <= s < z for _, _, s in flat)

    def put(values):
        return torch.as_tensor(np.asarray(values, dtype=np.int32)).to(device)

    tables = LayerTables(
        z=z, nb=nb, mb=mb, rows=tuple(tuple(r) for r in rows),
        max_row_degree=max(len(r) for r in rows),
        row_ptr=put(np.cumsum([0] + [len(r) for r in rows])),
        col=put([j for _, j, _ in flat]),
        shift=put([s for _, _, s in flat]),
    )
    code._device_cache[key] = tables
    return tables


def _rot(x: torch.Tensor, s: int) -> torch.Tensor:
    """[..., z] rotated so position r reads input position (r + s) mod z."""
    return x if s == 0 else torch.roll(x, -s, dims=-1)


def layered_sweep_plain(t, Lr, syn, act, tables, *, threshold, clip, algorithm,
                        min_sum_alpha, min_sum_beta, scale, out=None, scratch=None,
                        in_place=False, step=None):
    """One serial pass over all layers plus the decision-syndrome check: the
    plain PyTorch version of ``cuda_layered.layered_sweep_cuda`` (same
    arguments).  Returns new ``(t, Lr, ok [B] bool)``; ``act`` [B] bool gates
    the updates (an inactive frame's state does not change).  With
    ``in_place`` it updates ``t`` and ``Lr`` where they lie, as the kernel
    does, and ``ok`` goes into ``out`` when given (``scratch`` is the
    kernel's and unused here); ``step`` (``device_loop.LoopTail``) runs the
    loop's bookkeeping over ``ok`` afterwards."""
    z = tables.z
    t_in, Lr_in = t, Lr
    t, Lr = t.clone(), Lr.clone()
    act_f = act.to(t.dtype)[:, None]  # [B, 1], broadcasts over z
    keep = act_f > 0
    no_pad = [torch.ones((1, 1), dtype=torch.bool, device=t.device)] * tables.max_row_degree
    for i, row in enumerate(tables.rows):
        sgn = torch.where(syn[i] == 1, -1.0, 1.0)
        old = [_load(Lr[ci], scale) for ci, _, _ in row]
        lq = []
        for (_, j, s), lr_old in zip(row, old):
            v = _rot(t[j], s) - lr_old
            lq.append(torch.clamp(v, -threshold, threshold) if clip else v)
        if algorithm == "min-sum":
            msgs = cuda_kernels._ms_messages(lq, no_pad, sgn, threshold, clip,
                                             min_sum_alpha, min_sum_beta)
        else:
            msgs = cuda_kernels._sp_messages(lq, no_pad, sgn, threshold, clip)
        for k, (ci, j, s) in enumerate(row):
            new_q = _store(msgs[k], Lr.dtype, scale)
            delta = _load(new_q, scale) - old[k]
            t[j] = t[j] + _rot(delta, (z - s) % z) * act_f
            Lr[ci] = torch.where(keep, new_q, Lr[ci])
    ok = syndrome_ok(t, syn, tables)
    if in_place:
        t, Lr = t_in.copy_(t), Lr_in.copy_(Lr)
    ok = ok if out is None else out.copy_(ok)
    if step is not None:
        step.plain(ok)
    return t, Lr, ok


def syndrome_ok(t, syn, tables) -> torch.Tensor:
    """Decision syndrome == target, per frame ([B] bool); total <= 0 -> 1."""
    zdec = (t <= 0).to(torch.int32)  # [nb, B, z]
    bad = torch.zeros((t.shape[1],), dtype=torch.int32, device=t.device)
    for i, row in enumerate(tables.rows):
        p = torch.zeros_like(zdec[0])
        for (_, j, s) in row:
            p = p ^ _rot(zdec[j], s)
        bad = bad + (p ^ syn[i]).sum(dim=1, dtype=torch.int32)
    return bad == 0


def initial_state(tables: LayerTables, llr, syndrome, mdt):
    """``llr [N, B]`` and ``syndrome [M, B]`` in the sweep's layout, with zero
    messages: ``(t [nb, B, z], Lr [ncells, B, z], syn [mb, B, z])``.  ``t`` is
    a buffer of its own, never a view of ``llr``: the kernel updates it in
    place.  The ``[N, B]`` callers (:func:`layered_decode_batch_last`, the
    serving endpoints, the public API) come through here; the trial chunk
    stages ``t`` and ``syn`` in this layout itself (:func:`layered_state_program`)."""
    z, B = tables.z, llr.shape[1]
    t = llr.reshape(tables.nb, z, B).permute(0, 2, 1).clone(
        memory_format=torch.contiguous_format)
    syn = syndrome.to(torch.int8).reshape(tables.mb, z, B).permute(0, 2, 1).contiguous()
    return t, zero_messages(tables, B, mdt, llr.device), syn


def zero_messages(tables: LayerTables, B: int, mdt, device) -> torch.Tensor:
    """A batch's check-to-bit messages before the first sweep: ``Lr
    [ncells, B, z]`` zeros in storage type ``mdt``."""
    return torch.zeros((tables.col.shape[0], B, tables.z), dtype=mdt, device=device)


class _SweepLanes(device_loop.Lanes):
    """A batch's layered state on its lanes: ``t``, ``Lr``, ``syn``, the
    counts ``iters``, the loop's flags, the sweep and the factory of its
    scratch (by lane count)."""

    mode = device_loop.LAYERED

    def __init__(self, sweep, make_scratch, use_kernel, t, Lr, syn, iters, done, it,
                 fill=True):
        self.sweep, self.make_scratch = sweep, make_scratch
        self.t, self.Lr, self.syn, self.iters = t, Lr, syn, iters
        self.scratch = make_scratch(t.shape[1])
        super().__init__(done, it, use_kernel, fill)

    def pass_(self, tail):
        """One sweep of the active lanes, in place; its flags land in
        ``loop.ok``, and the sweep runs the loop's bookkeeping ``tail`` after
        them.  Allocates nothing on the kernel.  An inactive lane's ``t`` stays
        put too, because decisions derive from the final ``t``."""
        self.sweep(self.t, self.Lr, self.syn, self.loop.active, out=self.loop.ok,
                   scratch=self.scratch, step=tail)

    def compacted(self, n):
        like = device_loop.lanes_like
        return _SweepLanes(self.sweep, self.make_scratch, self.use_kernel,
                           *(like(x, 1, n) for x in (self.t, self.Lr, self.syn)),
                           like(self.iters, 0, n), like(self.loop.done, 0, n), self.loop.it,
                           fill=False)

    def gathered(self):
        return self.t, self.Lr, self.syn

    def carried(self):
        return self.t, self.Lr

    def returned(self):
        # Decisions derive from t, so the narrowest rung hands back its final
        # t alone: no later pass reads its lanes' messages.
        return (self.t,)


# The JAX package's text for a layered decode of a code without a QC layout.
NOT_QC_MESSAGE = (
    "schedule='layered' requires a QC code (codes.qc; generate "
    "with make_qc_code or cli generate --qc)"
)


def _checked_tables(code: LDPCCode, opts, device) -> tuple[LayerTables, bool]:
    """``code``'s layer tables on ``device`` and whether its sweeps run the
    kernel; raises for a code without a QC layout or a row the kernel refuses."""
    if code.qc is None:
        raise ValueError(NOT_QC_MESSAGE)
    device = torch.device(device)
    tables = layer_tables(code, device)
    # The port's one backend rule; a CUDA tensor never takes the plain sweep
    # unless backend="xla" asks for it.
    use_kernel = _build.use_kernel(opts.backend, device)
    if use_kernel:
        why = cuda_layered.refusal(tables.max_row_degree)
        if why is not None:
            raise ValueError(why)
    return tables, use_kernel


def layered_state_program(code: LDPCCode, opts, device):
    """The layered decode of ``code`` on ``device`` in the sweep's own layout:
    ``(run, use_kernel, tables)``, ``run(t [nb, B, z] float32, syn [mb, B, z]
    int8, graph)`` decoding eagerly (``graph=None``) or as the capture into
    ``graph`` and returning ``(t, iters [B] int32, done [B] bool)``: ``t`` the
    final totals, updated in place (a decision is ``t <= 0``), ``iters`` as
    :func:`layered_decode_batch_last` reports them.  ``tables`` is what its
    captured pointers point into.  The trial chunk (``sim/runner.py``) stages
    its trials in this layout and reads its statistics from ``t``; the
    ``[N, B]`` callers take :func:`layered_program`."""
    tables, use_kernel = _checked_tables(code, opts, device)
    mdt = cuda_kernels.STORAGE_DTYPES[opts.message_dtype]

    def run(t, syn, graph):
        Lr = zero_messages(tables, t.shape[1], mdt, t.device)
        return _layered_program(tables, t, Lr, syn, opts, use_kernel, graph)

    return run, use_kernel, tables


def layered_program(code: LDPCCode, opts, device):
    """The layered decode of ``code`` on ``device`` as one program over
    ``[N, B]`` tensors: ``(run, use_kernel, keep)``, ``run(llr [N, B]
    float32, syn [M, B] int8, graph)`` returning ``(z [N, B] int8, iters,
    ok)``, eagerly (``graph=None``) or as the capture into ``graph``, ``keep``
    what its captured pointers point into.  It is :func:`layered_state_program`
    between :func:`initial_state`'s copies into the sweep's layout and the
    decisions' copy back: the layout of ``decode_program``, which the serving
    endpoints, :func:`layered_decode_batch_last` and the public API take."""
    tables, use_kernel = _checked_tables(code, opts, device)
    mdt = cuda_kernels.STORAGE_DTYPES[opts.message_dtype]

    def run(llr, syn, graph):
        t, iters, done = _layered_program(tables, *initial_state(tables, llr, syn, mdt), opts,
                                          use_kernel, graph)
        z = (t <= 0).to(torch.int8).permute(0, 2, 1).reshape(tables.nb * tables.z, llr.shape[1])
        return z, iters, done

    return run, use_kernel, tables


def layered_decode_batch_last(
    code: LDPCCode,
    llr: torch.Tensor,  # [N, B] float32 a-priori LLRs (batch last)
    syndrome: torch.Tensor,  # [M, B] int target syndrome (batch last)
    opts,  # decoder.bp.DecodeOptions
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Layered decode on the tensors' device; returns
    (z [N,B] int8, iters [B] int32, ok [B] bool).  On the card under the
    kernel backend the decode is one replay of a captured CUDA graph."""
    return device_loop.batch_last_decode("layered", layered_program, code, llr, syndrome, opts)


def sweep_lanes(code: LDPCCode, opts, llr, syndrome) -> _SweepLanes:
    """The layered state of ``llr [N, B]`` and ``syndrome [M, B]`` on their
    device before the first sweep."""
    tables, use_kernel = _checked_tables(code, opts, llr.device)
    mdt = cuda_kernels.STORAGE_DTYPES[opts.message_dtype]
    return _sweep_lanes(tables, *initial_state(tables, llr, syndrome, mdt), opts, use_kernel)


def _layered_program(tables, t0, Lr0, syn3, opts, use_kernel, graph):
    """The layered decode of ``t0 [nb, B, z]`` (updated in place) with
    messages ``Lr0`` (its working buffer) toward ``syn3 [mb, B, z]``,
    eagerly (``graph=None``) or as the capture into ``graph``: ``(t, iters,
    done)``."""
    lanes = _sweep_lanes(tables, t0, Lr0, syn3, opts, use_kernel)
    device_loop.run_schedule(lanes, opts, graph)
    # A converged frame reports the sweep at which its decision syndrome
    # first matched; failures report max_iterations.
    done = lanes.loop.done
    return lanes.t, torch.where(done, lanes.iters.clamp_min(1), opts.max_iterations), done


def _sweep_lanes(tables, t0, Lr0, syn3, opts, use_kernel) -> _SweepLanes:
    """The lanes over ``t0``, ``Lr0`` and ``syn3`` (:func:`_layered_program`),
    with the sweep and its scratch bound to ``tables`` and ``opts``."""
    device = t0.device
    B = t0.shape[1]
    mdt = cuda_kernels.STORAGE_DTYPES[opts.message_dtype]
    kw = dict(
        threshold=opts.message_threshold, clip=opts.clip_messages,
        algorithm=opts.algorithm, min_sum_alpha=opts.min_sum_alpha,
        min_sum_beta=opts.min_sum_beta,
        scale=opts.int8_scale if opts.message_dtype == "int8" else None,
    )
    if use_kernel:
        sweep_fn = cuda_layered.layered_sweep_cuda
    else:  # the plain sweep updates in place as the kernel does
        sweep_fn = functools.partial(layered_sweep_plain, in_place=True)

    def sweep(t, Lr, syn, act, out, scratch, step):
        return sweep_fn(t, Lr, syn, act, tables, out=out, scratch=scratch, step=step, **kw)

    def scratch(width):
        shape = (cuda_layered.sweep_scratch_shape(tables, width, opts.algorithm, mdt)
                 if use_kernel else None)
        return None if shape is None else torch.empty(
            shape, dtype=torch.float32, device=device)

    def zeros(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    return _SweepLanes(sweep, scratch, use_kernel, t0, Lr0, syn3, zeros((B,), torch.int32),
                       zeros((B,), torch.bool), zeros((1,), torch.int32))
