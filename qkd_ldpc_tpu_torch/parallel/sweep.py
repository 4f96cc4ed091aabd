"""Sharded Monte-Carlo sweep: trial parallelism over a mesh, and sweep
points on a 2-D ``(trial, node)`` mesh.

Counterpart of ``qkd_ldpc_tpu/parallel/sweep.py``.  A shard's chunk is the
single-device runner's chunk program (``sim.runner._point_chunk``: keygen
K4, exact-weight channel K3, syndrome, decode, seven stat scalars, batch
after batch; on the card one replay of the chunk's captured graph), as the
JAX package's ``_sharded_chunk`` is its ``lax.scan`` per shard.  A global
batch of ``batch`` lanes splits over the trial axis: shard ``g`` runs trial
ids ``offset + i*batch + g*b + lane`` in batch ``i`` for its
``b = batch / n_shards`` lanes (its lane start and the chunk's offset are
the chunk program's first trial id, ``batch`` its stride), and the ragged
tail of a point is masked globally, so every shard's partials are exactly
those lanes' share of the unsharded run.  Batches chain into chunks (up to
``max_batches_per_dispatch``, and as many as keep the int32 sum of
iterations squared exact), merged on each shard's device; a chunk costs one
``[7]`` fetch a shard.  The node-sharded decoders' chunks stay a host loop
over batches (their decodes fetch a flag every iteration).  The host then
merges the chunk's shards in global shard order: within a process with
``PointPartials.merge``, across processes after one gloo ``all_gather`` of
an int64 ``[k, 7]`` tensor, to which each process gives the rows it leads
(a row whose node shards span processes is counted once).  Sums are exact
integers and minima / maxima go through ``merge``, so the result is
bit-identical to the single-device runner on any mesh, with any number of
processes (trial t's keys depend only on the point key and t).

Shards on distinct cards run in one host thread per card; shards that
share a card, and CPU shards, run in turn (``mesh.run_on_shards``).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from qkd_ldpc_tpu_torch.channel.keys import make_trial_batch, num_errors_for
from qkd_ldpc_tpu_torch.channel.threefry import fold_in
from qkd_ldpc_tpu_torch.codes.ldpc_code import LDPCCode
from qkd_ldpc_tpu_torch.decoder.bp import DecodeOptions
from qkd_ldpc_tpu_torch.decoder.reconcile import apriori_llr
from qkd_ldpc_tpu_torch.decoder.syndrome import syndrome
from qkd_ldpc_tpu_torch.parallel.mesh import (
    NODE_AXIS,
    TRIAL_AXIS,
    Mesh,
    all_gather_rows,
    replicated,
    run_on_shards,
    trial_sharding,
)
from qkd_ldpc_tpu_torch.parallel import node_sharded, qc_node_sharded
from qkd_ldpc_tpu_torch.sim.runner import _point_chunk, merge_partials_tree
from qkd_ldpc_tpu_torch.sim.stats import (
    PointPartials,
    partials_from_stacked,
    reduce_trials,
    stack_partials,
)


def _check_int32_stats_bound(batch: int, opts: DecodeOptions) -> int:
    """Trials per device-merged chunk must keep the sum of iterations squared
    under 2**31 (device sums are exact int32; host merges are exact Python
    ints).  Returns the most batches one chunk may merge."""
    mi2 = max(opts.max_iterations, 1) ** 2
    if batch * mi2 > 2**31 - 1:
        raise ValueError(
            f"batch ({batch}) x max_iterations^2 ({opts.max_iterations}^2) "
            "overflows the int32 iteration statistics; lower batch_size"
        )
    return max(1, (2**31 - 1) // (batch * mi2))


def _n_err(code: LDPCCode, qber: float) -> int:
    n_err = num_errors_for(code.n_vars, qber)
    if n_err == 0:
        raise ValueError(f"Key size '{code.n_vars}' is too small for QBER.")
    return n_err


def _dispatch_chunks(chunk_fn, mesh: Mesh, trials: int, batch: int, opts: DecodeOptions,
                     max_batches_per_dispatch: int) -> list:
    """Every chunk of one point over the local trial shards WITHOUT fetching:
    a list (one entry a chunk) of the stacked ``[7]`` device stats of the
    shards this process leads (every shard runs: a row spanning processes
    decodes in all of them).

    ``chunk_fn(shard, first, valid, n_batches, b)`` is one shard's chunk of
    ``n_batches`` batches of its ``b`` lanes: in batch ``i`` trial ids
    ``first + i * batch + lane``, the lanes below ``valid - i * batch``
    valid; it returns the stacked ``[7]`` partials."""
    safe_batches = _check_int32_stats_bound(batch, opts)
    shards = trial_sharding(mesh, batch)
    b = batch // mesh.shape.get(TRIAL_AXIS, 1)
    futures = []
    offset = 0
    while offset < trials:
        remaining = trials - offset
        n_batches = min(-(-remaining // batch), max_batches_per_dispatch, safe_batches)
        valid = min(n_batches * batch, remaining)

        def chunk(shard, offset=offset, valid=valid, n_batches=n_batches):
            start = shard.lanes.start
            return chunk_fn(shard, offset + start, valid - start, n_batches, b)

        stats = run_on_shards(chunk, shards)
        futures.append([st for sh, st in zip(shards, stats) if sh.row.leader])
        offset += valid
    return futures


def _collect(futures: list, mesh: Mesh) -> PointPartials:
    """Fetch each chunk's shard stats and merge them in global shard order
    (across processes after one all-gather a chunk)."""
    total = PointPartials()
    for shard_stats in futures:
        rows = (torch.stack([s.cpu().to(torch.int64) for s in shard_stats]) if shard_stats
                else torch.empty((0, 7), dtype=torch.int64))
        if mesh.process_count > 1:
            rows = all_gather_rows(rows)
        for row in rows:
            total = total.merge(partials_from_stacked(row))
    return total


def _trial_chunk_fn(code, point_key, n_err, opts, prng, batch):
    """A trial shard's chunk: the runner's chunk program (one graph replay on
    the card), ``batch`` (the global batch) apart from one batch to the next."""
    def chunk_fn(shard, first, valid, n_batches, b):
        return _point_chunk(code, point_key, n_err, first, valid, b, n_batches, opts, prng,
                            shard.device, stride=batch)
    return chunk_fn


def _batch_loop(batch_fn, batch):
    """A chunk as a host loop over batches: ``batch_fn(shard, first, count,
    b)`` reduces ``b`` lanes, trial ids ``first + lane``, the first ``count``
    of them valid."""
    def chunk_fn(shard, first, valid, n_batches, b):
        out = None
        for i in range(n_batches):
            count = min(max(valid - i * batch, 0), b)
            red = batch_fn(shard, first + i * batch, count, b)
            out = red if out is None else merge_partials_tree(out, red)
        return stack_partials(out)
    return chunk_fn


def _global_batch(batch: int, mesh: Mesh) -> int:
    """``batch`` rounded up to a multiple of the trial axis."""
    n_shards = mesh.shape.get(TRIAL_AXIS, 1)
    return -(-batch // n_shards) * n_shards


def _upload(code: LDPCCode, mesh: Mesh) -> None:
    for d in replicated(mesh):
        code.to_device(d)


def make_point_dispatcher(
    code: LDPCCode,
    batch: int,
    opts: DecodeOptions,
    mesh: Mesh,
    max_batches_per_dispatch: int = 64,
    prng: str = "threefry",
):
    """Bind the code to every device of ``mesh`` once and return
    ``dispatch(point_key, qber, trials) -> (futures, actual_qber)``, the
    sharded analog of ``sim.runner._dispatch_point``; :func:`_collect`
    merges its futures.  ``batch`` is per device; the global batch is
    ``batch x`` the trial axis."""
    gbatch = batch * mesh.shape[TRIAL_AXIS]
    _upload(code, mesh)

    def dispatch(point_key: torch.Tensor, qber: float, trials: int):
        n_err = _n_err(code, qber)
        futures = _dispatch_chunks(
            _trial_chunk_fn(code, point_key, n_err, opts, prng, gbatch), mesh, trials,
            gbatch, opts, max_batches_per_dispatch)
        return futures, n_err / code.n_vars

    return dispatch


def run_point_sharded(
    code: LDPCCode,
    point_key: torch.Tensor,
    qber: float,
    trials: int,
    batch: int,
    opts: DecodeOptions,
    mesh: Mesh,
    tick: Callable[[int], None] | None = None,
    max_batches_per_dispatch: int = 64,
) -> tuple[PointPartials, float]:
    """All trials of one (matrix, QBER) point, sharded over ``mesh``.

    ``batch`` is the GLOBAL batch, rounded up to a multiple of the trial
    axis; the tail is masked, so the partial sums are exactly the
    single-device runner's."""
    n_err = _n_err(code, qber)
    _upload(code, mesh)
    gbatch = _global_batch(batch, mesh)
    futures = _dispatch_chunks(
        _trial_chunk_fn(code, point_key, n_err, opts, "threefry", gbatch), mesh, trials,
        gbatch, opts, max_batches_per_dispatch)
    total = _collect(futures, mesh)
    if tick is not None:
        tick(total.n_trials)
    return total, n_err / code.n_vars


def run_sweep_sharded(
    code: LDPCCode,
    master_key: torch.Tensor,
    qbers: list[float],
    trials: int,
    batch: int,
    opts: DecodeOptions,
    mesh: Mesh,
    tick: Callable[[int], None] | None = None,
    max_batches_per_dispatch: int = 64,
) -> list[tuple[PointPartials, float]]:
    """A QBER sweep on the mesh, point ``i`` keyed ``fold_in(master_key, i)``,
    with one point in flight: point k+1 is dispatched before point k's
    statistics are fetched (the JAX runner's pipeline; results depend only
    on each point's key)."""
    n_errs = [_n_err(code, q) for q in qbers]
    gbatch = _global_batch(batch, mesh)
    _upload(code, mesh)
    results: list[tuple[PointPartials, float]] = []
    pending: list[tuple[list, float]] = []

    def flush_one():
        futures, actual = pending.pop(0)
        total = _collect(futures, mesh)
        if tick is not None:
            tick(total.n_trials)
        results.append((total, actual))

    for i, n_err in enumerate(n_errs):
        futures = _dispatch_chunks(
            _trial_chunk_fn(code, fold_in(master_key, i), n_err, opts, "threefry", gbatch),
            mesh, trials, gbatch, opts, max_batches_per_dispatch)
        pending.append((futures, n_err / code.n_vars))
        if len(pending) > 1:  # keep one point in flight
            flush_one()
    while pending:
        flush_one()
    return results


def run_point_node_sharded(
    code: LDPCCode,
    point_key: torch.Tensor,
    qber: float,
    trials: int,
    batch: int,
    opts: DecodeOptions,
    mesh: Mesh,
    tick: Callable[[int], None] | None = None,
    max_batches_per_dispatch: int = 64,
) -> tuple[PointPartials, float]:
    """One sweep point on a 2-D ``(trial, node)`` mesh: the batch splits over
    ``trial`` while each frame's variables split over ``node``.

    Routing as in the JAX package: ``routing="roll"``, or ``"auto"`` with a
    QC code, takes the QC node-sharded decoder (``parallel.qc_node_sharded``,
    flooding or layered, a non-QC code raising under ``"roll"``);
    ``"gather"``, or a non-QC code under ``"auto"``, takes the general
    decoder (``parallel.node_sharded``), which decodes flooding only.  Every
    process holding shards of a row makes the row's whole trials and decodes
    its own variables.

    Statistics: exactly the single-device runner's for min-sum; for
    sum-product a rare boundary frame may move by one iteration (the
    decoders' cross-shard products group differently)."""
    if opts.routing == "roll" or (opts.routing == "auto" and code.qc is not None):
        if code.qc is None:
            raise ValueError(qc_node_sharded.NOT_QC_MESSAGE)
        decoder = qc_node_sharded
    else:
        node_sharded._check_options(opts)
        decoder = node_sharded
    if NODE_AXIS not in mesh.axis_names:
        raise ValueError(f"node-sharded decoding needs a mesh with a {NODE_AXIS!r} axis")
    n_err = _n_err(code, qber)
    # float32 division, as the single-device step decodes with
    aq = np.float32(n_err) / np.float32(code.n_vars)

    def batch_fn(shard, first, count, b):
        alice, bob = make_trial_batch(point_key, code.n_vars, b, n_err, first,
                                      backend=opts.backend, device=shard.device)
        llr = apriori_llr(bob, aq)
        syn = syndrome(code, alice)
        z, iters, ok = decoder._decode_row(code, llr.T, syn.T, opts, shard.row)
        keys_match = (z.T == alice.to(torch.int8)).all(dim=-1)
        valid = torch.arange(b, device=shard.device) < count
        return reduce_trials(ok, keys_match, iters, opts.max_iterations, valid)

    gbatch = _global_batch(batch, mesh)
    futures = _dispatch_chunks(_batch_loop(batch_fn, gbatch), mesh, trials, gbatch, opts,
                               max_batches_per_dispatch)
    total = _collect(futures, mesh)
    if tick is not None:
        tick(total.n_trials)
    return total, n_err / code.n_vars
