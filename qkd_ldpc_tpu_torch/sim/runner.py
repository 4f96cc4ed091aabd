"""Monte-Carlo sweep orchestration: the trial step, the point runner and
the sweep over matrices x QBER points with checkpoint/resume.

Counterpart of ``qkd_ldpc_tpu/sim/runner.py`` and, like it, of the
reference's batch simulator (``QKD_LDPC_batch_simulation``,
``src/simulation.cpp:192-316``).  One (matrix, QBER) point is key
generation, exact-weight error injection, syndrome computation, batched BP
decode and the statistics reduction, batch after batch, with seven int32
scalars per chunk as the only result fetched from the device.

Additions over the reference, as in the JAX package:

- **Checkpoint/resume**: each completed (matrix, QBER) point appends a JSON
  line; an interrupted sweep resumes where it stopped.  The file's name and
  lines are byte-identical to the JAX package's for the same experiment, so
  either package resumes the other's checkpoint.
- **Determinism contract**: point key = fold_in(master key, global point
  index); trial t = fold_in(point_key, t) — reproducible independent of
  batch size, and equal to the JAX package's stream.

A chunk of up to ``max_batches_per_dispatch`` trial batches is one device
program, as the JAX package's ``_point_chunk_step`` (``lax.scan`` under one
``jit``).  On the card it is one CUDA graph per (code, batch, batches a
chunk, options, prng, card) that holds, batch after batch, keygen (K4, K3
and the tie path gated on the card), syndrome, a-priori LLRs, the decode
(its loops WHILE nodes) and the statistics; a call copies one int32 input
vector in (point key, first trial id, valid trials, error count, LLR
magnitude: :func:`chunk_inputs`), replays the graph once and copies the
seven partials out.  Points differ only in that vector, so a sweep captures
once per code.  The CPU, ``backend="xla"`` and ``eager_loops()`` run the same
program eagerly.  The sweep keeps one point in flight, as the JAX package
does: point p+1 is dispatched before point p's statistics are fetched.
With ``cfg.use_mesh`` and more than one card visible, or more than one
process in a ``torch.distributed`` group, the sweep runs over a trial mesh
(``parallel``) with bit-identical results; only process 0 then writes the
checkpoint and shows progress.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from pathlib import Path
from typing import Callable, Sequence

import numpy as np
import torch

from qkd_ldpc_tpu_torch.channel.cuda_prng import DeviceRange
from qkd_ldpc_tpu_torch.channel.keys import make_trials_from_ids, master_key, num_errors_for
from qkd_ldpc_tpu_torch.channel.threefry import fold_in
from qkd_ldpc_tpu_torch.codes import LDPCCode, list_matrix_files, load_code
from qkd_ldpc_tpu_torch.config import Config
from qkd_ldpc_tpu_torch.decoder import device_loop
from qkd_ldpc_tpu_torch.decoder.bp import DecodeOptions, decode_program
from qkd_ldpc_tpu_torch.decoder.layered import NOT_QC_MESSAGE
from qkd_ldpc_tpu_torch.decoder.reconcile import llr_magnitude
from qkd_ldpc_tpu_torch.decoder.syndrome import syndrome
from qkd_ldpc_tpu_torch.sim.planner import rate_based_qber_range
from qkd_ldpc_tpu_torch.sim.progress import ProgressBar
from qkd_ldpc_tpu_torch.sim.stats import (
    STAT_KEYS,
    PointPartials,
    SimResult,
    finalize_point,
    partials_from_stacked,
    reduce_trials,
    stack_partials,
)
from qkd_ldpc_tpu_torch.utils import canonical_device, resolve_device


@dataclasses.dataclass
class SimInput:
    """One matrix plus its planned QBER sweep (reference ``sim_input``,
    ``src/simulation.hpp:16-21``)."""

    code: LDPCCode
    matrix_filename: str
    qber: list[float]


def decode_options_from_config(cfg: Config) -> DecodeOptions:
    return DecodeOptions(
        max_iterations=cfg.sum_product_max_iterations,
        clip_messages=cfg.enable_sum_product_msg_llr_threshold,
        message_threshold=cfg.sum_product_msg_llr_threshold,
        algorithm=cfg.decoder,
        min_sum_alpha=cfg.min_sum_alpha,
        min_sum_beta=cfg.min_sum_beta,
        message_dtype=cfg.dtype,
        backend=cfg.backend,
        schedule=cfg.schedule,
    )


def prepare_sim_inputs(
    matrix_paths: Sequence[str | Path], cfg: Config
) -> list[SimInput]:
    """Load all matrices and plan their QBER sweeps
    (reference ``prepare_sim_inputs``, simulation.cpp:140-158).

    ``cfg.threads_number`` sizes the host thread pool for matrix ingest
    (the reference sizes its trial pool with it, simulation.cpp:230; here
    trial parallelism is a device batch, so the host threads go to parsing
    many matrix files concurrently).
    """
    paths = list(matrix_paths)
    if cfg.threads_number > 1 and len(paths) > 1:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=cfg.threads_number) as pool:
            codes = list(
                pool.map(lambda p: load_code(p, dense=cfg.use_dense_matrices), paths)
            )
    else:
        codes = [load_code(p, dense=cfg.use_dense_matrices) for p in paths]
    inputs = []
    for path, code in zip(paths, codes):
        qber = rate_based_qber_range(code.code_rate, cfg.r_qber_parameters)
        inputs.append(
            SimInput(code=code, matrix_filename=Path(path).name, qber=qber)
        )
    return inputs


def point_batch_partials(
    code: LDPCCode,
    point_key: torch.Tensor,
    num_errors: int,
    trial_offset: int,
    valid_count: int,
    batch: int,
    opts: DecodeOptions,
    prng: str = "threefry",
    device=None,
) -> dict[str, torch.Tensor]:
    """One device step: trials [offset, offset+batch) -> partial sums (a
    chunk of one batch: on the card one graph replay)."""
    stacked = _point_chunk(code, point_key, num_errors, trial_offset, valid_count, batch,
                           1, opts, prng, device)
    return dict(zip(STAT_KEYS, stacked))


def merge_partials_tree(a: dict, b: dict) -> dict:
    """Device-side merge of two partial-sum dicts (min/max-aware)."""
    return dict(
        n_trials=a["n_trials"] + b["n_trials"],
        n_sp=a["n_sp"] + b["n_sp"],
        n_ldpc=a["n_ldpc"] + b["n_ldpc"],
        sum_it=a["sum_it"] + b["sum_it"],
        sum_it2=a["sum_it2"] + b["sum_it2"],
        min_it=torch.minimum(a["min_it"], b["min_it"]),
        max_it=torch.maximum(a["max_it"], b["max_it"]),
    )


# The int32 input vector of one chunk call (see chunk_inputs): its fields.
KEY, FIRST, VALID, ERRORS, LLR = slice(0, 2), slice(2, 3), slice(3, 4), slice(4, 5), slice(5, 6)
_M32 = 0xFFFFFFFF


def chunk_inputs(point_key: torch.Tensor, first: int, total_valid: int, num_errors: int,
                 n_vars: int) -> torch.Tensor:
    """The int32 ``[6]`` input vector of one chunk call, on the host: the
    point key's two words and the first trial id (raw uint32 bits, the id
    mod 2**32), the chunk's valid trials, the error count, and the bits of
    the float32 a-priori LLR magnitude (computed here from the float32 QBER
    ``num_errors / n_vars`` as ``reconcile.apriori_llr`` computes it)."""
    words = [int(w) & _M32 for w in point_key.tolist()] + [int(first) & _M32]
    mag = llr_magnitude(np.float32(num_errors) / np.float32(n_vars))
    vec = np.concatenate([np.array(words, np.uint32).view(np.int32),
                          np.array([total_valid, num_errors], np.int32),
                          np.array([mag], np.float32).view(np.int32)])
    return torch.from_numpy(vec)


class _ChunkProgram:
    """``n_batches`` trial batches of ``width`` lanes, merged on the device:
    the runner's one program, eager (``graph=None``) or captured into a
    :class:`~qkd_ldpc_tpu_torch.decoder.device_loop.Graph`.  Batch ``i``
    runs trials ``first + i * stride + lane`` and counts the lanes below
    ``valid - i * stride``; everything that varies per call is read from the
    input vector ``x`` (:func:`chunk_inputs`) on the device, so one capture
    serves every point and chunk of the code (``stride`` is the global batch
    of a trial shard, else ``width``)."""

    def __init__(self, code, width, stride, n_batches, opts, prng, device):
        self.code, self.width, self.stride, self.n_batches = code, width, stride, n_batches
        self.opts, self.prng, self.device = opts, prng, device
        self.decode, self.use_kernel, _ = decode_program(code, opts, device)

    def batch(self, x: torch.Tensor, i: int, graph) -> dict[str, torch.Tensor]:
        """Batch ``i``: keygen and channel (K4, K3, the gated tie path),
        syndrome, a-priori LLRs, decode, statistics."""
        code, B, opts, dev = self.code, self.width, self.opts, self.device
        ids = DeviceRange(x[FIRST], range(i * self.stride, i * self.stride + B))
        alice, bob = make_trials_from_ids(x[KEY], code.n_vars, ids, x[ERRORS], self.prng,
                                          opts.backend, dev)
        mag = x[LLR].view(torch.float32)
        llr = torch.where(bob.T == 1, -mag, mag).contiguous()  # [N, B]
        syn = syndrome(code, alice).T.contiguous()  # [M, B] int8
        z, iters, ok = self.decode(llr, syn, graph)
        keys_match = (z.T == alice.to(torch.int8)).all(dim=-1)
        valid = torch.arange(B, dtype=torch.int32, device=dev) < x[VALID] - i * self.stride
        return reduce_trials(ok, keys_match, iters, opts.max_iterations, valid)

    def __call__(self, x: torch.Tensor, graph=None) -> torch.Tensor:
        """The chunk's stacked ``[7]`` int32 partials."""
        out = None
        for i in range(self.n_batches):
            red = self.batch(x, i, graph)
            out = red if out is None else merge_partials_tree(out, red)
        return stack_partials(out)


def _point_chunk(code, point_key, num_errors, start_offset, total_valid,
                 batch, n_batches, opts, prng="threefry", device=None, stride=None):
    """``n_batches`` sequential trial batches merged on the device: one
    result fetch per chunk instead of per batch.  The tail batch masks its
    excess trials through ``total_valid``.  On the card under the kernel
    backend it is one replay of the chunk's captured graph: the input vector
    goes in by one copy from pinned memory, the ``[7]`` partials come back
    as a copy on the card.  ``stride`` (default ``batch``): the trial ids
    between two batches, a trial shard's global batch."""
    device = canonical_device(resolve_device(device))
    stride = batch if stride is None else stride
    x = chunk_inputs(point_key, start_offset, total_valid, num_errors, code.n_vars)
    program = _ChunkProgram(code, batch, stride, n_batches, opts, prng, device)
    if not device_loop.graphs_on(program.use_kernel, device):
        return program(x.to(device))
    key = ("chunk", code.fingerprint, batch, stride, n_batches, opts, prng)
    return device_loop.run_graph(
        key, lambda v, graph: (program(v, graph),), (x,), keep=program, device=device,
        loops=device_loop.LOOPS_PER_DECODE * n_batches,
        warmup=lambda v: program.batch(v, 0, None))[0]


def _dispatch_point(
    code: LDPCCode,
    point_key: torch.Tensor,
    qber: float,
    trials: int,
    batch: int,
    opts: DecodeOptions,
    max_batches_per_dispatch: int = 64,
    prng: str = "threefry",
    device=None,
) -> tuple[list, float]:
    """Run all trials of one point chunk by chunk WITHOUT fetching the
    statistics; returns (list of stacked device stats, actual QBER)."""
    device = resolve_device(device)
    n_err = num_errors_for(code.n_vars, qber)
    if n_err == 0:
        raise ValueError(f"Key size '{code.n_vars}' is too small for QBER.")
    actual_qber = n_err / code.n_vars

    # The device-side sum of iters^2 accumulates in exact int32; bound the
    # trials per chunk so chunk_trials * max_iterations^2 < 2^31 (host-side
    # merges across chunks are exact Python ints).
    mi2 = max(opts.max_iterations, 1) ** 2
    if batch * mi2 > 2**31 - 1:
        raise ValueError(
            f"batch ({batch}) x max_iterations^2 ({opts.max_iterations}^2) "
            "overflows the int32 iteration statistics; lower batch_size"
        )
    safe_batches = max(1, (2**31 - 1) // (batch * mi2))

    futures = []
    offset = 0
    while offset < trials:
        remaining = trials - offset
        n_batches = min(
            -(-remaining // batch), max_batches_per_dispatch, safe_batches
        )
        valid = min(n_batches * batch, remaining)
        futures.append(
            _point_chunk(code, point_key, n_err, offset, valid, batch,
                         n_batches, opts, prng, device)
        )
        offset += valid
    return [_HostCopy(f) for f in futures], actual_qber


class _HostCopy:
    """A device tensor's copy into pinned host memory, queued behind the
    work that makes it (a CUDA event marks its end): the host waits for it
    only when it reads it."""

    def __init__(self, t: torch.Tensor):
        self.event = None
        if t.is_cuda:
            self.host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self.host.copy_(t, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = t

    def get(self) -> torch.Tensor:
        if self.event is not None:
            self.event.synchronize()
        return self.host


def _collect_point(futures: list) -> PointPartials:
    total = PointPartials()
    for stacked in futures:
        total = total.merge(partials_from_stacked(stacked.get()))
    return total


def run_point(
    code: LDPCCode,
    point_key: torch.Tensor,
    qber: float,
    trials: int,
    batch: int,
    opts: DecodeOptions,
    tick: Callable[[int], None] | None = None,
    max_batches_per_dispatch: int = 64,
    prng: str = "threefry",
    device=None,
) -> tuple[PointPartials, float]:
    """Run all trials of one (matrix, QBER) point; returns (partials, actual
    QBER).  ``device=None`` means the card and raises when there is none."""
    futures, actual_qber = _dispatch_point(
        code, point_key, qber, trials, batch, opts, max_batches_per_dispatch,
        prng, device,
    )
    total = _collect_point(futures)
    if tick is not None:
        tick(total.n_trials)
    return total, actual_qber


def auto_batch_size(cfg: Config, code: LDPCCode) -> int:
    """Pick a trial batch size: the configured one, else up to 512 trials
    with the message state of a batch kept to a bounded size.  The rule is
    the JAX package's, so both packages sweep with the same batch (the
    results do not depend on it)."""
    if cfg.batch_size:
        return min(cfg.batch_size, cfg.trials_number)
    bytes_per_trial = code.n_checks * code.dc_max * 4 * 6
    cap = max(1, (3 << 29) // bytes_per_trial)
    return int(min(cfg.trials_number, 512, cap))


# --------------------------------------------------------------------------
# Checkpointing


def _experiment_fingerprint(sim_inputs: Sequence[SimInput], cfg: Config) -> str:
    """Hash of everything that determines a sweep's results, so a resumed
    checkpoint can never be silently reused for a *different* experiment.
    Equal to the JAX package's for the same inputs."""
    # compact_after is deliberately absent — compaction is a schedule change
    # with bit-identical results, so resuming a sweep with it toggled is
    # sound.  prng and a non-flooding schedule are part of the name, as in
    # the JAX package.
    parts = [
        f"{cfg.trials_number}|{cfg.simulation_seed}|"
        f"{cfg.sum_product_max_iterations}|{cfg.decoder}|{cfg.min_sum_alpha}|"
        f"{cfg.dtype}|{cfg.backend}|{cfg.enable_sum_product_msg_llr_threshold}|"
        f"{cfg.sum_product_msg_llr_threshold}"
        + ("" if cfg.prng == "threefry" else f"|prng={cfg.prng}")
        + ("" if cfg.schedule == "flooding" else f"|sched={cfg.schedule}")
    ]
    for si in sim_inputs:
        parts.append(
            f"{si.matrix_filename}|{si.code.n_vars}|{si.code.n_checks}|"
            f"{si.code.n_edges}|" + ",".join(f"{q:.9g}" for q in si.qber)
        )
    return hashlib.sha256("\n".join(parts).encode()).hexdigest()[:12]


def _checkpoint_path(cfg: Config, sim_inputs: Sequence[SimInput]) -> Path | None:
    if not cfg.checkpoint_dir:
        return None
    d = Path(cfg.checkpoint_dir)
    d.mkdir(parents=True, exist_ok=True)
    return d / (
        f"sweep(trial_num={cfg.trials_number},"
        f"max_sum_prod_iters={cfg.sum_product_max_iterations},"
        f"seed={cfg.simulation_seed},"
        f"exp={_experiment_fingerprint(sim_inputs, cfg)}).jsonl"
    )


def _load_checkpoint(path: Path | None) -> dict[int, dict]:
    if path is None or not path.exists():
        return {}
    done = {}
    for line in path.read_text().splitlines():
        if line.strip():
            rec = json.loads(line)
            done[rec["sim_number"]] = rec
    return done


def _append_checkpoint(path: Path | None, record: dict) -> None:
    if path is None:
        return
    with path.open("a") as f:
        f.write(json.dumps(record) + "\n")


# --------------------------------------------------------------------------
# Batch simulation


def batch_simulation(
    sim_inputs: Sequence[SimInput],
    cfg: Config,
    progress: bool = True,
    device=None,
) -> list[SimResult]:
    """Full sweep over all matrices x QBER points (reference
    ``QKD_LDPC_batch_simulation``), with checkpoint/resume.

    Points run in order on ``device`` (``None`` = the card; raises when there
    is none), one point in flight: point p+1 is dispatched before point p's
    statistics are fetched, as in the JAX package, so the host's dispatch of
    the next point overlaps the card's work on this one; checkpoint lines,
    CSV rows and progress ticks keep the JAX package's order.  With ``cfg.continuation_qber > 0`` every point of a matrix at
    or above it runs in ONE cross-point continuation call after the
    matrix's other points; its statistics are identical to the plain
    runner's.

    A trial mesh engages when ``cfg.use_mesh`` holds and either ``device``
    is the card unpinned (``None`` or ``cuda``) with more than one card
    visible — the mesh then covers every card — or this process belongs to a
    group of several — the mesh then holds ``device`` once in each process.
    ``batch`` is then per trial shard, as in the JAX package.  Every process
    reads the checkpoint (multi-process resume needs ``checkpoint_dir`` on a
    shared file system); only process 0 appends to it and shows progress.
    """
    unpinned = device is None or torch.device(device) == torch.device("cuda")
    device = resolve_device(device)
    opts = decode_options_from_config(cfg)
    if cfg.schedule == "layered" and any(si.code.qc is None for si in sim_inputs):
        # The JAX package raises this at the first decode of such a code,
        # after the sweep's earlier points; here before any point runs.
        raise ValueError(NOT_QC_MESSAGE)
    ckpt_path = _checkpoint_path(cfg, sim_inputs)
    done = _load_checkpoint(ckpt_path)
    master = master_key(cfg.simulation_seed, cfg.prng)
    mesh = _sweep_mesh(cfg, device, unpinned)
    if mesh is not None and mesh.process_index != 0:
        ckpt_path, progress = None, False

    total_trials = sum(len(si.qber) for si in sim_inputs) * cfg.trials_number
    bar = ProgressBar(total_trials, enabled=progress)
    results: dict[int, SimResult] = {}
    pending: list[tuple] = []  # (sim_number, si, actual_qber, collect)

    def flush_one() -> None:
        num, si, actual_qber, collect = pending.pop(0)
        finish(num, si, actual_qber, collect())

    def finish(num, si, actual_qber, partials) -> None:
        result = finalize_point(
            partials,
            sim_number=num,
            matrix_filename=si.matrix_filename,
            is_regular=si.code.is_regular,
            num_bit_nodes=si.code.n_vars,
            num_check_nodes=si.code.n_checks,
            initial_qber=actual_qber,
            max_iterations=opts.max_iterations,
        )
        results[num] = result
        _append_checkpoint(
            ckpt_path, dict(sim_number=num, result=dataclasses.asdict(result))
        )
        bar.tick(partials.n_trials)

    sim_number = 0
    for si in sim_inputs:
        batch = auto_batch_size(cfg, si.code)
        # Per-matrix options derive from the config-derived base every time
        # (compaction is sized by the per-matrix batch and must not leak
        # from one matrix into the next).
        m_opts = opts
        if cfg.compact_after > 0 and batch >= 8:
            # Residency compaction: schedule-only, bit-identical.  Lanes =
            # batch/4; waterfall points overflow into the exact full-batch
            # fallback.
            m_opts = dataclasses.replace(
                opts, compact_after=cfg.compact_after, compact_lanes=batch // 4,
            )
        if mesh is not None:
            from qkd_ldpc_tpu_torch.parallel.sweep import _collect as collect_sharded
            from qkd_ldpc_tpu_torch.parallel.sweep import make_point_dispatcher

            mesh_dispatch = make_point_dispatcher(si.code, batch, m_opts, mesh,
                                                  prng=cfg.prng)
        cont_entries = []  # (sim_number, qber, point_key) waterfall points
        for qber in si.qber:
            if sim_number in done:
                results[sim_number] = SimResult(**done[sim_number]["result"])
                bar.tick(cfg.trials_number)
                sim_number += 1
                continue
            point_key = fold_in(master, sim_number)
            if cfg.continuation_qber > 0 and qber >= cfg.continuation_qber:
                cont_entries.append((sim_number, qber, point_key))
            elif mesh is not None:  # finished in place: the mesh's own order
                futures, actual_qber = mesh_dispatch(point_key, qber, cfg.trials_number)
                finish(sim_number, si, actual_qber, collect_sharded(futures, mesh))
            else:
                futures, actual_qber = _dispatch_point(
                    si.code, point_key, qber, cfg.trials_number, batch, m_opts,
                    prng=cfg.prng, device=device,
                )
                pending.append((sim_number, si, actual_qber,
                                lambda f=futures: _collect_point(f)))
                if len(pending) > 1:  # keep one point in flight
                    flush_one()
            sim_number += 1

        if cont_entries:
            from qkd_ldpc_tpu_torch.sim.continuation import dispatch_sweep_continuation

            futs, actuals = dispatch_sweep_continuation(
                si.code, [k for _, _, k in cont_entries],
                [q for _, q, _ in cont_entries], cfg.trials_number,
                batch, m_opts, mesh=mesh, prng=cfg.prng, device=device,
            )
            for (num, _, _), (piece,), aq in zip(cont_entries, futs, actuals):
                # the points' slices share one fetch
                pending.append((num, si, aq,
                                lambda p=piece: partials_from_stacked(p.fetch())))
                if len(pending) > 1:
                    flush_one()
    while pending:
        flush_one()
    bar.close()
    return [results[i] for i in sorted(results)]


def _sweep_mesh(cfg: Config, device: torch.device, unpinned: bool):
    """The trial mesh of a sweep, or None for one device (see
    :func:`batch_simulation`)."""
    if not cfg.use_mesh:
        return None
    from qkd_ldpc_tpu_torch.parallel.mesh import make_trial_mesh, process_count

    if device.type == "cuda" and unpinned and torch.cuda.device_count() > 1:
        return make_trial_mesh()
    if process_count() > 1:
        return make_trial_mesh([device])
    return None


def simulate_directory(cfg: Config, matrix_dir: str | Path, progress: bool = True,
                       device=None) -> list[SimResult]:
    """Convenience: load every matrix in a directory and run the sweep."""
    paths = list_matrix_files(matrix_dir)
    if not paths:
        raise FileNotFoundError(f"Matrix folder is empty: {matrix_dir}")
    sim_inputs = prepare_sim_inputs(paths, cfg)
    return batch_simulation(sim_inputs, cfg, progress=progress, device=device)
