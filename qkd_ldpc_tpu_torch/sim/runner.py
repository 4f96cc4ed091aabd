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
and the tie path gated on the card), the a-priori LLRs and Alice's syndrome
(the continuation's staging kernel ``stage_fill``), the decode (its loops
WHILE nodes) and the statistics (:func:`trial_stats`, merged into the chunk's
partials on the card), the staging and the statistics in the decode's own
layout (:class:`_ChunkProgram`); a call copies one int32 input
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

import ctypes
import dataclasses
import hashlib
import json
from pathlib import Path
from typing import Callable, Sequence

import numpy as np
import torch

from qkd_ldpc_tpu_torch import _build
from qkd_ldpc_tpu_torch.channel.cuda_prng import DeviceRange
from qkd_ldpc_tpu_torch.channel.keys import make_trials_from_ids, master_key, num_errors_for
from qkd_ldpc_tpu_torch.channel.threefry import fold_in
from qkd_ldpc_tpu_torch.codes import LDPCCode, list_matrix_files, load_code
from qkd_ldpc_tpu_torch.config import Config
from qkd_ldpc_tpu_torch.decoder import device_loop
from qkd_ldpc_tpu_torch.decoder.bp import DecodeOptions, decode_program
from qkd_ldpc_tpu_torch.decoder.layered import NOT_QC_MESSAGE, layered_state_program
from qkd_ldpc_tpu_torch.decoder.reconcile import llr_magnitude
from qkd_ldpc_tpu_torch.sim.cuda_continuation import fill_bits_shape, stage_fill
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
from qkd_ldpc_tpu_torch.spans import span
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


# ---------------------------------------------------------------------------
# trial_stats: a batch's key check and statistics, merged into the chunk's [7]

KERNEL_STATS = "trial_stats"
KERNEL_STATS_LAYERED = "trial_stats_layered"  # the layered trial chunk's instance


def _merge_batch(out, ok, keys_match, iters, valid, offset, max_it, first):
    """``reduce_trials`` over the lanes below ``valid[0] - offset``, written
    into ``out`` (``first``) or merged into it as ``merge_partials_tree``."""
    lanes = torch.arange(ok.shape[0], dtype=torch.int32, device=ok.device)
    red = reduce_trials(ok, keys_match, iters, max_it, lanes < valid[0] - offset)
    if not first:
        red = merge_partials_tree(dict(zip(STAT_KEYS, out)), red)
    out.copy_(stack_partials(red))


def trial_stats_plain(z, alice_s, ok, iters, valid, offset, max_it, out, scratch=None,
                      first=True):
    """Batch statistics into ``out``, the chunk's int32 ``[7]`` partials
    (``STAT_KEYS``): the trials whose decision ``z [N, B]`` int8 equals
    Alice's bits ``alice_s [N, B]`` int8, the lanes below ``valid[0] -
    offset`` counted (``valid`` an int32 ``[1]``), reduced by
    ``reduce_trials`` with ``ok [B]`` and ``iters [B]``; the first batch's
    written, a later one's merged as ``merge_partials_tree`` merges.
    ``scratch`` is the kernel's (unused here)."""
    _merge_batch(out, ok, (z == alice_s).all(dim=0), iters, valid, offset, max_it, first)


def trial_stats_layered_plain(t, alice_l, ok, iters, valid, offset, max_it, out, scratch=None,
                              first=True):
    """:func:`trial_stats_plain` for the layered chunk, which keeps the
    sweep's layout: the decisions are ``t <= 0`` of the final totals ``t [nb,
    B, z]`` float32, compared with Alice's bits ``alice_l [nb, B, z]`` int8."""
    keys_match = ((t <= 0).to(torch.int8) == alice_l).all(dim=2).all(dim=0)
    _merge_batch(out, ok, keys_match, iters, valid, offset, max_it, first)


def _check_stats_args(ok, iters, valid, out, scratch, B):
    if ok.shape != (B,) or ok.dtype != torch.bool or iters.shape != (B,) or (
            iters.dtype != torch.int32):
        raise ValueError("trial_stats: ok is bool [B], iters int32 [B]")
    if valid.shape != (1,) or valid.dtype != torch.int32 or out.shape != (7,) or (
            out.dtype != torch.int32):
        raise ValueError("trial_stats: valid is int32 [1], out int32 [7]")
    if scratch.shape != (B + 1,) or scratch.dtype != torch.int32:
        raise ValueError(f"trial_stats: scratch must be int32 [{B + 1}]")


def _launch_stats(name, tensors, *sizes):
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev or not t.is_contiguous() for t in tensors):
        raise ValueError("trial_stats needs contiguous CUDA tensors on one device")
    P, I = ctypes.c_void_p, ctypes.c_int
    fn = _build.function("trial_stats", name, [P] * 7 + [I] * len(sizes) + [P])
    with torch.cuda.device(dev):
        err = fn(*(t.data_ptr() for t in tensors), *sizes,
                 torch.cuda.current_stream().cuda_stream)
    _build.check_launch(name, err)


def trial_stats_cuda(z, alice_s, ok, iters, valid, offset, max_it, out, scratch, first=True):
    """One launch (``csrc/trial_stats.cu``); ``scratch`` is int32 ``[B + 1]``,
    all 0 before the launch, which leaves it so."""
    N, B = z.shape
    if alice_s.shape != (N, B) or z.dtype != torch.int8 or alice_s.dtype != torch.int8:
        raise ValueError("trial_stats: z and alice_s are int8 [N, B]")
    _check_stats_args(ok, iters, valid, out, scratch, B)
    if N * B >= 2**31 or B > 8 * 48 * 1024:
        raise ValueError("trial_stats: N * B must fit 32-bit offsets and B a block's "
                         "48 KiB of lane masks")
    _launch_stats(KERNEL_STATS, (z, alice_s, ok, iters, valid, out, scratch), offset, max_it,
                  N, B, int(first))


def trial_stats_layered_cuda(t, alice_l, ok, iters, valid, offset, max_it, out, scratch,
                             first=True):
    """One launch of the layered instance (``csrc/trial_stats.cu``); ``scratch``
    as :func:`trial_stats_cuda`'s."""
    nb, B, z = t.shape
    if alice_l.shape != (nb, B, z) or t.dtype != torch.float32 or alice_l.dtype != torch.int8:
        raise ValueError("trial_stats: t is float32 and alice_l int8 [nb, B, z]")
    _check_stats_args(ok, iters, valid, out, scratch, B)
    if nb * B * z >= 2**31:
        raise ValueError("trial_stats: nb * B * z must fit 32-bit offsets")
    _launch_stats(KERNEL_STATS_LAYERED, (t, alice_l, ok, iters, valid, out, scratch), offset,
                  max_it, nb, B, z, int(first))


def trial_stats_width(z, alice_s) -> int:
    """Bytes a load of the instance :func:`trial_stats_cuda` launches for
    these tensors: 16, or 8, 4, 1 where ``B`` or a base address is not
    16-byte aligned."""
    fn = _build.function("trial_stats", "trial_stats_width",
                         [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int])
    return int(fn(z.data_ptr(), alice_s.data_ptr(), z.shape[1]))


def trial_stats_layered_width(t, alice_l) -> int:
    """Floats of ``t`` a lane of :func:`trial_stats_layered_cuda` loads a
    step: 4 where ``z`` and the base addresses allow it, else 1."""
    fn = _build.function("trial_stats", "trial_stats_layered_width",
                         [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int])
    return int(fn(t.data_ptr(), alice_l.data_ptr(), t.shape[2]))


def trial_stats(z, alice_s, ok, iters, valid, offset, max_it, out, scratch, first, *,
                use_kernel):
    """The instance for the layout of ``z``: decisions ``[N, B]`` int8, or the
    layered sweep's final totals ``[nb, B, z]`` float32."""
    if z.ndim == 3:
        stats = trial_stats_layered_cuda if use_kernel else trial_stats_layered_plain
    else:
        stats = trial_stats_cuda if use_kernel else trial_stats_plain
    stats(z, alice_s, ok, iters, valid, offset, max_it, out, scratch, first)


class _ChunkProgram:
    """``n_batches`` trial batches of ``width`` lanes, merged on the device:
    the runner's one program, eager (``graph=None``) or captured into a
    :class:`~qkd_ldpc_tpu_torch.decoder.device_loop.Graph`.  Batch ``i``
    runs trials ``first + i * stride + lane`` and counts the lanes below
    ``valid - i * stride``; everything that varies per call is read from the
    input vector ``x`` (:func:`chunk_inputs`) on the device, so one capture
    serves every point and chunk of the code (``stride`` is the global batch
    of a trial shard, else ``width``).  Around the decode a batch is the
    continuation's staging (``stage_fill``: the LLRs, Alice's syndrome and
    bits) and :func:`trial_stats`, in the decode's layout: the flooding
    decode (``decode_program``) takes ``[N, B]`` tensors, and the staging
    transposes the trials' ``[B, N]`` rows into them (two kernels); the
    layered decode keeps its own ``[nb, B, z]`` state from the staging to the
    statistics (``layered.layered_state_program``: one staging kernel, the
    statistics read the final totals), so no copy touches it.  The CPU and
    ``backend="xla"`` run the plain versions."""

    def __init__(self, code, width, stride, n_batches, opts, prng, device):
        self.code, self.width, self.stride, self.n_batches = code, width, stride, n_batches
        self.opts, self.prng, self.device = opts, prng, device
        if opts.schedule == "layered":
            self.decode, self.use_kernel, self.maps = layered_state_program(code, opts, device)
            z, nb, mb = self.maps.z, self.maps.nb, self.maps.mb
            self.shapes = (nb, width, z), (mb, width, z)
        else:
            self.decode, self.use_kernel, _ = decode_program(code, opts, device)
            self.maps = code.to_device(device)
            self.shapes = (code.n_vars, width), (code.n_checks, width)

    def buffers(self) -> tuple[torch.Tensor, torch.Tensor]:
        """The chunk's ``[7]`` partials (the first batch writes them) and the
        statistics kernel's scratch (zeros, left so by every launch)."""
        return (torch.empty(7, dtype=torch.int32, device=self.device),
                torch.zeros(self.width + 1, dtype=torch.int32, device=self.device))

    def batch(self, x: torch.Tensor, i: int, graph, out: torch.Tensor,
              scratch: torch.Tensor) -> None:
        """Batch ``i``: keygen and channel (K4, K3, the gated tie path),
        staging (a-priori LLRs, Alice's syndrome and bits), decode, and its
        statistics into ``out``."""
        code, B, opts, dev, kern = self.code, self.width, self.opts, self.device, self.use_kernel
        N = code.n_vars
        ids = DeviceRange(x[FIRST], range(i * self.stride, i * self.stride + B))
        alice, bob = make_trials_from_ids(x[KEY], N, ids, x[ERRORS], self.prng,
                                          opts.backend, dev)
        bits_shape, checks_shape = self.shapes
        llr = torch.empty(bits_shape, dtype=torch.float32, device=dev)
        syn = torch.empty(checks_shape, dtype=torch.int8, device=dev)
        alice_s = torch.empty(bits_shape, dtype=torch.int8, device=dev)
        bits = (torch.empty(fill_bits_shape(B, N), dtype=torch.int32, device=dev)
                if kern and llr.ndim == 2 else None)
        stage_fill(alice, bob, self.maps, x[LLR], llr, syn, alice_s, use_kernel=kern, bits=bits)
        z, iters, ok = self.decode(llr, syn, graph)
        trial_stats(z, alice_s, ok, iters, x[VALID], i * self.stride, opts.max_iterations,
                    out, scratch, i == 0, use_kernel=kern)

    def __call__(self, x: torch.Tensor, graph=None) -> torch.Tensor:
        """The chunk's stacked ``[7]`` int32 partials."""
        out, scratch = self.buffers()
        for i in range(self.n_batches):
            self.batch(x, i, graph, out, scratch)
        return out


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
        loops=device_loop.loops_per_decode(batch, opts) * n_batches,
        warmup=lambda v: program.batch(v, 0, None, *program.buffers()))[0]


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
    with span("qkd.point.dispatch"):
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
        with span("qkd.fetch.wait"):
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
    with span("qkd.point.run"):
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
    with span("qkd.sweep.checkpoint"), path.open("a") as f:
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
    with span("qkd.sweep.run"):
        with span("qkd.sweep.setup"):
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
