"""The trial chunk as one program (``sim/runner.py``'s ``_ChunkProgram``)
against the JAX package's ``_point_chunk_step`` and ``_sharded_chunk``; the
device-scalar forms of the channel kernels' wrappers; the gated tie block of
``introduce_errors``; and the port's exports against the JAX package's.

The port runs on the CPU, where the chunk program runs eagerly through the
kernels' plain versions (on the card the same program is captured as one
CUDA graph, which ``chip_smoke.py`` holds against the eager chunk).  Codes
are the small QC code of the other port tests; keys come from the JAX
package's key tree, carried across as words.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qkd_ldpc_tpu.channel import keys as jkeys
from qkd_ldpc_tpu.decoder.bp import DecodeOptions as JaxDecodeOptions
from qkd_ldpc_tpu.parallel import make_trial_mesh as j_make_trial_mesh
from qkd_ldpc_tpu.parallel.sweep import _make_trial_lane, _sharded_chunk
from qkd_ldpc_tpu.sim.runner import _point_chunk_step
from qkd_ldpc_tpu_torch.channel import cuda_prng, cuda_select
from qkd_ldpc_tpu_torch.channel import keys as tkeys
from qkd_ldpc_tpu_torch.channel.cuda_prng import ALICE, SCORES, TIES, DeviceRange
from qkd_ldpc_tpu_torch.channel.threefry import to_raw_int32
from qkd_ldpc_tpu_torch.decoder import device_loop
from qkd_ldpc_tpu_torch.decoder.bp import DecodeOptions
from qkd_ldpc_tpu_torch.parallel import make_trial_mesh
from qkd_ldpc_tpu_torch.parallel.sweep import _collect, _dispatch_chunks, _trial_chunk_fn
from qkd_ldpc_tpu_torch.sim import runner
from qkd_ldpc_tpu_torch.sim.runner import (
    _ChunkProgram,
    _dispatch_point,
    _point_chunk,
    chunk_inputs,
    point_batch_partials,
)
from qkd_ldpc_tpu_torch.sim.stats import STAT_KEYS
from tests._torch_port_common import code_pair

torch.set_num_threads(1)
CPU = torch.device("cpu")
# Three batches of 16 with a tail: 40 valid trials from trial 5 on.
BATCH, N_BATCHES, TOTAL_VALID, START = 16, 3, 40, 5
# 21 of 384 bits: frames take 2 to 17 iterations, some lanes overflow the
# compacted lanes (phase C runs).
N_ERRORS = 21
# Sum-product across formulations (the North star): verdicts equal, the sum
# of iterations within this many frames moved by one iteration.
SP_ITERATION_ALLOWANCE = 2
SCHEDULES = {
    "flooding": dict(schedule="flooding", compact_after=4, compact_lanes=4),
    "layered": dict(schedule="layered", compact_after=2, compact_lanes=4),
}


def _options(schedule, algorithm):
    kw = dict(algorithm=algorithm, max_iterations=30, message_dtype="bfloat16",
              **SCHEDULES[schedule])
    return JaxDecodeOptions(**kw), DecodeOptions(**kw)


def _jax_chunk(jc, point, n_err, start, total_valid, opts, n_batches=N_BATCHES):
    return np.asarray(_point_chunk_step(
        jc, jkeys.derive_point_key(777, point), jnp.int32(n_err), jnp.int32(start),
        jnp.int32(total_valid), batch=BATCH, n_batches=n_batches, opts=opts,
        prng="threefry")).tolist()


def _assert_north_star(got, want, algorithm):
    """Min-sum 7/7; sum-product: trials and verdicts equal, the iteration
    statistics within ``SP_ITERATION_ALLOWANCE`` frames moved by one."""
    if algorithm == "min-sum":
        assert got == want
        return
    g, w = dict(zip(STAT_KEYS, got)), dict(zip(STAT_KEYS, want))
    assert [g[k] for k in ("n_trials", "n_sp", "n_ldpc")] == [
        w[k] for k in ("n_trials", "n_sp", "n_ldpc")]
    assert abs(g["sum_it"] - w["sum_it"]) <= SP_ITERATION_ALLOWANCE
    assert abs(g["min_it"] - w["min_it"]) <= 1 and abs(g["max_it"] - w["max_it"]) <= 1


# ---- F2: the port exports every name the JAX package exports --------------


@pytest.mark.parametrize("sub", ["", ".channel", ".codes", ".decoder", ".parallel", ".sim"],
                         ids=["top", "channel", "codes", "decoder", "parallel", "sim"])
def test_port_exports_every_jax_name(sub):
    jmod = importlib.import_module("qkd_ldpc_tpu" + sub)
    tmod = importlib.import_module("qkd_ldpc_tpu_torch" + sub)
    missing = [name for name in jmod.__all__ if not hasattr(tmod, name)]
    assert not missing, f"qkd_ldpc_tpu_torch{sub} lacks {missing}"


# ---- (a) the chunk program against _point_chunk_step ------------------------


@pytest.mark.parametrize("algorithm", ["min-sum", "sum-product"])
@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
def test_chunk_equals_jax_point_chunk_step(schedule, algorithm):
    """Three batches with a tail and compaction (phase C included): the
    seven partials of ``_point_chunk`` equal JAX's ``_point_chunk_step``."""
    jc, tc = code_pair("qc")
    jo, to = _options(schedule, algorithm)
    want = _jax_chunk(jc, 3, N_ERRORS, START, TOTAL_VALID, jo)
    got = _point_chunk(tc, tkeys.derive_point_key(777, 3), N_ERRORS, START, TOTAL_VALID,
                       BATCH, N_BATCHES, to, device=CPU).tolist()
    _assert_north_star(got, want, algorithm)
    assert got[0] == TOTAL_VALID


# ---- (b) one program instance, three input vectors ---------------------------


@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
def test_one_program_serves_three_inputs(schedule):
    """One ``_ChunkProgram`` driven with three input vectors that differ in
    key, error count, first trial and valid trials: each result equals a
    fresh eager chunk for that input and JAX's chunk (min-sum, 7/7).  No
    value of the first input stays in the program."""
    jc, tc = code_pair("qc")
    jo, to = _options(schedule, "min-sum")
    program = _ChunkProgram(tc, BATCH, BATCH, N_BATCHES, to, "threefry", CPU)
    results = []
    for point, n_err, start, valid in ((3, N_ERRORS, START, TOTAL_VALID),
                                       (4, 15, 2**32 - 20, 48), (5, 24, 1000, 17)):
        key = tkeys.derive_point_key(777, point)
        got = program(chunk_inputs(key, start, valid, n_err, tc.n_vars)).tolist()
        fresh = _point_chunk(tc, key, n_err, start, valid, BATCH, N_BATCHES, to,
                             device=CPU).tolist()
        jstart = start - 2**32 if start >= 2**31 else start  # JAX's int32 offset
        assert got == fresh == _jax_chunk(jc, point, n_err, jstart, valid, jo)
        results.append(got)
    assert len({tuple(r) for r in results}) == 3


def test_chunk_inputs_layout():
    """The input vector: key words and first id as raw uint32 bits, the
    counts, and the LLR magnitude's float32 bits as ``apriori_llr`` forms it."""
    from qkd_ldpc_tpu_torch.decoder.reconcile import apriori_llr

    key = torch.tensor([2**32 - 1, 7], dtype=torch.int64)
    x = chunk_inputs(key, 2**32 + 3, 40, 21, 384)
    assert x.dtype == torch.int32 and x.shape == (6,)
    assert x[runner.KEY].tolist() == [-1, 7] and x[runner.FIRST].tolist() == [3]
    assert x[runner.VALID].item() == 40 and x[runner.ERRORS].item() == 21
    want = apriori_llr(torch.zeros((1, 1), dtype=torch.uint8),
                       np.float32(21) / np.float32(384))
    assert torch.equal(x[runner.LLR].view(torch.float32), want[0])


def test_point_batch_partials_is_a_chunk_of_one_batch():
    """``point_batch_partials`` keeps the JAX signature: a dict of the seven
    0-d partials of one batch, equal to JAX's single-batch chunk."""
    jc, tc = code_pair("qc")
    jo, to = _options("flooding", "min-sum")
    got = point_batch_partials(tc, tkeys.derive_point_key(777, 3), N_ERRORS, START, 11,
                               BATCH, to, device=CPU)
    assert list(got) == list(STAT_KEYS)
    assert all(v.ndim == 0 and v.dtype == torch.int32 for v in got.values())
    assert [int(v) for v in got.values()] == _jax_chunk(jc, 3, N_ERRORS, START, 11, jo,
                                                         n_batches=1)


# ---- the capture's key and calls, with the graph stood in for ----------------


def _fake_graphs(monkeypatch):
    """Take the graph path on the CPU: ``run_graph`` records its key, loops
    and inputs and runs the program eagerly."""
    calls = []

    def fake_run_graph(key, program, inputs, keep=None, device=None, loops=3, warmup=None):
        assert all(not x.is_cuda and x.dtype == torch.int32 and x.shape == (6,)
                   for x in inputs)
        calls.append((key, loops))
        return program(*inputs, None)

    monkeypatch.setattr(device_loop, "graphs_on", lambda use_kernel, device: True)
    monkeypatch.setattr(device_loop, "run_graph", fake_run_graph)
    return calls


def test_a_sweep_captures_once_per_code(monkeypatch):
    """Points that differ in QBER, key and offset share one graph key (the
    error count is an input, not part of the key); each chunk is one call;
    the graph holds three loops a batch; results equal the eager path."""
    _, tc = code_pair("qc")
    _, to = _options("flooding", "min-sum")
    points = [(runner.fold_in(tkeys.master_key(5), i), q) for i, q in
              enumerate((0.03, 0.04, 0.055))]
    eager = [_dispatch_point(tc, k, q, 40, BATCH, to, device=CPU) for k, q in points]
    calls = _fake_graphs(monkeypatch)
    graphed = [_dispatch_point(tc, k, q, 40, BATCH, to, device=CPU) for k, q in points]
    assert len(calls) == 3 and len({key for key, _ in calls}) == 1
    assert {loops for _, loops in calls} == {device_loop.LOOPS_PER_DECODE * 3}
    for (fe, qe), (fg, qg) in zip(eager, graphed):
        assert qe == qg
        assert [f.get().tolist() for f in fe] == [f.get().tolist() for f in fg]


# ---- (c) the sharded chunk against _sharded_chunk and the single device ------


@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
def test_sharded_chunk_equals_jax_and_single_device(schedule):
    """Four trial shards of a global batch of 16 (4 lanes each), three
    batches with a tail: the shards' chunks (the runner's chunk program with
    the global batch as stride) merged equal JAX's ``_sharded_chunk`` on a
    four-device mesh and the port's single-device chunk, 7/7 (min-sum)."""
    jc, tc = code_pair("qc")
    jo, to = _options(schedule, "min-sum")
    jmesh = j_make_trial_mesh(jax.devices()[:4])
    want = np.asarray(_sharded_chunk(
        jc, jkeys.derive_point_key(777, 3), _make_trial_lane(BATCH, jmesh),
        jnp.int32(N_ERRORS), jnp.int32(0), jnp.int32(TOTAL_VALID), tc.n_vars, N_BATCHES,
        jo, "threefry")).tolist()
    key = tkeys.derive_point_key(777, 3)
    mesh = make_trial_mesh([CPU] * 4)
    futures = _dispatch_chunks(_trial_chunk_fn(tc, key, N_ERRORS, to, "threefry", BATCH),
                               mesh, TOTAL_VALID, BATCH, to, N_BATCHES)
    assert len(futures) == 1 and len(futures[0]) == 4
    got = _collect(futures, mesh)
    single = _point_chunk(tc, key, N_ERRORS, 0, TOTAL_VALID, BATCH, N_BATCHES, to,
                          device=CPU).tolist()
    stats = [getattr(got, k) for k in STAT_KEYS]
    assert stats == want == single


# ---- (d) the kernels' wrappers take the device-scalar forms ------------------


@pytest.mark.parametrize("start", [0, 77, 2**32 - 3], ids=["zero", "offset", "wrapping"])
def test_trial_words_take_a_device_range_and_raw_key_words(start):
    """K4's plain version: a key as int32 raw words and ids as a base tensor
    plus a range give the rows of the int64 key and the plain range."""
    key = tkeys.derive_point_key(777, 9)
    want = cuda_prng.trial_words_plain(key, 96, range(start, start + 5), (ALICE, SCORES, TIES))
    base = to_raw_int32(torch.tensor([start - 2 if start >= 2 else start], dtype=torch.int64))
    shift = 2 if start >= 2 else 0
    ids = DeviceRange(base, range(shift, shift + 5))
    got = cuda_prng.trial_words(to_raw_int32(key), 96, ids, (ALICE, SCORES, TIES), "xla")
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    alice, bob = tkeys.make_trials_from_ids(to_raw_int32(key), 96, ids,
                                            torch.tensor([9], dtype=torch.int32), device=CPU)
    a2, b2 = tkeys.make_trial_batch(key, 96, 5, 9, start, device=CPU)
    assert torch.equal(alice, a2) and torch.equal(bob, b2)


def test_device_range_base_must_be_one_int32():
    with pytest.raises(ValueError, match="int32"):
        cuda_prng.trial_words_plain(torch.tensor([1, 2]), 8,
                                    DeviceRange(torch.zeros(1, dtype=torch.int64), range(2)))


@pytest.mark.parametrize("k", [0, 1, 37, 96])
def test_select_flip_takes_a_one_element_k_tensor(k):
    """K3's plain version: k as an int32 [1] tensor equals the int form."""
    key = tkeys.derive_point_key(3, 4)
    alice, scores = cuda_prng.trial_words_plain(key, 96, range(0, 8), (ALICE, SCORES))
    scores[4:] &= -(1 << 26)  # ties at the threshold in half the rows
    want = cuda_select.select_flip(scores, k, alice)
    got = cuda_select.select_flip(scores, torch.tensor([k], dtype=torch.int32), alice)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("k", [3, 40])
def test_tie_completion_takes_a_one_element_k_tensor(k):
    """The tie path (KT's plain version, ``_uniform_ties`` under the flag)
    with k as an int32 [1] tensor equals the int form and JAX's
    ``_exact_weight_mask``."""
    rng = np.random.default_rng(k)
    scores = rng.integers(0, 2**32, (6, 120), dtype=np.uint64).astype(np.uint32)
    scores &= np.uint32(0xF0000000)  # excess ties in every row
    second = rng.integers(0, 2**32, (6, 120), dtype=np.uint64).astype(np.uint32)
    alice = rng.integers(0, 2, (6, 120), dtype=np.uint8)

    def raw(a):
        return torch.from_numpy(a.view(np.int32).copy())

    want = np.asarray(jkeys._exact_weight_mask(
        jnp.asarray(scores), k, tie_scores_fn=lambda: jnp.asarray(second))) ^ alice
    for kk in (k, torch.tensor([k], dtype=torch.int32)):
        got = tkeys._exact_weight_flip(raw(scores), torch.from_numpy(alice), kk,
                                       lambda: raw(second), "xla")
        np.testing.assert_array_equal(got.numpy(), want)


def test_block_words_plain_equals_jax_bits():
    """The flat block (plain version of the block kernel) is
    ``jax.random.bits(key, shape)``, as ``keys.block_words`` reshapes it."""
    jk = jax.random.PRNGKey(1234)
    want = np.asarray(jax.random.bits(jk, (3, 50), jnp.uint32))
    key = torch.from_numpy(np.asarray(jk).astype(np.int64))
    got = tkeys.block_words(key, (3, 50), CPU)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    flat = cuda_prng.block_words(to_raw_int32(key), 150, CPU)
    assert torch.equal(flat.view(3, 50), got)


def test_block_kernel_wrappers_refuse_the_cpu():
    key = torch.tensor([1, 2])
    flag = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA device"):
        cuda_prng.block_words_cuda(key, 8, CPU)
    with pytest.raises(ValueError, match="off the card"):
        cuda_prng.block_words(key, 8, CPU, gate=flag)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_select.complete_ties_cuda(torch.zeros((2, 8), dtype=torch.int32),
                                       torch.zeros((2, 1), dtype=torch.int32),
                                       torch.tensor([3], dtype=torch.int32),
                                       torch.zeros((2, 8), dtype=torch.int32),
                                       torch.zeros((2, 8), dtype=torch.uint8),
                                       torch.zeros((2, 8), dtype=torch.uint8), flag)


# ---- D1: introduce_errors draws its tie block only on excess ties -------------


def _count_blocks(monkeypatch, cut_first=False):
    """Count ``cuda_prng.block_words`` calls; ``cut_first`` keeps only the top
    two bits of the first block (the scores: excess ties in every row)."""
    real, calls = cuda_prng.block_words, []

    def spy(key, count, device, backend="auto", gate=None):
        out = real(key, count, device, backend, gate)
        calls.append(count)
        return out & -2**30 if cut_first and len(calls) == 1 else out

    monkeypatch.setattr(cuda_prng, "block_words", spy)
    return calls


def test_introduce_errors_skips_the_tie_block_without_excess(monkeypatch):
    jk = jax.random.PRNGKey(99)
    alice = np.random.default_rng(1).integers(0, 2, (4, 300), dtype=np.uint8)
    want = np.asarray(jkeys.introduce_errors(jk, jnp.asarray(alice), 17))
    calls = _count_blocks(monkeypatch)
    got = tkeys.introduce_errors(torch.from_numpy(np.asarray(jk).astype(np.int64)),
                                 alice, 17, device=CPU)
    np.testing.assert_array_equal(got.numpy(), want)
    assert calls == [4 * 300]  # the scores only


def test_introduce_errors_tie_block_is_fold_in_key_1(monkeypatch):
    """With excess ties in every row the tie block is drawn, from
    ``fold_in(key, 1)``, and Bob's bits equal JAX's mask on the same cut
    scores with the JAX tie words."""
    jk = jax.random.PRNGKey(98)
    alice = np.random.default_rng(2).integers(0, 2, (4, 300), dtype=np.uint8)
    calls = _count_blocks(monkeypatch, cut_first=True)
    got = tkeys.introduce_errors(torch.from_numpy(np.asarray(jk).astype(np.int64)),
                                 alice, 17, device=CPU)
    assert calls == [4 * 300, 4 * 300]
    scores = np.asarray(jax.random.bits(jk, (4, 300), jnp.uint32)) & np.uint32(0xC0000000)
    ties = jax.random.bits(jax.random.fold_in(jk, 1), (4, 300), jnp.uint32)
    mask = np.asarray(jkeys._exact_weight_mask(jnp.asarray(scores), 17,
                                               tie_scores_fn=lambda: ties))
    np.testing.assert_array_equal(got.numpy(), alice ^ mask.astype(np.uint8))
