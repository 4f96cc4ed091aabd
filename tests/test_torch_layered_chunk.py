"""The layered trial chunk in the sweep's own layout (``sim/runner.py``'s
``_ChunkProgram`` under ``schedule="layered"``): the staging writes ``t``,
Alice's syndrome and bits as ``[nb, B, z]`` (``stage_fill_layered_plain``),
the decode takes and returns that state (``layered.layered_state_program``),
and the statistics read the final ``t`` (``trial_stats_layered_plain``).

Each plain version is held against the ``[N, B]`` one on the same inputs
moved into the layered layout, the chunk against the ``[N, B]`` route through
``decode_program``, and ``decode_program`` / ``layered_decode_batch_last`` /
the serving endpoint to their ``[N, B]`` contract.  On the card
``chip_smoke.py --chunk-glue`` holds the kernels against these plain versions.
"""

import numpy as np
import pytest
import torch

from qkd_ldpc_tpu_torch.channel.cuda_prng import DeviceRange
from qkd_ldpc_tpu_torch.channel.keys import derive_point_key, make_trials_from_ids
from qkd_ldpc_tpu_torch.codes import make_qc_code
from qkd_ldpc_tpu_torch.decoder.bp import DecodeOptions, decode, decode_program
from qkd_ldpc_tpu_torch.decoder.layered import (
    layer_tables,
    layered_decode_batch_last,
    layered_state_program,
)
from qkd_ldpc_tpu_torch.decoder.reconcile import llr_magnitude
from qkd_ldpc_tpu_torch.serve import Reconciler
from qkd_ldpc_tpu_torch.sim import cuda_continuation as steps
from qkd_ldpc_tpu_torch.sim import runner
from qkd_ldpc_tpu_torch.sim.runner import (
    ERRORS,
    FIRST,
    KEY,
    LLR,
    VALID,
    _ChunkProgram,
    chunk_inputs,
    trial_stats,
    trial_stats_layered_cuda,
    trial_stats_layered_plain,
    trial_stats_plain,
)

torch.set_num_threads(1)
CPU = torch.device("cpu")
MAX_IT = 30
# (z, nb, mb, dv, seed) of make_qc_code: z a multiple of 32, of 4 only, odd
CODES = {"z32": (32, 12, 6, 3, 5), "z20": (20, 6, 3, 2, 4), "z13": (13, 10, 5, 3, 3)}
_codes = {}


def _code(which):
    if which not in _codes:
        z, nb, mb, dv, seed = CODES[which]
        _codes[which] = make_qc_code(z=z, nb=nb, mb=mb, dv=dv, seed=seed)
    return _codes[which]


def _layered(x, nb, z):
    """An ``[nb z, B]`` array in the sweep's ``[nb, B, z]`` layout."""
    return x.reshape(nb, z, x.shape[1]).permute(0, 2, 1).contiguous()


def _rows(rng, B, N, p=0.07):
    alice = rng.integers(0, 2, (B, N)).astype(np.uint8)
    bob = alice ^ (rng.random((B, N)) < p).astype(np.uint8)
    return torch.from_numpy(alice), torch.from_numpy(bob)


# ---- the staging ------------------------------------------------------------


@pytest.mark.parametrize("B", [1, 37, 64])
@pytest.mark.parametrize("which", sorted(CODES))
def test_layered_staging_equals_the_nb_staging_permuted(which, B):
    """``t``, Alice's syndrome and bits of the layered staging are the ``[N,
    B]`` staging's arrays, each row ``j z + k`` moved to ``[j, :, k]``, bit
    for bit; the arrays start as garbage, so every element is written."""
    code = _code(which)
    tables = layer_tables(code, CPU)
    nb, mb, z = tables.nb, tables.mb, tables.z
    N, M = code.n_vars, code.n_checks
    rng = np.random.default_rng(B * 7 + z)
    alice, bob = _rows(rng, B, N)
    mag = torch.tensor([np.float32(3.125)]).view(torch.int32)
    llr, syn, alice_s = (torch.empty((N, B)), torch.empty((M, B), dtype=torch.int8),
                         torch.empty((N, B), dtype=torch.int8))
    steps.stage_fill_plain(alice, bob, code.to_device(CPU), mag, llr, syn, alice_s)
    t = torch.full((nb, B, z), float("nan"))
    syn_l = torch.full((mb, B, z), 7, dtype=torch.int8)
    alice_l = torch.full((nb, B, z), 7, dtype=torch.int8)
    steps.stage_fill(alice, bob, tables, mag, t, syn_l, alice_l, use_kernel=False)
    assert torch.equal(t.view(torch.int32), _layered(llr, nb, z).view(torch.int32))
    assert torch.equal(syn_l, _layered(syn, mb, z))
    assert torch.equal(alice_l, _layered(alice_s, nb, z))
    assert int(syn_l.sum()) > 0


def test_layered_staging_refusals():
    """The kernel's wrapper refuses wrong shapes and types before it looks for
    the card, and CPU tensors."""
    code = _code("z32")
    tables = layer_tables(code, CPU)
    nb, mb, z, B = tables.nb, tables.mb, tables.z, 8
    alice, bob = _rows(np.random.default_rng(1), B, code.n_vars)
    mag = torch.tensor([np.float32(2.0)]).view(torch.int32)
    t, syn, al = (torch.empty((nb, B, z)), torch.empty((mb, B, z), dtype=torch.int8),
                  torch.empty((nb, B, z), dtype=torch.int8))
    with pytest.raises(ValueError, match=r"\[nb, S, z\]"):
        steps.stage_fill_layered_cuda(alice, bob, tables, mag, t[:, :4], syn, al)
    with pytest.raises(ValueError, match="float32"):
        steps.stage_fill_layered_cuda(alice, bob, tables, mag, t.double(), syn, al)
    with pytest.raises(ValueError, match="mag"):
        steps.stage_fill_layered_cuda(alice, bob, tables, mag.float(), t, syn, al)
    with pytest.raises(ValueError, match="CUDA"):
        steps.stage_fill_layered_cuda(alice, bob, tables, mag, t, syn, al)


# ---- the statistics -----------------------------------------------------------


def _layered_batch(rng, nb, B, z):
    """Final totals ``t [nb, B, z]`` and Alice's bits in that layout: a third
    of the lanes' keys differ in one position (the first run's first, the
    last run's last, or one at random), ``ok`` and ``iters`` at random, some
    totals exactly 0 and -0 (decision 1)."""
    t = torch.from_numpy(rng.normal(0, 4, (nb, B, z)).astype(np.float32))
    t[0, 0, 0], t[-1, -1, -1] = 0.0, -0.0
    alice = (t <= 0).to(torch.int8)
    for b in range(B):
        if b % 3 == 1:
            j, k = [(0, 0), (nb - 1, z - 1), (rng.integers(nb), rng.integers(z))][b % 9 // 3]
            alice[j, b, k] ^= 1
    ok = torch.from_numpy(rng.random(B) < 0.7)
    iters = torch.where(ok, torch.from_numpy(rng.integers(1, MAX_IT + 1, B).astype(np.int32)),
                        MAX_IT).to(torch.int32)
    return t, alice, ok, iters


@pytest.mark.parametrize("batches", [1, 3])
@pytest.mark.parametrize("tail", ["full", "valid_below_B"])
@pytest.mark.parametrize("which", ["z32", "z13"])
def test_layered_stats_equal_the_nb_stats_permuted(which, batches, tail):
    """The layered statistics equal ``trial_stats_plain`` on the decisions
    ``t <= 0`` and Alice's bits moved to ``[N, B]``: the first batch written,
    later ones merged, lanes with a differing key among the successes, and a
    tail where only part of a batch (and none of the one past it) counts."""
    tables = layer_tables(_code(which), CPU)
    nb, z, B = tables.nb, tables.z, 29
    rng = np.random.default_rng(batches + len(tail) + z)
    total = batches * B if tail == "full" else (batches - 1) * B + 11
    valid = torch.tensor([total], dtype=torch.int32)
    got, want = torch.full((7,), -5, dtype=torch.int32), torch.full((7,), -5, dtype=torch.int32)
    scratch = torch.zeros(B + 1, dtype=torch.int32)
    for i in range(batches):
        t, alice, ok, iters = _layered_batch(rng, nb, B, z)
        trial_stats(t, alice, ok, iters, valid, i * B, MAX_IT, got, scratch, i == 0,
                    use_kernel=False)
        z_nb = (t <= 0).to(torch.int8).permute(0, 2, 1).reshape(nb * z, B)
        a_nb = alice.permute(0, 2, 1).reshape(nb * z, B)
        trial_stats_plain(z_nb, a_nb, ok, iters, valid, i * B, MAX_IT, want, None, i == 0)
        assert got.tolist() == want.tolist()
    assert int(got[0]) == min(total, batches * B)
    assert 0 < int(got[2]) < int(got[1])  # keys matched and missed among the successes


def test_layered_stats_refusals():
    nb, B, z = 3, 8, 16
    t, alice, ok, iters = _layered_batch(np.random.default_rng(2), nb, B, z)
    valid, out = torch.tensor([B], dtype=torch.int32), torch.zeros(7, dtype=torch.int32)
    scratch = torch.zeros(B + 1, dtype=torch.int32)
    trial_stats_layered_plain(t, alice, ok, iters, valid, 0, MAX_IT, out)
    with pytest.raises(ValueError, match="CUDA"):
        trial_stats_layered_cuda(t, alice, ok, iters, valid, 0, MAX_IT, out, scratch)
    with pytest.raises(ValueError, match="float32"):
        trial_stats_layered_cuda(t.to(torch.int8), alice, ok, iters, valid, 0, MAX_IT, out,
                                 scratch)
    with pytest.raises(ValueError, match="scratch"):
        trial_stats_layered_cuda(t, alice, ok, iters, valid, 0, MAX_IT, out, scratch[:B])


# ---- the chunk ----------------------------------------------------------------


def _nb_route(code, x, B, n_batches, opts):
    """The layered chunk as it ran before: the ``[N, B]`` staging, the
    ``[N, B]`` layered decode (``decode_program``) and ``[N, B]`` statistics."""
    run, use_kernel, _ = decode_program(code, opts, CPU)
    assert not use_kernel
    out = torch.empty(7, dtype=torch.int32)
    maps = code.to_device(CPU)
    N, M = code.n_vars, code.n_checks
    for i in range(n_batches):
        ids = DeviceRange(x[FIRST], range(i * B, i * B + B))
        alice, bob = make_trials_from_ids(x[KEY], N, ids, x[ERRORS], "threefry", "auto", CPU)
        llr, syn, alice_s = (torch.empty((N, B)), torch.empty((M, B), dtype=torch.int8),
                             torch.empty((N, B), dtype=torch.int8))
        steps.stage_fill_plain(alice, bob, maps, x[LLR], llr, syn, alice_s)
        z, iters, ok = run(llr, syn, None)
        trial_stats_plain(z, alice_s, ok, iters, x[VALID], i * B, opts.max_iterations, out,
                          None, i == 0)
    return out


@pytest.mark.parametrize("algorithm", ["sum-product", "min-sum"])
@pytest.mark.parametrize("which", ["z32", "z20"])
def test_layered_chunk_equals_the_nb_route(which, algorithm):
    """Two batches of 24 trials at a QBER where some frames fail, with the
    compaction's phases A-C, the second batch valid in part: the chunk in the
    sweep's layout gives the ``[N, B]`` route's seven partials."""
    code = _code(which)
    opts = DecodeOptions(schedule="layered", algorithm=algorithm, max_iterations=MAX_IT,
                         compact_after=2, compact_lanes=6)
    B, n_batches = 24, 2
    x = chunk_inputs(derive_point_key(31, 4), 5, B + 17, code.n_vars * 9 // 100, code.n_vars)
    program = _ChunkProgram(code, B, B, n_batches, opts, "threefry", CPU)
    tables = program.maps
    assert program.shapes == ((tables.nb, B, tables.z), (tables.mb, B, tables.z))
    got = program(x).tolist()
    assert got == _nb_route(code, x, B, n_batches, opts).tolist()
    assert got[0] == B + 17 and got[1] < got[0]  # some frames failed


def test_layered_chunk_runs_the_layered_instances(monkeypatch):
    """The layered chunk stages and reduces through the layered plain
    versions (never the ``[N, B]`` ones) and decodes through the state
    program; a flooding chunk the other way round."""
    code = _code("z32")
    calls = []

    def counted(module, name):
        real = getattr(module, name)

        def call(*args, **kwargs):
            calls.append(name)
            return real(*args, **kwargs)

        monkeypatch.setattr(module, name, call)

    for module, name in ((steps, "stage_fill_plain"), (steps, "stage_fill_layered_plain"),
                         (runner, "trial_stats_plain"), (runner, "trial_stats_layered_plain")):
        counted(module, name)
    x = chunk_inputs(derive_point_key(3, 1), 0, 16, 20, code.n_vars)
    for schedule, want in (("layered", ["stage_fill_layered_plain", "trial_stats_layered_plain"]),
                           ("flooding", ["stage_fill_plain", "trial_stats_plain"])):
        calls.clear()
        opts = DecodeOptions(schedule=schedule, max_iterations=MAX_IT)
        _ChunkProgram(code, 16, 16, 1, opts, "threefry", CPU)(x)
        assert calls == want, schedule


# ---- the [N, B] contract of the other callers ----------------------------------


@pytest.mark.parametrize("which", ["z32", "z13"])
def test_decode_program_keeps_its_nb_contract(which):
    """``decode_program`` (so ``layered_decode_batch_last``) takes ``[N, B]``
    LLRs and syndromes and returns ``[N, B]`` decisions; they are the state
    program's final ``t <= 0`` moved back, with the same counts and flags."""
    code = _code(which)
    tables = layer_tables(code, CPU)
    nb, mb, z, B = tables.nb, tables.mb, tables.z, 19
    opts = DecodeOptions(schedule="layered", max_iterations=MAX_IT, compact_after=2,
                         compact_lanes=5)
    rng = np.random.default_rng(z)
    alice, bob = _rows(rng, B, code.n_vars, p=0.06)
    mag = torch.tensor([np.float32(llr_magnitude(np.float32(0.06)))]).view(torch.int32)
    llr, syn, alice_s = (torch.empty((code.n_vars, B)),
                         torch.empty((code.n_checks, B), dtype=torch.int8),
                         torch.empty((code.n_vars, B), dtype=torch.int8))
    steps.stage_fill_plain(alice, bob, code.to_device(CPU), mag, llr, syn, alice_s)
    run, _, _ = decode_program(code, opts, CPU)
    z_nb, iters, ok = run(llr, syn, None)
    assert z_nb.shape == (code.n_vars, B) and z_nb.dtype == torch.int8
    assert iters.shape == ok.shape == (B,) and iters.dtype == torch.int32
    state, _, _ = layered_state_program(code, opts, CPU)
    t, iters_l, ok_l = state(_layered(llr, nb, z), _layered(syn, mb, z), None)
    assert t.shape == (nb, B, z) and t.dtype == torch.float32
    assert torch.equal(z_nb, (t <= 0).to(torch.int8).permute(0, 2, 1).reshape(nb * z, B))
    assert torch.equal(iters, iters_l) and torch.equal(ok, ok_l)
    z2, iters2, ok2 = layered_decode_batch_last(code, llr, syn, opts)
    assert torch.equal(z2, z_nb) and torch.equal(iters2, iters) and torch.equal(ok2, ok)
    assert 0 < int(ok.sum()) < B  # converged and failed frames both


def test_layered_serving_endpoint_takes_nb_frames():
    """A layered ``Reconciler`` (the serve program over ``decode_program``)
    answers ``[n, N]`` frames as ``decode`` does: bits, counts and flags."""
    code = _code("z32")
    opts = DecodeOptions(schedule="layered", max_iterations=MAX_IT)
    rng = np.random.default_rng(9)
    n, q = 11, np.float32(0.05)
    alice, bob = (t.numpy() for t in _rows(rng, n, code.n_vars, p=0.05))
    syn = ((alice.astype(np.int64) @ code.dense.T.astype(np.int64)) % 2).astype(np.uint8)
    got = Reconciler(code, opts, lanes=4, device="cpu").reconcile(bob, syn, q)
    mag = np.float32(llr_magnitude(q))
    want = decode(code, np.where(bob == 1, -mag, mag).astype(np.float32), syn, opts,
                  device="cpu")
    np.testing.assert_array_equal(got.bits, want.bits.numpy())
    np.testing.assert_array_equal(got.iterations, want.iterations.numpy())
    np.testing.assert_array_equal(got.syndromes_match, want.syndromes_match.numpy())
