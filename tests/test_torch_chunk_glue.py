"""The trial chunk's tensor work around the decode (``sim/runner.py``'s
``_ChunkProgram``): the staging of the LLRs, Alice's syndrome and bits
through the continuation's ``stage_fill``, and the key check and statistics
of ``trial_stats``, on the CPU where both run their plain versions.

``trial_stats_plain`` is held against ``reduce_trials`` ->
``merge_partials_tree`` -> ``stack_partials``, and a chunk of the program
against the glue it replaced (``torch.where`` LLRs, ``decoder/syndrome.py``,
the ``[B, N]`` key compare, the valid mask and the merge), with the decode
replaced by a function of its inputs so that only the glue is compared.  On
the card ``chip_smoke.py`` holds the kernels against these plain versions.
"""

import numpy as np
import pytest
import torch

from qkd_ldpc_tpu_torch.channel.cuda_prng import DeviceRange
from qkd_ldpc_tpu_torch.channel.keys import derive_point_key
from qkd_ldpc_tpu_torch.codes import make_qc_code, read_alist
from qkd_ldpc_tpu_torch.decoder.bp import DecodeOptions
from qkd_ldpc_tpu_torch.decoder.syndrome import syndrome
from qkd_ldpc_tpu_torch.sim import runner
from qkd_ldpc_tpu_torch.sim.runner import (
    ERRORS,
    FIRST,
    KEY,
    LLR,
    VALID,
    _ChunkProgram,
    chunk_inputs,
    merge_partials_tree,
    trial_stats,
    trial_stats_cuda,
    trial_stats_plain,
)
from qkd_ldpc_tpu_torch.sim.stats import reduce_trials, stack_partials

torch.set_num_threads(1)
CPU = torch.device("cpu")
MAX_IT = 30
REFERENCE_ALIST = "data/alist_sparse_matrices/(N=10240,M=5231,R=0.49,CW=3,GEN=666).alist"
_codes = {}


def _code(which):
    if which not in _codes:
        _codes[which] = (make_qc_code(z=32, nb=12, mb=6, dv=3, seed=5) if which == "qc"
                         else read_alist(REFERENCE_ALIST))
    return _codes[which]


def _batch(rng, N, B, kind):
    """Decisions, Alice's bits, flags and iteration counts of one batch:
    ``kind`` "random" (a third of the keys differ in one bit, ok at random),
    "all_fail" (no lane converged, keys differ), "all_succeed" (every lane
    converged with its key)."""
    alice = torch.from_numpy(rng.integers(0, 2, (N, B)).astype(np.int8))
    z = alice.clone()
    if kind != "all_succeed":
        bad = rng.random(B) < (1.0 if kind == "all_fail" else 0.35)
        rows = torch.from_numpy(rng.integers(0, N, B))
        lanes = torch.from_numpy(np.flatnonzero(bad))
        z[rows[lanes], lanes] ^= 1
    ok = {"random": torch.from_numpy(rng.random(B) < 0.7),
          "all_fail": torch.zeros(B, dtype=torch.bool),
          "all_succeed": torch.ones(B, dtype=torch.bool)}[kind]
    iters = torch.from_numpy(rng.integers(1, MAX_IT + 1, B).astype(np.int32))
    iters = torch.where(ok, iters, MAX_IT)
    return z, alice, ok, iters


def _old_stats(z, alice, ok, iters, valid_total, offset):
    """The chunk's statistics as the glue computed them before the kernel."""
    keys_match = (z.T == alice.T).all(dim=-1)
    valid = torch.arange(z.shape[1], dtype=torch.int32) < valid_total - offset
    return reduce_trials(ok, keys_match, iters, MAX_IT, valid)


# ---- trial_stats_plain against reduce_trials -> merge -> stack ---------------


@pytest.mark.parametrize("batches", [1, 2, 3])
@pytest.mark.parametrize("kind", ["random", "all_fail", "all_succeed"])
@pytest.mark.parametrize("tail", ["full", "valid_below_B"])
def test_trial_stats_plain_equals_reduce_merge_stack(batches, kind, tail):
    """Batches of 77 lanes (N = 96) merged into one ``[7]``: the first
    written, the others merged; with ``valid`` below B the last batch counts
    only part of its lanes (and a batch past it none)."""
    rng = np.random.default_rng(11 * batches + len(kind) + len(tail))
    N, B = 96, 77
    total = batches * B if tail == "full" else (batches - 1) * B + 30
    valid = torch.tensor([total], dtype=torch.int32)
    out, scratch = torch.full((7,), -5, dtype=torch.int32), torch.zeros(B + 1, dtype=torch.int32)
    want = None
    for i in range(batches):
        z, alice, ok, iters = _batch(rng, N, B, kind)
        trial_stats_plain(z, alice, ok, iters, valid, i * B, MAX_IT, out, scratch, i == 0)
        red = _old_stats(z, alice, ok, iters, total, i * B)
        want = red if want is None else merge_partials_tree(want, red)
    assert out.dtype == torch.int32
    assert out.tolist() == stack_partials(want).tolist()
    assert int(out[0]) == min(total, batches * B)
    if kind == "all_fail":
        assert out[1:].tolist() == [0, 0, 0, 0, MAX_IT, 0]
    if kind == "all_succeed":
        assert int(out[1]) == int(out[2]) == int(out[0])


def test_trial_stats_dispatch_and_refusals():
    """``use_kernel=False`` is the plain version; the kernel's wrapper refuses
    CPU tensors and wrong shapes or types before it looks for the card."""
    rng = np.random.default_rng(5)
    N, B = 64, 40
    z, alice, ok, iters = _batch(rng, N, B, "random")
    valid = torch.tensor([B], dtype=torch.int32)
    args = (z, alice, ok, iters, valid, 0, MAX_IT)
    got = torch.zeros(7, dtype=torch.int32)
    want = torch.zeros(7, dtype=torch.int32)
    trial_stats(*args, got, torch.zeros(B + 1, dtype=torch.int32), True, use_kernel=False)
    trial_stats_plain(*args, want)
    assert got.tolist() == want.tolist()
    scratch = torch.zeros(B + 1, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        trial_stats_cuda(*args, got, scratch)
    with pytest.raises(ValueError, match="scratch"):
        trial_stats_cuda(*args, got, torch.zeros(B, dtype=torch.int32))
    with pytest.raises(ValueError, match="int8"):
        trial_stats_cuda(z.to(torch.uint8), *args[1:], got, scratch)
    with pytest.raises(ValueError, match="int32"):
        trial_stats_cuda(z, alice, ok, iters.long(), valid, 0, MAX_IT, got, scratch)


# ---- the chunk's glue against the glue it replaced ---------------------------


class _Trials:
    """Alice's and Bob's ``[B, N]`` uint8 rows of each batch, drawn with
    numpy from the batch's first trial id and handed to both glues in place
    of the channel (which ``test_torch_chunk.py`` holds against JAX's): the
    glue, not the channel, is under test."""

    def __init__(self, n_bits, seed):
        self.n_bits, self.seed, self.rows = n_bits, seed, {}

    def __call__(self, point_key, n_bits, ids, num_errors, prng, backend, device):
        first = ids.offsets.start
        if first not in self.rows:
            rng = np.random.default_rng(self.seed + first)
            B = len(ids.offsets)
            alice = rng.integers(0, 2, (B, n_bits)).astype(np.uint8)
            bob = alice ^ (rng.random((B, n_bits)) < 0.06).astype(np.uint8)
            self.rows[first] = (torch.from_numpy(alice), torch.from_numpy(bob))
        return self.rows[first]


class _FakeDecode:
    """A decode that is a function of its inputs and of Alice's bits (known
    to the test): z is Bob's hard decision, or Alice's bits in a third of
    the lanes, or Alice's with one bit flipped in another third; ok and
    iters from the syndrome.  Records the LLRs and syndromes it is given."""

    def __init__(self, trials, width):
        self.trials, self.width, self.seen = trials, width, []

    def __call__(self, llr, syn, graph):
        assert graph is None
        i = len(self.seen)
        self.seen.append((llr.clone(), syn.clone()))
        alice = self.trials.rows[i * self.width][0].T.to(torch.int8)  # [N, B]
        lane = torch.arange(llr.shape[1])
        z = torch.where(lane % 3 == 0, alice, (llr < 0).to(torch.int8))
        flip = lane % 3 == 1
        z = torch.where(flip, alice, z)
        z[0, flip] ^= 1
        weight = syn.to(torch.int32).sum(dim=0)
        ok = (weight + lane) % 4 != 0
        iters = torch.where(ok, (weight + lane) % MAX_IT + 1, MAX_IT).to(torch.int32)
        return z.contiguous(), iters, ok


def _old_chunk(code, x, B, n_batches, opts, decode, trials):
    """The chunk as the glue ran it before ``stage_fill`` and ``trial_stats``."""
    out = None
    for i in range(n_batches):
        ids = DeviceRange(x[FIRST], range(i * B, i * B + B))
        alice, bob = trials(x[KEY], code.n_vars, ids, x[ERRORS], "threefry", opts.backend, CPU)
        mag = x[LLR].view(torch.float32)
        llr = torch.where(bob.T == 1, -mag, mag).contiguous()
        syn = syndrome(code, alice).T.contiguous()
        z, iters, ok = decode(llr, syn, None)
        keys_match = (z.T == alice.to(torch.int8)).all(dim=-1)
        valid = torch.arange(B, dtype=torch.int32, device=CPU) < x[VALID] - i * B
        red = reduce_trials(ok, keys_match, iters, opts.max_iterations, valid)
        out = red if out is None else merge_partials_tree(out, red)
    return stack_partials(out)


@pytest.mark.parametrize("width", [512, 1000, 77])
@pytest.mark.parametrize("which", ["qc", "reference_alist"])
def test_chunk_glue_equals_the_replaced_glue(which, width, monkeypatch):
    """Two batches, the second partly valid (as a sweep row of 1000 trials
    in batches of 512): the LLRs and syndromes the decode receives and the
    seven partials equal the old glue's bit for bit, on a QC code (rows of
    one degree) and the reference's alist (rows of 5 and 6: padded slots)."""
    code = _code(which)
    n_batches, valid = 2, width + width // 2
    opts = DecodeOptions(max_iterations=MAX_IT)
    x = chunk_inputs(derive_point_key(777, 9), 123, valid, code.n_vars * 6 // 100,
                     code.n_vars)
    trials = _Trials(code.n_vars, seed=width)
    monkeypatch.setattr(runner, "make_trials_from_ids", trials)
    program = _ChunkProgram(code, width, width, n_batches, opts, "threefry", CPU)
    assert not program.use_kernel
    new, old = _FakeDecode(trials, width), _FakeDecode(trials, width)
    program.decode = new
    got = program(x)
    want = _old_chunk(code, x, width, n_batches, opts, old, trials)
    assert len(new.seen) == len(old.seen) == n_batches
    for (llr_n, syn_n), (llr_o, syn_o) in zip(new.seen, old.seen):
        assert llr_n.dtype == llr_o.dtype == torch.float32
        assert torch.equal(llr_n.view(torch.int32), llr_o.view(torch.int32))
        assert syn_n.dtype == syn_o.dtype == torch.int8 and torch.equal(syn_n, syn_o)
    assert got.tolist() == want.tolist()
    assert int(got[0]) == valid
    assert 0 < int(got[2]) < int(got[1]) < valid  # keys matched and missed among successes


def test_chunk_glue_plain_statistics_through_runner(monkeypatch):
    """The chunk's plain statistics reduce through the runner module's
    ``reduce_trials``, so a fault planted there shows in the partials."""
    code = _code("qc")
    opts = DecodeOptions(max_iterations=MAX_IT)
    x = chunk_inputs(derive_point_key(777, 2), 0, 32, 20, code.n_vars)
    program = _ChunkProgram(code, 32, 32, 1, opts, "threefry", CPU)
    want = program(x).tolist()
    monkeypatch.setattr(runner, "reduce_trials",
                        lambda ok, keys, it, mi, valid: reduce_trials(
                            ok, keys, it, mi, valid & (torch.arange(ok.shape[0]) < 16)))
    got = program(x).tolist()
    assert want[0] == 32 and got[0] == 16
