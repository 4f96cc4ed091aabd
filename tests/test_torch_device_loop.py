"""Port vs JAX package: the decode loops' device-resident control flow
(``decoder/device_loop.py``).  On the CPU the decode programs run eagerly
through the plain version of the loop's bookkeeping kernel, the same
program the card captures as one CUDA graph with WHILE nodes; here they are
held per lane to the JAX package's ``while_loop`` / ``cond`` decoder in
every compaction regime, and the pieces of the graph path that do not need
a card (wrappers' ``out=`` forms, launch recording, device counters, the
gated tie path's plain version) are held to their eager counterparts."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qkd_ldpc_tpu.channel import keys as jkeys
from qkd_ldpc_tpu.decoder import bp as jbp
from qkd_ldpc_tpu_torch import _build
from qkd_ldpc_tpu_torch.channel import cuda_prng, cuda_select
from qkd_ldpc_tpu_torch.channel import keys as tkeys
from qkd_ldpc_tpu_torch.decoder import bp as tbp
from qkd_ldpc_tpu_torch.decoder import cuda_kernels, device_loop, layered

from tests._torch_port_common import assert_equal, code_pair, decode_frames

torch.set_num_threads(1)

# (n_err, compact_after, compact_lanes, max_iterations) of 16 frames: the
# plain loop; phase B only (the unconverged minority fits the compacted
# lanes); a forced phase-C overflow (more unconverged lanes than compacted
# ones at a high QBER); every lane
# converged inside phase A (phase B and C run no pass).
REGIMES = {
    "flooding": {
        "plain": (16, 0, 0, 25), "phase-b": (14, 6, 8, 25),
        "phase-c": (20, 8, 4, 25), "all-in-phase-a": (10, 6, 4, 25)},
    "layered": {
        "plain": (28, 0, 0, 20), "phase-b": (24, 5, 8, 20),
        "phase-c": (28, 4, 3, 20), "all-in-phase-a": (20, 5, 4, 20)},
}
CODES = {"flooding": "irregular", "layered": "qc"}


def _spy_loops(monkeypatch):
    """Record (limit, passes run, final it) of every loop the program runs."""
    loops = []
    real = device_loop.run_loop

    def spy(body, state, limit, mode, **kw):
        start = int(state.it)
        real(body, state, limit, mode, **kw)
        loops.append((limit, int(state.it) - start, int(state.it)))

    monkeypatch.setattr(device_loop, "run_loop", spy)
    return loops


@pytest.mark.parametrize("algorithm", ["min-sum", "sum-product"])
@pytest.mark.parametrize("regime", ["plain", "phase-b", "phase-c", "all-in-phase-a"])
@pytest.mark.parametrize("schedule", ["flooding", "layered"])
def test_decode_program_equals_jax_per_lane(schedule, regime, algorithm, monkeypatch):
    """The CPU loop, driven by the plain bookkeeping, gives each lane the
    JAX decoder's decisions, iterations and verdict (min-sum bit for bit;
    sum-product on decisions, with at most one waterfall frame of recorded
    ulp drift: the North-star rule), and its
    loops stop where JAX's would: the last pass count equals the largest
    iteration count."""
    n_err, k1, b2, cap = REGIMES[schedule][regime]
    jc, tc = code_pair(CODES[schedule])
    llr, syn = decode_frames(tc, n_err, 16, seed=40)
    kw = dict(algorithm=algorithm, max_iterations=cap, compact_after=k1,
              compact_lanes=b2, schedule=schedule)
    loops = _spy_loops(monkeypatch)
    got = tbp.decode(tc, llr, syn, tbp.DecodeOptions(**kw), device="cpu")
    want = jbp.decode(jc, jnp.asarray(llr), jnp.asarray(syn), jbp.DecodeOptions(**kw))
    got = tuple(x.numpy() for x in got)
    want = tuple(np.asarray(x) for x in want)
    if algorithm == "min-sum":
        assert_equal(got, want)
    else:  # at most one frame of recorded ulp drift (ROADMAP C)
        moved = np.nonzero((got[1] != want[1]) | (got[2] != want[2]))[0]
        assert len(moved) <= 1, moved
        same = np.ones(16, bool)
        same[moved] = False
        np.testing.assert_array_equal(got[0][same], want[0][same])
    iters, ok = got[1], got[2]
    assert max(it for _, _, it in loops) == iters.max()
    assert all(passes >= 0 for _, passes, _ in loops)
    if regime == "plain":
        assert len(loops) == 1
        return
    assert len(loops) == 3  # phases A, B and C
    (lim_a, _, it_a), (_, pass_b, _), (_, pass_c, _) = loops
    assert lim_a == k1 and it_a <= k1
    unconverged_after_a = int(((iters > it_a) | ~ok).sum())
    if regime == "all-in-phase-a":
        assert ok.all() and iters.max() <= k1 and pass_b == pass_c == 0
    elif regime == "phase-b":
        assert pass_b > 0 and pass_c == 0 and unconverged_after_a <= b2
    else:
        assert pass_c > 0 and int((iters > k1).sum()) > b2


def _reference_step(mode, ok, done, active, frozen, it, iters, limit):
    """numpy statement of the carry (JAX bp.py:434-452, layered.py:215-225)."""
    done, iters = done.copy(), iters.copy()
    if mode != device_loop.ENTRY:
        newly = active & ok & ~done
        done |= newly
        it += 1
        if mode == device_loop.LAYERED:
            iters[newly] = it
    act = ~done if frozen is None else ~done & ~frozen
    return done, act, it, iters, bool(it < limit and act.any())


@pytest.mark.parametrize("with_frozen", [False, True])
@pytest.mark.parametrize("mode", [device_loop.ENTRY, device_loop.FLOODING,
                                  device_loop.LAYERED])
def test_loop_step_plain_is_the_carry(mode, with_frozen):
    rng = np.random.default_rng(mode * 2 + with_frozen)
    B = 37
    ok, done, active = (rng.random(B) < p for p in (0.5, 0.3, 0.6))
    active &= ~done
    frozen = rng.random(B) < 0.2 if with_frozen else None
    iters = rng.integers(0, 9, B).astype(np.int32)
    for it0, limit in ((3, 9), (8, 9)):
        t = {k: torch.from_numpy(np.array(v)) for k, v in dict(
            ok=ok, done=done, active=active, iters=iters).items()}
        it = torch.tensor([it0], dtype=torch.int32)
        go = torch.zeros(1, dtype=torch.bool)
        passes = torch.zeros((), dtype=torch.int64)
        device_loop.loop_step(mode, t["ok"], t["done"], t["active"],
                              None if frozen is None else torch.from_numpy(frozen), it,
                              t["iters"], limit, use_kernel=False, passes=passes, go=go)
        want = _reference_step(mode, ok, done, active, frozen, it0, iters, limit)
        np.testing.assert_array_equal(t["done"].numpy(), want[0])
        np.testing.assert_array_equal(t["active"].numpy(), want[1])
        assert int(it) == want[2] and bool(go) == want[4]
        np.testing.assert_array_equal(t["iters"].numpy(), want[3])
        assert int(passes) == (mode != device_loop.ENTRY)


def test_run_loop_counts_passes_and_tests_before_the_first():
    """``lax.while_loop`` semantics: the condition is tested before the first
    pass, a loop at its limit or with every lane done runs no pass."""
    B = 4
    for it0, done0, limit, want_passes in ((5, [0, 0, 0, 0], 5, 0), (0, [1, 1, 1, 1], 9, 0),
                                           (0, [0, 0, 0, 0], 3, 3)):
        st = device_loop.LoopState(torch.tensor(done0, dtype=torch.bool),
                                   torch.tensor([it0], dtype=torch.int32))
        bodies = []

        def body():
            bodies.append(1)
            st.ok.fill_(False)

        device_loop.run_loop(body, st, limit, device_loop.FLOODING, use_kernel=False)
        assert len(bodies) == want_passes and int(st.it) == it0 + want_passes


@pytest.mark.parametrize("storage", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("algorithm", ["sum-product", "min-sum"])
def test_out_variants_equal_the_allocating_ones(storage, algorithm):
    """K1, K2 (in place over ``Lr_prev`` too), K5 and KV write into given
    buffers exactly what they return otherwise (plain versions)."""
    _, tc = code_pair("irregular")
    maps = tc.to_device("cpu")
    scale = 0.25 if storage == "int8" else None
    mdt = cuda_kernels.STORAGE_DTYPES[storage]
    llr, syn = decode_frames(tc, 13, 8, seed=41)
    llr_t = torch.from_numpy(llr.T.copy())
    syn_t = torch.from_numpy(syn.T.copy())
    kw = dict(threshold=20.0, clip=True, algorithm=algorithm, min_sum_alpha=0.8,
              min_sum_beta=0.0, scale=scale, backend="xla")
    tot0 = cuda_kernels._store(llr_t, mdt, scale)
    lr = cuda_kernels.check_update_first(tot0, syn_t, maps, **kw)
    buf = torch.full_like(lr, 3)
    assert torch.equal(cuda_kernels.check_update_first(tot0, syn_t, maps, out=buf, **kw), lr)
    assert torch.equal(buf, lr)
    z = torch.zeros((tc.n_vars, 8), dtype=torch.int8)
    count = torch.zeros(8, dtype=torch.int32)
    active = torch.tensor([1, 1, 0, 1, 1, 0, 1, 1], dtype=torch.bool)
    ref = cuda_kernels.variable_update(lr, llr_t, z, count, active, maps, backend="xla",
                                       scale=scale)
    total, ok = torch.empty_like(ref[0]), torch.zeros(8, dtype=torch.bool)
    z2, count2 = z.clone(), count.clone()
    got = cuda_kernels.variable_update(lr, llr_t, z2, count2, active, maps, backend="xla",
                                       scale=scale, out=(total, ok))
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    assert got[0] is total and got[3] is ok and got[1] is z2 and got[2] is count2
    fresh = torch.tensor([0, 1, 0, 0, 1, 0, 0, 0], dtype=torch.bool)
    for f in (None, fresh):
        ref_lr, ref_ok = cuda_kernels.check_update_fused(total, lr, syn_t, maps, fresh=f,
                                                         **kw)
        for in_place in (False, True):
            prev = lr.clone()
            out = prev if in_place else torch.empty_like(lr)
            flags = torch.ones(8, dtype=torch.bool)
            got_lr, got_ok = cuda_kernels.check_update_fused(
                total, prev, syn_t, maps, fresh=f, ok=flags, out=out, **kw)
            assert got_lr is out and got_ok is flags
            assert torch.equal(got_lr, ref_lr) and torch.equal(got_ok, ref_ok)


def test_layered_sweep_out_and_in_place_equal_the_plain_sweep():
    _, tc = code_pair("qc")
    tables = layered.layer_tables(tc, "cpu")
    llr, syn = decode_frames(tc, 14, 6, seed=42)
    t, lr, syn3 = layered.initial_state(
        tables, torch.from_numpy(llr.T.copy()), torch.from_numpy(syn.T.copy()),
        torch.bfloat16)
    kw = dict(threshold=20.0, clip=True, algorithm="sum-product", min_sum_alpha=0.8,
              min_sum_beta=0.0, scale=None)
    act = torch.tensor([1, 0, 1, 1, 1, 0], dtype=torch.bool)
    ref = layered.layered_sweep_plain(t, lr, syn3, act, tables, **kw)
    t2, lr2, ok = t.clone(), lr.clone(), torch.zeros(6, dtype=torch.bool)
    got = layered.layered_sweep_plain(t2, lr2, syn3, act, tables, out=ok, in_place=True,
                                      **kw)
    assert got[0] is t2 and got[1] is lr2 and got[2] is ok
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


def test_recording_lists_launches_and_device_counters_count_passes():
    """A capture lists its kernel nodes instead of counting them; a replay
    counts the outer nodes; a WHILE body's kernels are counted by the
    passes its device counter holds, and a reset zeroes the counter."""
    _build.reset_launch_counts()
    with _build.recording() as outer:
        _build.check_launch("k_outer", 0)
        with _build.recording() as body:
            _build.check_launch("k_body", 0)
    assert outer == ["k_outer"] and body == ["k_body"]
    assert _build.launch_counts() == {}
    passes = torch.zeros(2, dtype=torch.int64)
    _build.add_device_counter(body, passes[1])
    _build.count_replay(outer)
    _build.count_replay(outer)
    passes[1] += 7
    assert _build.launch_counts() == {"k_outer": 2, "k_body": 7}
    _build.reset_launch_counts()
    assert _build.launch_counts() == {} and int(passes[1]) == 0
    with pytest.raises(RuntimeError, match="failed to launch"):
        _build.check_launch("k_outer", 1)


def test_a_dropped_graphs_counters_fold_into_the_host_counts():
    """A graph leaving the cache folds its bodies' passes into the host's
    counts: they stay counted, its counters are no longer read, and a reset
    clears them."""
    _build.reset_launch_counts()
    passes = torch.zeros(3, dtype=torch.int64)
    mine, other = [passes[0], passes[2]], torch.zeros((), dtype=torch.int64)
    _build.add_device_counter(["k_a"], mine[0])
    _build.add_device_counter(["k_b", "k_c"], mine[1])
    _build.add_device_counter(["k_d"], other)
    passes += 2
    other += 5
    _build.fold_device_counters(mine)
    passes += 100  # read no more
    other += 1
    assert _build.launch_counts() == {"k_a": 2, "k_b": 2, "k_c": 2, "k_d": 6}
    _build.reset_launch_counts()
    assert _build.launch_counts() == {}
    _build.fold_device_counters([other])


def test_graphs_only_for_the_kernel_backend_on_the_card():
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert device_loop.graphs_on(True, cuda) and not device_loop.graphs_on(False, cuda)
    assert not device_loop.graphs_on(True, cpu)
    with device_loop.eager_loops():
        assert not device_loop.graphs_on(True, cuda)
        with device_loop.eager_loops():
            pass
        assert not device_loop.graphs_on(True, cuda)
    assert device_loop.graphs_on(True, cuda)


@pytest.mark.parametrize("schedule", ["flooding", "layered"])
def test_pallas_backend_still_raises_on_the_cpu(schedule):
    _, tc = code_pair("qc")
    llr, syn = decode_frames(tc, 10, 4, seed=43)
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        tbp.decode(tc, llr, syn, tbp.DecodeOptions(backend="pallas", schedule=schedule),
                   device="cpu")
    b = torch.zeros(4, dtype=torch.bool)
    it = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        device_loop.loop_step_cuda(device_loop.ENTRY, b, b, b.clone(), None, it, None, 3)


def _tie_batch(rows, n, k, seed):
    """Raw scores where every row's threshold sits in a run of equal scores
    (excess ties), and independent second words."""
    rng = np.random.default_rng(seed)
    scores = rng.integers(0, 2**32, (rows, n), dtype=np.uint64).astype(np.uint32)
    for r in range(rows):
        lo = np.sort(scores[r])[k - 3]
        at = rng.choice(n, 9, replace=False)
        scores[r, at] = lo
    second = rng.integers(0, 2**32, (rows, n), dtype=np.uint64).astype(np.uint32)
    second[:, : n // 4] = second[:, :1]  # equal second words: index order decides
    return scores, second


def _raw(a):
    return torch.from_numpy(a.view(np.int32).copy())


def test_gated_tie_path_plain_version_equals_jax():
    """The tie path that the card gates on K3's flag: its plain version
    (select_flip, then ``_uniform_ties`` where the flag is set) equals the
    JAX package's ``_exact_weight_mask`` with ``tie_scores_fn``, Alice's
    bits flipped; a batch without excess ties is select_flip's row."""
    k = 40
    scores, second = _tie_batch(6, 300, k, seed=44)
    alice = np.random.default_rng(45).integers(0, 2, scores.shape).astype(np.uint8)
    want = np.asarray(jkeys._exact_weight_mask(
        jnp.asarray(scores), k, tie_scores_fn=lambda: jnp.asarray(second))) ^ alice
    got = tkeys._exact_weight_flip(_raw(scores), torch.from_numpy(alice), k,
                                   lambda: _raw(second), "xla")
    np.testing.assert_array_equal(got.numpy(), want)
    thresh, bob, excess = cuda_select.select_flip(_raw(scores), k, torch.from_numpy(alice))
    assert int(excess) == 1 and not torch.equal(bob, got)
    # no excess ties: the second word is never drawn, the row is select_flip's
    plain = np.random.default_rng(46).permutation(2**20)[: 6 * 300].reshape(6, 300)
    _, bob, excess = cuda_select.select_flip(_raw(plain.astype(np.uint32)), k,
                                             torch.from_numpy(alice))
    assert int(excess) == 0
    got = tkeys._exact_weight_flip(_raw(plain.astype(np.uint32)), torch.from_numpy(alice),
                                   k, lambda: 1 / 0)
    assert torch.equal(got, bob)


def test_tie_kernels_refuse_cpu_tensors():
    scores = torch.zeros((2, 8), dtype=torch.int32)
    alice = torch.zeros((2, 8), dtype=torch.uint8)
    flag = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda_select.complete_ties_cuda(scores, torch.zeros((2, 1), dtype=torch.int32), 3,
                                       scores, alice, alice.clone(), flag)
    with pytest.raises(ValueError, match="CUDA device"):
        cuda_prng.trial_words_cuda(torch.zeros(2, dtype=torch.int64), 8, range(2),
                                   ("ties",), "cpu", gate=flag)
