"""Port vs JAX package: the decode loops' device-resident control flow
(``decoder/device_loop.py``).  On the CPU the decode programs run eagerly
through the plain version of the loop's bookkeeping kernel, the same
program the card captures as one CUDA graph with WHILE nodes; here they are
held per lane to the JAX package's ``while_loop`` / ``cond`` decoder in
every compaction regime, and the pieces of the graph path that do not need
a card (wrappers' ``out=`` forms, launch recording, device counters, the
gated tie path's plain version) are held to their eager counterparts."""

import math

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
# lanes); a forced overflow (more unconverged lanes than compacted ones at a
# high QBER: the ladder, which flooding leaves at its 8-lane rung and layered,
# compacted to 3, takes down through 8 and 4); every lane converged inside
# phase A (no rung runs a pass); the ladder through 8 and 4 lanes before the
# cap; and an overflow whose live lanes never fall to 8, so the full batch
# runs to the cap.
REGIMES = {
    "flooding": {
        "plain": (16, 0, 0, 25), "phase-b": (14, 6, 8, 25),
        "phase-c": (20, 8, 4, 25), "all-in-phase-a": (10, 6, 4, 25),
        "ladder": (16, 6, 4, 25), "full-width": (24, 8, 4, 25)},
    "layered": {
        "plain": (28, 0, 0, 20), "phase-b": (24, 5, 8, 20),
        "phase-c": (28, 4, 3, 20), "all-in-phase-a": (20, 5, 4, 20),
        "ladder": (28, 3, 4, 20), "full-width": (32, 4, 4, 20)},
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
    (lim_a, _, it_a) = loops[0]
    assert lim_a == k1 and it_a <= k1
    if regime == "all-in-phase-a":
        # no lane left after phase A: phase B's IF node and the ladder's skip
        assert len(loops) == 1
        assert ok.all() and iters.max() <= k1
        return
    unconverged_after_a = int(((iters > it_a) | ~ok).sum())
    if regime == "phase-b":
        assert len(loops) == 2  # phases A and B
        assert loops[1][1] > 0 and unconverged_after_a <= b2
    else:  # the ladder: the full batch's loop (none where half the batch is left),
        # then a loop a rung engaged
        assert len(loops) >= 3 and int((iters > k1).sum()) > b2
        assert sum(passes for _, passes, _ in loops[1:]) > 0
        # the rungs run the pass count on, one after another, to the end
        assert all(a[2] <= b[2] - b[1] for a, b in zip(loops[1:], loops[2:]))


# (B, B2, unconverged lanes after phase A): k = 0; 0 < k < B2; k = B2
# exactly; more unconverged lanes than B2 (phase C's overflow); at the
# flagship's batch and compacted width and at a ragged batch.
PARTITIONS = {
    f"B{B}-{name}": (B, B2, n)
    for B, B2 in ((512, 128), (101, 25))
    for name, n in (("k0", 0), ("k-inside", B2 // 3), ("k-full", B2), ("overflow", B2 + 7))
}


def _lanes(done, iters, it, fill=True):
    lanes = device_loop.Lanes(done, it, use_kernel=False, fill=fill)
    lanes.iters = iters
    return lanes


def _partitioned(B, B2, n, seed, below=0, limit=2 ** 31 - 1):
    """A batch of B lanes, n of them unconverged at random places, its
    compacted twin of B2 lanes (unset, sharing the batch's pass count) and
    the partition's choice."""
    g = torch.Generator().manual_seed(seed)
    done = torch.ones(B, dtype=torch.bool)
    done[torch.randperm(B, generator=g)[:n]] = False
    iters = torch.randint(0, 50, (B,), dtype=torch.int32, generator=g)
    lanes = _lanes(done, iters, torch.tensor([7], dtype=torch.int32))
    part = _lanes(torch.empty(B2, dtype=torch.bool), torch.empty(B2, dtype=torch.int32),
                  lanes.loop.it, fill=False)
    sel = device_loop.Selection(B, B2, "cpu", below=below, limit=limit)
    return lanes, part, sel


@pytest.mark.parametrize("case", sorted(PARTITIONS))
def test_plain_partition_is_the_stable_argsort(case):
    """The partition's plain version (a prefix count, as the kernel) picks
    the lanes that the parent's ``argsort(done, stable=True)[:B2]`` picked,
    moves k = min(#unconverged, B2) of them, gives the part the flags and
    counts ``index_select`` gave it and the loop state ``LoopState``'s
    fills gave it, and counts the batch; after phase A it flags an
    overflow, and a rung's partition (not the first) runs its rung only for
    lanes that fit it and not the next, and counts the rung."""
    B, B2, n = PARTITIONS[case]
    lanes, part, sel = _partitioned(B, B2, n, seed=B + n)
    done = lanes.loop.done
    before = sel.counts.clone()
    over = torch.empty(1, dtype=torch.bool)
    device_loop.partition(lanes, part, sel, use_kernel=False, over=over)
    want = torch.argsort(done.to(torch.int32), stable=True)[:B2]
    k = min(n, B2)
    assert torch.equal(sel.idx.long(), want)
    assert int(sel.k) == k and bool(sel.go) == (0 < n <= B2) and bool(over) == (n > B2)
    assert torch.equal(part.loop.done, done[want])
    assert torch.equal(part.iters, lanes.iters[want])
    assert int(part.loop.it) == 7
    assert bool(part.loop.ok.all()) and not bool(part.loop.active.any())
    assert int(part.loop.ticket) == 0
    assert (sel.counts - before).tolist() == [1, int(k > 0), k, int(n > B2), int(n > B2),
                                              0, 0, 0, 0]
    for below, limit in ((B2 // 3, 9), (B2 // 3, 7), (0, 9)):
        lanes, part, sel = _partitioned(B, B2, n, seed=B + n, below=below, limit=limit)
        before, passes = sel.counts.clone(), torch.zeros(1, dtype=torch.int64)
        device_loop.partition(lanes, part, sel, use_kernel=False, first=False, passes=passes)
        go = below < n <= B2 and 0 < n and 7 < limit
        assert torch.equal(sel.idx.long(), want) and int(sel.k) == k and bool(sel.go) == go
        assert int(passes) == 1
        assert (sel.counts - before).tolist() == [0] * 5 + [int(go), k * go, 0,
                                                            k * go * (below == 0)]


# Phase B's tensors in each layout: batch-last (the flooding state: [N, B],
# [M, B], [dc, M, B]) and the layered [rows, B, z] (z 32 and 20: 16-byte and
# narrower units).
LAYOUTS = {
    "batch-last": [(40,), (24,), (6, 24)],
    "layered": [(12, None, 32), (6, None, 20)],
}


def _pair(shape, B, B2, dtype, g):
    full_shape = tuple(B if d is None else d for d in shape) if None in shape else shape + (B,)
    part_shape = tuple(B2 if d is None else d for d in shape) if None in shape else shape + (B2,)
    if dtype == torch.int8:
        full = torch.randint(-128, 128, full_shape, dtype=torch.int8, generator=g)
    else:
        full = torch.randn(full_shape, generator=g).to(dtype)
    return full, torch.empty(part_shape, dtype=dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_plain_gather_and_scatter_move_the_chosen_lanes(layout, dtype):
    """The plain gather equals ``index_select`` on the k moved slots and the
    plain scatter ``index_copy_`` on their lanes, leaving every other lane
    as it was; the copy kernels' view of each tensor is (rows, a lane's run
    in units): one element a lane in the batch-last layout, a run of z in
    the layered one, 16-byte units where the run allows them."""
    g = torch.Generator().manual_seed(3)
    for B, B2, n in ((64, 16, 9), (64, 16, 30)):  # phase B alone; an overflow
        lanes, part, sel = _partitioned(B, B2, n, seed=n)
        device_loop.partition(lanes, part, sel, use_kernel=False)
        k, moved = min(n, B2), sel.idx[:min(n, B2)].long()
        pairs = [_pair(shape, B, B2, dtype, g) for shape in LAYOUTS[layout]]
        passes = torch.zeros(1, dtype=torch.int64)
        device_loop.compact_copy(pairs, sel, scatter=False, use_kernel=False, passes=passes)
        assert int(passes) == 1
        for full, p in pairs:
            d = device_loop.lane_axis(full, p)
            assert torch.equal(p.narrow(d, 0, k), full.index_select(d, moved))
            rows, units, unit = device_loop.copy_run(full, p)
            run = math.prod(full.shape[d + 1:]) * full.element_size()
            assert rows == math.prod(full.shape[:d]) and units * unit == run
            if layout == "batch-last":
                assert units == 1 and unit == full.element_size()
            else:
                assert unit == (16 if run % 16 == 0 else math.gcd(run, 16))
        want = []
        for full, p in pairs:
            d = device_loop.lane_axis(full, p)
            p.narrow(d, 0, k).copy_(torch.flip(p.narrow(d, 0, k), [0]))  # phase B's work
            want.append(full.clone().index_copy_(d, moved, p.narrow(d, 0, k)))
        device_loop.compact_copy(pairs, sel, scatter=True, use_kernel=False)
        for (full, _), w in zip(pairs, want):
            assert torch.equal(full, w)


def _schedule_counts(conv, B, k1, b2, cap):
    """The compaction counter a batch adds, and the rungs that engage, from
    each lane's converging pass ``conv`` (past ``cap`` for a failing lane):
    the statement of ``run_schedule`` that the tests hold it to.  After a
    pass ``t``, ``live(t)`` lanes are left; a loop on ``w`` lanes with floor
    ``f`` runs passes while ``live > f`` and passes are left."""
    def live(t):
        return int((conv > t).sum())

    n, t = live(k1), k1
    counts = [1, int(n > 0), min(n, b2), int(n > b2), int(n > b2), 0, 0, 0, 0]
    widths = [b2] if n <= b2 else [B] + device_loop.ladder(B, b2)
    floors = widths[1:] + [0]
    for i, (w, f) in enumerate(zip(widths, floors)):
        if i or n <= b2:  # a rung's partition, or phase B's
            m = live(t)
            if not (0 < m <= w and m > f and t < cap):
                continue
            if n > b2:
                counts[5:7] = [counts[5] + 1, counts[6] + m]
                counts[8] += m if f == 0 else 0
        while t < cap and live(t) > f:
            t += 1
            counts[7] += w
    return counts


@pytest.mark.parametrize("regime", ["plain", "phase-b", "phase-c", "all-in-phase-a", "ladder",
                                    "full-width"])
@pytest.mark.parametrize("schedule", ["flooding", "layered"])
def test_compacted_decode_equals_the_plain_loop_per_lane(monkeypatch, schedule, regime):
    """Compaction through the partitions, the gathers of the unconverged
    lanes alone and the scatters back gives every lane the plain loop's
    decisions, iterations and verdict bit for bit, whichever rungs of the
    ladder the batch takes, and the device counter counts what moved: one
    batch, engaged where a lane was left after phase A, the lanes moved, an
    overflow past the compacted lanes (the ladder taken), the rungs the
    ladder engaged and their lanes, the lane-passes after phase A and the
    lanes of the narrowest rung in the ladder.  ``compaction_bytes`` of those
    counts and the program's bytes a lane (``bp.lane_bytes``) is what the
    gathers and scatters moved: the ``k`` lanes of each tensor they copied."""
    moved = []
    real_copy = device_loop.compact_copy_plain

    def copy(pairs, sel, scatter, passes=None):
        for full, part in pairs:
            lanes = full.shape[device_loop.lane_axis(full, part)]
            moved.append(int(sel.k) * full.numel() * full.element_size() // lanes)
        real_copy(pairs, sel, scatter, passes)

    monkeypatch.setattr(device_loop, "compact_copy_plain", copy)
    n_err, k1, b2, cap = REGIMES[schedule][regime]
    _, tc = code_pair(CODES[schedule])
    llr, syn = decode_frames(tc, n_err, 16, seed=40)  # REGIMES' frames
    kw = dict(algorithm="min-sum", max_iterations=cap, schedule=schedule)
    plain = tbp.decode(tc, llr, syn, tbp.DecodeOptions(**kw), device="cpu")
    counter = device_loop.compaction_counter("cpu")
    before = counter.clone()
    opts = tbp.DecodeOptions(**kw, compact_after=k1, compact_lanes=b2)
    got = tbp.decode(tc, llr, syn, opts, device="cpu")
    assert_equal(tuple(x.numpy() for x in got), tuple(x.numpy() for x in plain))
    conv = torch.where(plain.syndromes_match, plain.iterations, cap + 1)
    left = int((conv > k1).sum())
    want = ([0] * len(device_loop.COMPACTION_COUNTS) if regime == "plain"
            else _schedule_counts(conv, 16, k1, b2, cap))
    assert (counter - before).tolist() == want
    counts = dict(zip(device_loop.COMPACTION_COUNTS, want))
    assert device_loop.compaction_bytes(counts, tbp.lane_bytes(tc, opts), b2) == sum(moved)
    rungs = want[5]
    assert {"plain": left >= 0, "phase-b": 0 < left <= b2, "phase-c": left > b2 and rungs > 0,
            "all-in-phase-a": left == 0, "full-width": left > b2 and rungs == 0
            and int((conv > cap - 1).sum()) > 8,
            "ladder": left > 8 and rungs >= 2 and int((conv >= cap).sum()) <= b2}[regime]


def _reference_step(mode, ok, done, active, frozen, it, iters, limit, floor=0):
    """numpy statement of the carry (JAX bp.py:434-452, layered.py:215-225),
    with the ladder's floor on the active frames (0: JAX's any)."""
    done, iters = done.copy(), iters.copy()
    if mode != device_loop.ENTRY:
        newly = active & ok & ~done
        done |= newly
        it += 1
        if mode == device_loop.LAYERED:
            iters[newly] = it
    act = ~done if frozen is None else ~done & ~frozen
    return done, act, it, iters, bool(it < limit and act.sum() > floor)


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
    n_live = _reference_step(mode, ok, done, active, frozen, 3, iters, 9)[1].sum()
    # the ladder's floors: just under the live frames (go), and at them (stop)
    for it0, limit, floor in ((3, 9, 0), (8, 9, 0), (3, 9, n_live - 1), (3, 9, n_live)):
        t = {k: torch.from_numpy(np.array(v)) for k, v in dict(
            ok=ok, done=done, active=active, iters=iters).items()}
        it = torch.tensor([it0], dtype=torch.int32)
        go = torch.zeros(1, dtype=torch.bool)
        passes = torch.zeros((), dtype=torch.int64)
        if mode == device_loop.ENTRY:
            device_loop.loop_step(mode, t["ok"], t["done"], t["active"],
                                  None if frozen is None else torch.from_numpy(frozen), it,
                                  t["iters"], limit, use_kernel=False, passes=passes, go=go,
                                  floor=int(floor))
            lanes = 0
        else:
            lane_passes = torch.zeros(1, dtype=torch.int64)
            device_loop.LoopTail(mode, t["done"], t["active"], None if frozen is None else
                                 torch.from_numpy(frozen), it, t["iters"], limit, go,
                                 torch.zeros(1, dtype=torch.int32), passes, None, int(floor),
                                 lane_passes).plain(t["ok"])
            lanes = int(lane_passes)
        want = _reference_step(mode, ok, done, active, frozen, it0, iters, limit, floor)
        np.testing.assert_array_equal(t["done"].numpy(), want[0])
        np.testing.assert_array_equal(t["active"].numpy(), want[1])
        assert int(it) == want[2] and bool(go) == want[4]
        np.testing.assert_array_equal(t["iters"].numpy(), want[3])
        assert int(passes) == (mode != device_loop.ENTRY)
        assert lanes == (0 if mode == device_loop.ENTRY else B)


@pytest.mark.parametrize("B, B2, want", [(512, 128, [256, 128]), (16, 4, [8, 4]),
                                         (16, 3, [8, 4, 3]), (101, 25, [50, 25]),
                                         (512, 256, [256]), (10, 9, [9])])
def test_ladder_halves_from_the_batch_to_compact_lanes(B, B2, want):
    """The rungs below a batch halve while the half exceeds ``compact_lanes``,
    then end at it; a decode's graph holds phase A's loop, the ladder's IF
    node and full-width loop, and an IF node and a loop a rung (one loop
    without compaction)."""
    assert device_loop.ladder(B, B2) == want
    opts = tbp.DecodeOptions(max_iterations=20, compact_after=4, compact_lanes=B2)
    assert device_loop.loops_per_decode(B, opts) == 3 + 2 * len(want)
    assert device_loop.loops_per_decode(B, tbp.DecodeOptions(max_iterations=20)) == 1
    assert device_loop.loops_per_decode(B, tbp.DecodeOptions(
        max_iterations=4, compact_after=4, compact_lanes=B2)) == 1


class _BodyCounter:
    """Stands in for a :class:`device_loop.Graph` under capture on the CPU: it
    counts the conditional bodies and their depth, and runs each body once."""

    def __init__(self):
        self.bodies, self.depth, self.deepest = 0, 0, 0

    def handle(self):
        return 0

    def conditional(self, kind, handle, body):
        self.bodies += 1
        self.depth += 1
        self.deepest = max(self.deepest, self.depth)
        try:
            body(torch.zeros(1, dtype=torch.int64))
        finally:
            self.depth -= 1


@pytest.mark.parametrize("b2", [4, 3])
@pytest.mark.parametrize("schedule", ["flooding", "layered"])
def test_a_decode_captures_loops_per_decode_bodies(schedule, b2):
    """The program a decode captures holds exactly ``loops_per_decode``
    conditional bodies (the trial chunk sizes its graph's counters by it),
    nested no deeper than a graph allows."""
    n_err, k1, _, cap = REGIMES[schedule]["ladder"]
    _, tc = code_pair(CODES[schedule])
    llr, syn = decode_frames(tc, n_err, 16, seed=40)
    opts = tbp.DecodeOptions(algorithm="min-sum", max_iterations=cap, schedule=schedule,
                             compact_after=k1, compact_lanes=b2)
    run, _, _ = tbp.decode_program(tc, opts, "cpu")
    graph = _BodyCounter()
    run(torch.from_numpy(llr).T.contiguous(), torch.from_numpy(syn).T.contiguous(), graph)
    assert graph.bodies == device_loop.loops_per_decode(16, opts)
    assert graph.deepest <= device_loop.MAX_DEPTH


def test_run_loop_counts_passes_and_tests_before_the_first():
    """``lax.while_loop`` semantics: the condition is tested before the first
    pass, a loop at its limit or with every lane done runs no pass.  A pass
    runs the bookkeeping it is handed after its flags."""
    B = 4
    for it0, done0, limit, want_passes in ((5, [0, 0, 0, 0], 5, 0), (0, [1, 1, 1, 1], 9, 0),
                                           (0, [0, 0, 0, 0], 3, 3)):
        st = device_loop.LoopState(torch.tensor(done0, dtype=torch.bool),
                                   torch.tensor([it0], dtype=torch.int32))
        bodies = []

        def body(tail):
            bodies.append(1)
            st.ok.fill_(False)
            tail.plain(st.ok)

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
