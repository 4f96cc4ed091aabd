"""The continuation as one program (``sim/continuation.py``'s
``_ContinuationProgram``) against the JAX package's ``_continuation_point``
and ``_continuation_sweep``, and each outer-loop step's plain version
(``sim/cuda_continuation.py``) against a numpy statement of the JAX lines it
stands for.

The port runs on the CPU, where the program runs eagerly through the steps'
plain versions; on the card the same program is captured as one CUDA graph,
which ``chip_smoke.py`` holds against this eager program and the kernels
against these plain versions.  JAX's ``regen``, ``refill`` and banking are
closures of its ``_continuation_core`` and cannot be called alone, so each
step is held against the lines of ``qkd_ldpc_tpu/sim/continuation.py`` cited
in its test, on crafted carries drawn from a numpy seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qkd_ldpc_tpu import codes as jcodes
from qkd_ldpc_tpu.decoder import DecodeOptions as JaxDecodeOptions
from qkd_ldpc_tpu.sim import continuation as jcont
from qkd_ldpc_tpu_torch import codes as tcodes
from qkd_ldpc_tpu_torch.channel.threefry import fold_in, prng_key
from qkd_ldpc_tpu_torch.decoder.bp import DecodeOptions
from qkd_ldpc_tpu_torch.sim import continuation as tcont
from qkd_ldpc_tpu_torch.sim import cuda_continuation as steps
from qkd_ldpc_tpu_torch.sim import run_point_continuation

torch.set_num_threads(1)
CPU = torch.device("cpu")
# The R~0.49 waterfall code of tests/test_torch_continuation.py: at QBER
# 0.07-0.08 and a 30-iteration cap trials both converge and fail.
WF = dict(n=1024, m=523, dv=3, seed=3, name="wf-1024")
# 70 trials a point on 16 lanes, refill quantum 4: 70 = 17 * 4 + 2, so each
# point ends with a tail refill of n_new = 2 < K.
TRIALS, BATCH, SEGMENT, K = 70, 16, 3, 4
QBERS = (0.07, 0.075, 0.078)


@pytest.fixture(scope="module")
def codes():
    return jcodes.make_code(**WF), tcodes.make_code(**WF)


def _jax_core(jc, keys, n_errs, trials, offset, opts):
    """JAX's ``_continuation_core`` under ``jit`` with a given first trial id
    (``_continuation_sweep`` fixes it at 0)."""
    fn = jax.jit(jcont._continuation_core,
                 static_argnames=("batch", "segment", "refill_min", "opts", "prng"))
    return np.asarray(fn(jc, jnp.stack(keys), jnp.asarray(n_errs, jnp.int32),
                         jnp.asarray(trials, jnp.int32), jnp.asarray(offset, jnp.int32),
                         batch=BATCH, segment=SEGMENT, refill_min=K, opts=opts))


def _keys(n):
    jk = [jax.random.fold_in(jax.random.PRNGKey(777), i) for i in range(n)]
    tk = [fold_in(prng_key(777), i) for i in range(n)]
    return jk, tk


def _assert_sp_close(port, jax_, what):
    """Sum-product across formulations (the North star): trials, successes
    and keys equal; the iteration sum and sum of squares may differ by a
    rare boundary frame moved by one iteration (recorded in ROADMAP C)."""
    assert np.array_equal(port[:3], jax_[:3]), what
    assert np.all(np.abs(port[3] - jax_[3]) <= 2), what


@pytest.mark.parametrize("algorithm", ["min-sum", "sum-product"])
def test_point_equals_jax_continuation_point(codes, algorithm):
    """P = 1 through ``run_point_continuation`` and the program: its [7]
    statistics equal JAX's ``_continuation_point`` (min-sum exactly), with a
    tail refill of 2 < K trials."""
    jc, tc = codes
    jk, tk = _keys(1)
    n_err = int(tc.n_vars * 0.075)
    jopts = JaxDecodeOptions(max_iterations=30, algorithm=algorithm)
    want = np.asarray(jcont._continuation_point(
        jc, jk[0], jnp.asarray(n_err, jnp.int32), jnp.asarray(TRIALS, jnp.int32),
        BATCH, SEGMENT, K, jopts))
    got, counts = tcont._continuation_core(
        tc, tk, [n_err], TRIALS, 0, BATCH, SEGMENT, K,
        DecodeOptions(max_iterations=30, algorithm=algorithm), device=CPU)
    got = got[:, 0].numpy()
    assert got[0] == TRIALS and 0 < got[1] < TRIALS
    if algorithm == "min-sum":
        assert np.array_equal(got, want)
    else:
        _assert_sp_close(got, want, (got, want))
    # 18 refills move the 70 trials (the 18th a tail of 2); 5 blocks of 16
    assert counts["refills"] == 18 and counts["generations"] == 5


@pytest.mark.parametrize("algorithm", ["min-sum", "sum-product"])
def test_sweep_equals_jax_continuation_sweep(codes, algorithm):
    """P = 3: drained lanes of point p host point p+1's trials; the [7, 3]
    statistics equal JAX's ``_continuation_sweep`` (min-sum exactly)."""
    jc, tc = codes
    jk, tk = _keys(3)
    n_errs = [int(tc.n_vars * q) for q in QBERS]
    jopts = JaxDecodeOptions(max_iterations=30, algorithm=algorithm)
    want = np.asarray(jcont._continuation_sweep(
        jc, jnp.stack(jk), jnp.asarray(n_errs, jnp.int32), jnp.asarray(TRIALS, jnp.int32),
        BATCH, SEGMENT, K, jopts))
    got, _ = tcont._continuation_core(
        tc, tk, n_errs, TRIALS, 0, BATCH, SEGMENT, K,
        DecodeOptions(max_iterations=30, algorithm=algorithm), device=CPU)
    got = got.numpy()
    assert got.shape == (7, 3) and list(got[0]) == [TRIALS] * 3
    if algorithm == "min-sum":
        assert np.array_equal(got, want)
    else:
        for p in range(3):
            _assert_sp_close(got[:, p], want[:, p], (p, got, want))


def test_trial_ids_wrap_at_2_32(codes):
    """A first trial id of 2**32 - 37 (JAX's int32 -37): the ids of every
    staging block wrap mod 2**32 as JAX's ``(trial_offset + base +
    arange(S)).astype(uint32)`` (:123-125); two points, min-sum, exact."""
    jc, tc = codes
    jk, tk = _keys(2)
    n_errs = [int(tc.n_vars * q) for q in QBERS[:2]]
    opts = dict(max_iterations=30, algorithm="min-sum")
    want = _jax_core(jc, jk, n_errs, TRIALS, -37, JaxDecodeOptions(**opts))
    got, _ = tcont._continuation_core(tc, tk, n_errs, TRIALS, 2**32 - 37, BATCH, SEGMENT, K,
                                      DecodeOptions(**opts), device=CPU)
    assert np.array_equal(got.numpy(), want)
    # the wrap changes the trials: the same run from id 0 differs
    from_0, _ = tcont._continuation_core(tc, tk, n_errs, TRIALS, 0, BATCH, SEGMENT, K,
                                         DecodeOptions(**opts), device=CPU)
    assert not np.array_equal(from_0.numpy(), want)


def test_loop_counts_come_from_the_carry(codes):
    """``last_loop_counts`` is read from the program's carry with the
    statistics: one count an outer step, refill and staging block."""
    _, tc = codes
    _, tk = _keys(1)
    p, _ = run_point_continuation(tc, tk[0], 0.075, TRIALS, BATCH,
                                  DecodeOptions(max_iterations=30), segment=SEGMENT,
                                  refill_frac=0.25, device=CPU)
    counts = dict(tcont.last_loop_counts)
    assert p.n_trials == TRIALS
    assert counts["refills"] == 18 and counts["generations"] == 5
    # every outer step decodes `segment` passes: the lanes did at least the
    # trials' work (iterations plus one a-priori pass each)
    lane_passes = SEGMENT * counts["outer_steps"] * BATCH
    assert lane_passes >= p.sum_it + (TRIALS - p.n_sp) * 30 + TRIALS


def test_warm_up_runs_one_outer_step(codes):
    """The capture's warm-up (``outer_limit=1``) stops after one outer step:
    one block staged, the lanes filled K at a time, one banking."""
    _, tc = codes
    _, tk = _keys(1)
    x = tcont.continuation_inputs(tk, [76], TRIALS, 0, 10**6, tc.n_vars)
    prog = tcont._ContinuationProgram(tc, 1, BATCH, SEGMENT, K, DecodeOptions(max_iterations=30),
                                      "threefry", CPU)
    carry = prog(x, None, outer_limit=1)
    st = carry[7:]
    assert int(st[steps.OUTER]) == 1 and int(st[steps.GENS]) == 1
    assert int(st[steps.REFILLS]) == BATCH // K and int(st[steps.POS]) == BATCH
    assert int(st[steps.FAULT]) == 0


def test_a_loop_past_its_bound_raises(codes, monkeypatch):
    """The outer loop's bound stops the program and the host raises: a fault
    of the program never spins forever, and never passes as a result."""
    _, tc = codes
    _, tk = _keys(1)
    real = steps.loop_caps
    monkeypatch.setattr(steps, "loop_caps", lambda *a: (3, real(*a)[1]))
    with pytest.raises(RuntimeError, match="stopped a loop at its bound"):
        tcont._continuation_core(tc, tk, [76], TRIALS, 0, BATCH, SEGMENT, K,
                                 DecodeOptions(max_iterations=30), device=CPU)


@pytest.mark.parametrize("trials,batch,segment,k,max_it", [
    (70, 16, 3, 4, 30), (9, 20, 5, 5, 12), (64, 8, 1, 1, 7), (33, 12, 7, 12, 40)])
def test_loop_caps_hold_with_room(codes, trials, batch, segment, k, max_it):
    """Runs that a point's trials, lanes, segment and quantum make as long
    as they can be stay far inside both bounds."""
    _, tc = codes
    _, tk = _keys(2)
    opts = DecodeOptions(max_iterations=max_it)
    _, counts = tcont._continuation_core(tc, tk, [76, 80], trials, 0, batch, segment, k, opts,
                                         device=CPU)
    outer, _ = steps.loop_caps(trials, 2, batch, batch, k, max_it, segment)
    assert counts["outer_steps"] <= outer // 2


def test_inputs_layout():
    keys = [torch.tensor([1, 2**32 - 1]), torch.tensor([5, 6])]
    x = tcont.continuation_inputs(keys, [40, 41], 100, 2**32 - 3, 999, 1024)
    assert x.dtype == torch.int32 and x.shape == (3 + 4 * 2,)
    assert x[:3].tolist() == [100, -3, 999]
    assert x[3:7].tolist() == [1, -1, 5, 6]
    assert x[7:9].tolist() == [40, 41]
    mags = x[9:11].view(torch.float32)
    q = np.float32([40, 41]) / np.float32(1024)
    assert np.array_equal(mags.numpy(), np.log(((1 - q) / q).astype(np.float64)).astype(
        np.float32))


# ---------------------------------------------------------------------------
# Each step's plain version against the JAX lines it stands for (numpy).

S, P, B = 16, 3, 16
RNG_SEED = 20261017


def _carry(rng, **kw):
    """A crafted carry: x, acc [7, P], st, and the lanes' flags."""
    x = torch.zeros(steps.KEYS + 4 * P, dtype=torch.int32)
    x[steps.TRIALS] = kw.get("trials", 40)
    x[steps.OFFSET] = kw.get("offset", 0)
    x[steps.OUTER_CAP] = 10**6
    x[steps.KEYS:steps.KEYS + 2 * P] = torch.from_numpy(
        rng.integers(-2**31, 2**31, 2 * P).astype(np.int32))
    x[steps.KEYS + 2 * P:steps.KEYS + 3 * P] = torch.tensor([30, 40, 50])
    x[steps.KEYS + 3 * P:] = torch.tensor([2.5, 2.25, 2.0]).view(torch.int32)
    st = torch.zeros(steps.SLOTS, dtype=torch.int32)
    live = torch.from_numpy(rng.random(B) < kw.get("live_frac", 0.5))
    lanes = dict(live=live, run=live & torch.from_numpy(rng.random(B) < 0.5),
                 fresh=torch.from_numpy(rng.random(B) < 0.3),
                 age=torch.from_numpy(rng.integers(0, 9, B).astype(np.int32)),
                 lane_p=torch.from_numpy(rng.integers(0, P, B).astype(np.int32)))
    lanes["done"] = live & ~lanes["run"] & torch.from_numpy(rng.random(B) < 0.6)
    return x, st, lanes


def _lane_tuple(lanes):
    return tuple(lanes[k] for k in ("live", "run", "done", "fresh", "age", "lane_p"))


@pytest.mark.parametrize("base,pos,trials", [(8, 16, 40), (32, 16, 40), (0, 4, 6)],
                         ids=["mid-point", "tail", "short-point"])
def test_refill_lanes_equals_jax_refill(base, pos, trials):
    """``refill`` (:142-199): ``idx = nonzero(~live, size=K)`` — the first K
    empty lanes in lane order — of which the slots with ``base + pos + i <
    trials`` take a trial; age/done/live/fresh/lane_p of those lanes
    (``fresh |=`` keeps earlier fresh lanes), ``next_id += sum(sel)``,
    ``pos += K`` even at a tail.  The port's age is -1 (its first pass forms
    the a-priori totals) where JAX's is 0."""
    rng = np.random.default_rng(RNG_SEED)
    for _ in range(8):
        x, st, lanes = _carry(rng, trials=trials)
        st[steps.BASE], st[steps.POS], st[steps.SP] = base, pos, 1
        st[steps.NEXT_ID], st[steps.LIVE_N] = 5, int(lanes["live"].sum())
        live0 = lanes["live"].numpy().copy()
        fresh0 = lanes["fresh"].numpy().copy()
        age0, lp0 = lanes["age"].numpy().copy(), lanes["lane_p"].numpy().copy()
        # JAX :154-170, in numpy
        idx = np.nonzero(~live0)[0][:K]
        sel = base + pos + np.arange(K) < trials
        picked = idx[sel[:len(idx)]]
        lane_of = torch.zeros(K, dtype=torch.int32)
        steps.refill_lanes_plain(x, st, _lane_tuple(lanes), lane_of, K)
        n_new = len(picked)
        assert lane_of.tolist() == list(picked) + [-1] * (K - n_new)
        pick = np.zeros(B, bool)
        pick[picked] = True
        assert np.array_equal(lanes["live"].numpy(), live0 | pick)
        assert np.array_equal(lanes["fresh"].numpy(), fresh0 | pick)  # accumulates
        assert np.array_equal(lanes["age"].numpy(), np.where(pick, -1, age0))
        assert np.array_equal(lanes["lane_p"].numpy(), np.where(pick, 1, lp0))
        assert not lanes["done"].numpy()[pick].any() and lanes["run"].numpy()[pick].all()
        assert int(st[steps.NEXT_ID]) == 5 + int(sel.sum())
        assert int(st[steps.POS]) == pos + K and int(st[steps.COL0]) == pos
        assert int(st[steps.N_NEW]) == n_new
        assert int(st[steps.LIVE_N]) == int(live0.sum()) + n_new
        assert int(st[steps.REFILLS]) == int(n_new > 0)


@pytest.mark.parametrize("base,sp,trials,offset", [
    (0, 0, 40, 0), (32, 0, 40, 0), (32, 2, 40, 7), (16, 1, 40, 2**32 - 20)],
    ids=["next-block", "advance", "clamp-at-last-point", "ids-wrap"])
def test_stage_step_equals_jax_regen(base, sp, trials, offset):
    """``regen``'s scalars (:111-131): ``new_base = base + S``; where
    ``new_base >= trials`` the point advances (``sp = min(sp + 1, P - 1)``,
    base and ``next_id`` to 0); the block's ids are ``trial_offset + base``
    onwards mod 2**32, of point ``sp``'s key and error count; ``pos = 0``."""
    rng = np.random.default_rng(RNG_SEED + 1)
    x, st, _ = _carry(rng, trials=trials, offset=np.uint32(offset).view(np.int32))
    st[steps.BASE], st[steps.SP], st[steps.NEXT_ID], st[steps.POS] = base, sp, 9, S
    st[steps.EXCESS] = 1
    steps.stage_step_plain(x, st, S, P)
    new_base = base + S
    adv = new_base >= trials
    want_sp = min(sp + 1, P - 1) if adv else sp
    want_base = 0 if adv else new_base
    assert int(st[steps.SP]) == want_sp and int(st[steps.BASE]) == want_base
    assert int(st[steps.NEXT_ID]) == (0 if adv else 9) and int(st[steps.POS]) == 0
    keys = x[steps.KEYS:steps.KEYS + 2 * P].view(P, 2)
    assert st[steps.KEY0:steps.KEY1 + 1].tolist() == keys[want_sp].tolist()
    assert int(st[steps.K]) == [30, 40, 50][want_sp]
    assert int(st[steps.MAG]) == int(x[steps.KEYS + 3 * P + want_sp])
    ids0 = np.uint32((offset + want_base) % 2**32)
    assert np.int32(int(st[steps.ID_BASE])).view(np.uint32) == ids0
    assert int(st[steps.EXCESS]) == 0 and int(st[steps.GENS]) == 1


def test_stage_fill_equals_jax_regen_arrays(codes):
    """``regen``'s arrays (:132-139): ``apriori_llr(bob, q).T``,
    ``syndrome(code, alice).T`` and ``alice.T``, the LLR magnitude read from
    the carry."""
    _, tc = codes
    rng = np.random.default_rng(RNG_SEED + 2)
    N, M = tc.n_vars, tc.n_checks
    alice = rng.integers(0, 2, (S, N)).astype(np.uint8)
    bob = alice ^ (rng.random((S, N)) < 0.07).astype(np.uint8)
    st = torch.zeros(steps.SLOTS, dtype=torch.int32)
    st[steps.MAG] = torch.tensor([2.5], dtype=torch.float32).view(torch.int32)[0]
    llr_s = torch.zeros((N, S))
    syn_s, alice_s = torch.zeros((M, S), dtype=torch.int8), torch.zeros((N, S),
                                                                         dtype=torch.int8)
    steps.stage_fill_plain(torch.from_numpy(alice), torch.from_numpy(bob), tc.to_device(CPU),
                           st, llr_s, syn_s, alice_s)
    assert np.array_equal(llr_s.numpy(), np.where(bob.T == 1, -2.5, 2.5).astype(np.float32))
    assert np.array_equal(syn_s.numpy(), ((tc.dense.astype(np.int64) @ alice.T) % 2))
    assert np.array_equal(alice_s.numpy(), alice.T)


def test_refill_copy_equals_jax_blend(codes):
    """``refill``'s blend (:156-188): the staged columns ``pos .. pos + n_new``
    land in the chosen lanes; their messages are zeroed; other lanes keep
    theirs."""
    _, tc = codes
    rng = np.random.default_rng(RNG_SEED + 3)
    N, M, dc = tc.n_vars, tc.n_checks, tc.dc_max
    staged = (torch.from_numpy(rng.standard_normal((N, S)).astype(np.float32)),
              torch.from_numpy(rng.integers(0, 2, (M, S)).astype(np.int8)),
              torch.from_numpy(rng.integers(0, 2, (N, S)).astype(np.int8)))
    pool = (torch.from_numpy(rng.standard_normal((N, B)).astype(np.float32)),
            torch.from_numpy(rng.integers(0, 2, (M, B)).astype(np.int8)),
            torch.from_numpy(rng.integers(0, 2, (N, B)).astype(np.int8)),
            torch.from_numpy(rng.standard_normal((dc, M, B)).astype(np.float32)))
    before = [t.clone() for t in pool]
    st = torch.zeros(steps.SLOTS, dtype=torch.int32)
    st[steps.COL0], st[steps.N_NEW] = 8, 3
    lane_of = torch.tensor([1, 6, 7, -1], dtype=torch.int32)
    steps.refill_copy_plain(st, lane_of, staged, pool)
    lanes = [1, 6, 7]
    for src, dst, old in zip(staged, pool, before):
        assert torch.equal(dst[:, lanes], src[:, 8:11])
        rest = [b for b in range(B) if b not in lanes]
        assert torch.equal(dst[:, rest], old[:, rest])
    assert not pool[3][:, :, lanes].any()
    assert torch.equal(pool[3][:, :, 0], before[3][:, :, 0])


def test_pass_step_equals_jax_segment_bookkeeping():
    """The segment pass (:225-233): ``act = live & ~done & (age < max_it)``
    (the port's ``run``), ``done |= ok & act``; ``run`` after the pass is
    the next pass's ``act``; ``fresh`` clears after the first pass only."""
    rng = np.random.default_rng(RNG_SEED + 4)
    for first in (True, False):
        x, st, lanes = _carry(rng)
        live, done, age = lanes["live"], lanes["done"], lanes["age"]
        run = live & ~done & (age < 6)
        fresh = lanes["fresh"].clone()
        fresh0 = fresh.clone()
        ok = torch.from_numpy(rng.random(B) < 0.5)
        done_want = done.numpy() | (ok.numpy() & run.numpy())
        steps.pass_step_plain(ok, done, run, age, fresh, 6, first)
        assert np.array_equal(done.numpy(), done_want)
        assert np.array_equal(run.numpy(), live.numpy() & ~done_want & (age.numpy() < 6))
        assert torch.equal(fresh, torch.zeros_like(fresh) if first else fresh0)


def test_bank_equals_jax_banking_into_points():
    """The banking (:241-259) into two points: ``finished = live & (done |
    age >= max_it)`` (the port's ``live & ~run``), scatter adds of trials,
    successes, keys matches, iterations and squares, scatter min/max over
    the successes with neutral elements elsewhere; finished lanes freed."""
    rng = np.random.default_rng(RNG_SEED + 5)
    max_it, N = 8, 64
    for _ in range(4):
        x, st, lanes = _carry(rng, live_frac=0.8)
        live, done, age, lane_p = (lanes[k] for k in ("live", "done", "age", "lane_p"))
        lane_p.clamp_(max=1)  # two points
        run = live & ~done & (age < max_it)
        z = torch.from_numpy(rng.integers(0, 2, (N, B)).astype(np.int8))
        alice = z.clone()
        alice[0, rng.random(B) < 0.3] ^= 1
        acc = torch.zeros((7, P), dtype=torch.int32)
        acc[5] = max_it
        acc[0] = torch.tensor([3, 4, 0])  # earlier bankings stay
        # numpy statement of :241-259
        lv, dn, ag, lp = live.numpy(), done.numpy(), age.numpy(), lane_p.numpy()
        fin = lv & (dn | (ag >= max_it))
        spr = fin & dn
        keys = (z.numpy() == alice.numpy()).all(axis=0)
        it = np.where(spr, ag, 0)
        want = acc.numpy().copy()
        np.add.at(want[0], lp, fin.astype(np.int32))
        np.add.at(want[1], lp, spr.astype(np.int32))
        np.add.at(want[2], lp, (spr & keys).astype(np.int32))
        np.add.at(want[3], lp, it)
        np.add.at(want[4], lp, it * it)
        np.minimum.at(want[5], lp, np.where(spr, ag, max_it))
        np.maximum.at(want[6], lp, it)
        flags = torch.zeros(4, dtype=torch.uint8)
        mis = torch.zeros(B, dtype=torch.int32)
        steps.bank_plain(x, acc, st, (live, run, done, age, lane_p), z, alice, mis, max_it,
                         flags)
        assert np.array_equal(acc.numpy(), want)
        assert np.array_equal(live.numpy(), lv & ~fin)
        assert int(st[steps.LIVE_N]) == int((lv & ~fin).sum()) and int(st[steps.OUTER]) == 1
        more = int(st[steps.SP]) < P - 1 or int(st[steps.NEXT_ID]) < int(x[steps.TRIALS])
        assert bool(flags[steps.OUTER_GO]) == (more or bool((lv & ~fin).any()))
        assert not mis.any()


@pytest.mark.parametrize("sp,next_id,live_n,pos", [
    (0, 10, 3, 4), (2, 40, 3, 4), (2, 39, 15, 4), (2, 39, 0, 16), (1, 40, 12, 16)])
def test_want_equals_jax_want_lanes(sp, next_id, live_n, pos):
    """``want_lanes`` (:205-209) — ids left (a later point, or
    ``next_id < trials``) and (at least K empty lanes, or none live) — and
    the cond's predicate ``pos >= S`` (:211-213), written together."""
    x, st, _ = _carry(np.random.default_rng(RNG_SEED + 6), trials=40)
    st[steps.SP], st[steps.NEXT_ID], st[steps.LIVE_N], st[steps.POS] = sp, next_id, live_n, pos
    flags = torch.zeros(4, dtype=torch.uint8)
    steps.want_plain(x, st, B, P, K, S, 100, True, flags)
    want = (sp < P - 1 or next_id < 40) and (B - live_n >= K or live_n == 0)
    assert flags[1:].tolist() == [want, want and pos >= S, want and pos < S]
    assert int(st[steps.INNER]) == 0 and int(st[steps.FAULT]) == 0


def test_start_equals_jax_init():
    """The initial carry (:266-292): no lane live, accumulators at their
    neutral elements (min at max_it), an empty staging block (``pos = S``,
    ``base = -S``), and ``outer_cond`` with no live lane."""
    x, st, lanes = _carry(np.random.default_rng(RNG_SEED + 7))
    st.fill_(7)
    acc = torch.full((7, P), 5, dtype=torch.int32)
    flags = torch.zeros(4, dtype=torch.uint8)
    steps.start_plain(x, acc, st, _lane_tuple(lanes), S, 30, flags)
    assert acc.tolist() == [[0] * P] * 5 + [[30] * P, [0] * P]
    assert int(st[steps.BASE]) == -S and int(st[steps.POS]) == S
    assert int(st[steps.SP]) == int(st[steps.NEXT_ID]) == int(st[steps.OUTER]) == 0
    assert not any(t.any() for t in _lane_tuple(lanes))
    assert int(flags[steps.OUTER_GO]) == 1


def test_step_wrappers_refuse_the_cpu():
    """A kernel's wrapper launches for CUDA tensors and raises on the CPU;
    only ``use_kernel=False`` runs the plain version."""
    x, st, lanes = _carry(np.random.default_rng(RNG_SEED + 8))
    with pytest.raises(ValueError, match="CUDA"):
        steps.stage_step_cuda(x, st, S, P)
    with pytest.raises(ValueError, match="CUDA"):
        steps.pass_step_cuda(lanes["done"], lanes["done"], lanes["run"], lanes["age"],
                             lanes["fresh"], 5, True)
