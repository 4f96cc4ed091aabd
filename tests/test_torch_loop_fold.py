"""The loops' tests folded into the kernels that end each step: their plain
versions on the CPU.

A decode loop's pass ends in its check update (flooding) or its sweep
(layered); the loop's bookkeeping after the pass (``device_loop.LoopTail``)
runs there, in the kernel's last block on the card and, in the plain
versions here, right after the plain pass.  The folded plain pass must leave
every tensor as the plain pass followed by ``loop_step_plain`` does, and the
bookkeeping must be JAX's carry (``qkd_ldpc_tpu/decoder/bp.py:434-452``,
``layered.py:213-225``), stated in numpy.

The continuation's refill-loop test (``want_lanes`` and the cond's ``pos >=
S``, ``qkd_ldpc_tpu/sim/continuation.py:205-213``) runs in the step before
it: the start and the banking before the refill loop, the stage step and the
refill's lane step after a regeneration or a refill.  Each step with the
test folded in must equal the step followed by ``want_plain`` on the same
carry, over the carries of ``test_want_equals_jax_want_lanes``.
"""

import numpy as np
import pytest
import torch

from qkd_ldpc_tpu_torch.decoder import cuda_kernels, device_loop, layered
from qkd_ldpc_tpu_torch.sim import cuda_continuation as steps
from tests._torch_port_common import code_pair, decode_frames

torch.set_num_threads(1)
SEED = 20261019
LIMIT = 20
KW = dict(threshold=100.0, clip=True, algorithm="min-sum", min_sum_alpha=0.8,
          min_sum_beta=0.0, scale=None)
# regime -> (frozen lanes, it before the pass, every frame done before it,
# every frame's syndrome met)
REGIMES = {"mid": (False, 3, False, False), "frozen": (True, 3, False, False),
           "at_the_limit": (False, LIMIT - 1, False, False),
           "no_active_lane": (False, 3, True, False),
           "every_lane_converges": (False, 3, False, True)}


def _loop_state(rng, b, regime):
    """A loop's buffers before a pass: ``done``, ``frozen``, ``active`` as the
    previous test left them, ``it``, ``iters``, the go byte and counters."""
    frozen_on, it0, all_done, _ = REGIMES[regime]
    done = np.ones(b, bool) if all_done else rng.random(b) < 0.3
    frozen = (rng.random(b) < 0.3) if frozen_on else None
    active = ~done & (True if frozen is None else ~frozen)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    return dict(done=t(done), active=t(active), frozen=None if frozen is None else t(frozen),
                it=torch.tensor([it0], dtype=torch.int32),
                iters=t(rng.integers(0, 9, b).astype(np.int32)),
                go=torch.zeros(1, dtype=torch.bool), passes=torch.zeros((), dtype=torch.int64),
                ticket=torch.zeros(1, dtype=torch.int32))


def _tail(mode, s):
    return device_loop.LoopTail(mode, s["done"], s["active"], s["frozen"], s["it"],
                                s["iters"] if mode == device_loop.LAYERED else None, LIMIT,
                                s["go"], s["ticket"], s["passes"])


def _jax_carry(mode, ok, s):
    """numpy statement of the carry after a pass (JAX bp.py:434-452,
    layered.py:213-225): converged frames join ``done`` (the layered carry
    records their sweep), ``it`` moves, and the loop goes on while ``it <
    limit`` and a frame is neither done nor frozen."""
    done, active = s["done"].numpy().copy(), s["active"].numpy()
    iters = s["iters"].numpy().copy()
    it = int(s["it"]) + 1
    newly = active & ok & ~done
    done |= newly
    if mode == device_loop.LAYERED:
        iters[newly] = it
    act = ~done if s["frozen"] is None else ~done & ~s["frozen"].numpy()
    return done, act, it, iters, bool(it < LIMIT and act.any())


def _flooding_pass(rng, regime):
    """The check update's inputs on the irregular code: totals, messages, and
    targets that the totals' decisions meet on every frame or on some."""
    _, tc = code_pair("irregular")
    b = 24
    maps = tc.to_device(torch.device("cpu"))
    tot = torch.from_numpy((4.0 * rng.standard_normal((tc.n_vars, b))).astype(np.float32))
    lrp = torch.from_numpy((2.0 * rng.standard_normal((tc.dc_max, tc.n_checks, b))).astype(
        np.float32))
    dec = (tot.numpy() <= 0).astype(np.int64)
    met = (tc.dense.astype(np.int64) @ dec) % 2  # [M, B]: every check met
    syn = np.where(rng.random(b) < 0.5, met, rng.integers(0, 2, met.shape))
    if REGIMES[regime][3]:
        syn = met
    return maps, tot, lrp, torch.from_numpy(syn.astype(np.int8))


def _layered_pass(rng, regime):
    """A layered state two plain sweeps into the decode of real frames (few
    errors where every frame must converge in the next sweep)."""
    _, tc = code_pair("qc")
    tables = layered.layer_tables(tc, torch.device("cpu"))
    n_err = 2 if REGIMES[regime][3] else 20
    llr, syn = decode_frames(tc, n_err, 12, seed=int(rng.integers(1 << 30)))
    t, lr, syn3 = layered.initial_state(tables, torch.from_numpy(llr.T.copy()),
                                        torch.from_numpy(syn.T.copy()), torch.float32)
    act = torch.ones(llr.shape[0], dtype=torch.bool)
    for _ in range(2):
        t, lr, _ = layered.layered_sweep_plain(t, lr, syn3, act, tables, **KW)
    return tables, t, lr, syn3


@pytest.mark.parametrize("regime", list(REGIMES))
@pytest.mark.parametrize("schedule", ["flooding", "layered"])
def test_folded_pass_equals_the_pass_then_the_bookkeeping(schedule, regime):
    """The plain pass with its bookkeeping handed to it (``step=``) against
    the plain pass followed by ``loop_step_plain``, on every tensor either
    writes (messages, totals, flags, done, active, iters, it, go, passes and
    the ticket, which only the kernel's blocks take); and the bookkeeping
    against JAX's carry.  Frozen lanes, a pass that reaches the limit, no
    active lane, and every lane converging."""
    rng = np.random.default_rng(SEED + 7 * len(regime) + len(schedule))
    if schedule == "flooding":
        mode = device_loop.FLOODING
        maps, tot, lrp, syn = _flooding_pass(rng, regime)
        b = tot.shape[1]

        def run(state, step):
            out, ok = lrp.clone(), torch.ones(b, dtype=torch.bool)
            cuda_kernels.check_update_fused(tot, out, syn, maps, backend="xla", ok=ok, out=out,
                                            step=step, **KW)
            return out, ok
    else:
        mode = device_loop.LAYERED
        tables, t0, lr0, syn3 = _layered_pass(rng, regime)
        b = t0.shape[1]

        def run(state, step):
            t, lr, ok = t0.clone(), lr0.clone(), torch.zeros(b, dtype=torch.bool)
            layered.layered_sweep_plain(t, lr, syn3, state["active"], tables, out=ok,
                                        in_place=True, step=step, **KW)
            return torch.cat([t.flatten(), lr.flatten()]), ok

    before = _loop_state(rng, b, regime)
    folded = {k: None if v is None else v.clone() for k, v in before.items()}
    unfolded = {k: None if v is None else v.clone() for k, v in before.items()}
    msgs_f, ok_f = run(folded, _tail(mode, folded))
    msgs_u, ok_u = run(unfolded, None)
    _tail(mode, unfolded).plain(ok_u)
    assert torch.equal(msgs_f, msgs_u) and torch.equal(ok_f, ok_u)
    for k, v in folded.items():
        assert v is None or torch.equal(v, unfolded[k]), k
    done, act, it, iters, go = _jax_carry(mode, ok_u.numpy(), before)
    assert np.array_equal(folded["done"].numpy(), done)
    assert np.array_equal(folded["active"].numpy(), act)
    assert int(folded["it"]) == it and bool(folded["go"]) == go
    assert np.array_equal(folded["iters"].numpy(), iters)
    assert int(folded["passes"]) == 1 and int(folded["ticket"]) == 0
    if regime == "every_lane_converges":
        assert bool(ok_u.all()) and not go
    if regime in ("at_the_limit", "no_active_lane"):
        assert not go


def test_a_tail_is_the_bookkeeping_after_a_pass():
    """The entry test is a kernel of its own; a pass's tail is FLOODING or
    LAYERED, and the wrappers refuse it where no pass's flags are given."""
    b = torch.zeros(4, dtype=torch.bool)
    s = dict(done=b, active=b.clone(), frozen=None, it=torch.zeros(1, dtype=torch.int32),
             iters=None, go=torch.zeros(1, dtype=torch.bool), passes=None,
             ticket=torch.zeros(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA"):
        _tail(device_loop.FLOODING, s).args(b)
    with pytest.raises(ValueError, match="last kernel"):
        device_loop.loop_step_cuda(device_loop.FLOODING, b, b, b.clone(), None, s["it"], None,
                                   3)
    _, tc = code_pair("irregular")
    maps = tc.to_device(torch.device("cpu"))
    tot = torch.zeros((tc.n_vars, 4))
    syn = torch.zeros((tc.n_checks, 4), dtype=torch.int8)
    with pytest.raises(ValueError, match="no step"):
        cuda_kernels.check_update_first(tot, syn, maps, backend="xla",
                                        step=_tail(device_loop.FLOODING, s), **KW)


# ---------------------------------------------------------------------------
# The continuation's refill-loop test, run by the step before it.

S, P, B, K, INNER_CAP, TRIALS = 16, 3, 16, 4, 100, 40
# (sp, next_id, live_n, pos) of test_want_equals_jax_want_lanes: ids left or
# not, lanes free or not, the staging block used up or not
GRID = [(0, 10, 3, 4), (2, 40, 3, 4), (2, 39, 15, 4), (2, 39, 0, 16), (1, 40, 12, 16)]


def _carry(rng, sp, next_id, live_n, pos, points=P, trials=TRIALS):
    """x, acc, st and B lanes of which ``live_n`` are live, on the grid's
    carry; the staging block's base puts ``pos`` inside the point."""
    x = torch.zeros(steps.KEYS + 4 * points, dtype=torch.int32)
    x[steps.TRIALS], x[steps.OUTER_CAP] = trials, 10**6
    x[steps.KEYS:steps.KEYS + 2 * points] = torch.from_numpy(
        rng.integers(-2**31, 2**31, 2 * points).astype(np.int32))
    x[steps.KEYS + 2 * points:steps.KEYS + 3 * points] = torch.arange(30, 30 + 10 * points,
                                                                       10)
    x[steps.KEYS + 3 * points:] = torch.full((points,), 2.25).view(torch.int32)
    st = torch.zeros(steps.SLOTS, dtype=torch.int32)
    st[steps.SP], st[steps.NEXT_ID], st[steps.LIVE_N], st[steps.POS] = sp, next_id, live_n, pos
    st[steps.BASE], st[steps.INNER] = 16, 5
    live = np.zeros(B, bool)
    live[rng.permutation(B)[:live_n]] = True
    run = live & (rng.random(B) < 0.5)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    lanes = dict(live=t(live), run=t(run), done=t(live & ~run & (rng.random(B) < 0.6)),
                 fresh=t(rng.random(B) < 0.3), age=t(rng.integers(0, 9, B).astype(np.int32)),
                 lane_p=t(rng.integers(0, P, B).astype(np.int32)))
    acc = torch.from_numpy(rng.integers(0, 50, (7, points)).astype(np.int32))
    return dict(x=x, acc=acc, st=st, flags=torch.zeros(4, dtype=torch.uint8),
                lane_of=torch.zeros(K, dtype=torch.int32),
                z=torch.from_numpy(rng.integers(0, 2, (8, B)).astype(np.int8)),
                alice=torch.from_numpy(rng.integers(0, 2, (8, B)).astype(np.int8)),
                mis=torch.zeros(B, dtype=torch.int32), **lanes)


def _run_step(name, c, test):
    """One continuation step on the carry ``c`` (in place), with ``test``
    folded in or not; returns whether the step tests as ``entry``."""
    lanes6 = tuple(c[k] for k in ("live", "run", "done", "fresh", "age", "lane_p"))
    if name == "start":
        steps.start_plain(c["x"], c["acc"], c["st"], lanes6, S, 30, c["flags"], test)
        return True
    if name == "stage_step":
        steps.stage_step_plain(c["x"], c["st"], S, P, test=test)
        return False
    if name == "refill_lanes":
        steps.refill_lanes_plain(c["x"], c["st"], lanes6, c["lane_of"], K, test=test)
        return False
    lanes5 = tuple(c[k] for k in ("live", "run", "done", "age", "lane_p"))
    steps.bank_plain(c["x"], c["acc"], c["st"], lanes5, c["z"], c["alice"], c["mis"], 30,
                     c["flags"], test=test)
    return True


def _want_lanes(c, points=P):
    """numpy of JAX's ``want_lanes`` and the cond's predicate on a carry."""
    st = c["st"].numpy()
    sp, next_id, live_n, pos = (int(st[k]) for k in (steps.SP, steps.NEXT_ID, steps.LIVE_N,
                                                    steps.POS))
    want = (sp < points - 1 or next_id < int(c["x"][steps.TRIALS])) and (
        B - live_n >= K or live_n == 0)
    return [want, want and pos >= S, want and pos < S]


def _held(step, base, points=P):
    """The step with the refill loop's test handed to it against the step
    followed by ``want_plain``: every tensor equal, the verdicts JAX's
    ``want_lanes`` on the carry the step left (none where the start or the
    banking ends the outer loop).  Returns the folded carry."""
    folded = {k: v.clone() for k, v in base.items()}
    unfolded = {k: v.clone() for k, v in base.items()}
    entry = _run_step(step, folded, steps.RefillTest(B, points, K, S, INNER_CAP,
                                                     folded["flags"]))
    _run_step(step, unfolded, None)
    goes = not entry or bool(unfolded["flags"][steps.OUTER_GO])
    if goes:
        steps.want_plain(unfolded["x"], unfolded["st"], B, points, K, S, INNER_CAP, entry,
                         unfolded["flags"])
    for k, v in folded.items():
        assert torch.equal(v, unfolded[k]), k
    if goes:
        assert folded["flags"][steps.IN_GO:].tolist() == _want_lanes(folded, points)
        assert int(folded["st"][steps.INNER]) == (0 if entry else 6)
    else:
        assert folded["flags"][steps.IN_GO:].tolist() == [0, 0, 0]
    return folded


@pytest.mark.parametrize("carry", GRID, ids=[f"sp{g[0]}_next{g[1]}_live{g[2]}_pos{g[3]}"
                                              for g in GRID])
@pytest.mark.parametrize("step", ["stage_step", "refill_lanes", "bank"])
def test_step_with_the_refill_test_equals_the_step_then_want_plain(step, carry):
    """The stage step and the refill's lane step (the test after a pass) and
    the banking (the test before the next outer step's refill loop) on the
    carries of ``test_want_equals_jax_want_lanes``."""
    _held(step, _carry(np.random.default_rng(SEED + GRID.index(carry)), *carry))


@pytest.mark.parametrize("points,trials", [(3, TRIALS), (1, TRIALS), (1, 0)])
def test_start_with_the_refill_test_equals_the_start_then_want_plain(points, trials):
    """The start (the test before the first refill loop): a later point, ids
    of the one point, or no id at all (the outer loop never starts, so no
    test)."""
    base = _carry(np.random.default_rng(SEED + points + trials), 0, 0, 3, 4, points, trials)
    folded = _held("start", base, points)
    assert bool(folded["flags"][steps.OUTER_GO]) == (trials > 0 or points > 1)


@pytest.mark.parametrize("step", ["stage_step", "refill_lanes"])
def test_a_pass_past_the_bound_stops_the_refill_loop(step):
    """The test after a regeneration or a refill counts JAX's passes in
    ``st[INNER]``: at the bound it stops the loop and raises the fault bit,
    as ``want_plain`` does."""
    rng = np.random.default_rng(SEED + 99)
    folded = _carry(rng, 0, 10, 3, 4)
    folded["st"][steps.INNER] = INNER_CAP - 1
    unfolded = {k: v.clone() for k, v in folded.items()}
    _run_step(step, folded, steps.RefillTest(B, P, K, S, INNER_CAP, folded["flags"]))
    _run_step(step, unfolded, None)
    steps.want_plain(unfolded["x"], unfolded["st"], B, P, K, S, INNER_CAP, False,
                     unfolded["flags"])
    for k, v in folded.items():
        assert torch.equal(v, unfolded[k]), k
    assert int(folded["st"][steps.FAULT]) == steps.FAULT_INNER
    assert folded["flags"][steps.IN_GO:].tolist() == [0, 0, 0]
