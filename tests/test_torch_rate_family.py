"""The rate family and the rate-agile endpoint on the CPU, on a small QC
code: the family's members are ``RateAdapter.make``'s, the step rule rounds
down to the grid and clamps, and ``Reconciler(rates=family)`` answers every
step bit for bit as an endpoint bound to that step's member does, from one
serve program."""

import math

import numpy as np
import pytest
import torch

from portbench.reference import rate_adapt as ref_rate
from qkd_ldpc_tpu_torch.channel.threefry import fold_in, prng_key
from qkd_ldpc_tpu_torch.codes import make_qc_code
from qkd_ldpc_tpu_torch.decoder import DecodeOptions, RateAdapter, RateFamily, rate_step
from qkd_ldpc_tpu_torch.decoder.rate_adapt import binary_entropy
from qkd_ldpc_tpu_torch.serve import Reconciler

torch.set_num_threads(1)
D, GRID, SEED, SHARED = 64, 16, 3, 7
OPTS = DecodeOptions(message_dtype="bfloat16", max_iterations=60)
FRAMES, ERRORS = 20, 34  # a block: frames of the 576 payload bits, exact errors each


@pytest.fixture(scope="module")
def code():
    return make_qc_code(z=32, nb=20, mb=10, dv=3, seed=666)


@pytest.fixture(scope="module")
def family(code):
    return RateFamily.make(code, d=D, seed=SEED, grid=GRID)


@pytest.fixture(scope="module")
def agile(code, family):
    return Reconciler(code, OPTS, lanes=8, rates=family, shared_seed=SHARED, device="cpu")


def _block(step, l):
    rng = np.random.default_rng(100 + step)
    alice = rng.integers(0, 2, (FRAMES, l), dtype=np.uint8)
    bob = alice.copy()
    for r in range(FRAMES):
        bob[r, rng.choice(l, ERRORS, replace=False)] ^= 1
    return alice, bob


def test_members_are_the_adapters_of_each_split(code, family):
    assert family.steps == D // GRID + 1 and family.payload_bits == code.n_vars - D
    for i, m in enumerate(family.members):
        want = RateAdapter.make(code, n_punctured=i * GRID, n_shortened=D - i * GRID,
                                seed=SEED)
        for f in ("key_idx", "punct_idx", "short_idx"):
            np.testing.assert_array_equal(getattr(m, f), getattr(want, f))
        np.testing.assert_array_equal(m.key_idx, family.key_idx)
        assert m.leak_bits == code.n_checks - i * GRID


@pytest.mark.parametrize("kw,match", [(dict(d=64, grid=24), "grid"),
                                      (dict(d=64, grid=0), "grid")])
def test_family_arguments_are_checked(code, kw, match):
    with pytest.raises(ValueError, match=match):
        RateFamily.make(code, **kw)


@pytest.mark.parametrize("step", range(D // GRID + 1))
def test_agile_endpoint_equals_the_members_endpoint(code, family, agile, step):
    """Syndromes, and the whole secure chain: bits, iterations, flags, keys,
    leak and final bits, equal to ``Reconciler(adapter=member)``'s."""
    one = Reconciler(code, OPTS, lanes=8, adapter=family.member(step), shared_seed=SHARED,
                     device="cpu")
    alice, bob = _block(step, family.payload_bits)
    fk = fold_in(prng_key(5), step)
    syn = agile.syndromes(alice, fk, rate=step)
    np.testing.assert_array_equal(syn, one.syndromes(alice, fk))
    tk, pk = prng_key(11 + step), prng_key(40 + step)
    tags = agile.tags(alice, tk)
    q = ERRORS / family.payload_bits
    got = agile.reconcile_secure(bob, syn, q, tags, tk, pk, rate=step)
    want = one.reconcile_secure(bob, syn, q, tags, tk, pk)
    for f in got._fields:
        np.testing.assert_array_equal(np.asarray(getattr(got, f)), np.asarray(getattr(want, f)),
                                      err_msg=f)
    plain = agile.reconcile(bob, syn, q, rate=step)
    for a, b in zip(plain, one.reconcile(bob, syn, q)):
        np.testing.assert_array_equal(a, b)
    assert agile.leak(step) == code.n_checks - step * GRID == one.leak_bits
    assert int(got.leak_bits[0]) == code.n_checks - step * GRID + 64
    assert got.final_bits == agile.final_key_bits(rate=step) == one.final_key_bits()
    # one serve program (and one syndrome program) for every step
    assert sorted(k[0] for k in agile._runners) == ["serve", "syndrome"]


def test_a_one_member_family_is_that_adapter(code):
    ad = RateAdapter.make(code, n_punctured=16, n_shortened=32, seed=SEED)
    fam = RateFamily.single(ad)
    assert fam.steps == 1 and fam.member(0) is ad and fam.step(0.05, 1.2) == 0
    rec = Reconciler(code, OPTS, lanes=8, rates=fam, shared_seed=SHARED, device="cpu")
    one = Reconciler(code, OPTS, lanes=8, adapter=ad, shared_seed=SHARED, device="cpu")
    assert rec.adapter is ad and not rec.agile and rec.leak_bits == one.leak_bits
    alice, bob = _block(0, ad.payload_bits)
    syn = rec.syndromes(alice, prng_key(3), rate=0)
    np.testing.assert_array_equal(syn, one.syndromes(alice, prng_key(3)))
    q = ERRORS / ad.payload_bits
    for a, b in zip(rec.reconcile(bob, syn, q), one.reconcile(bob, syn, q)):
        np.testing.assert_array_equal(a, b)
    prog = rec._runner("serve").program
    assert prog.rates is None and prog.inputs.fields[0][3] == (2,)


def test_rate_arguments_are_checked(code, family, agile):
    alice, bob = _block(0, family.payload_bits)
    syn = agile.syndromes(alice, prng_key(1), rate=0)
    for bad in (None, -1, family.steps, 1.5, True):
        with pytest.raises(ValueError):
            agile.reconcile(bob, syn, 0.05, rate=bad)
    with pytest.raises(ValueError, match="step"):
        agile.leak_bits
    fixed = Reconciler(code, OPTS, lanes=8, device="cpu")
    with pytest.raises(ValueError, match="one rate"):
        fixed.leak(0)
    with pytest.raises(ValueError, match="not both"):
        Reconciler(code, OPTS, rates=family, adapter=family.member(0), device="cpu")
    other = make_qc_code(z=32, nb=20, mb=10, dv=3, seed=5)
    with pytest.raises(ValueError, match="different code"):
        Reconciler(other, OPTS, rates=family, device="cpu")


def test_counters_count_blocks_frames_iterations_and_key(code, family):
    rec = Reconciler(code, OPTS, lanes=8, rates=family, shared_seed=SHARED, device="cpu")
    want_it = want_ok = want_bits = 0
    for step in (1, 3, 3):
        alice, bob = _block(step, family.payload_bits)
        syn = rec.syndromes(alice, prng_key(9), rate=step)
        tk = prng_key(2)
        out = rec.reconcile_secure(bob, syn, ERRORS / family.payload_bits,
                                   rec.tags(alice, tk), tk, prng_key(4), rate=step)
        want_it += int(np.where(out.syndromes_match, out.iterations, OPTS.max_iterations).sum())
        want_ok += int(out.verified.sum())
        want_bits += int(out.verified.sum()) * out.final_bits
    c = rec.counters
    assert (c.frames, c.frame_iterations, c.frames_verified, c.final_key_bits) == (
        3 * FRAMES, want_it, want_ok, want_bits)
    assert c.blocks_by_rate == {1: 1, 3: 2}
    c.reset()
    assert (c.frames, c.frame_iterations, c.blocks_by_rate) == (0, 0, {})


# ---- the step rule ---------------------------------------------------------


def _p(code, q, f):
    return code.n_checks - f * binary_entropy(q) * (code.n_vars - D)


def test_the_step_rule_clamps(code, family):
    # a clean channel: every modulated position punctured (the highest rate)
    assert family.step(1e-4, 1.2) == family.steps - 1
    # a channel past the mother code: every position shortened (the lowest)
    assert family.step(0.2, 1.5) == 0
    with pytest.raises(ValueError):
        family.step(0.0, 1.2)
    with pytest.raises(ValueError):
        family.step(0.05, 0.0)


@pytest.mark.parametrize("edge", [1, 2, 3])
def test_the_step_rule_rounds_down_at_grid_edges(code, family, edge):
    """Just above a grid edge of ``p`` the step is the edge's, just below it
    the step before: the lower rate, the safe side."""
    f, target = 1.2, edge * GRID
    lo, hi = 1e-6, 0.5  # p falls as q rises: bisect for p == target
    for _ in range(200):
        mid = (lo + hi) / 2
        lo, hi = (mid, hi) if _p(code, mid, f) > target else (lo, mid)
    below_edge, above_edge = hi * (1 + 1e-9), lo * (1 - 1e-9)
    assert _p(code, above_edge, f) > target > _p(code, below_edge, f)
    assert family.step(above_edge, f) == edge
    assert family.step(below_edge, f) == edge - 1


def test_the_step_rule_is_the_references(code):
    """Both sides' rules (the program's and the benchmark's own) agree over a
    fine grid of QBERs and efficiencies."""
    for q in np.linspace(0.005, 0.12, 347):
        for f in (1.0, 1.17, 1.25, 1.5):
            got = rate_step(code.n_vars, code.n_checks, D, GRID, float(q), f)
            assert got == ref_rate.step(code.n_vars, code.n_checks, D, GRID, float(q), f)
            p = math.floor(_p(code, float(q), f) / GRID) * GRID
            assert got == min(max(p, 0), D) // GRID
