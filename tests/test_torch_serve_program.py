"""The serving step as one program (``serve.py``'s ``_ServeProgram`` and
``_SyndromeProgram``) against the JAX package's jitted ``_serve_step``,
``_serve_step_adapted`` and ``_syndrome_step`` on the same numpy inputs, and
the endpoint's ring of chunk slots.

On the CPU the programs run eagerly through the kernels' plain versions (on
the card the same programs are captured once per endpoint as CUDA graphs,
which ``chip_smoke.py`` holds against their eager runs).  Tolerances: min-sum
equal per lane; sum-product equal on decisions and flags, with at most
``SP_MOVED_FRAMES`` frames whose iterations differ by one (ROADMAP C);
syndromes exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qkd_ldpc_tpu import codes as jcodes
from qkd_ldpc_tpu.decoder import DecodeOptions as JOpts
from qkd_ldpc_tpu.decoder.rate_adapt import RateAdapter as JAdapter
from qkd_ldpc_tpu.decoder.reconcile import apriori_llr as j_apriori_llr
from qkd_ldpc_tpu.serve import Reconciler as JReconciler
from qkd_ldpc_tpu.serve import _serve_step, _serve_step_adapted, _syndrome_step
from qkd_ldpc_tpu_torch import codes as tcodes
from qkd_ldpc_tpu_torch.channel.threefry import prng_key
from qkd_ldpc_tpu_torch.decoder import DecodeOptions as TOpts
from qkd_ldpc_tpu_torch.decoder import RateAdapter
from qkd_ldpc_tpu_torch.decoder.reconcile import llr_magnitude
from qkd_ldpc_tpu_torch.serve import (
    Reconciler,
    _ServeProgram,
    _SyndromeProgram,
    chunk_header,
)
from tests._torch_port_common import make_frames

torch.set_num_threads(1)
CPU = torch.device("cpu")
LANES = 8
SP_MOVED_FRAMES = 2
KW = dict(max_iterations=60)


@pytest.fixture(scope="module")
def medium():
    kw = dict(n=512, m=262, dv=3, seed=7, name="n512")
    return jcodes.make_code(**kw), tcodes.make_code(**kw)


def _syndromes(code, bits):
    return ((bits.astype(np.int64) @ code.dense.T.astype(np.int64)) % 2).astype(np.uint8)


def _run(program, bob, syn, qber, valid):
    """One chunk through ``program`` eagerly: the input buffer as a slot
    holds it (rows past ``valid`` are whatever ``bob`` / ``syn`` hold there),
    and the outputs ``(bits, iterations, flags)``."""
    inp = torch.zeros(program.inputs.nbytes, dtype=torch.uint8)
    out = torch.zeros(program.outputs.nbytes, dtype=torch.uint8)
    header, b, s = program.inputs.views(inp.numpy())
    header[:], b[:], s[:] = chunk_header(qber, valid), bob, syn
    program(inp, out)
    it, ok, bits = program.outputs.views(out.numpy())
    return bits.copy(), it.copy(), ok.copy()


def _jax(fn, jrec, bob, syn, qber, opts, adapted=False):
    args = (jrec.code, jnp.asarray(bob), jnp.asarray(syn), jnp.float32(qber))
    if adapted:
        args += (jrec._key_idx, jrec._short_idx, jrec._short_pinned)
    return tuple(np.asarray(x) for x in fn(*args, opts=opts))


def _assert_equal(got, want, algorithm):
    """Min-sum equal per lane; sum-product equal on decisions and flags, the
    iterations within one on at most SP_MOVED_FRAMES frames."""
    np.testing.assert_array_equal(got[0], want[0])  # decisions
    np.testing.assert_array_equal(got[2], want[2])  # flags
    if algorithm == "min-sum":
        np.testing.assert_array_equal(got[1], want[1])
        return
    moved = np.nonzero(got[1] != want[1])[0]
    assert len(moved) <= SP_MOVED_FRAMES, (moved, got[1][moved], want[1][moved])
    assert np.all(np.abs(got[1][moved].astype(int) - want[1][moved]) <= 1)


@pytest.mark.parametrize("n_errors", [15, 20])
def test_port_magnitude_equals_jax_at_the_test_qbers(n_errors):
    """The QBERs below are ones where XLA:CPU's ``log`` is correctly rounded,
    so the port's magnitude (``chunk_header``) equals JAX's LLR there."""
    q = np.float32(n_errors) / np.float32(512)
    want = np.asarray(j_apriori_llr(jnp.zeros((1,), jnp.uint8), q))[0]
    mag = chunk_header(q, LANES)[0:1].view(np.float32)[0]
    assert mag == want == llr_magnitude(q)


@pytest.mark.parametrize("algorithm", ["sum-product", "min-sum"])
def test_one_program_at_two_qbers_equals_serve_step(medium, algorithm):
    """One program object, two chunks at two QBERs: each equals JAX's
    ``_serve_step`` at its QBER (the magnitude comes from the chunk's input,
    not from the program's construction)."""
    jc, tc = medium
    opts = dict(KW, algorithm=algorithm)
    jrec = JReconciler(jc, JOpts(**opts), lanes=LANES)
    program = _ServeProgram(tc, TOpts(**opts), LANES, None, 0, CPU)
    for n_errors, seed in ((15, 1), (20, 2)):
        alice, bob = make_frames(tc.n_vars, LANES, n_errors, seed)
        syn = _syndromes(tc, alice)
        q = n_errors / tc.n_vars
        got = _run(program, bob, syn, q, LANES)
        want = _jax(_serve_step, jrec, bob, syn, q, JOpts(**opts))
        _assert_equal(got, want, algorithm)
        assert want[2].all()
        np.testing.assert_array_equal(got[0], alice)


def test_ragged_tail_pad_lanes_decode_as_zeros(medium):
    """A chunk of 5 valid frames whose slot still holds other rows in its
    pad lanes: every lane equals JAX's ``_serve_step`` on the chunk padded
    with zeros (pad lanes converge at once), and a full chunk before it on
    the same program is unaffected."""
    jc, tc = medium
    opts = dict(KW, algorithm="min-sum")
    jrec = JReconciler(jc, JOpts(**opts), lanes=LANES)
    program = _ServeProgram(tc, TOpts(**opts), LANES, None, 0, CPU)
    alice, bob = make_frames(tc.n_vars, LANES, 20, 3)
    syn = _syndromes(tc, alice)
    q = 20 / tc.n_vars
    full = _run(program, bob, syn, q, LANES)
    _assert_equal(full, _jax(_serve_step, jrec, bob, syn, q, JOpts(**opts)), "min-sum")
    valid = 5
    stale_bob = np.random.default_rng(4).integers(0, 2, bob.shape, dtype=np.uint8)
    stale_bob[:valid] = bob[:valid]
    stale_syn = np.ones_like(syn)
    stale_syn[:valid] = syn[:valid]
    got = _run(program, stale_bob, stale_syn, q, valid)
    padded_bob, padded_syn = bob.copy(), syn.copy()
    padded_bob[valid:], padded_syn[valid:] = 0, 0
    want = _jax(_serve_step, jrec, padded_bob, padded_syn, q, JOpts(**opts))
    _assert_equal(got, want, "min-sum")
    assert (got[0][valid:] == 0).all() and got[2][valid:].all()
    for a, b in zip(got, full):
        np.testing.assert_array_equal(a[:valid], b[:valid])


@pytest.mark.parametrize("algorithm,p,s", [
    ("min-sum", 0, 96), ("sum-product", 64, 0), ("min-sum", 32, 64)],
    ids=["shortened-min-sum", "punctured-sum-product", "both-min-sum"])
def test_adapted_program_equals_serve_step_adapted(medium, algorithm, p, s):
    """The adapted step: zeros, channel LLRs at the payload, the shared
    seed's pinned +-64 at the shortened positions, decode, payload gather —
    equal to JAX's ``_serve_step_adapted`` on a ragged chunk."""
    jc, tc = medium
    opts = dict(KW, algorithm=algorithm)
    jad = JAdapter.make(jc, n_punctured=p, n_shortened=s, seed=2)
    tad = RateAdapter.make(tc, n_punctured=p, n_shortened=s, seed=2)
    jrec = JReconciler(jc, JOpts(**opts), lanes=LANES, adapter=jad, shared_seed=3)
    program = _ServeProgram(tc, TOpts(**opts), LANES, tad, 3, CPU)
    l = tad.payload_bits
    n_errors = 10 if p else 14
    alice, bob = make_frames(l, LANES, n_errors, 5)
    frames = tad.build_frames(torch.from_numpy(alice), prng_key(9), 3,
                              device=CPU).numpy()
    syn = _syndromes(tc, frames)
    valid = 6
    bob[valid:], syn[valid:] = 0, 0
    q = n_errors / l
    got = _run(program, bob, syn, q, valid)
    want = _jax(_serve_step_adapted, jrec, bob, syn, q, JOpts(**opts), adapted=True)
    _assert_equal(got, want, algorithm)
    assert want[2][:valid].all()
    np.testing.assert_array_equal(got[0][:valid], alice[:valid])


def test_syndrome_program_equals_syndrome_step(medium):
    """Alice's side: full frames and a ragged chunk's rows, exact."""
    jc, tc = medium
    program = _SyndromeProgram(tc, TOpts(), LANES, CPU)
    bits = np.random.default_rng(6).integers(0, 2, (LANES, tc.n_vars), dtype=np.uint8)
    inp = torch.from_numpy(bits.reshape(-1).copy())
    out = torch.zeros(program.outputs.nbytes, dtype=torch.uint8)
    program(inp, out)
    (got,) = program.outputs.views(out.numpy())
    want = np.asarray(_syndrome_step(jc.to_device(), jnp.asarray(bits)))
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int8 and want.dtype == got.dtype


@pytest.mark.parametrize("adapted", [False, True], ids=["plain", "adapted"])
def test_reconcile_windows_reuse_slots(medium, adapted):
    """18 frames through 4 lanes (5 chunks, the last of 2) with windows 1, 2
    and 4 on one endpoint: identical results, equal to the JAX endpoint's;
    one serve program and one syndrome program for all calls, and as many
    slots as the largest window."""
    jc, tc = medium
    opts = dict(KW, algorithm="min-sum")
    jad = JAdapter.make(jc, n_punctured=32, n_shortened=64, seed=4) if adapted else None
    tad = RateAdapter.make(tc, n_punctured=32, n_shortened=64, seed=4) if adapted else None
    jrec = JReconciler(jc, JOpts(**opts), lanes=4, adapter=jad)
    trec = Reconciler(tc, TOpts(**opts), lanes=4, adapter=tad, device=CPU)
    alice, bob = make_frames(trec.frame_bits, 18, 12, 8)
    trec.max_inflight_chunks = 2
    syn = trec.syndromes(alice, frame_key=prng_key(2))
    q = 12 / trec.frame_bits
    results = {}
    for window in (1, 2, 4, 2):
        trec.max_inflight_chunks = window
        results.setdefault(window, []).append(trec.reconcile(bob, syn, qber=q))
    want = jrec.reconcile(bob, syn, qber=q)
    for window, outs in results.items():
        for got in outs:
            for f in want._fields:
                np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                              err_msg=f"{f}, window {window}")
    assert want.syndromes_match.all()
    np.testing.assert_array_equal(results[1][0].bits, alice)
    runners = list(trec._runners.values())
    assert len(runners) == 2
    assert sorted(len(r.slots) for r in runners) == [2, 4]  # syndromes: window 2
    if not adapted:
        np.testing.assert_array_equal(syn, np.asarray(_syndrome_step(
            jc.to_device(), jnp.asarray(alice))))
