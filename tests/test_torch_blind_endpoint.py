"""Blind reconciliation on the serving endpoint (``serve.Reconciler.
blind_session``, ``BlindRounds``, the blind layout of ``_ServeProgram``) on a
small quasi-cyclic code: equal bit for bit to the benchmark's plain reference
(``portbench/reference/blind.py``, sum-product) and to the JAX package's
blind session (min-sum: exact per frame), in keys, flags, rounds, leak,
final lengths and iterations; one blind program for every round and reveal
count; only the frames not yet verified decoded after round 0; its counters.
"""

import jax
import numpy as np
import pytest
import torch

from portbench.reference import blind as rblind
from portbench.reference import channel, codes, rate_adapt, threefry, toeplitz
from portbench.reference.decode import Decoder
from qkd_ldpc_tpu import codes as jcodes
from qkd_ldpc_tpu.decoder import DecodeOptions as JOpts
from qkd_ldpc_tpu.decoder import blind as jblind
from qkd_ldpc_tpu.decoder.rate_adapt import RateAdapter as JAdapter
from qkd_ldpc_tpu_torch import serve
from qkd_ldpc_tpu_torch.codes import make_qc_code
from qkd_ldpc_tpu_torch.decoder import BlindSession, DecodeOptions, RateAdapter, RateFamily
from qkd_ldpc_tpu_torch.decoder import device_loop
from qkd_ldpc_tpu_torch.serve import Reconciler, _ServeProgram, chunk_header

from tests._torch_port_common import tkey

torch.set_num_threads(1)
CPU = torch.device("cpu")
Z, NB, MB, DV, CODE_SEED, POS_SEED = 32, 20, 10, 3, 666, 3
TAG, SEC = 64, 100
# (d, reveal step, QBERs of the frame groups, max rounds)
CASES = {"reveals": (64, 16, (0.04, 0.07, 0.09), None),
         "coarse": (128, 48, (0.05, 0.1), None),
         "capped": (64, 8, (0.08, 0.1), 3),
         "hopeless": (64, 32, (0.16,), None)}


@pytest.fixture(scope="module")
def code():
    return make_qc_code(z=Z, nb=NB, mb=MB, dv=DV, seed=CODE_SEED)


@pytest.fixture(scope="module")
def graph():
    return codes.on_device(codes.qc_graph(Z, NB, MB, DV, CODE_SEED), CPU)


def _block(code, graph, d, qbers, frames=20, seed=11):
    """Alice's frames (the reference's), her payloads and syndromes, and
    Bob's payloads with exact-weight flips, the frames split over ``qbers``."""
    pl = rate_adapt.plan(code.n_vars, code.n_checks, d, d, POS_SEED)
    l = pl.key_idx.size
    gen = torch.Generator().manual_seed(seed)
    alice = torch.randint(0, 2, (frames, l), generator=gen, dtype=torch.uint8)
    bob = alice.clone()
    for rows, q in zip(np.array_split(np.arange(frames), len(qbers)), qbers):
        for r in rows:
            pos = torch.randperm(l, generator=gen)[:int(q * l)]
            bob[r, pos] ^= 1
    fk = threefry.fold_in(threefry.key(2**33 + seed), d)
    full = rate_adapt.frames(pl, alice, fk, 0)
    syn = channel.syndromes(graph, full).to(torch.uint8)
    return pl, alice, bob, syn, full


def _reveal(full):
    full = full.numpy()
    return lambda positions, rows: full[np.ix_(rows, positions)]


def _endpoint(code, d, algorithm="sum-product", lanes=8, **kw):
    opts = DecodeOptions(message_dtype="bfloat16", algorithm=algorithm, max_iterations=60)
    ad = RateAdapter.make(code, n_punctured=d, seed=POS_SEED)
    return Reconciler(code, opts, lanes=lanes, adapter=ad, device=CPU, **kw)


@pytest.mark.parametrize("case", sorted(CASES))
def test_blind_chain_equals_the_reference(code, graph, case):
    """Keys, flags, rounds, leak, final lengths, iterations and amplified rows
    of the endpoint's session and ``finalize`` equal the plain reference's."""
    d, step, qbers, max_rounds = CASES[case]
    pl, alice, bob, syn, full = _block(code, graph, d, qbers)
    rec = _endpoint(code, d)
    hint = 0.06
    tk, pk = threefry.fold_in(threefry.key(7), 1), threefry.fold_in(threefry.key(7), 2)
    a_tags = toeplitz.hash_bits(alice, tk, TAG)
    s = rec.blind_session(bob.numpy(), syn.numpy(), hint, reveal_step=step,
                          max_rounds=max_rounds)
    res = s.run(_reveal(full))
    out = s.finalize(a_tags.numpy(), tk, pk, TAG, SEC)
    ref = rblind.rounds(Decoder(max_iterations=60, storage="bfloat16"), graph, pl, bob, syn,
                        full, channel.llr_magnitude(np.float32(hint)), step, max_rounds)
    sec = rblind.chain(ref, a_tags, tk, pk, TAG, SEC)
    np.testing.assert_array_equal(res.key, ref["key"].numpy())
    np.testing.assert_array_equal(res.ok, ref["ok"].numpy())
    np.testing.assert_array_equal(res.rounds, ref["rounds"].numpy())
    np.testing.assert_array_equal(res.iterations, ref["iterations"].numpy())
    np.testing.assert_array_equal(res.leak_bits, ref["leak"].numpy())
    np.testing.assert_array_equal(out.key, sec["key"].numpy())
    np.testing.assert_array_equal(out.final_bits, sec["final"].numpy())
    np.testing.assert_array_equal(out.verified, sec["verified"].numpy())
    np.testing.assert_array_equal(out.leak_bits, sec["leak"].numpy())
    if case == "hopeless":
        assert not res.ok.any() and (out.final_bits == 0).all()
    else:
        assert res.ok.any() and (res.rounds > 0).any()
    if case == "reveals":  # ragged lengths, and Alice's amplified key on verified frames
        assert len(set(out.final_bits[out.verified].tolist())) > 1
        a_key = toeplitz.hash_bits(alice, pk, out.key.shape[1]).numpy()
        for i in np.flatnonzero(out.verified):
            n = out.final_bits[i]
            np.testing.assert_array_equal(out.key[i, :n], a_key[i, :n])


@pytest.mark.parametrize("algorithm", ["min-sum", "sum-product"])
@pytest.mark.parametrize("case", ["reveals", "capped"])
def test_blind_session_equals_jax_and_the_old_session(code, graph, algorithm, case):
    """The endpoint's session (8 lanes, frames packed into chunks) equals
    ``BlindSession`` (its own endpoint, lanes the block's frames) and the JAX
    package's session on the same QC code: exactly for min-sum; for
    sum-product on keys, flags and rounds."""
    d, step, qbers, max_rounds = CASES[case]
    pl, alice, bob, syn, full = _block(code, graph, d, qbers, seed=23)
    kw = dict(max_iterations=60, algorithm=algorithm, message_dtype="bfloat16")
    rec = _endpoint(code, d, algorithm)
    got = rec.blind_session(bob.numpy(), syn.numpy(), 0.06, reveal_step=step,
                            max_rounds=max_rounds).run(_reveal(full))
    ad = RateAdapter.make(code, n_punctured=d, seed=POS_SEED)
    old = BlindSession(ad, bob.numpy(), syn.numpy(), qber_hint=0.06,
                       opts=DecodeOptions(**kw), reveal_step=step, max_rounds=max_rounds,
                       device=CPU)
    pos = old.begin()
    while pos is not None:
        pos = old.provide(full.numpy()[:, pos])
    jc = jcodes.make_qc_code(z=Z, nb=NB, mb=MB, dv=DV, seed=CODE_SEED)
    js = jblind.BlindSession(JAdapter.make(jc, n_punctured=d, seed=POS_SEED), bob.numpy(),
                             syn.numpy(), qber_hint=0.06, opts=JOpts(**kw), reveal_step=step,
                             max_rounds=max_rounds)
    pos = js.begin()
    while pos is not None:
        pos = js.provide(full.numpy()[:, pos])
    want = js.result()
    fields = want._fields if algorithm == "min-sum" else ("key", "ok", "rounds", "leak_bits")
    for f in fields:
        np.testing.assert_array_equal(getattr(got, f), np.asarray(getattr(want, f)), err_msg=f)
    for f in got._fields:
        np.testing.assert_array_equal(getattr(got, f), getattr(old.result(), f), err_msg=f)
    assert (got.rounds > 0).any() and got.ok.any()


def test_one_program_serves_every_round(code, graph, monkeypatch):
    """One blind program for every round, reveal count and QBER hint: a
    second session at another hint adds none; each round dispatches only the
    frames still going, densely packed (chunks = ceil(live / lanes)); on the
    CPU nothing is captured, and under ``eager_loops()`` the rounds give the
    same results.  ``warmup`` builds no blind program."""
    d, step, qbers, _ = CASES["reveals"]
    _, _, bob, syn, full = _block(code, graph, d, qbers)
    rec = _endpoint(code, d).warmup()
    assert sorted(k[0] for k in rec._runners) == ["serve", "syndrome"]
    calls, captures = [], []
    real_call, real_capture = _ServeProgram.__call__, serve._Runner._capture
    monkeypatch.setattr(_ServeProgram, "__call__", lambda self, *a, **kw: (
        calls.append(self.blind), real_call(self, *a, **kw))[1])
    monkeypatch.setattr(serve._Runner, "_capture", lambda self: (
        captures.append(1), real_capture(self))[1])
    outs = []
    for hint in (0.06, 0.075):
        rec.counters.reset()
        res = rec.blind_session(bob.numpy(), syn.numpy(), hint, reveal_step=step).run(
            _reveal(full))
        outs.append(res)
        live = [int((res.rounds >= r).sum()) for r in range(int(res.rounds.max()) + 1)]
        assert rec.counters.blind_rounds == len(live) > 1
        assert rec.counters.live_frame_rounds == sum(live)
        assert rec.counters.lanes_dispatched == sum(-(-n // 8) * 8 for n in live)
    assert sorted(k[0] for k in rec._runners) == ["blind", "serve", "syndrome"]
    assert set(calls) == {True} and not captures
    assert not device_loop.graphs_on(rec._runners[next(
        k for k in rec._runners if k[0] == "blind")].program.use_kernel, CPU)
    with device_loop.eager_loops():
        again = rec.blind_session(bob.numpy(), syn.numpy(), 0.06, reveal_step=step).run(
            _reveal(full))
    for f in again._fields:
        np.testing.assert_array_equal(getattr(again, f), getattr(outs[0], f), err_msg=f)


@pytest.mark.parametrize("revealed", [0, 16, 40, 64])
def test_the_blind_layout_pins_the_first_revealed_positions(code, graph, revealed):
    """One chunk of the blind program at reveal count ``revealed``, 6 valid
    lanes of 8 (the last two rows stale): the valid lanes equal ``decode`` of
    the LLRs built by hand (the channel's at the payload, Alice's bit pinned
    at the first ``revealed`` punctured positions, 0 past them); the pad
    lanes decode zeros and converge."""
    from qkd_ldpc_tpu_torch.decoder import decode
    from qkd_ldpc_tpu_torch.decoder.rate_adapt import pinned_llr

    d = 64
    pl, _, bob, syn, full = _block(code, graph, d, (0.09,), frames=8, seed=5)
    ad = RateAdapter.make(code, n_punctured=d, seed=POS_SEED)
    opts = DecodeOptions(message_dtype="bfloat16", max_iterations=40)
    prog = _ServeProgram(code, opts, 8, RateFamily.single(ad), 0, CPU, blind=True)
    inp = torch.zeros(prog.inputs.nbytes, dtype=torch.uint8)
    out = torch.zeros(prog.outputs.nbytes, dtype=torch.uint8)
    header, b, s, a = prog.inputs.views(inp.numpy())
    header[:] = chunk_header(0.07, 6, 0, revealed)
    b[:], s[:] = bob.numpy(), syn.numpy()
    a[:] = full.numpy()[:, ad.punct_idx]
    prog(inp, out)
    it, ok, bits = (x.copy() for x in prog.outputs.views(out.numpy()))
    llr = ad.llr(bob[:6], 0.07)
    shown = torch.as_tensor(ad.punct_idx[:revealed])
    llr[:, shown] = pinned_llr(full[:6, shown])
    want = decode(code, llr, syn[:6], opts, device=CPU)
    np.testing.assert_array_equal(bits[:6], want.bits[:, ad.key_idx].numpy())
    np.testing.assert_array_equal(it[:6], want.iterations.numpy())
    np.testing.assert_array_equal(ok[:6], want.syndromes_match.numpy())
    assert ok[6:].all() and not bits[6:].any()
    if revealed == d:  # every punctured bit known: the frames at QBER 0.09 decode
        assert ok[:6].all()


def test_reveals_counters_and_the_callers_rows(code, graph):
    """Alice is asked only for the frames still going; ``provide`` takes
    their rows or every frame's, with one result; the counters: frames by
    finishing round, bits revealed, frame-iterations, verified frames and
    final key bits."""
    d, step, qbers, _ = CASES["reveals"]
    pl, alice, bob, syn, full = _block(code, graph, d, qbers, seed=31)
    rec = _endpoint(code, d)
    asked = []

    def reveal(positions, rows):
        asked.append(rows.copy())
        return full.numpy()[np.ix_(rows, positions)]

    res = rec.blind_session(bob.numpy(), syn.numpy(), 0.06, reveal_step=step).run(reveal)
    for r, rows in enumerate(asked):  # before round r + 1: the frames not verified by r
        np.testing.assert_array_equal(rows, np.flatnonzero(~(res.ok & (res.rounds <= r))))
    c = rec.counters
    assert c.frames == 20 and c.frames_by_round == {
        r: int(n) for r, n in enumerate(np.bincount(res.rounds)) if n}
    assert c.bits_revealed == int(np.minimum(res.rounds * step, d).sum())
    assert c.frame_iterations >= int(res.iterations.sum())
    s = rec.blind_session(bob.numpy(), syn.numpy(), 0.06, reveal_step=step)
    pos = s.begin()
    while pos is not None:  # every frame's rows this time
        pos = s.provide(full.numpy()[:, pos])
    for f in res._fields:
        np.testing.assert_array_equal(getattr(s.result(), f), getattr(res, f), err_msg=f)
    tk, pk = threefry.fold_in(threefry.key(9), 1), threefry.fold_in(threefry.key(9), 2)
    c.reset()
    out = s.finalize(toeplitz.hash_bits(alice, tk, TAG).numpy(), tk, pk)
    assert c.frames_verified == int(out.verified.sum()) > 0
    assert c.final_key_bits == int(out.final_bits.sum())


def test_blind_arguments_are_checked(code, graph):
    d, step, qbers, _ = CASES["reveals"]
    _, _, bob, syn, full = _block(code, graph, d, qbers)
    rec = _endpoint(code, d)
    s = rec.blind_session(bob.numpy(), syn.numpy(), 0.06, reveal_step=step)
    pos = s.begin()
    with pytest.raises(ValueError, match="live frames"):
        s.provide(full.numpy()[:3, pos])
    with pytest.raises(RuntimeError):
        s.begin()
    with pytest.raises(RuntimeError, match="pending"):
        s.result()
    with pytest.raises(ValueError, match="all-punctured adapter"):
        Reconciler(code, lanes=8, device=CPU).blind_session(bob.numpy(), syn.numpy())
    fam = RateFamily.make(code, d=64, seed=POS_SEED, grid=16)
    with pytest.raises(ValueError, match="all-punctured adapter"):
        Reconciler(code, lanes=8, rates=fam, device=CPU).blind_session(bob.numpy(),
                                                                        syn.numpy())
    with pytest.raises(ValueError, match="qber"):
        rec.blind_session(bob.numpy(), syn.numpy(), 1.5)
    with pytest.raises(ValueError, match="syndromes"):
        rec.blind_session(bob.numpy(), syn.numpy()[:, :-1])


def test_reconcile_blind_secure_is_the_session_and_finalize(code, graph):
    """The one-call chain equals ``blind_session`` + ``run`` + ``finalize`` and
    the JAX package's ``finalize`` on the same frames (min-sum)."""
    d, step, qbers, _ = CASES["reveals"]
    pl, alice, bob, syn, full = _block(code, graph, d, qbers, seed=41)
    rec = _endpoint(code, d, "min-sum")
    tag_key, pa_key = jax.random.PRNGKey(100), jax.random.PRNGKey(200)
    from qkd_ldpc_tpu import postprocess as jpp

    a_tags = np.array(jpp.verification_tags(alice.numpy(), tag_key, TAG))
    got = rec.reconcile_blind_secure(bob.numpy(), syn.numpy(), 0.06, a_tags, tkey(tag_key),
                                     tkey(pa_key), _reveal(full), reveal_step=step)
    s = rec.blind_session(bob.numpy(), syn.numpy(), 0.06, reveal_step=step)
    s.run(_reveal(full))
    again = s.finalize(a_tags, tkey(tag_key), tkey(pa_key))
    jc = jcodes.make_qc_code(z=Z, nb=NB, mb=MB, dv=DV, seed=CODE_SEED)
    js = jblind.BlindSession(JAdapter.make(jc, n_punctured=d, seed=POS_SEED), bob.numpy(),
                             syn.numpy(), qber_hint=0.06,
                             opts=JOpts(max_iterations=60, algorithm="min-sum",
                                        message_dtype="bfloat16"),
                             reveal_step=step)
    pos = js.begin()
    while pos is not None:
        pos = js.provide(full.numpy()[:, pos])
    want = js.finalize(a_tags, tag_key, pa_key)
    for f in want._fields:
        np.testing.assert_array_equal(getattr(got, f), np.asarray(getattr(want, f)),
                                      err_msg=f)
        np.testing.assert_array_equal(getattr(got, f), getattr(again, f), err_msg=f)
    assert got.verified.any() and len(set(got.final_bits[got.verified].tolist())) > 1
