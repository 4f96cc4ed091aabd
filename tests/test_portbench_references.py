"""The port against the benchmark's new plain references
(``portbench/reference/``: ``rate_adapt.py``, ``toeplitz.py``,
``layered.py``), which import nothing of the port: the adapted frames and
LLRs, the Toeplitz hash, the layered decode and the whole secure chain on
seeded keys, each equal bit for bit on the CPU."""

import numpy as np
import pytest
import torch

from portbench.reference import channel, codes, layered, rate_adapt, threefry, toeplitz
from portbench.reference.decode import Decoder, decode
from qkd_ldpc_tpu_torch.codes import make_qc_code
from qkd_ldpc_tpu_torch.decoder import DecodeOptions, RateFamily
from qkd_ldpc_tpu_torch.decoder.layered import layered_decode_batch_last
from qkd_ldpc_tpu_torch.postprocess import toeplitz_hash
from qkd_ldpc_tpu_torch.serve import Reconciler
from qkd_ldpc_tpu_torch.sim.runner import run_point

torch.set_num_threads(1)
CPU = torch.device("cpu")
Z, NB, MB, DV, CODE_SEED = 32, 20, 10, 3, 666
D, GRID, SEED, SHARED = 64, 16, 3, 7


@pytest.fixture(scope="module")
def code():
    return make_qc_code(z=Z, nb=NB, mb=MB, dv=DV, seed=CODE_SEED)


@pytest.fixture(scope="module")
def graph():
    g = codes.qc_graph(Z, NB, MB, DV, CODE_SEED)
    return g, codes.on_device(g, CPU)


@pytest.fixture(scope="module")
def family(code):
    return RateFamily.make(code, d=D, seed=SEED, grid=GRID)


def _payloads(n, l, k, seed):
    gen = torch.Generator().manual_seed(seed)
    alice = torch.randint(0, 2, (n, l), generator=gen, dtype=torch.uint8)
    pos = torch.rand((n, l), generator=gen).argsort(dim=1)[:, :k]
    flips = torch.zeros((n, l), dtype=torch.uint8).scatter_(1, pos, 1)
    return alice, alice ^ flips


@pytest.mark.parametrize("step", range(D // GRID + 1))
def test_adapted_frames_and_llrs_equal_the_reference(code, family, step):
    m = family.member(step)
    pl = rate_adapt.plan(code.n_vars, code.n_checks, D, step * GRID, SEED)
    for f in ("key_idx", "punct_idx", "short_idx"):
        np.testing.assert_array_equal(getattr(m, f), getattr(pl, f))
    assert m.leak_bits == pl.leak
    alice, bob = _payloads(12, m.payload_bits, 30, step)
    fk = threefry.fold_in(threefry.key(2**33 + 5), step)  # a key past 32 bits
    np.testing.assert_array_equal(m.build_frames(alice, fk, SHARED).numpy(),
                                  rate_adapt.frames(pl, alice, fk, SHARED).numpy())
    q = 30 / m.payload_bits
    want = rate_adapt.llr(pl, bob, channel.llr_magnitude(np.float32(q)), SHARED)
    np.testing.assert_array_equal(m.llr(bob, q, SHARED).numpy(), want.numpy())
    # the rate-agile program's template row is the reference's too
    mod_idx, templates = family.pin_templates(SHARED, CPU)
    np.testing.assert_array_equal(templates[step].numpy(), want[0, mod_idx].numpy())


@pytest.mark.parametrize("n_in,n_out,frames", [(576, 64, 7), (576, 300, 5), (37, 90, 3)])
@pytest.mark.parametrize("method", ["dense", "blocked", "blocked-diag"])
def test_toeplitz_hash_equals_the_reference(n_in, n_out, frames, method):
    gen = torch.Generator().manual_seed(n_in + n_out)
    bits = torch.randint(0, 2, (frames, n_in), generator=gen, dtype=torch.uint8)
    key = threefry.fold_in(threefry.key(99), n_out)
    got = toeplitz_hash(bits, key, n_out, block_out=64, method=method, device=CPU)
    np.testing.assert_array_equal(got.numpy(), toeplitz.hash_bits(bits, key, n_out).numpy())
    # T[i, j] = s[i - j + n - 1] by index arithmetic
    T = toeplitz.matrix(key, n_in, n_out, CPU)
    s = (threefry.bits(key, n_in + n_out - 1) < 2**31).to(torch.float32)
    assert T[0, n_in - 1] == s[0] and T[n_out - 1, 0] == s[n_in + n_out - 2]


@pytest.mark.parametrize("storage", ["float32", "bfloat16", "int8"])
def test_layered_decode_equals_the_reference_per_lane(code, graph, storage):
    g, gd = graph
    key = threefry.fold_in(threefry.key(4321), 7)
    n_err = channel.num_errors(g.n_vars, 0.075)
    alice, bob = channel.trials(key, torch.arange(48), g.n_vars, n_err)
    mag = channel.trial_magnitude(n_err, g.n_vars)
    llr = torch.where(bob == 1, -mag, mag).to(torch.float32)
    syn = channel.syndromes(gd, alice)
    opts = DecodeOptions(message_dtype=storage, schedule="layered", max_iterations=40)
    z, iters, ok = layered_decode_batch_last(code, llr.T.contiguous(), syn.T.contiguous(),
                                             opts)
    rz, riters, rok = layered.decode(Decoder(max_iterations=40, storage=storage),
                                     layered.Layers(g, Z, CPU), gd, llr, syn)
    np.testing.assert_array_equal(z.T.to(torch.uint8).numpy(), rz.numpy())
    np.testing.assert_array_equal(iters.numpy(), riters.numpy())
    np.testing.assert_array_equal(ok.numpy(), rok.numpy())
    assert 0 < int(rok.sum()) < 48  # both converged and failed frames


def test_layered_point_equals_run_point_with_compaction(code, graph):
    g, gd = graph
    key = threefry.fold_in(threefry.key(2**31 + 17), 2)
    opts = DecodeOptions(message_dtype="bfloat16", schedule="layered", compact_after=4,
                         compact_lanes=16)
    P, _ = run_point(code, key, 0.07, 160, 64, opts, device=CPU)
    ref = layered.point(Decoder(storage="bfloat16"), layered.Layers(g, Z, CPU), gd, key,
                        channel.num_errors(g.n_vars, 0.07), 160)
    assert {k: int(getattr(P, k)) for k in ref} == ref


def test_secure_chain_equals_the_reference(code, graph, family):
    """Alice's side by the reference, Bob's by the rate-agile endpoint: every
    frame's key row, verified flag, leak, final length, iterations and flag
    equal the reference chain's, at each step of the family."""
    g, gd = graph
    rec = Reconciler(code, DecodeOptions(message_dtype="bfloat16"), lanes=8, rates=family,
                     shared_seed=SHARED, device="cpu")
    dec = Decoder(storage="bfloat16")
    l, tag, sec = family.payload_bits, 64, 100
    for step in range(family.steps):
        pl = rate_adapt.plan(code.n_vars, code.n_checks, D, step * GRID, SEED)
        alice, bob = _payloads(16, l, 36, 50 + step)
        unit = threefry.fold_in(threefry.key(3**20), step)
        fk, tk, pk = (threefry.fold_in(unit, j) for j in range(3))
        syn = channel.syndromes(gd, rate_adapt.frames(pl, alice, fk, SHARED))
        a_tags = toeplitz.hash_bits(alice, tk, tag)
        q = 36 / l
        out = rec.reconcile_secure(bob.numpy(), syn.numpy(), q, a_tags.numpy(), tk, pk,
                                   rate=step)
        llr = rate_adapt.llr(pl, bob, channel.llr_magnitude(np.float32(q)), SHARED)
        z, iters, ok = decode(dec, gd, llr, syn)
        payload = z[:, torch.as_tensor(pl.key_idx)]
        verified = ok & (toeplitz.hash_bits(payload, tk, tag) == a_tags).all(dim=1)
        final = l - pl.leak - tag - sec
        assert out.final_bits == final
        np.testing.assert_array_equal(out.key, toeplitz.hash_bits(payload, pk, final).numpy())
        np.testing.assert_array_equal(out.verified, verified.numpy())
        np.testing.assert_array_equal(out.leak_bits, np.full(16, pl.leak + tag))
        np.testing.assert_array_equal(out.iterations, iters.numpy())
        np.testing.assert_array_equal(out.syndromes_match, ok.numpy())


def test_the_secure_chains_yardstick_arithmetic():
    """``arith_secure``: a hash's bytes, and device time inside spans."""
    from portbench import arith_secure

    assert arith_secure.toeplitz_bytes(512, 9216, 4444) == 512 * 9216 + 13659 + 512 * 4444
    ivals = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (5.0, 6.0)]
    spans = [(1.5, 3.5), (3.2, 3.4), (5.5, 9.0)]
    assert arith_secure.busy_inside(ivals, spans, 0.0, 5.8) == pytest.approx(0.5 + 0.5 + 0.3)
    assert arith_secure.busy_inside(ivals, [], 0.0, 9.0) == 0.0

    class Trace:
        device = [(0.0, 1.0, "void check_update_kernel<0>"), (1.0, 2.0, "Memcpy HtoD"),
                  (2.0, 3.0, "void variable_update_kernel<8>"), (3.0, 4.0, "sgemm")]

    assert arith_secure.kernel_intervals(Trace, "check_update", "variable_update") == [
        (0.0, 1.0), (2.0, 3.0)]
    assert len(arith_secure.kernel_intervals(Trace)) == 3  # every kernel, no copy
