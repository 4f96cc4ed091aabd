"""The plain reference against the program's CPU path at a tiny size: the
same code graphs, the same threefry stream and trials, and the same decode
statistics and per-frame answers."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench.reference import channel, codes, stats, threefry
from portbench.reference.decode import Decoder, decode
from portbench import harness


def test_threefry_stream_is_the_programs():
    from qkd_ldpc_tpu_torch.channel import threefry as prog

    k = threefry.key(2**31 + 5)
    assert k.tolist() == [0, 2**31 + 5] == prog.prng_key(2**31 + 5).tolist()
    ids = torch.tensor([0, 1, 2**32 - 1], dtype=torch.int64)
    assert torch.equal(threefry.fold_in(k, ids), prog.fold_in(k, ids))
    words = prog.random_bits(threefry.fold_in(k, 3), 64).to(torch.int64) & threefry.M32
    assert torch.equal(threefry.bits(threefry.fold_in(k, 3), 64), words)
    assert threefry.key(2**40 + 7).tolist() == [2**8, 7]


@pytest.mark.parametrize("z", [32, 512])
def test_qc_graph_is_the_programs(z):
    from qkd_ldpc_tpu_torch.codes import make_qc_code

    g = codes.qc_graph(z, 20, 10, 3, 666)
    code = make_qc_code(z=z, nb=20, mb=10, dv=3, seed=666)
    adj, mask = g.dense_adjacency()
    assert np.array_equal(code.chk_adj, adj) and np.array_equal(code.chk_mask, mask)


def test_alist_graph_is_the_programs():
    from qkd_ldpc_tpu_torch.codes import load_code

    path = harness.ROOT / "configs" / "ref_alist_n10240.alist"
    g, code = codes.alist_graph(path), load_code(path)
    adj, mask = g.dense_adjacency()
    assert np.array_equal(np.where(code.chk_mask, code.chk_adj, 0), np.where(mask, adj, 0))
    assert np.array_equal(code.chk_mask, mask)


@pytest.mark.parametrize("name", ["qc_n10240_r05", "ref_alist_n10240"])
def test_configuration_sizes_are_the_graphs(name):
    from portbench import spec

    cfg = spec.config(name)
    g = codes.build(cfg["code"], harness.ROOT / "configs")
    assert (g.n_vars, g.n_checks, g.n_edges) == tuple(
        cfg["code"][k] for k in ("n_vars", "n_checks", "n_edges"))


def test_trials_are_the_programs():
    from qkd_ldpc_tpu_torch.channel.keys import make_trial_batch

    key = threefry.fold_in(threefry.key(99), 4)
    ids = torch.arange(7, 7 + 16, dtype=torch.int64)
    alice, bob = channel.trials(key, ids, 640, 40)
    pa, pb = make_trial_batch(key, 640, 16, 40, trial_offset=7, device="cpu")
    assert torch.equal(alice, pa) and torch.equal(bob, pb)
    assert ((alice ^ bob).sum(dim=1) == 40).all()


def test_tied_scores_rank_by_tie_word_then_position():
    scores = torch.tensor([[5, 1, 5, 5, 9, 5]], dtype=torch.int64)
    ties = torch.tensor([[0, 0, 7, 3, 0, 3]], dtype=torch.int64)
    flips = channel.exact_weight_flips(scores, 3, lambda rows: ties[rows])
    # 1 is below; of the 5s (positions 0, 2, 3, 5; tie words 0, 7, 3, 3) take 0 and 3
    assert flips.tolist() == [[True, True, False, True, False, False]]


@pytest.mark.parametrize("storage", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("qber", [0.05, 0.08])
def test_point_statistics_are_the_programs(storage, qber):
    from qkd_ldpc_tpu_torch.codes import make_qc_code
    from qkd_ldpc_tpu_torch.decoder.bp import DecodeOptions
    from qkd_ldpc_tpu_torch.sim.runner import run_point

    code = make_qc_code(z=32, nb=20, mb=10, dv=3, seed=666)
    g = codes.on_device(codes.qc_graph(32, 20, 10, 3, 666), "cpu")
    key = threefry.fold_in(threefry.key(2**31 + 12345), 3)
    opts = DecodeOptions(message_dtype=storage, compact_after=8, compact_lanes=32)
    P, _ = run_point(code, key, qber, 200, 128, opts, device="cpu")
    ref = stats.point(Decoder(storage=storage), g, key, channel.num_errors(640, qber), 200,
                      width=64)
    assert {k: getattr(P, k) for k in stats.KEYS} == ref


def test_served_frames_are_the_programs():
    from qkd_ldpc_tpu_torch.codes import make_qc_code
    from qkd_ldpc_tpu_torch.decoder.bp import DecodeOptions
    from qkd_ldpc_tpu_torch.serve import Reconciler

    code = make_qc_code(z=32, nb=20, mb=10, dv=3, seed=666)
    g = codes.on_device(codes.qc_graph(32, 20, 10, 3, 666), "cpu")
    gen = torch.Generator().manual_seed(3)
    alice = torch.randint(0, 2, (40, 640), generator=gen, dtype=torch.uint8)
    flips = torch.zeros_like(alice).scatter_(
        1, torch.rand((40, 640), generator=gen).argsort(dim=1)[:, :58], 1)
    bob, syn = alice ^ flips, channel.syndromes(g, alice).to(torch.uint8)
    q = 58 / 640
    out = Reconciler(code, DecodeOptions(message_dtype="bfloat16"), lanes=16,
                     device="cpu").reconcile(bob.numpy(), syn.numpy(), q)
    mag = channel.llr_magnitude(np.float32(q))
    z, iters, ok = decode(Decoder(), g, torch.where(bob == 1, -mag, mag).float(), syn)
    assert np.array_equal(out.bits, z.numpy())
    assert np.array_equal(out.iterations, iters.numpy())
    assert np.array_equal(out.syndromes_match, ok.numpy())
    assert not ok.all() and ok.any()
