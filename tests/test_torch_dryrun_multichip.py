"""The legs of ``__graft_entry__.py::dryrun_multichip`` on the port, over an
8-shard CPU mesh: sharded results must equal the unsharded ones.

- (1) the sweep step sharded over the trial axis == ``run_point``, 7/7;
- (2) the node-sharded decode on a (4 x 2) mesh == ``decode`` (decisions
  and iterations), and the sweep step on that mesh == ``run_point``;
- (3) node-sharded min-sum/bf16 == ``decode`` bit for bit;
- (4) a QC code under ``routing="roll"`` on the trial mesh == ``"gather"`` ==
  unsharded, 7/7;
- (4b) the QC node-sharded decoder on the (4 x 2) mesh == ``decode`` (bits
  and iterations), sum-product and min-sum/bf16;
- (4c) the layered schedule with compaction on the trial mesh == unsharded;
- (4d) the QC node-sharded decoder, layered, on the (4 x 2) mesh == the
  single-device layered ``decode``, sum-product and min-sum/bf16;
- (5) the cross-point continuation on the trial mesh == the plain sharded
  runner at two waterfall points.
"""

import dataclasses

import numpy as np
import pytest
import torch

from qkd_ldpc_tpu_torch.channel.keys import make_trial_batch, num_errors_for
from qkd_ldpc_tpu_torch.channel.threefry import fold_in, prng_key
from qkd_ldpc_tpu_torch.codes import make_code, make_qc_code
from qkd_ldpc_tpu_torch.decoder.bp import DecodeOptions, decode
from qkd_ldpc_tpu_torch.decoder.reconcile import apriori_llr
from qkd_ldpc_tpu_torch.decoder.syndrome import syndrome
from qkd_ldpc_tpu_torch.parallel import (
    decode_node_sharded,
    decode_qc_node_sharded,
    make_mesh,
    make_trial_mesh,
    run_point_node_sharded,
    run_point_sharded,
)
from qkd_ldpc_tpu_torch.sim import dispatch_sweep_continuation, run_point
from qkd_ldpc_tpu_torch.sim.stats import PointPartials, partials_from_stacked

torch.set_num_threads(1)
N_DEVICES = 8
TRIALS = 2 * N_DEVICES
CPU = torch.device("cpu")
_cache = {}


def setup():
    if not _cache:
        code = make_code(n=256, m=131, dv=3, seed=1, name="dryrun-n256")
        opts = DecodeOptions(max_iterations=32)
        key = prng_key(777)
        p_ref, q_ref = run_point(code, key, 0.03, TRIALS, TRIALS, opts, device="cpu")
        _cache.update(
            code=code, opts=opts, key=key, p_ref=p_ref, q_ref=q_ref,
            mesh=make_trial_mesh([CPU] * N_DEVICES),
            mesh2=make_mesh(n_trial=N_DEVICES // 2, n_node=2, devices=[CPU] * N_DEVICES),
            qc=make_qc_code(z=16, nb=16, mb=8, dv=3, seed=4, name="dryrun-qc"),
            roll=DecodeOptions(max_iterations=32, routing="roll", message_dtype="bfloat16"),
            gather=DecodeOptions(max_iterations=32, routing="gather",
                                 message_dtype="bfloat16"),
        )
    return _cache


def frames(code, seed):
    n_err = num_errors_for(code.n_vars, 0.03)
    alice, bob = make_trial_batch(prng_key(seed), code.n_vars, TRIALS, n_err, device="cpu")
    return apriori_llr(bob, np.float32(n_err) / np.float32(code.n_vars)), syndrome(code, alice)


def same_decode(a, b, bits=True):
    assert torch.equal(a.iterations, b.iterations)
    assert torch.equal(a.syndromes_match, b.syndromes_match)
    if bits:
        assert torch.equal(a.bits, b.bits)


def leg_1(c):
    partials, q = run_point_sharded(c["code"], c["key"], 0.03, TRIALS, TRIALS, c["opts"],
                                    c["mesh"])
    assert q == c["q_ref"] and partials == c["p_ref"]
    assert partials.n_trials == TRIALS and partials.n_sp > 0


def leg_2(c):
    llr, syn = frames(c["code"], 1)
    res = decode_node_sharded(c["code"], llr, syn, c["opts"], c["mesh2"])
    same_decode(res, decode(c["code"], llr, syn, c["opts"], device="cpu"))
    p2, q2 = run_point_node_sharded(c["code"], c["key"], 0.03, TRIALS, TRIALS, c["opts"],
                                    c["mesh2"])
    assert q2 == c["q_ref"] and p2 == c["p_ref"]


def leg_3(c):
    llr, syn = frames(c["code"], 1)
    ms = DecodeOptions(max_iterations=32, algorithm="min-sum", message_dtype="bfloat16")
    same_decode(decode_node_sharded(c["code"], llr, syn, ms, c["mesh2"]),
                decode(c["code"], llr, syn, ms, device="cpu"))


def leg_4(c):
    ref, q_ref = run_point(c["qc"], c["key"], 0.03, TRIALS, TRIALS, c["gather"], device="cpu")
    roll, q = run_point_sharded(c["qc"], c["key"], 0.03, TRIALS, TRIALS, c["roll"], c["mesh"])
    gather, _ = run_point_sharded(c["qc"], c["key"], 0.03, TRIALS, TRIALS, c["gather"],
                                  c["mesh"])
    assert q == q_ref and roll == gather == ref and ref.n_sp > 0


def qc_node_legs(c, schedule):
    llr, syn = frames(c["qc"], 2)
    for o in (DecodeOptions(max_iterations=32, schedule=schedule),
              DecodeOptions(max_iterations=32, schedule=schedule, algorithm="min-sum",
                            message_dtype="bfloat16")):
        same_decode(decode_qc_node_sharded(c["qc"], llr, syn, o, c["mesh2"]),
                    decode(c["qc"], llr, syn, o, device="cpu"))


def leg_4b(c):
    qc_node_legs(c, "flooding")


def leg_4d(c):
    qc_node_legs(c, "layered")


def leg_4c(c):
    lay = DecodeOptions(max_iterations=32, schedule="layered", message_dtype="bfloat16",
                        compact_after=2, compact_lanes=2)
    ref, q_ref = run_point(c["qc"], c["key"], 0.03, TRIALS, TRIALS, lay, device="cpu")
    got, q = run_point_sharded(c["qc"], c["key"], 0.03, TRIALS, TRIALS, lay, c["mesh"])
    assert q == q_ref and got == ref


def leg_5(c):
    qbers = [0.03, 0.05]
    keys = [fold_in(c["key"], 10 + i) for i in range(len(qbers))]
    futs, actuals = dispatch_sweep_continuation(c["qc"], keys, qbers, TRIALS, TRIALS,
                                                c["roll"], mesh=c["mesh"])
    for k, q, fut, aq in zip(keys, qbers, futs, actuals):
        plain, q_plain = run_point_sharded(c["qc"], k, q, TRIALS, TRIALS, c["roll"], c["mesh"])
        got = PointPartials().merge(partials_from_stacked(fut[0].fetch()))
        assert aq == q_plain
        assert dataclasses.astuple(got) == dataclasses.astuple(plain), (q, got, plain)


@pytest.mark.parametrize("leg", [leg_1, leg_2, leg_3, leg_4, leg_4b, leg_4c, leg_4d, leg_5],
                         ids=["1", "2", "3", "4", "4b", "4c", "4d", "5"])
def test_dryrun_multichip_leg(leg):
    leg(setup())
