"""The port's QC node-sharded decoder (``parallel/qc_node_sharded.py``),
flooding and layered, against the JAX package's ``decode_qc_node_sharded``
and the port's single-device decoder.

The same frames (made with numpy from a seed: a-priori LLRs and target
syndromes) go to both packages.  The JAX package runs on its 8-device
virtual CPU mesh (tests/conftest.py), the port on ``[torch.device("cpu")] *
8``.  Min-sum must equal both bit for bit on any mesh, ``min_sum_beta``
included; sum-product (its cross-shard product groups differently from the
single-device prefix/suffix products, and ``tanh``/``log1p`` round
differently in the two packages) is held on decisions and iterations.
Counterparts of tests/test_qc_node_sharded.py, plus the plan field for
field and the layered offset min-sum that the JAX tests leave out.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from qkd_ldpc_tpu import codes as jcodes
from qkd_ldpc_tpu.decoder import DecodeOptions as JaxDecodeOptions
from qkd_ldpc_tpu.decoder import decode as j_decode
from qkd_ldpc_tpu.parallel import decode_qc_node_sharded as j_decode_qc_node_sharded
from qkd_ldpc_tpu.parallel import make_mesh as j_make_mesh
from qkd_ldpc_tpu.parallel import run_point_node_sharded as j_run_point_node_sharded
from qkd_ldpc_tpu.parallel.qc_node_sharded import build_qc_shard_plan as j_build_qc_shard_plan
from qkd_ldpc_tpu_torch import codes as tcodes
from qkd_ldpc_tpu_torch.channel.threefry import fold_in, prng_key
from qkd_ldpc_tpu_torch.decoder.bp import DecodeOptions, decode
from qkd_ldpc_tpu_torch.parallel import (
    QCShardPlan,
    bp_decode_qc_node_sharded,
    build_qc_shard_plan,
    decode_node_sharded,
    decode_qc_node_sharded,
    make_mesh,
    run_point_node_sharded,
)
from qkd_ldpc_tpu_torch.sim import run_point
from tests._torch_port_common import assert_equal, assert_sp_close, decode_frames

torch.set_num_threads(1)
CPU = torch.device("cpu")
SPECS = {
    # N=128, M=64: nb divides every tested shard count (2, 4, 8)
    "qc": dict(z=16, nb=8, mb=4, dv=3, seed=3),
    # nb=6 over 4 shards: nb_s=2 pads two edgeless dummy blocks
    "padded": dict(z=16, nb=6, mb=3, dv=2, seed=1),
}
_codes = {}


def pair(which):
    if which not in _codes:
        spec = SPECS.get(which, {})
        if which == "medium":
            med = dict(n=512, m=262, dv=3, seed=7)
            _codes[which] = (jcodes.make_code(**med), tcodes.make_code(**med))
        else:
            _codes[which] = (jcodes.make_qc_code(**spec), tcodes.make_qc_code(**spec))
    return _codes[which]


def jopts(opts):
    return JaxDecodeOptions(**{f.name: getattr(opts, f.name)
                               for f in dataclasses.fields(opts)})


def host(r):
    return tuple(np.asarray(x) for x in r)


def run_all(which, llr, syn, opts, n_trial, n_node, single_opts=None):
    """(port single-device, port QC node-sharded, JAX QC node-sharded, JAX
    single-device) results as numpy (bits, iterations, syndromes_match)."""
    jc, tc = pair(which)
    single_opts = single_opts or opts
    ref = decode(tc, torch.from_numpy(llr), torch.from_numpy(syn), single_opts, device="cpu")
    out = decode_qc_node_sharded(tc, torch.from_numpy(llr), torch.from_numpy(syn), opts,
                                 make_mesh(n_trial, n_node, devices=[CPU] * 8))
    jout = j_decode_qc_node_sharded(jc, llr, syn, jopts(opts), j_make_mesh(n_trial, n_node))
    jref = j_decode(jc, llr, syn, jopts(single_opts))
    return host(ref), host(out), host(jout), host(jref)


def frames(which, n_err=5, batch=16, seed=5):
    return decode_frames(pair(which)[1], n_err, batch, seed)


# ---------------------------------------------------------------------------
# The shard plan


@pytest.mark.parametrize("which", ["qc", "padded"])
@pytest.mark.parametrize("n_node", [1, 2, 3, 4, 8])
def test_plan_equals_jax_field_for_field(which, n_node):
    jc, tc = pair(which)
    jp, tp = j_build_qc_shard_plan(jc.qc, n_node), build_qc_shard_plan(tc.qc, n_node)
    assert isinstance(tp, QCShardPlan)
    for f in dataclasses.fields(tp):
        a, b = getattr(jp, f.name), getattr(tp, f.name)
        if isinstance(b, np.ndarray):
            assert b.dtype == np.int32 and a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name
    assert tp.nb_s == -(-tp.nb // n_node) and tp.dv == tc.dv_max


# ---------------------------------------------------------------------------
# Flooding


@pytest.mark.parametrize("n_node", [2, 4, 8])
def test_qc_node_sharded_matches_single_device(n_node):
    """8 flips a frame: 15 of 16 frames converge, one fails at the cap."""
    ref, out, jout, jref = run_all("qc", *frames("qc", 8), DecodeOptions(max_iterations=60),
                                   8 // n_node, n_node)
    assert_equal(out, ref)
    assert_sp_close(out, jout, frames=0, shift=0)
    assert ref[2].any() and not ref[2].all()


def test_qc_node_sharded_block_padding():
    ref, out, jout, _ = run_all("padded", *frames("padded", 4, 8, 2),
                                DecodeOptions(max_iterations=40), 2, 4)
    assert_equal(out, ref)
    assert_sp_close(out, jout, frames=0, shift=0)


@pytest.mark.parametrize("n_node", [2, 8])
def test_qc_node_sharded_min_sum_bit_exact(n_node):
    ref, out, jout, jref = run_all("qc", *frames("qc"),
                                   DecodeOptions(algorithm="min-sum", max_iterations=60),
                                   8 // n_node, n_node)
    assert_equal(out, ref)
    assert_equal(out, jout)
    assert_equal(jout, jref)
    assert ref[2].any()


def test_qc_node_sharded_min_sum_forced_tie():
    """LLRs quantized to multiples of 0.25: equal |Lq| inside check rows, so
    the global-slot tie rule decides across shards."""
    llr, syn = frames("qc", 6, 8, 11)
    llr = (np.round(llr * 4.0) / 4.0).astype(np.float32)
    ref, out, jout, _ = run_all("qc", llr, syn,
                                DecodeOptions(algorithm="min-sum", max_iterations=30), 1, 8)
    assert_equal(out, ref)
    assert_equal(out, jout)


@pytest.mark.parametrize("algorithm", ["sum-product", "min-sum"])
@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_qc_node_sharded_quantized_messages(algorithm, dtype):
    ref, out, jout, _ = run_all(
        "qc", *frames("qc"),
        DecodeOptions(algorithm=algorithm, max_iterations=60, message_dtype=dtype), 2, 4)
    assert_equal(out, ref)
    if algorithm == "min-sum":
        assert_equal(out, jout)
    else:
        assert_sp_close(out, jout, frames=0, shift=0)


def test_qc_node_sharded_requires_qc():
    jc, tc = pair("medium")
    llr, syn = decode_frames(tc, 10, 4, 0)
    opts = DecodeOptions(max_iterations=5)
    with pytest.raises(ValueError) as te:
        decode_qc_node_sharded(tc, torch.from_numpy(llr), torch.from_numpy(syn), opts,
                               make_mesh(1, 8, devices=[CPU] * 8))
    with pytest.raises(ValueError) as je:
        j_decode_qc_node_sharded(jc, llr, syn, jopts(opts), j_make_mesh(1, 8))
    assert str(te.value) == str(je.value) == "QC node-sharding requires a QC code (codes.qc)"
    with pytest.raises(ValueError, match="requires a QC code"):
        run_point_node_sharded(tc, prng_key(1), 0.03, 8, 8,
                               DecodeOptions(max_iterations=5, routing="roll"),
                               make_mesh(4, 2, devices=[CPU] * 8))


def test_general_node_sharded_rejects_layered_schedule():
    _, tc = pair("medium")
    llr, syn = decode_frames(tc, 10, 4, 0)
    with pytest.raises(ValueError, match="flooding schedule only"):
        decode_node_sharded(tc, torch.from_numpy(llr), torch.from_numpy(syn),
                            DecodeOptions(max_iterations=5, schedule="layered"),
                            make_mesh(1, 8, devices=[CPU] * 8))


# ---------------------------------------------------------------------------
# Layered


@pytest.mark.parametrize("n_node", [2, 4, 8])
def test_qc_node_sharded_layered_matches_single_device(n_node):
    ref, out, jout, jref = run_all(
        "qc", *frames("qc"), DecodeOptions(max_iterations=60, schedule="layered"),
        8 // n_node, n_node)
    assert_equal(out, ref)
    assert_sp_close(out, jout, frames=0, shift=0)
    assert ref[2].any()


@pytest.mark.parametrize("n_node", [2, 8])
def test_qc_node_sharded_layered_min_sum_bit_exact(n_node):
    ref, out, jout, jref = run_all(
        "qc", *frames("qc"),
        DecodeOptions(algorithm="min-sum", max_iterations=60, schedule="layered"),
        8 // n_node, n_node)
    assert_equal(out, ref)
    assert_equal(out, jout)
    assert_equal(jout, jref)
    assert ref[2].any()


def test_qc_node_sharded_layered_block_padding():
    ref, out, jout, _ = run_all("padded", *frames("padded", 4, 8, 2),
                                DecodeOptions(max_iterations=40, schedule="layered"), 2, 4)
    assert_equal(out, ref)
    assert_sp_close(out, jout, frames=0, shift=0)


@pytest.mark.parametrize("algorithm", ["sum-product", "min-sum"])
@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_qc_node_sharded_layered_quantized(algorithm, dtype):
    ref, out, jout, _ = run_all(
        "qc", *frames("qc"),
        DecodeOptions(algorithm=algorithm, max_iterations=60, message_dtype=dtype,
                      schedule="layered"), 2, 4)
    assert_equal(out, ref)
    if algorithm == "min-sum":
        assert_equal(out, jout)
    else:
        assert_sp_close(out, jout, frames=0, shift=0)


@pytest.mark.parametrize("beta", [0.15, 0.5])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_node", [2, 4, 8])
def test_layered_offset_min_sum_equals_single_device_in_both_packages(beta, dtype, n_node):
    """Layered offset min-sum on the shard plan (``beta`` applied after the
    cross-shard merge, JAX qc_node_sharded.py:586), which the JAX package's
    own tests leave out: JAX's sharded decoder equals its single-device one,
    and the port equals both, bit for bit."""
    opts = DecodeOptions(algorithm="min-sum", min_sum_beta=beta, max_iterations=40,
                         message_dtype=dtype, schedule="layered")
    ref, out, jout, jref = run_all("qc", *frames("qc", 6, 16, 9), opts, 8 // n_node, n_node)
    assert_equal(jout, jref)
    assert_equal(out, jout)
    assert_equal(out, ref)
    assert ref[2].any()


def test_qc_sweep_point_layered_node_sharded():
    """``run_point_node_sharded`` on the layered schedule: min-sum partials
    equal the single-device runner's and the JAX package's, 7/7."""
    jc, tc = pair("qc")
    opts = DecodeOptions(algorithm="min-sum", max_iterations=50, schedule="layered")
    p1, q1 = run_point(tc, fold_in(prng_key(777), 3), 0.04, 32, 32, opts, device="cpu")
    p2, q2 = run_point_node_sharded(tc, fold_in(prng_key(777), 3), 0.04, 32, 32, opts,
                                    make_mesh(2, 4, devices=[CPU] * 8))
    pj, qj = j_run_point_node_sharded(
        jc, jax.random.fold_in(jax.random.PRNGKey(777), 3), 0.04, trials=32, batch=32,
        opts=jopts(opts), mesh=j_make_mesh(2, 4))
    assert q1 == q2 == qj and p2.n_trials == 32
    assert dataclasses.astuple(p2) == dataclasses.astuple(p1) == dataclasses.astuple(pj)


def test_qc_node_sharded_roll_parity():
    """The sharded decoder (routing "auto") agrees with the single device
    under routing "roll" too.  Frame 1 fails at the cap of 40 in both
    packages; their sum-product decisions there differ in two bits (the
    single-device decoders already do: ROADMAP C), so against JAX the bits
    are held on the converged frames."""
    ref, out, _, jref = run_all("qc", *frames("qc", 5, 8, 7), DecodeOptions(max_iterations=40),
                                2, 4, single_opts=DecodeOptions(max_iterations=40,
                                                                routing="roll"))
    assert_equal(out, ref)
    np.testing.assert_array_equal(out[1], jref[1])
    np.testing.assert_array_equal(out[2], jref[2])
    np.testing.assert_array_equal(out[0][out[2]], jref[0][out[2]])
    assert list(np.nonzero(~out[2])[0]) == [1]


def test_qc_sweep_point_dispatches_to_the_qc_decoder(monkeypatch):
    """A QC code under routing "auto" takes the QC decoder (the general one
    patched to raise), and its min-sum partials equal the single-device
    runner's and the JAX package's."""
    from qkd_ldpc_tpu_torch.parallel import node_sharded

    def boom(*a, **k):
        raise AssertionError("general node-sharded decoder used for a QC code")

    monkeypatch.setattr(node_sharded, "_decode_row", boom)
    jc, tc = pair("qc")
    opts = DecodeOptions(algorithm="min-sum", max_iterations=50)
    p1, q1 = run_point(tc, fold_in(prng_key(777), 3), 0.04, 32, 32, opts, device="cpu")
    p2, q2 = run_point_node_sharded(tc, fold_in(prng_key(777), 3), 0.04, 32, 32, opts,
                                    make_mesh(2, 4, devices=[CPU] * 8))
    pj, qj = j_run_point_node_sharded(
        jc, jax.random.fold_in(jax.random.PRNGKey(777), 3), 0.04, trials=32, batch=32,
        opts=jopts(opts), mesh=j_make_mesh(2, 4))
    assert q1 == q2 == qj and p2.n_trials == 32 and p2.n_sp > 0
    assert dataclasses.astuple(p2) == dataclasses.astuple(p1) == dataclasses.astuple(pj)


def test_qc_node_sharded_odd_batch_pads():
    """B = 17 on a trial axis of 4: inert frames pad the batch and are sliced
    off; a single frame comes back unbatched."""
    ref, out, jout, _ = run_all("qc", *frames("qc", 5, 17, 11),
                                DecodeOptions(max_iterations=40), 4, 2)
    assert out[0].shape == (17, 128)
    assert_equal(out, ref)
    assert_sp_close(out, jout, frames=0, shift=0)
    _, tc = pair("qc")
    llr, syn = frames("qc", 5, 1, 11)
    one = decode_qc_node_sharded(tc, torch.from_numpy(llr[0]), torch.from_numpy(syn[0]),
                                 DecodeOptions(max_iterations=40),
                                 make_mesh(4, 2, devices=[CPU] * 8))
    assert one.bits.shape == (128,) and one.iterations.ndim == 0


def test_bp_decode_is_batch_last_on_the_llr_device():
    _, tc = pair("qc")
    llr, syn = frames("qc", 5, 8, 3)
    z, iters, ok = bp_decode_qc_node_sharded(
        tc, torch.from_numpy(llr).T, torch.from_numpy(syn).T,
        DecodeOptions(max_iterations=40, algorithm="min-sum"),
        make_mesh(2, 4, devices=[CPU] * 8))
    ref = decode(tc, torch.from_numpy(llr), torch.from_numpy(syn),
                 DecodeOptions(max_iterations=40, algorithm="min-sum"), device="cpu")
    assert z.shape == (128, 8) and z.dtype == torch.int8 and iters.dtype == torch.int32
    assert torch.equal(z.T, ref.bits) and torch.equal(iters, ref.iterations)
    assert torch.equal(ok, ref.syndromes_match)
