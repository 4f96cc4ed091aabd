"""The port's general node-sharded decoder (``parallel/node_sharded.py``)
against the JAX package's ``decode_node_sharded`` and the port's
single-device decoder.

The same frames (made with numpy from a seed: a-priori LLRs and target
syndromes) go to both packages.  The JAX package runs on its 8-device
virtual CPU mesh (tests/conftest.py), the port on ``[torch.device("cpu")] *
8``.  Min-sum must equal both bit for bit on any mesh; sum-product (a
log-sum across shards where the single-device kernels multiply) is held on
decisions and iterations, as the JAX package holds its own
(tests/test_node_sharded.py).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from qkd_ldpc_tpu import codes as jcodes
from qkd_ldpc_tpu.decoder import DecodeOptions as JaxDecodeOptions
from qkd_ldpc_tpu.parallel import decode_node_sharded as j_decode_node_sharded
from qkd_ldpc_tpu.parallel import make_mesh as j_make_mesh
from qkd_ldpc_tpu.parallel import run_point_node_sharded as j_run_point_node_sharded
from qkd_ldpc_tpu.parallel.mesh import NODE_AXIS as J_NODE_AXIS
from qkd_ldpc_tpu_torch import codes as tcodes
from qkd_ldpc_tpu_torch.channel.threefry import fold_in, prng_key
from qkd_ldpc_tpu_torch.decoder.bp import DecodeOptions, decode
from qkd_ldpc_tpu_torch.parallel import (
    NODE_AXIS,
    Mesh,
    bp_decode_node_sharded,
    decode_node_sharded,
    make_mesh,
    run_point_node_sharded,
)
from qkd_ldpc_tpu_torch.sim import run_point
from tests import fixtures
from tests._torch_port_common import assert_equal, assert_sp_close, decode_frames as frames

torch.set_num_threads(1)
CPU = torch.device("cpu")
MEDIUM = dict(n=512, m=262, dv=3, seed=7, name="n512")
_codes = {}


def pair(which):
    if which not in _codes:
        if which == "medium":
            _codes[which] = (jcodes.make_code(**MEDIUM), tcodes.make_code(**MEDIUM))
        else:
            H = np.array(getattr(fixtures, which))
            _codes[which] = (jcodes.from_dense(H), tcodes.from_dense(H))
    return _codes[which]


def jopts(opts):
    return JaxDecodeOptions(**{f.name: getattr(opts, f.name)
                               for f in dataclasses.fields(opts)})


def run_all(which, llr, syn, opts, n_trial, n_node):
    """(port single-device, port node-sharded, JAX node-sharded) results as
    numpy (bits, iterations, syndromes_match)."""
    jc, tc = pair(which)
    ref = decode(tc, torch.from_numpy(llr), torch.from_numpy(syn), opts, device="cpu")
    out = decode_node_sharded(tc, torch.from_numpy(llr), torch.from_numpy(syn), opts,
                              make_mesh(n_trial, n_node, devices=[CPU] * 8))
    jout = j_decode_node_sharded(jc, llr, syn, jopts(opts), j_make_mesh(n_trial, n_node))

    def host(r):
        return tuple(np.asarray(x) for x in r)

    return host(ref), host(out), host(jout)


@pytest.mark.parametrize("n_node", [2, 4, 8])
def test_node_sharded_matches_single_device_and_jax(n_node):
    """N = 512 divides every node count: pure sharding, no padding."""
    llr, syn = frames(pair("medium")[1], 15, 16, 5)
    ref, out, jout = run_all("medium", llr, syn, DecodeOptions(max_iterations=60),
                             8 // n_node, n_node)
    assert_equal(out, ref)
    # frame 15 converges at 9 in the port (either decoder), at 8 in the JAX
    # package (either decoder): the packages' single-device decoders part there
    assert_sp_close(out, jout, frames=1, shift=1)
    assert ref[2].any()


def test_node_sharded_padding():
    """N = 7 over 8 shards: the dummy variables must not perturb anything."""
    llr, syn = frames(pair("H_HAMMING74")[1], 1, 8, 2)
    ref, out, jout = run_all("H_HAMMING74", llr, syn, DecodeOptions(max_iterations=20), 1, 8)
    assert_equal(out, ref)
    assert_equal(out, jout)


def test_node_sharded_single_frame():
    jc, tc = pair("H_JOHNSON")
    llr, syn = frames(tc, 1, 1, 0)
    opts = DecodeOptions(max_iterations=10)
    ref = decode(tc, torch.from_numpy(llr[0]), torch.from_numpy(syn[0]), opts, device="cpu")
    out = decode_node_sharded(tc, torch.from_numpy(llr[0]), torch.from_numpy(syn[0]), opts,
                              make_mesh(1, 8, devices=[CPU] * 8))
    jout = j_decode_node_sharded(jc, llr[0], syn[0], jopts(opts), j_make_mesh(1, 8))
    assert out.bits.shape == (tc.n_vars,) and out.iterations.ndim == 0
    assert int(out.iterations) == int(ref.iterations) == int(jout.iterations)
    np.testing.assert_array_equal(out.bits.numpy(), ref.bits.numpy())
    np.testing.assert_array_equal(out.bits.numpy(), np.asarray(jout.bits))


@pytest.mark.parametrize("n_node", [2, 8])
def test_node_sharded_min_sum_bit_exact(n_node):
    llr, syn = frames(pair("medium")[1], 15, 16, 5)
    ref, out, jout = run_all("medium", llr, syn,
                             DecodeOptions(algorithm="min-sum", max_iterations=60),
                             8 // n_node, n_node)
    assert_equal(out, ref)
    assert_equal(out, jout)


def test_node_sharded_min_sum_forced_tie():
    """LLRs quantized to multiples of 0.25: many equal |Lq| in a row, so the
    first-slot tie rule decides across shards."""
    llr, syn = frames(pair("medium")[1], 15, 8, 11)
    llr = (np.round(llr * 4.0) / 4.0).astype(np.float32)
    ref, out, jout = run_all("medium", llr, syn,
                             DecodeOptions(algorithm="min-sum", max_iterations=30), 1, 8)
    assert_equal(out, ref)
    assert_equal(out, jout)


@pytest.mark.parametrize("algorithm", ["sum-product", "min-sum"])
@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_node_sharded_quantized_messages(algorithm, dtype):
    llr, syn = frames(pair("medium")[1], 15, 16, 5)
    ref, out, jout = run_all(
        "medium", llr, syn,
        DecodeOptions(algorithm=algorithm, max_iterations=60, message_dtype=dtype), 2, 4)
    if algorithm == "min-sum":
        assert_equal(out, ref)
        assert_equal(out, jout)
    elif dtype == "bfloat16":
        assert_equal(out, ref)
        assert_sp_close(out, jout, frames=1, shift=1)
    else:
        # int8 SP, frame 15: port node-sharded 23 iterations, port single
        # device 15, JAX single device and node-sharded 11 (ROADMAP C)
        assert_sp_close(out, ref, frames=1, shift=None)
        assert_sp_close(out, jout, frames=1, shift=None)


def test_node_only_mesh():
    """A 1-D node mesh (no trial axis): the whole batch on one row."""
    jc, tc = pair("medium")
    llr, syn = frames(tc, 10, 4, 9)
    opts = DecodeOptions(max_iterations=40)
    mesh = Mesh([CPU] * 8, (NODE_AXIS,))
    assert mesh.shape == {NODE_AXIS: 8}
    out = decode_node_sharded(tc, torch.from_numpy(llr), torch.from_numpy(syn), opts, mesh)
    ref = decode(tc, torch.from_numpy(llr), torch.from_numpy(syn), opts, device="cpu")
    from jax.sharding import Mesh as JMesh

    jout = j_decode_node_sharded(jc, llr, syn, jopts(opts),
                                 JMesh(np.asarray(jax.devices()), (J_NODE_AXIS,)))
    np.testing.assert_array_equal(out.bits.numpy(), ref.bits.numpy())
    np.testing.assert_array_equal(out.bits.numpy(), np.asarray(jout.bits))


def test_offset_min_sum_equals_jax_general_decoder():
    """Normalized + offset min-sum (alpha 0.8, beta 0.15) through the general
    node-sharded decoder (JAX node_sharded.py:258-260)."""
    llr, syn = frames(pair("medium")[1], 18, 16, 3)
    ref, out, jout = run_all(
        "medium", llr, syn,
        DecodeOptions(algorithm="min-sum", min_sum_alpha=0.8, min_sum_beta=0.15,
                      max_iterations=40), 4, 2)
    assert_equal(out, ref)
    assert_equal(out, jout)


def test_layered_raises_the_jax_text():
    jc, tc = pair("medium")
    llr, syn = frames(tc, 15, 2, 1)
    opts = DecodeOptions(schedule="layered")
    with pytest.raises(ValueError) as te:
        bp_decode_node_sharded(tc, torch.from_numpy(llr).T, torch.from_numpy(syn).T, opts,
                               make_mesh(1, 8, devices=[CPU] * 8))
    with pytest.raises(ValueError) as je:
        j_decode_node_sharded(jc, llr, syn, jopts(opts), j_make_mesh(1, 8))
    assert str(te.value) == str(je.value)
    with pytest.raises(ValueError, match="flooding schedule only"):
        run_point_node_sharded(tc, prng_key(1), 0.03, 8, 8, opts,
                               make_mesh(4, 2, devices=[CPU] * 8))


@pytest.mark.parametrize("routing", ["auto", "roll"])
def test_qc_code_needs_the_qc_decoder_item_11b(routing, monkeypatch):
    """A QC code under routing "auto" or "roll" takes the QC node-sharded
    decoder, never the general one, and its min-sum partials equal the
    single-device runner's 7/7."""
    from qkd_ldpc_tpu_torch.parallel import node_sharded, qc_node_sharded

    calls = []
    real = qc_node_sharded._decode_row
    monkeypatch.setattr(qc_node_sharded, "_decode_row",
                        lambda *a: calls.append(1) or real(*a))

    def boom(*a, **k):
        raise AssertionError("general node-sharded decoder used for a QC code")

    monkeypatch.setattr(node_sharded, "_decode_row", boom)
    code = tcodes.make_qc_code(z=16, nb=16, mb=8, dv=3, seed=4)
    opts = DecodeOptions(max_iterations=40, routing=routing, algorithm="min-sum")
    key = fold_in(prng_key(777), 5)
    p1, q1 = run_point(code, key, 0.03, 24, 24, opts, device="cpu")
    p2, q2 = run_point_node_sharded(code, key, 0.03, 24, 24, opts,
                                    make_mesh(4, 2, devices=[CPU] * 8))
    assert calls and q1 == q2
    assert dataclasses.astuple(p2) == dataclasses.astuple(p1) and p1.n_sp > 0


def test_bad_batch_and_mesh_are_refused():
    _, tc = pair("medium")
    llr, syn = frames(tc, 15, 6, 1)
    with pytest.raises(ValueError, match="multiple of the 4 trial shards"):
        bp_decode_node_sharded(tc, torch.from_numpy(llr).T, torch.from_numpy(syn).T,
                               DecodeOptions(), make_mesh(4, 2, devices=[CPU] * 8))
    from qkd_ldpc_tpu_torch.parallel import make_trial_mesh

    with pytest.raises(ValueError, match="'node' axis"):
        bp_decode_node_sharded(tc, torch.from_numpy(llr).T, torch.from_numpy(syn).T,
                               DecodeOptions(), make_trial_mesh([CPU] * 2))


@pytest.mark.parametrize("kw", [dict(routing="gather"), dict(algorithm="min-sum")],
                         ids=["qc-gather-sp", "random-min-sum"])
def test_run_point_node_sharded_equals_run_point_and_jax(kw):
    """A sweep point on a (trial, node) mesh: 7/7 partials of the
    single-device runner and of the JAX package's node-sharded runner."""
    if "routing" in kw:
        spec = dict(z=16, nb=16, mb=8, dv=3, seed=4)
        jc, tc = jcodes.make_qc_code(**spec), tcodes.make_qc_code(**spec)
        qber = 0.03
    else:
        (jc, tc), qber = pair("medium"), 0.03
    opts = DecodeOptions(max_iterations=50, **kw)
    key = fold_in(prng_key(777), 2)
    p1, q1 = run_point(tc, key, qber, 40, 40, opts, device="cpu")
    p2, q2 = run_point_node_sharded(tc, key, qber, 40, 40, opts,
                                    make_mesh(4, 2, devices=[CPU] * 8))
    pj, qj = j_run_point_node_sharded(
        jc, jax.random.fold_in(jax.random.PRNGKey(777), 2), qber, trials=40, batch=40,
        opts=jopts(opts), mesh=j_make_mesh(4, 2))
    assert q1 == q2 == qj
    assert dataclasses.astuple(p2) == dataclasses.astuple(p1) == dataclasses.astuple(pj)
    assert p2.n_trials == 40 and p2.n_sp > 0
