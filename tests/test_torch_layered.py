"""Port vs JAX package: the layered schedule (``decoder/layered.py``).

The same numpy inputs go through ``qkd_ldpc_tpu.decoder.layered`` and the
port's plain loop (what runs for CPU tensors, and what ``chip_smoke.py``
holds the CUDA sweep kernel against on the card).  Min-sum has no
transcendentals and every storage rounding point is pinned: decisions,
iteration counts and ``ok`` must be equal per lane for float32, bfloat16 and
int8, with offset min-sum, without clipping, on a ragged batch and under
residency compaction.  Sum-product is matched on decisions and iteration
counts on these fixed inputs (no frame of them sits on a +-1-sweep
boundary).  The JAX side also runs once through its fused Pallas sweep
kernel (interpret mode off the TPU, as its own tests run it).
"""

import dataclasses
import unittest.mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qkd_ldpc_tpu import codes as jcodes
from qkd_ldpc_tpu.decoder import bp as jbp
from qkd_ldpc_tpu.decoder.layered import _row_tables as j_row_tables
from qkd_ldpc_tpu.sim.runner import run_point as j_run_point
from qkd_ldpc_tpu_torch import codes as tcodes
from qkd_ldpc_tpu_torch.channel.threefry import fold_in, prng_key
from qkd_ldpc_tpu_torch.codes.ldpc_code import code_from_numpy
from qkd_ldpc_tpu_torch.decoder import bp as tbp
from qkd_ldpc_tpu_torch.decoder import cuda_layered, layered
from qkd_ldpc_tpu_torch.decoder.reconcile import apriori_llr, reconcile
from qkd_ldpc_tpu_torch.decoder.syndrome import syndrome
from qkd_ldpc_tpu_torch.sim.runner import run_point

from tests._torch_port_common import code_pair, make_frames
from tests.test_torch_decoder import (
    DTYPES,
    assert_same_decisions,
    assert_same_result,
    decode_inputs,
)

torch.set_num_threads(1)

Z128 = dict(z=128, nb=6, mb=3, dv=3, seed=11)  # N=768, one full 128-wide tile


def both_layered(which, llr, syn, jax_backend="xla", **kw):
    jc, tc = code_pair(which)
    kw = dict(schedule="layered", max_iterations=30, **kw)
    rj = jbp.decode(jc, jnp.asarray(llr), jnp.asarray(syn),
                    jbp.DecodeOptions(backend=jax_backend, **kw))
    rt = tbp.decode(tc, llr, syn, tbp.DecodeOptions(**kw), device="cpu")
    return rj, rt


def carried_across(jc):
    fields = {f.name: getattr(jc, f.name) for f in dataclasses.fields(jc)}
    return code_from_numpy({k: (np.asarray(v) if hasattr(v, "shape") else v)
                            for k, v in fields.items()})


@pytest.mark.parametrize("spec", [dict(z=32, nb=12, mb=6, dv=3, seed=5), Z128],
                         ids=["z32", "z128"])
def test_row_tables_equal_jax(spec):
    """The layer tables of a JAX-built QC code carried across with
    code_from_numpy equal the JAX package's, and so do the port's own."""
    jc = jcodes.make_qc_code(**spec)
    want = j_row_tables(jc.qc)
    for tc in (carried_across(jc), tcodes.make_qc_code(**spec)):
        z, nb, mb, rows = layered._row_tables(tc.qc)
        assert (z, nb, mb) == want[:3]
        assert [[tuple(c) for c in r] for r in rows] == [
            [tuple(c) for c in r] for r in want[3]]
        tab = layered.layer_tables(tc, "cpu")
        flat = [c for r in rows for c in r]
        assert tab.row_ptr.tolist() == np.cumsum([0] + [len(r) for r in rows]).tolist()
        assert tab.col.tolist() == [j for _, j, _ in flat]
        assert tab.shift.tolist() == [s for _, _, s in flat]
        assert tab.max_row_degree == max(len(r) for r in rows) == tc.dc_max
        assert tab.row_ptr.dtype == torch.int32
        assert layered.layer_tables(tc, "cpu") is tab  # built once per device


@pytest.mark.parametrize("which,n_err", [("qc", 17), ("qc15", 7)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_min_sum_layered_exact(dtype, which, n_err):
    """Also on base rows of 15 cells, which the sweep kernel runs through its
    loop instance."""
    _, _, llr, syn = decode_inputs(which, 20, n_err, seed=41)
    rj, rt = both_layered(which, llr, syn, algorithm="min-sum", message_dtype=dtype)
    assert_same_result(rj, rt)
    assert rt.syndromes_match.all() and int(rt.iterations.max()) > 2


@pytest.mark.parametrize("dtype", DTYPES)
def test_sum_product_layered_decisions_and_iterations(dtype):
    alice, _, llr, syn = decode_inputs("qc", 20, 17, seed=41)
    rj, rt = both_layered("qc", llr, syn, message_dtype=dtype)
    assert_same_decisions(rj, rt)  # no +-1-sweep frame on these inputs
    ok = rt.syndromes_match.numpy()
    assert ok.all()
    np.testing.assert_array_equal(rt.bits.numpy()[ok], alice[ok].astype(np.int8))


VARIANTS = {
    # offset min-sum on a ragged batch width
    "beta-ragged": (13, 15, dict(algorithm="min-sum", min_sum_alpha=1.0,
                                 min_sum_beta=0.15)),
    "no-clip": (12, 15, dict(algorithm="min-sum", clip_messages=False,
                             message_threshold=2.5)),
    "tight-clip": (12, 15, dict(algorithm="min-sum", message_threshold=2.5)),
    # 24 errors: some frames fail (report max_iterations), and more lanes are
    # unconverged after 2 sweeps than compact_lanes: the phase-C fallback runs
    "compaction-overflow": (24, 24, dict(algorithm="min-sum", message_dtype="bfloat16",
                                         compact_after=2, compact_lanes=4)),
}


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_min_sum_layered_variants_exact(name):
    batch, n_err, kw = VARIANTS[name]
    _, _, llr, syn = decode_inputs("qc", batch, n_err, seed=42)
    rj, rt = both_layered("qc", llr, syn, **kw)
    assert_same_result(rj, rt)
    if name == "compaction-overflow":
        assert int((rt.iterations > 2).sum()) > 4
        assert (rt.iterations[~rt.syndromes_match] == 30).all()


def test_layered_equals_jax_pallas_sweep_kernel():
    """The JAX decoder through its fused Pallas sweep kernel (interpret mode)
    == the port's plain loop, compaction included."""
    _, _, llr, syn = decode_inputs("qc", 16, 19, seed=43)
    rj, rt = both_layered("qc", llr, syn, jax_backend="pallas", algorithm="min-sum",
                          message_dtype="bfloat16", compact_after=3, compact_lanes=8)
    assert_same_result(rj, rt)


@pytest.mark.parametrize("algorithm", ["min-sum", "sum-product"])
def test_layered_z128_code(algorithm):
    jc, tc = jcodes.make_qc_code(**Z128), tcodes.make_qc_code(**Z128)
    n_err = 38
    alice, bob = make_frames(jc.n_vars, 8, n_err, seed=44)
    llr = apriori_llr(torch.from_numpy(bob), n_err / jc.n_vars).numpy()
    syn = syndrome(tc, torch.from_numpy(alice)).numpy()
    kw = dict(schedule="layered", max_iterations=40, algorithm=algorithm,
              message_dtype="bfloat16")
    rj = jbp.decode(jc, jnp.asarray(llr), jnp.asarray(syn), jbp.DecodeOptions(**kw))
    rt = tbp.decode(tc, llr, syn, tbp.DecodeOptions(**kw), device="cpu")
    if algorithm == "min-sum":
        assert_same_result(rj, rt)
    else:
        assert_same_decisions(rj, rt)
    assert rt.syndromes_match.any()


@pytest.mark.parametrize("kw", [
    dict(message_dtype="bfloat16"),
    dict(message_dtype="int8"),
], ids=["bf16", "int8"])
def test_run_point_layered_partials_equal_jax(kw):
    """run_point with schedule='layered' goes through reconcile and decode
    unchanged; min-sum partials equal the JAX package's 7/7 (QBER 0.05:
    failed frames included), with a tail batch."""
    jc, tc = code_pair("qc")
    kw = dict(max_iterations=32, algorithm="min-sum", schedule="layered", **kw)
    pj, qj = j_run_point(jc, jax.random.fold_in(jax.random.PRNGKey(777), 2), 0.05,
                         trials=20, batch=8, opts=jbp.DecodeOptions(**kw))
    pt, qt = run_point(tc, fold_in(prng_key(777), 2), 0.05, trials=20, batch=8,
                       opts=tbp.DecodeOptions(**kw), device="cpu")
    assert qj == qt and dataclasses.astuple(pj) == dataclasses.astuple(pt)
    assert pt.n_trials == 20 and pt.n_sp > 0


def test_layered_requires_qc_code_with_the_reference_text():
    jc, tc = code_pair("irregular")
    llr = np.ones((2, tc.n_vars), np.float32)
    syn = np.zeros((2, tc.n_checks), np.int8)
    with pytest.raises(ValueError) as ej:
        jbp.decode(jc, jnp.asarray(llr), jnp.asarray(syn),
                   jbp.DecodeOptions(schedule="layered"))
    with pytest.raises(ValueError) as et:
        tbp.decode(tc, llr, syn, tbp.DecodeOptions(schedule="layered"), device="cpu")
    assert str(ej.value) == str(et.value)
    alice, bob = make_frames(tc.n_vars, 2, 5, seed=1)
    with pytest.raises(ValueError, match="requires a QC code"):
        reconcile(tc, alice, bob, 0.02, tbp.DecodeOptions(schedule="layered"),
                  device="cpu")


def _sweep_state(dtype, seed=45, batch=6, n_err=17):
    """A state two sweeps into a real decode, in the kernel's layout."""
    _, tc = code_pair("qc")
    tab = layered.layer_tables(tc, "cpu")
    _, _, llr, syn = decode_inputs("qc", batch, n_err, seed=seed)
    scale = 0.25 if dtype == "int8" else None
    kw = dict(threshold=100.0, clip=True, algorithm="min-sum", min_sum_alpha=0.8,
              min_sum_beta=0.0, scale=scale)
    t, Lr, syn3 = layered.initial_state(
        tab, torch.from_numpy(llr).T, torch.from_numpy(syn).T,
        layered.cuda_kernels.STORAGE_DTYPES[dtype])
    assert t.shape == (tab.nb, batch, tab.z) and t.is_contiguous()
    act = torch.ones(batch, dtype=torch.bool)
    for _ in range(2):
        t, Lr, _ = layered.layered_sweep_plain(t, Lr, syn3, act, tab, **kw)
    return tab, t, Lr, syn3, kw


@pytest.mark.parametrize("dtype", DTYPES)
def test_single_sweep_gating_and_purity(dtype):
    """One plain sweep with a mixed act mask: inactive frames keep their
    state, active frames move as in an all-active sweep, inputs are not
    modified, and ok is the decision-syndrome check of the new totals."""
    tab, t, Lr, syn3, kw = _sweep_state(dtype)
    t_in, Lr_in = t.clone(), Lr.clone()
    act = torch.tensor([True, False, True, True, False, True])
    full_t, full_Lr, full_ok = layered.layered_sweep_plain(
        t, Lr, syn3, torch.ones(6, dtype=torch.bool), tab, **kw)
    new_t, new_Lr, ok = layered.layered_sweep_plain(t, Lr, syn3, act, tab, **kw)
    assert torch.equal(t, t_in) and torch.equal(Lr, Lr_in)
    assert torch.equal(new_t[:, ~act], t_in[:, ~act])
    assert torch.equal(new_Lr[:, ~act], Lr_in[:, ~act])
    assert torch.equal(new_t[:, act], full_t[:, act])
    assert torch.equal(new_Lr[:, act], full_Lr[:, act])
    assert not torch.equal(new_t[:, act], t_in[:, act])
    assert torch.equal(ok[act], full_ok[act])
    assert torch.equal(ok, layered.syndrome_ok(new_t, syn3, tab))
    assert new_t.dtype == torch.float32 and new_Lr.dtype == Lr_in.dtype


def test_sweep_vector_width_follows_shape_and_alignment():
    """The kernel copies t in vectors of 4 floats when z is a multiple of 4
    and t is 16-byte aligned, and float by float otherwise; nothing else of
    it depends on z or on alignment.  The state's syndrome plane is int8, one
    byte per lifted check."""
    tab, t, Lr, syn3, _ = _sweep_state("bfloat16")
    assert syn3.dtype == torch.int8 and syn3.shape == (tab.mb, 6, tab.z)
    assert tab.z % 4 == 0 and t.data_ptr() % 16 == 0
    assert cuda_layered.copy_width(tab.z, t) == 4
    assert cuda_layered.copy_width(30, t) == 1
    odd = torch.zeros(65, dtype=torch.float32)[1:]  # 4 bytes past an aligned start
    assert cuda_layered.copy_width(tab.z, odd) == 1
    assert not hasattr(cuda_layered, "vector_width")
    # the row tables share a block's memory with the totals
    assert cuda_layered.totals_in_shared_memory(20, 512, 10, 60)
    assert cuda_layered.totals_in_shared_memory(113, 512)
    assert not cuda_layered.totals_in_shared_memory(113, 512, 57, 339)


def test_sweep_kernel_wrapper_refuses_cpu_tensors_and_bad_shapes():
    """The CUDA wrapper raises for CPU tensors, backend='pallas' does not
    fall back to the plain loop, and no rule lets a CUDA tensor take the
    plain loop under 'auto': a wide frame keeps its totals in global memory,
    every row degree from 2 up runs, and a degree below 2 raises."""
    tab, t, Lr, syn3, kw = _sweep_state("float32")
    act = torch.ones(6, dtype=torch.bool)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_layered.layered_sweep_cuda(t, Lr, syn3, act, tab, **kw)
    _, tc = code_pair("qc")
    llr = np.ones((2, tc.n_vars), np.float32)
    syn = np.zeros((2, tc.n_checks), np.int8)
    with pytest.raises(ValueError, match="CUDA"):
        tbp.decode(tc, llr, syn,
                   tbp.DecodeOptions(schedule="layered", backend="pallas"),
                   device="cpu")
    for degree in (2, 6, 9, 15, 60):
        assert cuda_layered.refusal(degree) is None
    assert "row degree" in cuda_layered.refusal(1)
    assert cuda_layered.totals_in_shared_memory(20, 512)
    assert not cuda_layered.totals_in_shared_memory(128, 512)
    assert not hasattr(layered, "_use_kernel")
    # On a (pretended) CUDA device the decode raises the refusal before any
    # device work, under "auto" as under "pallas"; "xla" and the CPU do not.
    steep = dataclasses.replace(tab, max_row_degree=1)
    tc._device_cache[("layers", torch.device("cpu"))] = steep
    try:
        for backend in ("auto", "pallas"):
            with pytest.raises(ValueError, match="row degree"), \
                    unittest.mock.patch.object(
                        layered._build, "use_kernel", lambda b, d: b != "xla"):
                layered.layered_decode_batch_last(
                    tc, torch.ones((tc.n_vars, 2)),
                    torch.zeros((tc.n_checks, 2), dtype=torch.int32),
                    tbp.DecodeOptions(schedule="layered", backend=backend))
    finally:
        del tc._device_cache[("layers", torch.device("cpu"))]
