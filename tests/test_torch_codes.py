"""Port vs JAX package: code construction (``qkd_ldpc_tpu_torch.codes``).

The generators are numpy only and must reproduce the JAX package's arrays
bit for bit from the same seed; ``code_from_numpy`` carries a graph built
by the JAX package across.
"""

import dataclasses

import numpy as np
import pytest
import torch

from qkd_ldpc_tpu import codes as jcodes
from qkd_ldpc_tpu.decoder.bp import dc_first_maps as jax_dc_first_maps
from qkd_ldpc_tpu_torch import codes as tcodes
from qkd_ldpc_tpu_torch.codes.ldpc_code import dc_first_maps

from tests import fixtures

torch.set_num_threads(1)

ARRAY_FIELDS = ("chk_adj", "chk_mask", "var_adj", "var_mask",
                "var_slot", "chk_slot", "var_deg", "chk_deg")
STATIC_FIELDS = ("n_vars", "n_checks", "dv_max", "dc_max", "n_edges",
                 "is_regular", "name", "qc")

CODES = {
    "qc-z32": ("make_qc_code", dict(z=32, nb=12, mb=6, dv=3, seed=5)),
    "qc-z16-ragged": ("make_qc_code", dict(z=16, nb=13, mb=7, dv=3, seed=4)),
    "irregular-n256": ("make_code", dict(n=256, m=131, dv=3, seed=1)),
    "irregular-n512": ("make_code", dict(n=512, m=262, dv=3, seed=7)),
}


def build_pair(which):
    fn, kw = CODES[which]
    return getattr(jcodes, fn)(**kw), getattr(tcodes, fn)(**kw)


def assert_same_code(jc, tc):
    for f in STATIC_FIELDS:
        assert getattr(jc, f) == getattr(tc, f), f
    for f in ARRAY_FIELDS:
        a, b = np.asarray(getattr(jc, f)), getattr(tc, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert jc.fingerprint == tc.fingerprint


def jax_fields(jc):
    return {f.name: getattr(jc, f.name) for f in dataclasses.fields(jc)}


@pytest.mark.parametrize("which", sorted(CODES))
def test_generators_reproduce_jax_arrays(which):
    assert_same_code(*build_pair(which))


@pytest.mark.parametrize("which", sorted(CODES))
def test_code_from_numpy_round_trip(which):
    jc, tc = build_pair(which)
    carried = tcodes.code_from_numpy(jax_fields(jc))
    assert_same_code(jc, carried)
    assert carried.fingerprint == tc.fingerprint
    assert carried.code_rate == jc.code_rate
    assert carried.n_info_bits == jc.n_info_bits


def test_code_from_numpy_rejects_incomplete_fields():
    jc, _ = build_pair("irregular-n256")
    fields = jax_fields(jc)
    del fields["var_slot"]
    with pytest.raises(ValueError, match="missing"):
        tcodes.code_from_numpy(fields)
    fields = jax_fields(jc)
    fields["dc_max"] = jc.dc_max + 1
    with pytest.raises(ValueError, match="shapes"):
        tcodes.code_from_numpy(fields)


@pytest.mark.parametrize("which", sorted(CODES))
def test_dc_first_maps_equal_jax(which):
    jc, tc = build_pair(which)
    j_adj, j_mask, j_slot = (np.asarray(x) for x in jax_dc_first_maps(jc))
    t_adj, t_mask, t_slot = dc_first_maps(tc)
    np.testing.assert_array_equal(j_adj, t_adj)
    np.testing.assert_array_equal(j_mask, t_mask)
    np.testing.assert_array_equal(j_slot, t_slot)
    dev = tc.to_device("cpu")
    np.testing.assert_array_equal(dev.chk_adj_T.numpy(), j_adj.reshape(-1))
    np.testing.assert_array_equal(dev.var_slot_T.numpy(), j_slot.reshape(-1))
    np.testing.assert_array_equal(dev.chk_mask_T_i32.numpy(), j_mask.astype(np.int32))
    assert dev.var_has_pad == (not tc.var_mask.all())
    assert tc.to_device("cpu") is dev  # placed once per device


@pytest.mark.parametrize("name", ["H_JOHNSON", "H_HAMMING74", "H_N10"])
def test_from_dense_equals_jax(name):
    H = np.array(getattr(fixtures, name))
    jc, tc = jcodes.from_dense(H, name=name), tcodes.from_dense(H, name=name)
    assert_same_code(jc, tc)
    np.testing.assert_array_equal(tc.dense, H)


def test_from_check_adjacency_rejects_bad_graphs():
    with pytest.raises(ValueError, match="Empty"):
        tcodes.from_check_adjacency([], n_vars=4)
    with pytest.raises(ValueError, match="Row '2' weight"):
        tcodes.from_check_adjacency([np.array([0, 1]), np.array([], int)], n_vars=2)
    with pytest.raises(ValueError, match="Duplicate edge"):
        tcodes.from_check_adjacency([np.array([0, 0, 1])], n_vars=2)
    with pytest.raises(ValueError, match="out of range"):
        tcodes.from_check_adjacency([np.array([0, 5])], n_vars=2)
    with pytest.raises(ValueError, match="Column '2' weight"):
        tcodes.from_check_adjacency([np.array([0, 2])], n_vars=3)
    with pytest.raises(ValueError, match="0 or 1"):
        tcodes.from_dense(np.array([[0, 2], [1, 1]]))


def test_generator_argument_validation():
    with pytest.raises(ValueError):
        tcodes.make_code(n=8, m=8)
    with pytest.raises(ValueError):
        tcodes.make_qc_code(z=8, nb=4, mb=4)
    with pytest.raises(ValueError):
        tcodes.make_qc_code(z=8, nb=6, mb=2, dv=3)
