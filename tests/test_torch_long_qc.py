"""Port vs JAX package on the long quasi-cyclic code's base shape: the
frame-scale profile's ``make_qc_code(z=2048, nb=128, mb=65, dv=3, seed=1)``
(N 262,144) lifted by 16 instead, so N = 2048 and M = 1040.  Its 384 base
cells over 65 base rows make rows of degree 5 and 6, so this is a QC code
whose check side has masked slots (the flagship's rows are all of degree 6;
the upstream's alist has both degrees but is not QC).

North-star criteria (ROADMAP): min-sum and the integer stages exactly,
sum-product on decisions and iteration counts.  K1 and K2 (the check update
first and fused) against the Pallas kernels as ``test_torch_kernels.py``
holds them, KV and the decision-syndrome flag against ``after_check``, C3's
syndrome against the JAX package's, and whole decodes at QBER 0.07, the
long-frame cell's, in the configuration's bfloat16 storage."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qkd_ldpc_tpu.decoder.syndrome import syndrome as j_syndrome
from qkd_ldpc_tpu_torch.decoder.reconcile import llr_magnitude
from qkd_ldpc_tpu_torch.sim.cuda_continuation import stage_fill
from tests._torch_port_common import code_pair, make_frames
from tests.test_torch_decoder import assert_same_result, both_decode, decode_inputs
from tests.test_torch_kernels import _check_update_matches_pallas
from tests.test_torch_kernels import (
    test_variable_update_and_syndrome_flag_match_jax_after_check as _variable_update_case,
)

torch.set_num_threads(1)

WHICH = "qc_long"
N_ERR = int(2048 * 0.07)  # 143 flips a frame: QBER 0.07


def test_the_small_lift_keeps_the_mixed_rows():
    jc, tc = code_pair(WHICH)
    assert (tc.n_vars, tc.n_checks, tc.n_edges, tc.dc_max) == (2048, 1040, 6144, 6)
    np.testing.assert_array_equal(np.asarray(jc.chk_adj), tc.chk_adj)
    np.testing.assert_array_equal(np.asarray(jc.chk_mask), tc.chk_mask)
    degrees = np.bincount(tc.chk_mask.sum(axis=1))
    assert degrees[5] == 6 * 16 and degrees[6] == 59 * 16 and tc.qc is not None


@pytest.mark.parametrize("mode", ["first", "fused"], ids=["K1-first", "K2-fused"])
@pytest.mark.parametrize("algorithm", ["sum-product", "min-sum"])
def test_check_update_matches_pallas_on_the_masked_qc_code(algorithm, mode):
    _check_update_matches_pallas(code_pair(WHICH)[1], algorithm, "bfloat16", mode, True)


def test_variable_update_and_syndrome_flag_match_jax_on_the_masked_qc_code():
    _variable_update_case(WHICH, "bfloat16")


def test_staged_syndrome_equals_jax_on_the_masked_qc_code():
    """C3's plain staging: Alice's syndrome over the masked rows equal to the
    JAX package's syndrome, the LLRs and Alice's bits transposed."""
    jc, tc = code_pair(WHICH)
    alice, bob = make_frames(tc.n_vars, 8, N_ERR, seed=5)
    q = np.float32(N_ERR) / np.float32(tc.n_vars)
    mag = torch.from_numpy(np.array([llr_magnitude(q)], np.float32).view(np.int32))
    N, M, S = tc.n_vars, tc.n_checks, alice.shape[0]
    llr = torch.empty((N, S), dtype=torch.float32)
    syn = torch.empty((M, S), dtype=torch.int8)
    alice_s = torch.empty((N, S), dtype=torch.int8)
    stage_fill(torch.from_numpy(alice), torch.from_numpy(bob), tc.to_device("cpu"), mag, llr,
               syn, alice_s, use_kernel=False)
    want = np.asarray(j_syndrome(jc, jnp.asarray(alice)))
    np.testing.assert_array_equal(syn.T.numpy(), want)
    np.testing.assert_array_equal(alice_s.T.numpy(), alice.astype(np.int8))
    np.testing.assert_array_equal(llr.T.numpy(), np.where(bob == 1, -1.0, 1.0) * llr_magnitude(q))


def test_min_sum_decode_exact_on_the_masked_qc_code():
    _, _, llr, syn = decode_inputs(WHICH, 12, N_ERR, seed=21)
    rj, rt = both_decode(WHICH, llr, syn, algorithm="min-sum", message_dtype="bfloat16",
                         max_iterations=30)
    assert_same_result(rj, rt)
    assert int(rt.iterations.max()) > 1


def test_sum_product_decode_decisions_and_iterations_on_the_masked_qc_code():
    alice, _, llr, syn = decode_inputs(WHICH, 12, N_ERR, seed=22)
    rj, rt = both_decode(WHICH, llr, syn, message_dtype="bfloat16", max_iterations=30)
    assert_same_result(rj, rt)
    ok = rt.syndromes_match.numpy()
    assert ok.any()
    np.testing.assert_array_equal(rt.bits.numpy()[ok], alice[ok].astype(np.int8))
