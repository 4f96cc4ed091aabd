"""Port vs JAX package: the check-node update kernels K1 / K2.

The plain PyTorch versions (what the port runs for CPU tensors, and what
``chip_smoke.py`` holds the CUDA kernels against on the card) are compared
with the Pallas kernels in interpret mode on the same numpy tensors, for
{sum-product, min-sum} x {float32, bfloat16, int8} on a code with padded
slots.

Tolerances.  Min-sum has no transcendentals: exact.  Sum-product float32:
``rtol 1e-5, atol 1e-5`` on finite entries (``tanh``/``log1p`` of PyTorch
and XLA:CPU differ by ulps), infinities and clip saturation at the same
places.  The output ``2 atanh(x)`` has the derivative ``2 / (1 - x^2)``, so
an ulp of difference in the leave-one-out product x is amplified without
limit as ``|x| -> 1`` (by about 1500 already at an output of 8): entries
beyond the plain tolerance must agree within 16 float32 ulps of x after
mapping back, ``|tanh(a/2) - tanh(b/2)| <= 16 * 2^-24``, and are bounded at
2 % of the tensor.  bfloat16/int8 storage: equal except where the float32
value sits within that tolerance of a rounding boundary — such entries may
differ by one storage step and are bounded at 0.5 % of the tensor.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qkd_ldpc_tpu.decoder.pallas_kernels import (
    check_update_pallas,
    fused_update_pallas,
)
from qkd_ldpc_tpu_torch.codes import make_code
from qkd_ldpc_tpu_torch.decoder import cuda_kernels

torch.set_num_threads(1)

B = 8
STEP_FRACTION_BOUND = 0.005
AMPLIFIED_FRACTION_BOUND = 0.02
X_ULPS = 16  # dc - 1 = 5 factors, each a tanh a few ulps apart, then 5 products
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16, "int8": jnp.int8}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16, "int8": torch.int8}


@pytest.fixture(scope="module")
def padded_code():
    code = make_code(n=96, m=50, dv=3, seed=3)  # row weights 5 and 6
    assert not code.chk_mask.all() and code.dc_max == 6
    return code


def _inputs(code, dtype, seed):
    """(tot, lr_prev) in storage, as float32 numpy of the storage values,
    plus the sign plane; made with numpy and handed to both packages."""
    rng = np.random.default_rng(seed)
    dc, M = code.dc_max, code.n_checks
    scale = 0.25 if dtype == "int8" else None
    tot = (6.0 * rng.standard_normal((dc, M, B))).astype(np.float32)
    lrp = (3.0 * rng.standard_normal((dc, M, B))).astype(np.float32)
    # Check 0 of frame 0: every input saturates tanh, so each leave-one-out
    # product is +-1 and the output +-inf before the clip.
    tot[:, 0, 0] = 400.0 * np.where(rng.random(dc) < 0.5, -1.0, 1.0)
    lrp[:, 0, 0] = 0.0
    tot[1, 1, 0] = 0.0
    syn = np.where(rng.random((M, B)) < 0.5, -1.0, 1.0).astype(np.float32)
    t_tot = cuda_kernels._store(torch.from_numpy(tot), TORCH[dtype], scale)
    t_lrp = cuda_kernels._store(torch.from_numpy(lrp), TORCH[dtype], scale)
    return t_tot, t_lrp, syn, scale


def _to_jax(t, dtype):
    if dtype == "bfloat16":
        return jnp.asarray(t.to(torch.float32).numpy()).astype(jnp.bfloat16)
    return jnp.asarray(t.numpy())


def _values(x, scale):
    x = np.asarray(x).astype(np.float32)
    return x * scale if scale is not None else x


@pytest.mark.parametrize("first", [True, False], ids=["K1-first", "K2-fused"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("algorithm", ["sum-product", "min-sum"])
@pytest.mark.parametrize("clip", [True, False], ids=["clip", "noclip"])
def test_plain_check_update_matches_pallas(padded_code, algorithm, dtype, first, clip):
    code = padded_code
    t_tot, t_lrp, syn, scale = _inputs(code, dtype, seed=17)
    mask = np.ascontiguousarray(code.chk_mask.T).astype(np.int32)
    kw = dict(threshold=100.0, clip=clip, algorithm=algorithm,
              min_sum_alpha=0.8, min_sum_beta=0.0 if first else 0.3, scale=scale)
    if first:
        want = check_update_pallas(
            _to_jax(t_tot, dtype), jnp.asarray(mask), jnp.asarray(syn),
            interpret=True, **kw)
        got = cuda_kernels.check_update_first(
            t_tot, torch.from_numpy(mask), torch.from_numpy(syn), **kw)
    else:
        want = fused_update_pallas(
            _to_jax(t_tot, dtype), _to_jax(t_lrp, dtype), jnp.asarray(mask),
            jnp.asarray(syn), interpret=True, **kw)
        got = cuda_kernels.check_update_fused(
            t_tot, t_lrp, torch.from_numpy(mask), torch.from_numpy(syn), **kw)
    assert got.dtype == TORCH[dtype] and tuple(got.shape) == want.shape
    a = _values(got.to(torch.float32).numpy() if dtype == "bfloat16" else got.numpy(), scale)
    b = _values(want, scale)
    np.testing.assert_array_equal(np.isfinite(a), np.isfinite(b))
    fin = np.isfinite(b)
    np.testing.assert_array_equal(a[~fin], b[~fin])
    if algorithm == "min-sum":
        np.testing.assert_array_equal(a, b)
        return
    if clip:  # the saturated row must sit exactly on the threshold
        top = 100.0 if dtype != "int8" else 127 * 0.25
        assert np.abs(b).max() == top and np.abs(a).max() == top
    if dtype == "float32":
        a64, b64 = a[fin].astype(np.float64), b[fin].astype(np.float64)
        loose = np.abs(a64 - b64) > 1e-5 + 1e-5 * np.abs(b64)
        x_gap = np.abs(np.tanh(a64 / 2) - np.tanh(b64 / 2))
        assert (x_gap[loose] <= X_ULPS * 2.0**-24).all(), x_gap[loose].max()
        assert loose.mean() <= AMPLIFIED_FRACTION_BOUND, loose.sum()
        return
    step = np.abs(b[fin]) * 2.0**-7 if dtype == "bfloat16" else scale
    diff = np.abs(a[fin] - b[fin])
    assert (diff <= step).all()
    assert (diff > 0).mean() <= STEP_FRACTION_BOUND, (diff > 0).sum()


def test_min_sum_first_occurrence_tie_rule():
    """Equal magnitudes in one row: the excluded edge is the lowest slot."""
    lq = torch.tensor([2.0, -1.0, 1.0, -1.0, 3.0]).view(5, 1, 1)
    mask = torch.ones((5, 1), dtype=torch.int32)
    syn = torch.ones((1, 1))
    out = cuda_kernels.check_update_first(
        lq, mask, syn, threshold=100.0, clip=True, algorithm="min-sum",
        min_sum_alpha=1.0, min_sum_beta=0.0, scale=None)
    # row minimum 1 first at slot 1: slot 1 sees the second minimum (1, the
    # tie at slot 2), every other slot sees 1; signs are leave-one-out.
    assert out.view(-1).tolist() == [1.0, -1.0, 1.0, -1.0, 1.0]
    want = check_update_pallas(
        jnp.asarray(lq.numpy()), jnp.asarray(mask.numpy()), jnp.asarray(syn.numpy()),
        interpret=True, algorithm="min-sum", min_sum_alpha=1.0)
    np.testing.assert_array_equal(np.asarray(want), out.numpy())


def test_kernel_wrapper_refuses_cpu_tensors():
    """The CUDA wrapper raises for CPU tensors; backend='pallas' does not
    fall back to the plain version."""
    lq = torch.zeros((3, 2, 2))
    mask = torch.ones((3, 2), dtype=torch.int32)
    syn = torch.ones((2, 2))
    kw = dict(threshold=100.0, clip=True, algorithm="min-sum",
              min_sum_alpha=0.8, min_sum_beta=0.0, scale=None)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_kernels.check_update_cuda(lq, None, mask, syn, first=True, **kw)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_kernels.check_update_first(lq, mask, syn, backend="pallas", **kw)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_kernels.check_update_fused(lq, lq, mask, syn, backend="pallas", **kw)
