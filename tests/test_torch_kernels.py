"""Port vs JAX package: the check-node update kernels K1 / K2 / K5 and the
variable-node update that runs between two of them.

The plain PyTorch versions (what the port runs for CPU tensors, and what
``chip_smoke.py`` holds the CUDA kernels against on the card) are compared
with the Pallas kernels in interpret mode on the same numpy tensors, for
{sum-product, min-sum} x {float32, bfloat16, int8} on a code with padded
slots.  The port's check update reads ``total [N, B]`` through the check
adjacency; the Pallas kernels are handed the gathered copy of the same
totals.  K5 is K2 with a per-frame ``fresh`` mask (mixed here) and a
threshold low enough for the skipped clip to matter.  The variable update
and the decision syndrome that the check update returns are held against
``after_check`` of the JAX decoder: exact, integer and storage-rounded
values only.

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

from qkd_ldpc_tpu.decoder import bp as jbp
from qkd_ldpc_tpu.decoder.pallas_kernels import (
    check_update_pallas,
    fused_update_fresh_pallas,
    fused_update_pallas,
)
from qkd_ldpc_tpu_torch.channel import cuda_prng, cuda_select
from qkd_ldpc_tpu_torch.codes import make_code
from qkd_ldpc_tpu_torch.decoder import cuda_kernels

from tests._torch_port_common import code_pair

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
    """(total [N, B], lr_prev [dc, M, B]) in storage and the [M, B] target
    syndrome bits; made with numpy and handed to both packages."""
    rng = np.random.default_rng(seed)
    dc, M, N = code.dc_max, code.n_checks, code.n_vars
    scale = 0.25 if dtype == "int8" else None
    tot = (6.0 * rng.standard_normal((N, B))).astype(np.float32)
    lrp = (3.0 * rng.standard_normal((dc, M, B))).astype(np.float32)
    # Check 0 of frame 0: every input saturates tanh, so each leave-one-out
    # product is +-1 and the output +-inf before the clip.
    row0 = code.chk_adj[0]
    tot[row0, 0] = 400.0 * np.where(rng.random(dc) < 0.5, -1.0, 1.0)
    lrp[:, 0, 0] = 0.0
    tot[code.chk_adj[1, 1], 0] = 0.0
    syn = (rng.random((M, B)) < 0.5).astype(np.int8)
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


@pytest.mark.parametrize("mode", ["first", "fused", "fresh"],
                         ids=["K1-first", "K2-fused", "K5-fresh"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("algorithm", ["sum-product", "min-sum"])
@pytest.mark.parametrize("clip", [True, False], ids=["clip", "noclip"])
def test_plain_check_update_matches_pallas(padded_code, algorithm, dtype, mode, clip):
    _check_update_matches_pallas(padded_code, algorithm, dtype, mode, clip)


# Check degrees above the unrolled kernel instances (2..8), rows of two
# degrees each (padded slots): dc_max = ceil(n * 3 / m).
HIGH_DEGREE_CODES = {12: dict(n=92, m=24, dv=3, seed=3), 15: dict(n=116, m=24, dv=3, seed=3)}
# One storage a (degree, mode), each degree taking all three: an interpreted
# Pallas kernel at these degrees takes seconds to build.
HIGH_DEGREE_DTYPES = {(12, "first"): "float32", (12, "fused"): "bfloat16",
                      (12, "fresh"): "int8", (15, "first"): "int8",
                      (15, "fused"): "float32", (15, "fresh"): "bfloat16"}


@pytest.mark.parametrize("mode", ["first", "fused", "fresh"],
                         ids=["K1-first", "K2-fused", "K5-fresh"])
@pytest.mark.parametrize("algorithm", ["sum-product", "min-sum"])
@pytest.mark.parametrize("dc", sorted(HIGH_DEGREE_CODES))
def test_plain_check_update_matches_pallas_at_high_degree(dc, algorithm, mode):
    """The plain versions the loop instances are held against on the card,
    at dc_max 12 and 15, against the Pallas kernels (which unroll any dc)."""
    dtype = HIGH_DEGREE_DTYPES[dc, mode]
    code = make_code(**HIGH_DEGREE_CODES[dc])
    assert code.dc_max == dc and not code.chk_mask.all()
    # K5: a row minimum of 11 or 14 inputs lies below the threshold of 5
    # that bites on rows of 6, so the clip is set where it changes min-sum.
    _check_update_matches_pallas(code, algorithm, dtype, mode, True, fresh_threshold=0.25)


def _check_update_matches_pallas(code, algorithm, dtype, mode, clip, fresh_threshold=5.0):
    first = mode == "first"
    t_tot, t_lrp, syn, scale = _inputs(code, dtype, seed=17)
    maps = code.to_device("cpu")
    mask = jnp.asarray(np.ascontiguousarray(code.chk_mask.T).astype(np.int32))
    # what the Pallas kernels are handed: the gathered totals and a sign plane
    j_tot = _to_jax(cuda_kernels._gathered(t_tot, maps), dtype)
    j_sign = jnp.asarray(np.where(syn == 1, -1.0, 1.0).astype(np.float32))
    t_syn = torch.from_numpy(syn)
    # K5: a threshold below most |tot - lr|, so clipped and fresh frames differ.
    threshold = fresh_threshold if mode == "fresh" else 100.0
    kw = dict(threshold=threshold, clip=clip, algorithm=algorithm,
              min_sum_alpha=0.8, min_sum_beta=0.0 if first else 0.3, scale=scale)
    if first:
        want = check_update_pallas(j_tot, mask, j_sign, interpret=True, **kw)
        got = cuda_kernels.check_update_first(t_tot, t_syn, maps, **kw)
    elif mode == "fresh":
        # Frame 0 (the saturating check) is fresh; the mask is mixed.
        fresh = np.array([1, 0, 1, 1, 0, 0, 1, 0], np.int32)
        want = fused_update_fresh_pallas(
            j_tot, _to_jax(t_lrp, dtype), mask, j_sign, jnp.asarray(fresh[None, :]),
            interpret=True, **kw)
        got, ok = cuda_kernels.check_update_fused(
            t_tot, t_lrp, t_syn, maps, fresh=torch.from_numpy(fresh != 0), **kw)
        assert not ok[torch.from_numpy(fresh != 0)].any()  # no iteration run yet
        if clip:  # the flag matters: without it the result is another one
            unflagged, _ = cuda_kernels.check_update_fused(t_tot, t_lrp, t_syn, maps, **kw)
            differs = (got != unflagged).flatten(0, 1).any(dim=0).numpy()
            np.testing.assert_array_equal(differs, fresh != 0)
    else:
        want = fused_update_pallas(
            j_tot, _to_jax(t_lrp, dtype), mask, j_sign, interpret=True, **kw)
        got, ok = cuda_kernels.check_update_fused(t_tot, t_lrp, t_syn, maps, **kw)
        assert ok.shape == (B,) and ok.dtype == torch.bool
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
        top = threshold if dtype != "int8" else min(threshold, 127 * 0.25)
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


def _one_check_maps(dc):
    """The maps of a code with one check over ``dc`` variables."""
    from qkd_ldpc_tpu_torch.codes.ldpc_code import from_dense

    return from_dense(np.ones((1, dc), np.uint8)).to_device("cpu")


def test_min_sum_first_occurrence_tie_rule():
    """Equal magnitudes in one row: the excluded edge is the lowest slot."""
    lq = torch.tensor([2.0, -1.0, 1.0, -1.0, 3.0]).view(5, 1)
    syn = torch.zeros((1, 1), dtype=torch.int8)
    out = cuda_kernels.check_update_first(
        lq, syn, _one_check_maps(5), threshold=100.0, clip=True, algorithm="min-sum",
        min_sum_alpha=1.0, min_sum_beta=0.0, scale=None)
    # row minimum 1 first at slot 1: slot 1 sees the second minimum (1, the
    # tie at slot 2), every other slot sees 1; signs are leave-one-out.
    assert out.view(-1).tolist() == [1.0, -1.0, 1.0, -1.0, 1.0]
    want = check_update_pallas(
        jnp.asarray(lq.numpy()).reshape(5, 1, 1), jnp.ones((5, 1), jnp.int32),
        jnp.ones((1, 1), jnp.float32), interpret=True, algorithm="min-sum",
        min_sum_alpha=1.0)
    np.testing.assert_array_equal(np.asarray(want), out.numpy())


@pytest.mark.parametrize("dc", [9, 15, 60])
def test_check_wrapper_takes_every_degree(dc):
    """No check degree is refused: a dc_max above the unrolled instances
    passes every check of the wrapper and stops only at the device (a CPU
    tensor here)."""
    maps = _one_check_maps(dc)
    kw = dict(threshold=100.0, clip=True, algorithm="sum-product",
              min_sum_alpha=0.8, min_sum_beta=0.0, scale=None)
    tot, syn = torch.zeros((dc, 4)), torch.zeros((1, 4), dtype=torch.int8)
    with pytest.raises(ValueError, match="the CUDA kernels need CUDA tensors"):
        cuda_kernels.check_update_cuda(tot, None, syn, maps, first=True, **kw)
    with pytest.raises(ValueError, match="the CUDA kernels need CUDA tensors"):
        cuda_kernels.check_update_cuda(tot, torch.zeros((dc, 1, 4)), syn, maps,
                                       first=False, **kw)
    assert not hasattr(cuda_kernels, "_DC_INSTANCES")


def test_kernel_wrapper_refuses_cpu_tensors():
    """The CUDA wrappers raise for CPU tensors; backend='pallas' does not
    fall back to the plain versions."""
    maps = _one_check_maps(3)
    tot = torch.zeros((3, 2))
    lr = torch.zeros((3, 1, 2))
    syn = torch.zeros((1, 2), dtype=torch.int8)
    kw = dict(threshold=100.0, clip=True, algorithm="min-sum",
              min_sum_alpha=0.8, min_sum_beta=0.0, scale=None)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_kernels.check_update_cuda(tot, None, syn, maps, first=True, **kw)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_kernels.check_update_first(tot, syn, maps, backend="pallas", **kw)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_kernels.check_update_fused(tot, lr, syn, maps, backend="pallas", **kw)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_kernels.check_update_fused(tot, lr, syn, maps, backend="pallas",
                                        fresh=torch.ones(2, dtype=torch.bool), **kw)
    z, count = torch.zeros((3, 2), dtype=torch.int8), torch.zeros(2, dtype=torch.int32)
    active = torch.ones(2, dtype=torch.bool)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_kernels.variable_update_cuda(lr, tot, z, count, active, maps, scale=None)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_kernels.variable_update(lr, tot, z, count, active, maps,
                                     backend="pallas", scale=None)


def _wrapper_inputs():
    maps = _one_check_maps(3)
    kw = dict(threshold=100.0, clip=True, algorithm="min-sum",
              min_sum_alpha=0.8, min_sum_beta=0.0, scale=None)
    return dict(
        maps=maps, kw=kw, tot=torch.zeros((3, 2)), lr=torch.zeros((3, 1, 2)),
        syn=torch.zeros((1, 2), dtype=torch.int8),
        z=torch.zeros((3, 2), dtype=torch.int8),
        count=torch.zeros(2, dtype=torch.int32),
        active=torch.ones(2, dtype=torch.bool))


@pytest.mark.parametrize("bad, match", [
    (dict(tot=torch.zeros((2, 2))), "code's N = 3"),  # a row short: read past the end
    (dict(tot=torch.zeros((4, 2))), "code's N = 3"),
    (dict(tot=torch.zeros(3)), "code's N = 3"),
    (dict(lr=torch.zeros((3, 1, 4))), "Lr_prev"),
    (dict(syn=torch.zeros((1, 2), dtype=torch.int32)), "syn"),
    (dict(fresh=torch.ones(3, dtype=torch.bool)), "fresh"),
    (dict(ok=torch.ones(3, dtype=torch.bool)), "ok"),
    (dict(ok=torch.ones(4, dtype=torch.bool)[::2]), "ok"),
    (dict(tot=torch.zeros((3, 4)).T[:2].T), "contiguous"),
], ids=["total-short", "total-long", "total-1d", "lr-shape", "syn-dtype",
        "fresh-shape", "ok-shape", "ok-strided", "total-strided"])
def test_check_wrapper_refuses_bad_shapes(bad, match):
    """The check wrapper holds every tensor against the code's sizes before
    anything reaches the device: in particular a ``total`` whose row count is
    not the code's N, which the kernel would index past."""
    x = _wrapper_inputs()
    x.update({k: v for k, v in bad.items() if k in x})
    with pytest.raises(ValueError, match=match):
        cuda_kernels.check_update_cuda(
            x["tot"], x["lr"], x["syn"], x["maps"], first=False,
            fresh=bad.get("fresh"), ok=bad.get("ok"), **x["kw"])


@pytest.mark.parametrize("bad, match", [
    (dict(lr=torch.zeros((3, 2, 2))), "Lr"),
    (dict(tot=torch.zeros((4, 2))), "llr"),
    (dict(z=torch.zeros((3, 2), dtype=torch.bool)), "z must"),
    (dict(count=torch.zeros(2, dtype=torch.int64)), "count"),
    (dict(active=torch.ones(3, dtype=torch.bool)), "active"),
], ids=["lr-shape", "llr-shape", "z-dtype", "count-dtype", "active-shape"])
def test_variable_wrapper_refuses_bad_shapes(bad, match):
    x = _wrapper_inputs()
    x.update(bad)
    with pytest.raises(ValueError, match=match):
        cuda_kernels.variable_update_cuda(
            x["lr"], x["tot"], x["z"], x["count"], x["active"], x["maps"], scale=None)


@pytest.mark.parametrize("bad, match", [
    (dict(point_key=torch.zeros(3, dtype=torch.int64)), "point_key"),
    (dict(rows=("alice", "bits")), "rows"),
    (dict(rows=("scores", "scores")), "rows"),
    (dict(rows=()), "rows"),
    (dict(ids=range(0, 8, 2)), "step 1"),
    (dict(ids=torch.zeros((2, 2), dtype=torch.int64)), "1-d"),
    (dict(ids=torch.zeros(2)), "integers"),
    (dict(n_bits=0), "positive"),
    (dict(device="cpu"), "CUDA"),
    (dict(ids=torch.arange(4)), "CUDA"),
], ids=["key-shape", "row-name", "row-twice", "no-rows", "range-step", "ids-2d",
        "ids-float", "no-bits", "cpu-device", "cpu-ids"])
def test_trial_words_wrapper_refuses_bad_arguments(bad, match):
    """K4's wrapper checks the key, the row names, the id form and the device
    before anything reaches the card."""
    x = dict(point_key=torch.tensor([1, 2]), n_bits=64, ids=range(4),
             rows=("alice", "scores"), device=None)
    x.update(bad)
    with pytest.raises(ValueError, match=match):
        cuda_prng.trial_words_cuda(**x)


@pytest.mark.parametrize("bad, match", [
    (dict(scores=torch.zeros((2, 8), dtype=torch.int64)), "int32"),
    (dict(scores=torch.zeros((0, 8), dtype=torch.int32)), "empty"),
    (dict(alice=torch.zeros((2, 8), dtype=torch.bool)), "alice"),
    (dict(alice=torch.zeros((2, 9), dtype=torch.uint8)), "alice"),
    (dict(), "CUDA"),
], ids=["scores-dtype", "scores-empty", "alice-dtype", "alice-shape", "cpu"])
def test_select_flip_wrapper_refuses_bad_arguments(bad, match):
    """K3's wrapper checks the scores and Alice's row before the device."""
    x = dict(scores=torch.zeros((2, 8), dtype=torch.int32), k=3,
             alice=torch.zeros((2, 8), dtype=torch.uint8))
    x.update(bad)
    with pytest.raises(ValueError, match=match):
        cuda_select.select_flip_cuda(**x)


@pytest.mark.parametrize("first", [True, False], ids=["first", "fused"])
def test_check_wrapper_holds_the_flag_buffer_to_the_vector_alignment(monkeypatch, first):
    """Every tensor the vector instance touches decides between it and the
    scalar instance: the caller's ``ok`` too (its bytes are read as one
    vector), which a contiguous view may start anywhere.  The device check is
    stubbed so that the choice is reached with CPU tensors."""
    x = _wrapper_inputs()
    seen = []

    class Reached(Exception):
        pass

    def spy(kernel, B, dtype, *tensors):
        seen.append((kernel, B, tensors))
        raise Reached

    monkeypatch.setattr(cuda_kernels, "_need_cuda", lambda ref: None)
    monkeypatch.setattr(cuda_kernels, "vector_width", spy)
    ok = torch.ones(3, dtype=torch.bool)[1:]  # contiguous, one byte past its buffer's start
    assert ok.is_contiguous() and ok.data_ptr() % 16 != 0
    with pytest.raises(Reached):
        cuda_kernels.check_update_cuda(
            x["tot"], None if first else x["lr"], x["syn"], x["maps"], first=first,
            ok=ok, **x["kw"])
    (kernel, B, tensors), = seen
    assert (kernel, B) == ("check_update", 2)
    assert any(t is ok for t in tensors) == (not first)
    assert any(t is x["tot"] for t in tensors) and any(t is x["syn"] for t in tensors)


def test_vector_width_follows_shape_and_alignment(monkeypatch):
    """The width compiled into the library when it divides B and every tensor
    is 16-byte aligned; the scalar instance otherwise."""
    asked = []

    def built_width(library, name):
        asked.append((library, name))
        return 8

    monkeypatch.setattr(cuda_kernels._build, "constant", built_width)
    x = torch.zeros((4, 64), dtype=torch.bfloat16)
    odd = torch.zeros(65, dtype=torch.int8)[1:]  # one byte past an aligned start
    assert x.data_ptr() % 16 == 0 and odd.data_ptr() % 16 == 1
    assert cuda_kernels.vector_width("check_update", 64, torch.bfloat16, x) == 8
    assert cuda_kernels.vector_width("variable_update", 128, torch.bfloat16, x, x) == 8
    assert cuda_kernels.vector_width("check_update", 100, torch.bfloat16, x) == 1
    assert cuda_kernels.vector_width("check_update", 9, torch.bfloat16, x) == 1
    assert cuda_kernels.vector_width("check_update", 64, torch.bfloat16, x, odd) == 1
    assert set(asked) == {("check_update_bfloat16", "check_update_vector_width"),
                          ("check_update_bfloat16", "variable_update_vector_width")}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("which", ["regular", "ragged", "qc", "dc12", "qc15"],
                         ids=["regular", "irregular", "qc", "dc12", "qc15"])
def test_variable_update_and_syndrome_flag_match_jax_after_check(which, dtype):
    """``variable_update_plain`` gives the totals and decisions of the JAX
    decoder's ``after_check``, and the ``ok`` that the next check update
    returns for those totals is its decision-syndrome flag: all exact.  The
    inactive frames keep their z and count."""
    jc, tc = code_pair(which)
    if which == "ragged":  # padded slots on both sides
        assert not tc.var_mask.all() and not tc.chk_mask.all()
    else:
        assert tc.var_mask.all()
    rng = np.random.default_rng(31)
    Bv = 6
    scale = 0.25 if dtype == "int8" else None
    dc, M, N = tc.dc_max, tc.n_checks, tc.n_vars
    lr = cuda_kernels._store(
        torch.from_numpy((1.5 * rng.standard_normal((dc, M, Bv))).astype(np.float32)),
        TORCH[dtype], scale)
    lr = lr * torch.from_numpy(np.ascontiguousarray(tc.chk_mask.T))[:, :, None].to(lr.dtype)
    llr = (2.0 * rng.standard_normal((N, Bv))).astype(np.float32)
    # frame 0's target is the syndrome of its own decisions: ok must be True there
    core = jbp._DecodeCore(
        jc, jbp.DecodeOptions(message_dtype=dtype, routing="gather"), jnp.float32, Bv)
    j_lr = _to_jax(lr, dtype)
    _, z_j, _ = core.after_check(j_lr, jnp.asarray(llr), jnp.zeros((M, Bv), jnp.int32))
    syn = (rng.random((M, Bv)) < 0.5).astype(np.int32)
    H = tc.dense.astype(np.int32)
    syn[:, 0] = (H @ np.asarray(z_j)[:, 0].astype(np.int32)) & 1
    tot_chk_j, z_j, ok_j = core.after_check(j_lr, jnp.asarray(llr), jnp.asarray(syn))
    assert bool(ok_j[0]) and not bool(ok_j.all())

    maps = tc.to_device("cpu")
    z0 = torch.full((N, Bv), 7, dtype=torch.int8)
    count0 = torch.arange(Bv, dtype=torch.int32)
    active = torch.tensor([True, True, False, True, False, True])
    total, z, count, ok0 = cuda_kernels.variable_update_plain(
        lr, torch.from_numpy(llr), z0, count0, active, maps, scale=scale)
    assert ok0.dtype == torch.bool and ok0.all() and ok0.shape == (Bv,)
    assert total.dtype == TORCH[dtype] and total.shape == (N, Bv)
    np.testing.assert_array_equal(
        _values(np.asarray(tot_chk_j), None),
        _values(cuda_kernels._gathered(total, maps).to(torch.float32).numpy(), None))
    np.testing.assert_array_equal(np.asarray(z_j)[:, active.numpy()],
                                  z.numpy()[:, active.numpy()])
    assert (z[:, ~active] == 7).all()
    assert count.tolist() == [1, 2, 2, 4, 4, 6]
    kw = dict(threshold=100.0, clip=True, algorithm="min-sum", min_sum_alpha=0.8,
              min_sum_beta=0.0, scale=scale)
    _, ok = cuda_kernels.check_update_fused(
        total, lr, torch.from_numpy(syn.astype(np.int8)), maps, ok=ok0, **kw)
    np.testing.assert_array_equal(np.asarray(ok_j), ok.numpy())
