"""The port's trial mesh (``parallel/mesh.py``), sharded point and sweep
runners (``parallel/sweep.py``), sharded continuation and
``partials_from_device``.

The JAX package runs on its 8-device virtual CPU mesh (tests/conftest.py);
the port on ``[torch.device("cpu")] * k``.  Sharded runs must give the seven
partial sums of the port's single-device runner and of the JAX package's
sharded runner, bit for bit — the cases of tests/test_sharding.py and
tests/test_continuation.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qkd_ldpc_tpu import codes as jcodes
from qkd_ldpc_tpu.decoder import DecodeOptions as JaxDecodeOptions
from qkd_ldpc_tpu.parallel import make_trial_mesh as j_make_trial_mesh
from qkd_ldpc_tpu.parallel import run_point_sharded as j_run_point_sharded
from qkd_ldpc_tpu.sim.continuation import (
    run_point_continuation_sharded as j_run_point_continuation_sharded,
)
from qkd_ldpc_tpu.sim.stats import partials_from_device as j_partials_from_device
from qkd_ldpc_tpu.sim.stats import reduce_trials as j_reduce_trials
from qkd_ldpc_tpu_torch import codes as tcodes
from qkd_ldpc_tpu_torch.channel.threefry import fold_in, prng_key
from qkd_ldpc_tpu_torch.decoder.bp import DecodeOptions
from qkd_ldpc_tpu_torch.parallel import (
    TRIAL_AXIS,
    make_mesh,
    make_point_dispatcher,
    make_trial_mesh,
    replicated,
    run_point_sharded,
    run_sweep_sharded,
    trial_sharding,
)
from qkd_ldpc_tpu_torch.parallel.sweep import _check_int32_stats_bound, _collect
from qkd_ldpc_tpu_torch.sim import dispatch_sweep_continuation, run_point
from qkd_ldpc_tpu_torch.sim.continuation import (
    run_point_continuation,
    run_point_continuation_sharded,
)
from qkd_ldpc_tpu_torch.sim.stats import (
    PointPartials,
    partials_from_device,
    partials_from_stacked,
    reduce_trials,
)

torch.set_num_threads(1)
CPU = torch.device("cpu")
MEDIUM = dict(n=512, m=262, dv=3, seed=7, name="n512")
WF = dict(n=1024, m=523, dv=3, seed=3, name="wf-1024")
_codes = {}


def pair(spec):
    key = spec["name"]
    if key not in _codes:
        _codes[key] = (jcodes.make_code(**spec), tcodes.make_code(**spec))
    return _codes[key]


def seven(p):
    return dataclasses.astuple(p)


def cpu_mesh(k=8):
    return make_trial_mesh([CPU] * k)


# ---------------------------------------------------------------------------
# The mesh


def test_trial_mesh_shape():
    mesh = cpu_mesh()
    assert mesh.shape == {TRIAL_AXIS: 8} and mesh.axis_names == (TRIAL_AXIS,)
    assert mesh.devices.shape == (8, 1) and mesh.process_count == 1
    mesh2 = make_mesh(n_trial=4, n_node=2, devices=[CPU] * 8)
    assert mesh2.shape == {"trial": 4, "node": 2} and mesh2.devices.shape == (4, 2)
    assert make_mesh(n_node=4, devices=[CPU] * 8).shape == {"trial": 2, "node": 4}
    # JAX's mesh of the same factors
    assert dict(j_make_trial_mesh().shape) == {"trial": 8}


def test_make_mesh_raises_the_jax_errors():
    with pytest.raises(ValueError, match="n_node=3 does not divide device count 8"):
        make_mesh(n_node=3, devices=[CPU] * 8)
    with pytest.raises(ValueError, match=r"3 x 2 != 8 devices"):
        make_mesh(n_trial=3, n_node=2, devices=[CPU] * 8)
    from qkd_ldpc_tpu.parallel import make_mesh as j_make_mesh

    for kw in (dict(n_node=3), dict(n_trial=3, n_node=2)):
        with pytest.raises(ValueError) as je:
            j_make_mesh(**kw)
        with pytest.raises(ValueError) as te:
            make_mesh(devices=[CPU] * 8, **kw)
        assert str(je.value) == str(te.value)


def test_the_default_mesh_is_every_card_and_raises_without_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_trial_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh(n_node=2)


def test_trial_sharding_and_replicated():
    mesh = make_mesh(n_trial=4, n_node=2, devices=[CPU] * 8)
    shards = trial_sharding(mesh, 12)
    assert [s.index for s in shards] == [0, 1, 2, 3]
    assert [s.lanes for s in shards] == [range(0, 3), range(3, 6), range(6, 9), range(9, 12)]
    assert all(s.devices == (CPU, CPU) and s.device == CPU for s in shards)
    assert replicated(mesh) == [CPU]
    with pytest.raises(ValueError, match="not a multiple"):
        trial_sharding(mesh, 10)


# ---------------------------------------------------------------------------
# The sharded point and sweep


@pytest.mark.parametrize("trials,batch,kw", [
    (64, 32, {}),
    (50, 24, {}),  # ragged tail, one chunk
    (37, 20, dict(algorithm="min-sum", message_dtype="bfloat16")),  # batch rounds to 24
], ids=["even", "ragged", "min-sum-bf16-rounded"])
def test_sharded_point_matches_single_device_and_jax(trials, batch, kw):
    jc, tc = pair(MEDIUM)
    opts = DecodeOptions(max_iterations=40, **kw)
    key = fold_in(prng_key(777), 1)
    p_one, q_one = run_point(tc, key, 0.03, trials, trials, opts, device="cpu")
    p_mesh, q_mesh = run_point_sharded(tc, key, 0.03, trials, batch, opts, cpu_mesh())
    pj, qj = j_run_point_sharded(
        jc, jax.random.fold_in(jax.random.PRNGKey(777), 1), 0.03, trials=trials,
        batch=batch, opts=JaxDecodeOptions(max_iterations=40, **kw), mesh=j_make_trial_mesh())
    assert q_one == q_mesh == qj
    assert seven(p_mesh) == seven(p_one) == seven(pj)
    assert p_mesh.n_trials == trials and p_mesh.n_sp > 0


@pytest.mark.parametrize("shards", [1, 3, 5])
def test_sharded_point_on_other_shard_counts(shards):
    _, tc = pair(MEDIUM)
    opts = DecodeOptions(max_iterations=40)
    key = fold_in(prng_key(3), 1)
    ref, _ = run_point(tc, key, 0.035, 23, 23, opts, device="cpu")
    got, _ = run_point_sharded(tc, key, 0.035, 23, 7, opts, cpu_mesh(shards))
    assert seven(got) == seven(ref)


def test_point_dispatcher_chunks_and_collect():
    """``batch`` is per device; chunks respect the dispatch cap; the futures
    merge to the single-device partials."""
    _, tc = pair(MEDIUM)
    opts = DecodeOptions(max_iterations=40)
    mesh = cpu_mesh(4)
    key = fold_in(prng_key(5), 0)
    ref, _ = run_point(tc, key, 0.03, 160, 16, opts, device="cpu")
    dispatch = make_point_dispatcher(tc, 4, opts, mesh)  # global batch 16
    futures, aq = dispatch(key, 0.03, 160)
    assert len(futures) == 1 and len(futures[0]) == 4  # one chunk of 10 batches
    assert seven(_collect(futures, mesh)) == seven(ref) and aq == 15 / 512
    capped = make_point_dispatcher(tc, 4, opts, mesh, max_batches_per_dispatch=4)
    futures, _ = capped(key, 0.03, 160)
    assert len(futures) == 3  # ceil(10 / 4)
    assert seven(_collect(futures, mesh)) == seven(ref)
    with pytest.raises(ValueError, match="too small for QBER"):
        dispatch(key, 0.001, 8)


def test_sharded_sweep_matches_per_point():
    _, tc = pair(MEDIUM)
    opts = DecodeOptions(max_iterations=40)
    qbers = [0.03, 0.035, 0.04]
    ticks = []
    swept = run_sweep_sharded(tc, prng_key(777), qbers, 40, 16, opts, cpu_mesh(),
                              tick=ticks.append)
    assert len(swept) == 3 and ticks == [40, 40, 40]
    for i, (p, q) in enumerate(swept):
        ref, q_ref = run_point(tc, fold_in(prng_key(777), i), qbers[i], 40, 40, opts,
                               device="cpu")
        assert q == q_ref and seven(p) == seven(ref)


def test_sharded_int32_stats_guard():
    _, tc = pair(MEDIUM)
    opts = DecodeOptions(max_iterations=100_000)
    with pytest.raises(ValueError, match="overflows the int32"):
        run_point_sharded(tc, prng_key(0), 0.03, 8, 8 * 215, opts, cpu_mesh())
    assert _check_int32_stats_bound(512, DecodeOptions(max_iterations=100)) == 419
    from qkd_ldpc_tpu.parallel.sweep import _check_int32_stats_bound as j_bound

    assert j_bound(512, JaxDecodeOptions(max_iterations=100)) == 419


def test_layered_on_the_trial_mesh():
    """Layered sweeps (+ compaction within each shard's lanes) on the trial
    mesh: the single-device partials, and the JAX package's (min-sum)."""
    spec = dict(z=16, nb=16, mb=8, dv=3, seed=4)
    jc, tc = jcodes.make_qc_code(**spec), tcodes.make_qc_code(**spec)
    kw = dict(max_iterations=32, schedule="layered", message_dtype="bfloat16",
              compact_after=2, compact_lanes=2)
    for alg in ("sum-product", "min-sum"):
        opts = DecodeOptions(algorithm=alg, **kw)
        ref, _ = run_point(tc, prng_key(777), 0.03, 16, 16, opts, device="cpu")
        got, _ = run_point_sharded(tc, prng_key(777), 0.03, 16, 16, opts, cpu_mesh())
        assert seven(got) == seven(ref) and got.n_sp > 0
    pj, _ = j_run_point_sharded(jc, jax.random.PRNGKey(777), 0.03, trials=16, batch=16,
                                opts=JaxDecodeOptions(algorithm="min-sum", **kw),
                                mesh=j_make_trial_mesh())
    assert seven(pj) == seven(got)


# ---------------------------------------------------------------------------
# Sharded continuation (tests/test_continuation.py:143-185)


def test_sharded_continuation_matches_plain():
    jc, tc = pair(WF)
    opts = DecodeOptions(max_iterations=30)
    key = fold_in(prng_key(777), 7)
    p1, q1 = run_point(tc, key, 0.075, 70, 70, opts, device="cpu")
    p2, q2 = run_point_continuation(tc, key, 0.075, 70, 16, opts, segment=3, device="cpu")
    p3, q3 = run_point_continuation_sharded(tc, key, 0.075, 70, 8, opts, cpu_mesh(),
                                            segment=3)
    pj, qj = j_run_point_continuation_sharded(
        jc, jax.random.fold_in(jax.random.PRNGKey(777), 7), 0.075, trials=70, batch=8,
        opts=JaxDecodeOptions(max_iterations=30), mesh=j_make_trial_mesh(), segment=3)
    assert q1 == q2 == q3 == qj
    assert seven(p1) == seven(p2) == seven(p3) == seven(pj)
    assert p3.n_trials == 70 and 0 < p3.n_sp < 70


def test_sharded_continuation_uneven_split():
    """13 trials over 8 shards: shards of 2 and of 1 trial, fewer trials
    than lanes."""
    _, tc = pair(WF)
    opts = DecodeOptions(max_iterations=25, message_dtype="bfloat16")
    key = fold_in(prng_key(5), 3)
    p1, _ = run_point(tc, key, 0.06, 13, 13, opts, device="cpu")
    p2, _ = run_point_continuation_sharded(tc, key, 0.06, 13, 4, opts, cpu_mesh(),
                                           segment=2)
    assert seven(p1) == seven(p2)


def test_sharded_continuation_more_shards_than_trials():
    _, tc = pair(WF)
    opts = DecodeOptions(max_iterations=25, algorithm="min-sum")
    key = fold_in(prng_key(6), 0)
    p1, _ = run_point(tc, key, 0.06, 5, 5, opts, device="cpu")
    p2, _ = run_point_continuation_sharded(tc, key, 0.06, 5, 4, opts, cpu_mesh(), segment=2)
    assert seven(p1) == seven(p2) and p2.n_trials == 5


def test_sharded_cross_point_continuation_matches_plain():
    """Several waterfall points as one continuation on each shard (the
    mesh branch of ``dispatch_sweep_continuation``)."""
    _, tc = pair(WF)
    opts = DecodeOptions(max_iterations=30)
    qbers = [0.07, 0.075, 0.078]
    keys = [fold_in(prng_key(777), i) for i in range(3)]
    futs, actuals = dispatch_sweep_continuation(tc, keys, qbers, 30, 4, opts,
                                                mesh=cpu_mesh(4), segment=3)
    for key, qber, fut, aq in zip(keys, qbers, futs, actuals):
        ref, q_ref = run_point(tc, key, qber, 30, 30, opts, device="cpu")
        p = PointPartials().merge(partials_from_stacked(fut[0].fetch()))
        assert aq == q_ref and seven(p) == seven(ref)


# ---------------------------------------------------------------------------
# partials_from_device


@pytest.mark.parametrize("any_success", [True, False])
def test_partials_from_device_equals_jax(any_success):
    rng = np.random.default_rng(4)
    ok = rng.random(12) < (0.7 if any_success else 0.0)
    keys = ok & (rng.random(12) < 0.9)
    iters = rng.integers(1, 30, 12).astype(np.int32)
    valid = np.arange(12) < 10
    pt = partials_from_device(
        reduce_trials(torch.from_numpy(ok), torch.from_numpy(keys),
                      torch.from_numpy(iters), 30, torch.from_numpy(valid)), 30)
    pj = j_partials_from_device(
        j_reduce_trials(jnp.asarray(ok), jnp.asarray(keys), jnp.asarray(iters), 30,
                        jnp.asarray(valid)), 30)
    assert seven(pt) == seven(pj)
    assert pt.n_trials == 10 and (pt.min_it == 30) != any_success
