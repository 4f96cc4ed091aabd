"""The port's sweep runner against the JAX package's: experiment fingerprint
and checkpoint file, CSV rows byte for byte, resuming the JAX package's
checkpoint, and the two schedule-only options (continuation crossover,
compaction) that must not change a row."""

import dataclasses

import numpy as np
import pytest

from qkd_ldpc_tpu import codes as jcodes
from qkd_ldpc_tpu import config as jconfig
from qkd_ldpc_tpu.sim import csv_writer as jcsv
from qkd_ldpc_tpu.sim import runner as jrunner
from qkd_ldpc_tpu_torch import codes as tcodes
from qkd_ldpc_tpu_torch import config as tconfig
from qkd_ldpc_tpu_torch.sim import csv_writer as tcsv
from qkd_ldpc_tpu_torch.sim import runner as trunner
from tests import fixtures

# Three points of a rate-0.49 code at N = 512: 15, 17 and 20 flips, QBERs at
# which the two packages' float32 a-priori LLRs agree (ROADMAP.md C), and
# where no sum-product frame of these trials sits on a +-1-iteration boundary.
ROW = (0.58, 0.03, 0.045, 0.005)
_codes = {}


def _code_pair():
    if not _codes:
        kw = dict(n=512, m=262, dv=3, seed=7, name="n512")
        _codes["pair"] = (jcodes.make_code(**kw), tcodes.make_code(**kw))
    return _codes["pair"]


def _configs(**kw):
    base = dict(trials_number=32, simulation_seed=777, sum_product_max_iterations=60,
                use_mesh=False)
    base.update(kw)
    return (jconfig.Config(r_qber_parameters=(jconfig.RQBERParams(*ROW),), **base).validate(),
            tconfig.Config(r_qber_parameters=(tconfig.RQBERParams(*ROW),), **base).validate())


def _inputs(jcfg, tcfg, codes=None):
    jc, tc = codes or _code_pair()
    from qkd_ldpc_tpu.sim.planner import rate_based_qber_range as jplan
    from qkd_ldpc_tpu_torch.sim.planner import rate_based_qber_range as tplan

    return ([jrunner.SimInput(jc, "n512.alist", jplan(jc.code_rate, jcfg.r_qber_parameters))],
            [trunner.SimInput(tc, "n512.alist", tplan(tc.code_rate, tcfg.r_qber_parameters))])


@pytest.mark.parametrize("variant", [
    {}, {"prng": "pallas"}, {"dtype": "bfloat16", "backend": "xla"},
    {"decoder": "min-sum", "min_sum_alpha": 0.75}, {"compact_after": 4},
    {"enable_sum_product_msg_llr_threshold": False},
])
def test_fingerprint_and_checkpoint_path_are_the_jax_packages(tmp_path, variant):
    jcfg, tcfg = _configs(checkpoint_dir=str(tmp_path), **variant)
    jin, tin = _inputs(jcfg, tcfg)
    assert trunner._experiment_fingerprint(tin, tcfg) == jrunner._experiment_fingerprint(jin, jcfg)
    assert trunner._checkpoint_path(tcfg, tin) == jrunner._checkpoint_path(jcfg, jin)
    assert trunner.auto_batch_size(tcfg, tin[0].code) == jrunner.auto_batch_size(jcfg, jin[0].code)


def test_layered_fingerprint_is_the_jax_packages(tmp_path):
    kw = dict(z=32, nb=12, mb=6, dv=3, seed=5)
    pair = (jcodes.make_qc_code(**kw), tcodes.make_qc_code(**kw))
    jcfg, tcfg = _configs(checkpoint_dir=str(tmp_path), schedule="layered")
    jin, tin = _inputs(jcfg, tcfg, pair)
    assert trunner._checkpoint_path(tcfg, tin) == jrunner._checkpoint_path(jcfg, jin)
    flooding = _configs(checkpoint_dir=str(tmp_path))[1]
    assert trunner._checkpoint_path(flooding, tin) != trunner._checkpoint_path(tcfg, tin)


SWEEPS = {
    "min-sum-float32": dict(decoder="min-sum", dtype="float32"),
    "min-sum-bfloat16": dict(decoder="min-sum", dtype="bfloat16"),
    "sum-product-float32": dict(decoder="sum-product", dtype="float32"),
}


@pytest.mark.parametrize("name", sorted(SWEEPS))
def test_sweep_rows_and_checkpoint_are_the_jax_packages(tmp_path, name, monkeypatch):
    jcfg, tcfg = _configs(checkpoint_dir=str(tmp_path / "jax"), **SWEEPS[name])
    jin, tin = _inputs(jcfg, tcfg)
    want = jrunner.batch_simulation(jin, jcfg, progress=False)
    got = trunner.batch_simulation(
        tin, dataclasses.replace(tcfg, checkpoint_dir=str(tmp_path / "torch")),
        progress=False, device="cpu")
    assert tcsv.format_rows(got) == jcsv.format_rows(want)
    assert len(got) == 3 and got[0].ratio_trials_successful_ldpc == 1.0
    (j_ckpt,) = (tmp_path / "jax").iterdir()
    (t_ckpt,) = (tmp_path / "torch").iterdir()
    assert t_ckpt.name == j_ckpt.name
    assert t_ckpt.read_bytes() == j_ckpt.read_bytes()

    # The port resumes the JAX package's checkpoint without decoding anything.
    def no_decode(*args, **kwargs):
        raise AssertionError("a checkpointed point was decoded again")

    monkeypatch.setattr(trunner, "_dispatch_point", no_decode)
    resumed = trunner.batch_simulation(tin, tcfg, progress=False, device="cpu")
    assert [dataclasses.asdict(r) for r in resumed] == [
        dataclasses.asdict(r) for r in want]
    assert j_ckpt.read_bytes() == t_ckpt.read_bytes()  # nothing appended


@pytest.mark.parametrize("option", [
    dict(continuation_qber=0.035), dict(continuation_qber=0.01), dict(compact_after=2),
])
def test_schedule_only_options_do_not_change_rows(option):
    _, plain = _configs(decoder="min-sum")
    _, tin = _inputs(*_configs(decoder="min-sum"))
    want = trunner.batch_simulation(tin, plain, progress=False, device="cpu")
    got = trunner.batch_simulation(tin, dataclasses.replace(plain, **option),
                                   progress=False, device="cpu")
    assert tcsv.format_rows(got) == tcsv.format_rows(want)


def test_too_small_a_key_raises_the_jax_packages_error():
    H = jcodes.from_dense(np.array(fixtures.H_JOHNSON))
    T = tcodes.from_dense(np.array(fixtures.H_JOHNSON))
    row = (0.5, 0.05, 0.15, 0.05)
    jcfg = jconfig.Config(r_qber_parameters=(jconfig.RQBERParams(*row),), trials_number=4,
                          use_mesh=False).validate()
    tcfg = tconfig.Config(r_qber_parameters=(tconfig.RQBERParams(*row),),
                          trials_number=4).validate()
    with pytest.raises(ValueError) as j:
        jrunner.batch_simulation([jrunner.SimInput(H, "j", [0.05])], jcfg, progress=False)
    with pytest.raises(ValueError) as t:
        trunner.batch_simulation([trunner.SimInput(T, "j", [0.05])], tcfg, progress=False,
                                 device="cpu")
    assert str(t.value) == str(j.value) == "Key size '6' is too small for QBER."
    # the continuation crossover refuses the same point with the same text
    with pytest.raises(ValueError, match=str(j.value)):
        trunner.batch_simulation(
            [trunner.SimInput(T, "j", [0.05])],
            dataclasses.replace(tcfg, continuation_qber=0.01), progress=False, device="cpu")


def test_layered_sweep_of_a_plain_code_raises_before_any_point(monkeypatch):
    from qkd_ldpc_tpu_torch.decoder.layered import NOT_QC_MESSAGE

    _, tcfg = _configs(schedule="layered")
    _, tin = _inputs(*_configs())
    monkeypatch.setattr(trunner, "_dispatch_point", lambda *a, **k: 1 / 0)
    with pytest.raises(ValueError, match="requires a QC code") as e:
        trunner.batch_simulation(tin, tcfg, progress=False, device="cpu")
    assert str(e.value) == NOT_QC_MESSAGE


def test_prepare_sim_inputs_is_the_jax_packages(tmp_path):
    """Ingest in a thread pool (``threads_number`` > 1) gives the sequential
    result, equal to the JAX package's: files, graphs, planned QBERs."""
    tcodes.write_alist(_code_pair()[1], tmp_path / "b.alist")
    tcodes.write_alist(tcodes.make_code(n=128, m=65, dv=3, seed=3), tmp_path / "a.alist")
    paths = sorted(tmp_path.iterdir())
    jcfg, tcfg = _configs(threads_number=4)
    want = [(s.matrix_filename, s.qber, s.code.fingerprint)
            for s in jrunner.prepare_sim_inputs(paths, jcfg)]
    for cfg in (tcfg, dataclasses.replace(tcfg, threads_number=1)):
        got = trunner.prepare_sim_inputs(paths, cfg)
        assert [(s.matrix_filename, s.qber, s.code.fingerprint) for s in got] == want


def test_one_point_in_flight_dispatches_before_it_collects(monkeypatch):
    """Point p+1 is dispatched before point p is collected (the JAX
    package's window of one), and the collection order is the point order."""
    _, tcfg = _configs(decoder="min-sum")
    _, tin = _inputs(*_configs(decoder="min-sum"))
    events = []
    real_dispatch, real_collect = trunner._dispatch_point, trunner._collect_point

    def dispatch(code, point_key, qber, *a, **k):
        events.append(("dispatch", qber))
        futures, aq = real_dispatch(code, point_key, qber, *a, **k)
        for f in futures:
            f.qber = qber
        return futures, aq

    def collect(futures):
        events.append(("collect", futures[0].qber))
        return real_collect(futures)

    monkeypatch.setattr(trunner, "_dispatch_point", dispatch)
    monkeypatch.setattr(trunner, "_collect_point", collect)
    trunner.batch_simulation(tin, tcfg, progress=False, device="cpu")
    q = tin[0].qber
    want = [("dispatch", q[0])]
    for prev, nxt in zip(q, q[1:]):
        want += [("dispatch", nxt), ("collect", prev)]
    assert events == want + [("collect", q[-1])]


@pytest.mark.parametrize("crossover", [0.0, 0.04], ids=["plain", "continuation"])
def test_pipelined_sweep_of_two_matrices_is_byte_equal_to_jax(tmp_path, crossover):
    """Two matrices, plain and continuation points sharing the window: the
    CSV rows, the checkpoint bytes and the progress ticks are the JAX
    package's; a resumed run dispatches nothing."""
    kw = dict(decoder="min-sum", continuation_qber=crossover)
    jcfg, tcfg = _configs(checkpoint_dir=str(tmp_path / "jax"), **kw)
    jin, tin = _inputs(jcfg, tcfg)
    jin, tin = jin + [dataclasses.replace(jin[0], matrix_filename="b.alist")], \
        tin + [dataclasses.replace(tin[0], matrix_filename="b.alist")]
    ticks = {"jax": [], "torch": []}

    def bar(name, real):
        class Bar(real):
            def tick(self, n):
                ticks[name].append(n)
                return super().tick(n)
        return Bar

    with pytest.MonkeyPatch.context() as m:
        m.setattr(jrunner, "ProgressBar", bar("jax", jrunner.ProgressBar))
        m.setattr(trunner, "ProgressBar", bar("torch", trunner.ProgressBar))
        want = jrunner.batch_simulation(jin, jcfg, progress=False)
        got = trunner.batch_simulation(
            tin, dataclasses.replace(tcfg, checkpoint_dir=str(tmp_path / "torch")),
            progress=False, device="cpu")
    assert tcsv.format_rows(got) == jcsv.format_rows(want)
    assert ticks["torch"] == ticks["jax"] and len(ticks["torch"]) == len(got)
    (j_ckpt,) = (tmp_path / "jax").iterdir()
    (t_ckpt,) = (tmp_path / "torch").iterdir()
    assert t_ckpt.read_bytes() == j_ckpt.read_bytes()

    def no_dispatch(*args, **kwargs):
        raise AssertionError("a checkpointed point was dispatched again")

    with pytest.MonkeyPatch.context() as m:
        m.setattr(trunner, "_dispatch_point", no_dispatch)
        from qkd_ldpc_tpu_torch.sim import continuation

        m.setattr(continuation, "dispatch_sweep_continuation", no_dispatch)
        resumed = trunner.batch_simulation(
            tin, dataclasses.replace(tcfg, checkpoint_dir=str(tmp_path / "torch")),
            progress=False, device="cpu")
    assert tcsv.format_rows(resumed) == tcsv.format_rows(got)
    assert t_ckpt.read_bytes() == j_ckpt.read_bytes()
