"""The port's config loader and QBER planner against the JAX package's: the
same fields from the same JSON, the same validation messages, the same sweep
points (C++ rounding of the step count included)."""

import dataclasses
import json
from pathlib import Path

import pytest

from qkd_ldpc_tpu import config as jconfig
from qkd_ldpc_tpu.sim import planner as jplanner
from qkd_ldpc_tpu_torch import config as tconfig
from qkd_ldpc_tpu_torch.sim import planner as tplanner

CONFIGS = sorted((Path(__file__).parent.parent / "configs").glob("*.json"))


def _raw(**overrides):
    raw = {
        "threads_number": 16,
        "trials_number": 5000,
        "use_config_simulation_seed": True,
        "simulation_seed": 777,
        "sum_product_max_iterations": 100,
        "code_rate_QBER_parameters": [
            {"code_rate": 0.95, "QBER_begin": 0.005, "QBER_end": 0.05, "QBER_step": 0.0005},
            {"code_rate": 0.36, "QBER_begin": 0.12, "QBER_end": 0.135, "QBER_step": 0.0005},
            {"code_rate": 0.58, "QBER_begin": 0.06, "QBER_end": 0.075, "QBER_step": 0.0005},
        ],
    }
    raw.update(overrides)
    return raw


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.name)
def test_repo_configs_load_to_equal_fields(path, monkeypatch):
    # config.quick.json takes its seed from the clock: pin it on both sides.
    monkeypatch.setattr(jconfig.time, "time", lambda: 1234.5)
    monkeypatch.setattr(tconfig.time, "time", lambda: 1234.5)
    j, t = jconfig.load_config(path), tconfig.load_config(path)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    raw = json.loads(path.read_text())
    assert dataclasses.asdict(tconfig.config_from_dict(raw)) == dataclasses.asdict(
        jconfig.config_from_dict(raw))
    assert [p.code_rate for p in t.r_qber_parameters] == sorted(
        p.code_rate for p in t.r_qber_parameters)


def _row(rate=0.5, begin=0.1, end=0.2, step=0.01):
    return [{"code_rate": rate, "QBER_begin": begin, "QBER_end": end, "QBER_step": step}]


INVALID = {
    "empty": {},
    "threads": _raw(threads_number=0),
    "trials": _raw(trials_number=0),
    "iterations": _raw(sum_product_max_iterations=0),
    "threshold": _raw(sum_product_msg_llr_threshold=0.0),
    "table_empty": _raw(code_rate_QBER_parameters=[]),
    "rate": _raw(code_rate_QBER_parameters=_row(rate=1.5)),
    "begin_end": _raw(code_rate_QBER_parameters=_row(begin=0.2, end=0.1)),
    "step_sign": _raw(code_rate_QBER_parameters=_row(step=-1.0)),
    "step_large": _raw(code_rate_QBER_parameters=_row(step=0.5)),
    "decoder": _raw(decoder="bogus"),
    "batch": _raw(batch_size=-1),
    "continuation": _raw(continuation_qber=1.0),
    "dtype": _raw(dtype="float16"),
    "backend": _raw(backend="triton"),
    "prng": _raw(prng="philox"),
    "compact": _raw(compact_after=-1),
    "schedule": _raw(schedule="serial"),
    "layered_continuation": _raw(schedule="layered", continuation_qber=0.07),
    "missing_key": {k: v for k, v in _raw().items() if k != "trials_number"},
}


@pytest.mark.parametrize("name", sorted(INVALID))
def test_validation_errors_are_the_jax_packages(name):
    raw = INVALID[name]
    with pytest.raises((ValueError, KeyError)) as j:
        jconfig.config_from_dict(raw)
    with pytest.raises(j.type) as t:
        tconfig.config_from_dict(raw)
    assert str(t.value) == str(j.value)


@pytest.mark.parametrize("text", ["", "{}"], ids=["empty_file", "empty_object"])
def test_load_errors_are_the_jax_packages(tmp_path, text):
    missing = tmp_path / "nope.json"
    with pytest.raises(FileNotFoundError) as j:
        jconfig.load_config(missing)
    with pytest.raises(FileNotFoundError) as t:
        tconfig.load_config(missing)
    assert str(t.value) == str(j.value)
    path = tmp_path / "config.json"
    path.write_text(text)
    with pytest.raises(ValueError) as j:
        jconfig.load_config(path)
    with pytest.raises(ValueError) as t:
        tconfig.load_config(path)
    assert str(t.value) == str(j.value)


# The JAX tests' table (tests/test_sim.py) and rows where (end - begin)/step
# sits at .5 or within an ulp of an integer: C++ round() is half away from
# zero, Python's round() would go to even.
TABLES = {
    "jax_tests": [(0.36, 0.12, 0.135, 0.0005), (0.58, 0.06, 0.075, 0.0005),
                  (0.95, 0.005, 0.05, 0.0005)],
    "half_steps": [(0.3, 0.1, 0.2, 0.04), (0.6, 0.1, 0.15, 0.02), (0.9, 0.01, 0.035, 0.01)],
    "near_integers": [(0.4, 0.03, 0.095, 0.005), (0.7, 0.005, 0.03, 0.0025),
                      (0.8, 0.1, 0.3, 0.1)],
}


@pytest.mark.parametrize("table", sorted(TABLES))
def test_rate_based_qber_range_is_the_jax_packages(table):
    jt = tuple(jconfig.RQBERParams(*r) for r in TABLES[table])
    tt = tuple(tconfig.RQBERParams(*r) for r in TABLES[table])
    for rate in (0.05, 0.3, 0.36, 0.489, 0.5, 0.58, 0.6, 0.75, 0.9, 0.95, 0.99):
        try:
            want = jplanner.rate_based_qber_range(rate, jt)
        except ValueError as e:
            with pytest.raises(ValueError, match=str(e)):
                tplanner.rate_based_qber_range(rate, tt)
            continue
        assert tplanner.rate_based_qber_range(rate, tt) == want
    # round(2.5) = 3 points in C++, where Python's round would give 2
    assert len(tplanner.rate_based_qber_range(
        0.3, (tconfig.RQBERParams(0.3, 0.1, 0.2, 0.04),))) == 3
