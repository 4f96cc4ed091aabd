"""The port's host oracle, console tracer and interactive mode against the
JAX package's: the same oracle results and trace arrays, and the same
printed lines for every trace flag, with and without traces."""

import numpy as np
import pytest

from qkd_ldpc_tpu import codes as jcodes
from qkd_ldpc_tpu import config as jconfig
from qkd_ldpc_tpu.decoder import oracle as joracle
from qkd_ldpc_tpu.sim import interactive as jinteractive
from qkd_ldpc_tpu.sim import tracing as jtracing
from qkd_ldpc_tpu_torch import codes as tcodes
from qkd_ldpc_tpu_torch import config as tconfig
from qkd_ldpc_tpu_torch.decoder import oracle as toracle
from qkd_ldpc_tpu_torch.sim import interactive as tinteractive
from qkd_ldpc_tpu_torch.sim import tracing as ttracing
from tests import fixtures
from tests._torch_port_common import code_pair, make_frames


def _frames(which):
    """(JAX code, port code, alice, bob, qber) of one frame."""
    if which == "johnson":
        H = np.array(fixtures.H_JOHNSON)
        return (jcodes.from_dense(H), tcodes.from_dense(H), np.array(fixtures.JOHNSON_ALICE),
                np.array(fixtures.JOHNSON_BOB), fixtures.JOHNSON_QBER)
    jc, tc = code_pair(which)
    alice, bob = make_frames(jc.n_vars, 1, 6, seed=11)
    return jc, tc, alice[0], bob[0], 6 / jc.n_vars


@pytest.mark.parametrize("which", ["johnson", "irregular", "ragged"])
def test_oracle_results_and_trace_arrays_are_the_jax_packages(which):
    jc, tc, alice, bob, q = _frames(which)
    seen = {"jax": [], "torch": []}
    j = joracle.oracle_reconcile(jc, alice, bob, q, max_iterations=30,
                                 trace=lambda t, a: seen["jax"].append((t, np.copy(a))))
    t = toracle.oracle_reconcile(tc, alice, bob, q, max_iterations=30,
                                 trace=lambda t, a: seen["torch"].append((t, np.copy(a))))
    assert t[1] == j[1]
    np.testing.assert_array_equal(t[0].bits, j[0].bits)
    assert (t[0].iterations, t[0].syndromes_match, t[0].max_abs_llr) == (
        j[0].iterations, j[0].syndromes_match, j[0].max_abs_llr)
    assert [tag for tag, _ in seen["torch"]] == [tag for tag, _ in seen["jax"]]
    for (tag, a), (_, b) in zip(seen["torch"], seen["jax"]):
        np.testing.assert_array_equal(a, b, err_msg=tag)
    np.testing.assert_array_equal(toracle.oracle_syndrome(tc, bob),
                                  joracle.oracle_syndrome(jc, bob))


@pytest.mark.parametrize("flags", [(True, True, True), (True, False, False),
                                   (False, True, False), (False, False, True),
                                   (False, False, False)],
                         ids=["all", "qkd_ldpc", "sum_product", "llr", "none"])
def test_console_traces_are_the_jax_packages(flags):
    for which in ("johnson", "ragged"):
        jc, tc, alice, bob, q = _frames(which)
        out = {"jax": [], "torch": []}
        j = jtracing.traced_reconcile(jc, alice, bob, q, flags=jtracing.TraceFlags(*flags),
                                      print_fn=out["jax"].append, max_iterations=20)
        t = ttracing.traced_reconcile(tc, alice, bob, q, flags=ttracing.TraceFlags(*flags),
                                      print_fn=out["torch"].append, max_iterations=20)
        assert out["torch"] == out["jax"]
        assert t[1] == j[1]
        assert bool(out["torch"]) == any(flags)


@pytest.mark.parametrize("traced", [False, True], ids=["untraced", "traced"])
def test_interactive_lines_are_the_jax_packages(tmp_path, traced):
    jc, tc = code_pair("irregular")
    tcodes.write_alist(tc, tmp_path / "b_irregular.alist")
    tcodes.write_dense(code_pair("regular")[1], tmp_path / "a_regular.txt")
    kw = dict(trials_number=1, simulation_seed=3, trace_qkd_ldpc=traced,
              trace_sum_product=traced, trace_sum_product_llr=traced,
              sum_product_max_iterations=40)
    row = (0.58, 0.02, 0.05, 0.01)
    jcfg = jconfig.Config(r_qber_parameters=(jconfig.RQBERParams(*row),), **kw).validate()
    tcfg = tconfig.Config(r_qber_parameters=(tconfig.RQBERParams(*row),), **kw).validate()
    answers = iter(["x", "9", "2"])  # two invalid choices, then the alist
    jlines, tlines = [], []
    jinteractive.interactive_simulation(jcfg, tmp_path, input_fn=lambda _: "2",
                                        print_fn=jlines.append)
    tinteractive.interactive_simulation(tcfg, tmp_path, input_fn=lambda _: next(answers),
                                        print_fn=tlines.append, device="cpu")
    invalid = ["Invalid selection. Try again."] * 2
    assert tlines[:3] + tlines[3 + 2:] == jlines
    assert tlines[3:5] == invalid
    assert sum(x.startswith("Error reconciliation") for x in tlines) == 3
    assert ("Iteration: 1" in tlines) == traced
