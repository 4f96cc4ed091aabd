"""The port's command line against the JAX package's (the counterparts of
tests/test_cli.py): the same CSV bytes and console lines from the same
config, the same exit codes and files, and the port's own ``--device`` rule:
the card by default, an error without one."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from qkd_ldpc_tpu import cli as jcli
from qkd_ldpc_tpu.codes import make_code, write_dense
from qkd_ldpc_tpu_torch import cli as tcli

REPO = Path(__file__).parent.parent


@pytest.fixture
def workspace(tmp_path):
    (tmp_path / "dense_matrices").mkdir()
    write_dense(make_code(n=128, m=65, dv=3, seed=3), tmp_path / "dense_matrices" / "c128.txt")
    cfg = {
        "threads_number": 1,
        "trials_number": 16,
        "use_config_simulation_seed": True,
        "simulation_seed": 42,
        "sum_product_max_iterations": 100,
        "use_dense_matrices": True,
        "batch_size": 16,
        "code_rate_QBER_parameters": [
            {"code_rate": 0.58, "QBER_begin": 0.03, "QBER_end": 0.04, "QBER_step": 0.005}
        ],
    }
    (tmp_path / "config.json").write_text(json.dumps(cfg))
    return tmp_path


def _both(capsys, argv_jax, argv_torch):
    """Run both CLIs; returns ((rc, out, err) of JAX, of the port)."""
    runs = []
    for main, argv in ((jcli.main, argv_jax), (tcli.main, argv_torch)):
        rc = main(argv)
        cap = capsys.readouterr()
        runs.append((rc, cap.out, cap.err))
    return runs


def test_batch_run_writes_the_jax_packages_csv(workspace, capsys):
    cfg = str(workspace / "config.json")
    j, t = _both(capsys, ["--config", cfg, "--no-progress", "--results-dir",
                          str(workspace / "rj")],
                 ["--config", cfg, "--no-progress", "--results-dir",
                  str(workspace / "rt"), "--device", "cpu"])
    assert j[0] == t[0] == 0
    assert t[1].replace("/rt/", "/rj/") == j[1]
    assert "BATCH MODE" in t[1]
    (jcsv,), (tcsv,) = (list((workspace / d).iterdir()) for d in ("rj", "rt"))
    assert tcsv.name == jcsv.name
    assert tcsv.read_bytes() == jcsv.read_bytes()
    assert len(tcsv.read_text().splitlines()) == 3
    # config-file paths resolve against the config's directory
    assert tcli.main(["--config", cfg, "--no-progress", "--device", "cpu"]) == 0
    assert len(list((workspace / "results").iterdir())) == 1


def test_missing_config_exits_1_as_in_the_jax_package(tmp_path, capsys):
    cfg = str(tmp_path / "nope.json")
    j, t = _both(capsys, ["--config", cfg], ["--config", cfg, "--device", "cpu"])
    assert j[0] == t[0] == 1
    assert t[2] == j[2]
    assert t[2].startswith("ERROR: ")


def test_interactive_prints_the_jax_packages_lines(workspace, capsys, monkeypatch):
    monkeypatch.setattr("builtins.input", lambda _: "1")
    cfg = str(workspace / "config.json")
    j, t = _both(capsys, ["--config", cfg, "--interactive"],
                 ["--config", cfg, "--interactive", "--device", "cpu"])
    assert j[0] == t[0] == 0
    assert t[1] == j[1]
    assert "INTERACTIVE MODE" in t[1] and "Iterations performed" in t[1]


@pytest.mark.parametrize("extra", [[], ["--dense"], ["--qc", "64"]],
                         ids=["alist", "dense", "qc"])
def test_generate_writes_the_jax_packages_files(tmp_path, capsys, extra):
    args = ["generate", "--n", "512", "--m", "256", "--dv", "3", "--seed", "9"] + extra
    j, t = _both(capsys, args + ["-o", str(tmp_path / "j.out")],
                 args + ["-o", str(tmp_path / "t.out")])
    assert j[0] == t[0] == 0
    assert (tmp_path / "t.out").read_bytes() == (tmp_path / "j.out").read_bytes()
    sidecar = Path(str(tmp_path / "t.out") + ".qc.json")
    assert sidecar.exists() == bool(extra and extra[0] == "--qc")
    if sidecar.exists():
        assert sidecar.read_bytes() == Path(str(tmp_path / "j.out") + ".qc.json").read_bytes()
    bad = ["generate", "--n", "500", "--m", "256", "--qc", "64", "-o", str(tmp_path / "b")]
    j, t = _both(capsys, bad, bad)
    assert j[0] == t[0] == 1 and t[2] == j[2]


def test_the_default_device_is_the_card_and_fails_without_one(workspace, capsys,
                                                                monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tcli.main(["--config", str(workspace / "config.json"), "--no-progress"]) == 1
    assert "ERROR: no CUDA device" in capsys.readouterr().err
    assert not (workspace / "results").exists()
    # the module entry point, in a process that sees no card
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-m", "qkd_ldpc_tpu_torch", "--config",
                           str(workspace / "config.json")], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 1 and "ERROR: no CUDA device" in proc.stderr


@pytest.mark.parametrize("flag", [["--coordinator", "localhost:1234"],
                                  ["--num-processes", "2"], ["--process-id", "0"]])
def test_multi_process_flags_are_refused(workspace, capsys, flag):
    """One of the three multi-process flags alone is refused before any work
    (torch.distributed discovers no cluster; the full set is driven in
    tests/test_torch_distributed.py)."""
    rc = tcli.main(["--config", str(workspace / "config.json"), "--device", "cpu"] + flag)
    assert rc == 1
    assert tcli.MULTI_PROCESS_FLAGS in capsys.readouterr().err
    assert not (workspace / "results").exists()


def test_profile_writes_a_torch_profiler_trace(workspace, capsys):
    prof = workspace / "prof"
    rc = tcli.main(["--config", str(workspace / "config.json"), "--no-progress",
                    "--device", "cpu", "--profile", str(prof)])
    assert rc == 0
    trace = json.loads((prof / "sweep.pt.trace.json").read_text())
    assert trace["traceEvents"]
