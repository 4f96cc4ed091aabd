"""The port across processes: gloo process groups on the CPU.

Coordinated processes (``torch.distributed``, gloo over localhost), each
with CPU trial shards, form one global trial mesh.  The sharded point, the
sharded continuation and the node-sharded point and decode must be equal
across ranks, to the port's single-process runs and to the JAX package's
``run_point`` — the determinism contract across process boundaries
(tests/test_distributed.py for the JAX package).  The CLI run by two
processes writes one CSV and one checkpoint, byte-equal to a single-process
run.  Importing the package starts neither CUDA nor a process group.

Subprocesses get ``communicate(timeout=120)``.  The 4-process variant takes
seconds here (the JAX package's, marked ``slow``, compiles in every process),
so it runs with the others.
"""

import dataclasses
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import pytest
import torch

from qkd_ldpc_tpu.codes import make_code as j_make_code
from qkd_ldpc_tpu.decoder import DecodeOptions as JaxDecodeOptions
from qkd_ldpc_tpu.sim.runner import run_point as j_run_point
from qkd_ldpc_tpu_torch.channel.threefry import prng_key
from qkd_ldpc_tpu_torch.codes import make_code, write_alist
from qkd_ldpc_tpu_torch.decoder.bp import DecodeOptions
from qkd_ldpc_tpu_torch.parallel import decode_node_sharded, initialize_distributed, make_mesh
from qkd_ldpc_tpu_torch.sim import run_point

REPO = Path(__file__).resolve().parent.parent
CODE = dict(n=256, m=131, dv=3, seed=1)
QBER, TRIALS = 0.03, 64

_WORKER = r"""
import sys, torch
torch.set_num_threads(1)
port, pid, nproc, local = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4])
from qkd_ldpc_tpu_torch.parallel import (
    decode_node_sharded, initialize_distributed, make_mesh, make_trial_mesh,
    run_point_node_sharded, run_point_sharded)
initialize_distributed(f"127.0.0.1:{port}", nproc, pid)
initialize_distributed(f"127.0.0.1:{port}", nproc, pid)  # a no-op the second time
from qkd_ldpc_tpu_torch.channel.threefry import prng_key
from qkd_ldpc_tpu_torch.codes import make_code
from qkd_ldpc_tpu_torch.decoder.bp import DecodeOptions
from qkd_ldpc_tpu_torch.sim.continuation import run_point_continuation_sharded
cpu = torch.device("cpu")
code = make_code(n=256, m=131, dv=3, seed=1)
opts = DecodeOptions(max_iterations=40)
mesh = make_trial_mesh([cpu] * local)
assert mesh.shape["trial"] == nproc * local and mesh.process_index == pid
def show(tag, p):
    print(tag, p.n_trials, p.n_sp, p.n_ldpc, p.sum_it, p.sum_it2, p.min_it, p.max_it,
          flush=True)
show("SHARDED", run_point_sharded(code, prng_key(777), 0.03, trials=64, batch=32,
                                  opts=opts, mesh=mesh)[0])
show("CONTINUATION", run_point_continuation_sharded(
    code, prng_key(777), 0.03, 64, 4, opts, mesh, segment=3)[0])
mesh2 = make_mesh(n_node=2, devices=[cpu] * (2 * local))
show("NODE", run_point_node_sharded(code, prng_key(777), 0.03, trials=64, batch=32,
                                    opts=DecodeOptions(max_iterations=40, algorithm="min-sum"),
                                    mesh=mesh2)[0])
g = torch.Generator().manual_seed(3)
llr = torch.randn(2 * nproc * local, 256, generator=g) + 2.0
syn = (torch.rand(2 * nproc * local, 131, generator=g) < 0.5).to(torch.int8)
res = decode_node_sharded(code, llr, syn, DecodeOptions(max_iterations=20,
                                                        algorithm="min-sum"), mesh2)
print("DECODE", res.iterations.tolist(), int(res.bits.sum()), flush=True)
# one row of node shards over every process's devices (sum-product: the
# log-sums of every shard, gathered through gloo, added in shard order)
res = decode_node_sharded(code, llr, syn, DecodeOptions(max_iterations=20),
                          make_mesh(n_trial=1, n_node=2 * nproc * local,
                                    devices=[cpu] * (2 * local)))
print("NODE_ACROSS", res.iterations.tolist(), int(res.bits.sum()),
      int((res.bits.to(torch.int64) * torch.arange(256)).sum()), flush=True)
from qkd_ldpc_tpu_torch.parallel import Mesh
node_only = Mesh([cpu] * (2 * local), ("node",))  # one row over every device
assert node_only.shape == {"node": 2 * nproc * local} and len(node_only.rows) == 1
res2 = decode_node_sharded(code, llr, syn, DecodeOptions(max_iterations=20), node_only)
print("NODE_ONLY", torch.equal(res.bits, res2.bits), torch.equal(res.iterations, res2.iterations),
      flush=True)
try:
    make_trial_mesh([cpu] * (1 + pid))
except ValueError as e:
    print("UNEVEN", "same number of trial shards" in str(e), flush=True)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env():
    return {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1",
            "CUDA_VISIBLE_DEVICES": ""}


def _run_group(n_procs: int, argv) -> list[str]:
    procs = [
        subprocess.Popen(argv(i), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                         env=_env(), cwd=REPO)
        for i in range(n_procs)
    ]
    try:
        outs = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for i, (p, (_, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {i} failed:\n{err[-3000:]}"
    return [out for out, _ in outs]


def _lines(out: str) -> dict[str, list[str]]:
    return {line.split()[0]: line.split()[1:] for line in out.splitlines() if line.strip()}


def _seven(p) -> list[str]:
    return [str(x) for x in dataclasses.astuple(p)]


def _group_runs(n_procs: int, local: int):
    port = _free_port()
    outs = _run_group(n_procs, lambda i: [sys.executable, "-c", _WORKER, str(port), str(i),
                                          str(n_procs), str(local)])
    runs = [_lines(o) for o in outs]
    for r in runs[1:]:
        assert r == runs[0], "ranks disagree"
    return runs[0]


def _check(run, n_procs, local):
    torch.set_num_threads(1)
    code = make_code(**CODE)
    opts = DecodeOptions(max_iterations=40)
    ref, _ = run_point(code, prng_key(777), QBER, TRIALS, TRIALS, opts, device="cpu")
    jref, _ = j_run_point(j_make_code(**CODE), jax.random.PRNGKey(777), QBER, trials=TRIALS,
                          batch=TRIALS, opts=JaxDecodeOptions(max_iterations=40))
    assert run["SHARDED"] == _seven(ref) == _seven(jref)
    assert run["CONTINUATION"] == _seven(ref)
    ms = DecodeOptions(max_iterations=40, algorithm="min-sum")
    ms_ref, _ = run_point(code, prng_key(777), QBER, TRIALS, TRIALS, ms, device="cpu")
    assert run["NODE"] == _seven(ms_ref)
    # the decode's lanes, gathered from every process, equal one process's
    g = torch.Generator().manual_seed(3)
    b = 2 * n_procs * local
    llr = torch.randn(b, 256, generator=g) + 2.0
    syn = (torch.rand(b, 131, generator=g) < 0.5).to(torch.int8)
    res = decode_node_sharded(code, llr, syn, DecodeOptions(max_iterations=20,
                                                            algorithm="min-sum"),
                              make_mesh(n_node=2, devices=[torch.device("cpu")] * 2))
    assert " ".join(run["DECODE"]) == f"{res.iterations.tolist()} {int(res.bits.sum())}"
    # a node row across every process equals the one-process row of that shape
    cpus = [torch.device("cpu")] * (2 * n_procs * local)
    res = decode_node_sharded(code, llr, syn, DecodeOptions(max_iterations=20),
                              make_mesh(n_trial=1, n_node=len(cpus), devices=cpus))
    assert " ".join(run["NODE_ACROSS"]) == (
        f"{res.iterations.tolist()} {int(res.bits.sum())} "
        f"{int((res.bits.to(torch.int64) * torch.arange(256)).sum())}")
    assert run["NODE_ONLY"] == ["True", "True"] and run["UNEVEN"] == ["True"]


def test_two_process_sharded_runs_match_single():
    _check(_group_runs(2, 2), 2, 2)


def test_four_process_sharded_runs_match_single():
    """Four processes of two shards: most shards are remote to each rank."""
    _check(_group_runs(4, 2), 4, 2)


# Node rows across processes (the QC node-sharded decoder, flooding and
# layered, SP and min-sum, and its sweep point), the same source in the
# workers and in the test: a row's processes exchange their partials through
# gloo and reduce them in shard order, so every decode is bit-equal to the
# one-process mesh of the same shape.
_ROWS_CASE = r"""
import dataclasses, hashlib
import numpy as np
import torch
from qkd_ldpc_tpu_torch.channel.keys import make_trial_batch, num_errors_for
from qkd_ldpc_tpu_torch.channel.threefry import prng_key
from qkd_ldpc_tpu_torch.codes import make_qc_code
from qkd_ldpc_tpu_torch.decoder.bp import DecodeOptions
from qkd_ldpc_tpu_torch.decoder.reconcile import apriori_llr
from qkd_ldpc_tpu_torch.decoder.syndrome import syndrome
from qkd_ldpc_tpu_torch.parallel import decode_qc_node_sharded, run_point_node_sharded

def rows_case(mesh):
    code = make_qc_code(z=16, nb=6, mb=3, dv=3, seed=2)  # 4 shards pad two blocks
    n_err = num_errors_for(code.n_vars, 0.06)
    alice, bob = make_trial_batch(prng_key(5), code.n_vars, 12, n_err, device="cpu")
    llr = apriori_llr(bob, np.float32(n_err) / np.float32(code.n_vars))
    syn = syndrome(code, alice)
    out = {}
    for sched in ("flooding", "layered"):
        for alg in ("sum-product", "min-sum"):
            o = DecodeOptions(algorithm=alg, schedule=sched, max_iterations=30)
            r = decode_qc_node_sharded(code, llr, syn, o, mesh)
            out[f"DEC_{sched}_{alg}"] = [
                *map(str, r.iterations.tolist()), *map(str, r.syndromes_match.int().tolist()),
                hashlib.sha256(r.bits.numpy().tobytes()).hexdigest()[:16]]
        ms = DecodeOptions(algorithm="min-sum", schedule=sched, max_iterations=30)
        p, _ = run_point_node_sharded(code, prng_key(777), 0.06, 24, 12, ms, mesh)
        out[f"PT_{sched}"] = [str(x) for x in dataclasses.astuple(p)]
    return code, out
"""

_ROWS = _ROWS_CASE + r"""
import sys
torch.set_num_threads(1)
port, pid, nproc, local, n_trial, n_node = sys.argv[1], *map(int, sys.argv[2:])
from qkd_ldpc_tpu_torch.parallel import initialize_distributed, make_mesh
initialize_distributed(f"127.0.0.1:{port}", nproc, pid)
mesh = make_mesh(n_trial, n_node, devices=[torch.device("cpu")] * local)
assert any(r.group is not None for r in mesh.rows)  # a row spans processes
for key, words in rows_case(mesh)[1].items():
    print(key, *words, flush=True)
"""


@pytest.mark.parametrize("n_procs,local,n_trial,n_node", [
    (2, 1, 1, 2),  # one row over two processes
    (2, 2, 1, 4),  # one row over two processes of two shards each
    (2, 3, 3, 2),  # mixed: each process holds a whole row and half of another
    (4, 1, 2, 2),  # two rows, each over two processes
], ids=["2x1-1x2", "2x2-1x4", "2x3-3x2", "4x1-2x2"])
def test_node_rows_across_processes_equal_one_process(n_procs, local, n_trial, n_node):
    port = _free_port()
    outs = _run_group(n_procs, lambda i: [sys.executable, "-c", _ROWS, str(port), str(i),
                                          str(n_procs), str(local), str(n_trial),
                                          str(n_node)])
    runs = [_lines(o) for o in outs]
    for r in runs[1:]:
        assert r == runs[0], "ranks disagree"
    torch.set_num_threads(1)
    ns = {}
    exec(_ROWS_CASE, ns)
    cpus = [torch.device("cpu")] * (n_procs * local)
    code, one = ns["rows_case"](make_mesh(n_trial, n_node, devices=cpus))
    assert runs[0] == one
    for sched in ("flooding", "layered"):
        ms = DecodeOptions(algorithm="min-sum", schedule=sched, max_iterations=30)
        ref, _ = run_point(code, prng_key(777), 0.06, 24, 12, ms, device="cpu")
        assert one[f"PT_{sched}"] == _seven(ref) and ref.n_sp > 0


_CLI = r"""
import sys
from qkd_ldpc_tpu_torch.parallel import mesh, sweep
count = [0]
real = mesh.all_gather_rows
def spy(rows):
    count[0] += 1
    return real(rows)
mesh.all_gather_rows = sweep.all_gather_rows = spy
from qkd_ldpc_tpu_torch import cli
rc = cli.main(sys.argv[1:])
print("GATHERS", count[0], flush=True)
sys.exit(rc)
"""


def test_two_process_cli_writes_one_artifact_set(tmp_path):
    """A sweep with a continuation crossover, run by two processes through
    the CLI: exactly one CSV and one checkpoint (process 0's), byte-equal to
    a single-process run; the multi-process run merged through gloo."""
    mats = tmp_path / "m"
    mats.mkdir()
    write_alist(make_code(**CODE), mats / "code.txt")
    cfg = dict(
        threads_number=1, trials_number=32, use_config_simulation_seed=True,
        simulation_seed=7, interactive_mode=False, sum_product_max_iterations=30,
        use_dense_matrices=False, enable_sum_product_msg_llr_threshold=True,
        sum_product_msg_llr_threshold=100.0, continuation_qber=0.035,
        code_rate_QBER_parameters=[dict(code_rate=0.6, QBER_begin=0.03, QBER_end=0.05,
                                        QBER_step=0.01)],
    )

    def run_cli(tag, n_procs, extra):
        d = tmp_path / tag
        d.mkdir()
        cp = d / "config.json"
        cp.write_text(json.dumps(dict(cfg, checkpoint_dir=str(d / "ckpt"),
                                      results_dir=str(d / "res"))))
        outs = _run_group(n_procs, lambda i: [
            sys.executable, "-c", _CLI, "--config", str(cp), "--matrix-dir", str(mats),
            "--no-progress", "--device", "cpu", *extra(i)])
        return d, [_lines(o)["GATHERS"] for o in outs]

    single, gathers1 = run_cli("single", 1, lambda i: [])
    port = _free_port()
    multi, gathers2 = run_cli("multi", 2, lambda i: [
        "--coordinator", f"127.0.0.1:{port}", "--num-processes", "2",
        "--process-id", str(i)])
    assert gathers1 == [["0"]]
    # one gather for the plain point, one for the continuation point
    assert gathers2[0] == gathers2[1] == ["2"]
    for sub, pattern in (("res", "*.csv"), ("ckpt", "*.jsonl")):
        s_files = sorted((single / sub).glob(pattern))
        m_files = sorted((multi / sub).glob(pattern))
        assert len(s_files) == len(m_files) == 1, (s_files, m_files)
        assert s_files[0].name == m_files[0].name
        assert s_files[0].read_bytes() == m_files[0].read_bytes()
    assert len(s_files[0].read_text().splitlines()) == 2  # checkpoint lines: 0.03, 0.04


def test_package_import_starts_neither_cuda_nor_a_process_group():
    script = (
        "import qkd_ldpc_tpu_torch, qkd_ldpc_tpu_torch.cli, qkd_ldpc_tpu_torch.parallel\n"
        "import torch\n"
        "assert not torch.cuda.is_initialized()\n"
        "assert not torch.distributed.is_initialized()\n"
        "print('clean')\n"
    )
    out = subprocess.run([sys.executable, "-c", script], env=_env(), cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and "clean" in out.stdout, out.stderr[-2000:]


@pytest.mark.parametrize("kw,match", [
    (dict(num_processes=0, process_id=0), "num-processes"),
    (dict(num_processes=2, process_id=2), "process-id"),
    (dict(num_processes=2, process_id=-1), "process-id"),
])
def test_initialize_distributed_refuses_a_bad_group(kw, match):
    with pytest.raises(ValueError, match=match):
        initialize_distributed("127.0.0.1:1", **kw)
    assert not torch.distributed.is_initialized()
