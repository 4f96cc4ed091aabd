"""Traffic kind ``sweep``: the upstream's batch simulation as its users run
it, pass after pass: ``sim.runner.batch_simulation`` over the
configuration's matrix with the configuration's sweep settings, then the
results CSV, as the command line writes them.

Ingest (``prepare_sim_inputs``) is set-up.  Each pass gets a fresh
``simulation_seed`` derived from the run's seed and a fresh checkpoint and
results directory under ``TMPDIR`` (a resumed pass would do no work); the
window closes at the first pass completed after ``--seconds``.  The rows of
a pass drawn from the seed are read back from its checkpoint, as written,
and held against the reference's statistics of the same trials."""

from __future__ import annotations

import json
import math
import random
import shutil
import tempfile
from pathlib import Path

from portbench import harness
from portbench.reference import channel, stats, threefry

ROW_FIELDS = ("iterations_successful_sp_mean", "iterations_successful_sp_std_dev",
              "iterations_successful_sp_min", "iterations_successful_sp_max",
              "ratio_trials_successful_sp", "ratio_trials_successful_ldpc")


def rate_qbers(rate: float, table: list) -> list[float]:
    """The sweep's QBER points for a code rate: the first entry of the table,
    in ascending rate, whose rate is at least the code's; ``round((end -
    begin) / step)`` points from ``begin`` (rounding half away from zero)."""
    for e in sorted(table, key=lambda e: e["code_rate"]):
        if rate <= e["code_rate"]:
            steps = int(math.floor((e["QBER_end"] - e["QBER_begin"]) / e["QBER_step"] + 0.5))
            return [e["QBER_begin"] + j * e["QBER_step"] for j in range(steps)]
    raise ValueError("no rate entry covers the code")


class Driver:
    def __init__(self, ctx: harness.Context):
        from qkd_ldpc_tpu_torch.config import config_from_dict
        from qkd_ldpc_tpu_torch.sim.runner import prepare_sim_inputs

        self.ctx = ctx
        self.tmp = Path(tempfile.mkdtemp(prefix="portbench-sweep-"))
        self.raw = dict(ctx.config["sweep"], dtype=ctx.storage)
        self.path = ctx.base / "configs" / ctx.config["code"]["file"]
        self.inputs = prepare_sim_inputs([self.path], config_from_dict(self.raw))
        self.units: list[dict] = []
        self.spans: list = []
        for w in range(ctx.params.get("warm_passes", 1)):
            self.one_pass(0xFFFFFFFF - w, "warm")

    def one_pass(self, index: int, tag: str) -> dict:
        from qkd_ldpc_tpu_torch.config import config_from_dict
        from qkd_ldpc_tpu_torch.sim import write_results
        from qkd_ldpc_tpu_torch.sim.runner import batch_simulation

        seed = self.ctx.word(index)
        d = self.tmp / f"{tag}{index}"
        cfg = config_from_dict(dict(self.raw, simulation_seed=seed,
                                    checkpoint_dir=str(d / "checkpoints"),
                                    results_dir=str(d / "results")))
        results = batch_simulation(self.inputs, cfg, progress=False, device=self.ctx.device)
        (d / "results").mkdir(parents=True, exist_ok=True)
        write_results(results, d / "results", cfg.trials_number,
                      cfg.sum_product_max_iterations, cfg.simulation_seed)
        return dict(index=index, seed=seed, rows=len(results), dir=str(d))

    def run(self, window: harness.Window) -> None:
        i = 0
        window.open()
        while not window.closed:
            with harness.span("portbench.sweep_pass", self.spans):
                u = self.one_pass(i, "pass")
            u["t0"], u["t1"] = self.spans[-1]
            self.units.append(u)
            window.unit_done(u["t1"])
            i += 1

    def end_to_end(self, window: harness.Window) -> dict:
        return {"rows_per_s": sum(u["rows"] for u in self.units) / window.length}

    def attempted_failed(self) -> tuple[int, int]:
        return len(self.units), 0

    def release(self) -> None:
        self.inputs = None

    def check(self) -> list:
        """``rows_gap``: the largest relative gap, over the rows of the
        sampled passes as their checkpoints hold them and over each row's
        written statistics, from the reference's; a row that is missing
        counts as a gap of 1."""
        ctx = self.ctx
        g = harness.reference_graph(ctx)
        dec = harness.reference_decoder(ctx)
        qbers = rate_qbers(1.0 - g.n_checks / g.n_vars, self.raw["code_rate_QBER_parameters"])
        n = self.raw["trials_number"]
        gap = 0.0 if self.units else 1.0
        sample = random.Random(ctx.seed).sample(
            self.units, min(ctx.cell["check"]["passes"], len(self.units)))
        for u in sample:
            written = {}
            for f in Path(u["dir"], "checkpoints").glob("*.jsonl"):
                for line in f.read_text().splitlines():
                    rec = json.loads(line)
                    written[rec["sim_number"]] = rec["result"]
            master = threefry.key(u["seed"])
            for num, q in enumerate(qbers):
                row = written.get(num)
                if row is None:
                    gap = max(gap, 1.0)
                    continue
                ref = stats.row(stats.point(dec, g, threefry.fold_in(master, num),
                                            channel.num_errors(g.n_vars, q), n),
                                dec.max_iterations)
                gap = max([gap] + [stats.relative_gap(row[k], ref[k]) for k in ROW_FIELDS])
        shutil.rmtree(self.tmp, ignore_errors=True)
        return [("rows_gap", gap, ctx.cell["check"]["limits"]["rows_gap"])]

