"""Traffic kind ``serve_open``: an open loop of sifted-key blocks into one
``serve.Reconciler`` endpoint.

A block is ``frames`` frames of the code's length; its QBER ``k / N`` takes
one of ``pool`` error counts ``k`` spaced evenly over
``[floor(qber_lo N), floor(qber_hi N)]`` (the same set for every seed, in an
order drawn from the seed), and each frame carries exactly ``k`` flips at
positions drawn from the seed.  Alice's keys, Bob's copies and Alice's
syndromes are made in set-up on the device (a ``torch.Generator`` seeded by
the run's seed; the syndromes by the reference's plain parity), and the pool
is cycled so that nothing is generated inside the window.

Blocks are due periodically at ``blocks_per_s`` from the window's start;
one server takes them in order, each as one ``Reconciler.reconcile`` call,
and a block's latency runs from its due time to its answer.  A block not
answered a minute after the window's last due time has failed."""

from __future__ import annotations

import math
import random
import sys
import time

import numpy as np
import torch

from portbench import harness
from portbench.reference import channel
from portbench.reference.decode import decode

GRACE_S = 60.0


def make_pool(ctx: harness.Context, g):
    """``(bob [P, F, N] uint8, syn [P, F, M] uint8, k [P])`` on the host."""
    p = ctx.params
    N = g.n_vars
    ks = np.linspace(int(p["qber_lo"] * N), int(p["qber_hi"] * N), p["pool"]).round()
    gen = torch.Generator(device=ctx.device)
    gen.manual_seed(ctx.seed)
    order = torch.randperm(p["pool"], generator=gen, device=ctx.device).tolist()
    ks = [int(ks[i]) for i in order]
    F = p["frames"]
    bob = np.empty((p["pool"], F, N), np.uint8)
    syn = np.empty((p["pool"], F, g.n_checks), np.uint8)
    for b, k in enumerate(ks):
        alice = torch.randint(0, 2, (F, N), generator=gen, device=ctx.device, dtype=torch.uint8)
        pos = torch.rand((F, N), generator=gen, device=ctx.device).argsort(dim=1)[:, :k]
        flips = torch.zeros((F, N), dtype=torch.uint8, device=ctx.device)
        flips.scatter_(1, pos, 1)
        bob[b] = (alice ^ flips).cpu().numpy()
        syn[b] = channel.syndromes(g, alice).to(torch.uint8).cpu().numpy()
    return bob, syn, ks


class Driver:
    def __init__(self, ctx: harness.Context):
        from qkd_ldpc_tpu_torch.serve import Reconciler

        p = ctx.params
        self.ctx = ctx
        g = harness.reference_graph(ctx)
        self.bob, self.syn, self.ks = make_pool(ctx, g)
        del g
        self.qber = [k / self.bob.shape[2] for k in self.ks]
        self.rec = Reconciler(harness.program_code(ctx), harness.decode_options(ctx),
                              lanes=p["lanes"], device=ctx.device)
        self.rec.max_inflight_chunks = p["inflight_chunks"]
        self.rec.warmup()
        for b in range(min(2, p["pool"])):
            self.rec.reconcile(self.bob[b], self.syn[b], self.qber[b])

    def run(self, window: harness.Window) -> None:
        p = self.ctx.params
        rate = p["blocks_per_s"]
        self.units, self.spans, self.kept, self.late = [], [], {}, []
        self.n_due = math.ceil(window.seconds * rate)
        sample = set(random.Random(self.ctx.seed).sample(
            range(self.n_due), min(self.ctx.cell["check"]["blocks"], self.n_due)))
        t0 = window.open()
        free = t0
        for i in range(self.n_due):
            due = t0 + i / rate
            t = harness.now()
            if t < due:
                if due - t > 1e-3:
                    time.sleep(due - t - 1e-3)
                while harness.now() < due:
                    pass
            if harness.now() - t0 > window.seconds + GRACE_S:
                break
            b = i % p["pool"]
            with harness.span("portbench.reconcile", self.spans):
                out = self.rec.reconcile(self.bob[b], self.syn[b], self.qber[b])
            start, done = self.spans[-1]
            if free <= due:  # the server was idle: how late the generator ran
                self.late.append(start - due)
            free = done
            self.units.append(dict(index=i, block=b, due=due, t0=start, t1=done))
            if i in sample:
                self.kept[i] = out
            if window.tracer is not None:
                window.tracer.unit_done(done)
        window.close(free)
        if self.late:
            print(f"portbench: generator lateness p50 {np.median(self.late) * 1e3:.4f} ms, "
                  f"max {max(self.late) * 1e3:.4f} ms over {len(self.late)} idle arrivals",
                  file=sys.stderr)
        worst = sorted(self.units, key=lambda u: u["t0"] - u["t1"])[:3]
        print("portbench: longest services (block, due s, wait ms, service ms): " + ", ".join(
            f"({u['index']}, {u['due'] - t0:.3f}, {(u['t0'] - u['due']) * 1e3:.3f}, "
            f"{(u['t1'] - u['t0']) * 1e3:.3f})" for u in worst), file=sys.stderr)

    def end_to_end(self, window: harness.Window) -> dict:
        return {"frames_per_s": len(self.units) * self.ctx.params["frames"] / window.length}

    def attempted_failed(self) -> tuple[int, int]:
        return self.n_due, self.n_due - len(self.units)

    def release(self) -> None:
        self.rec = None

    def check(self) -> list:
        """``frames_off``: the share of the sampled blocks' frames whose
        corrected bits, iteration count or syndrome flag differ from the
        reference's decode of the same block; a sampled block that was
        never answered counts all of its frames."""
        ctx = self.ctx
        g = harness.reference_graph(ctx)
        dec = harness.reference_decoder(ctx)
        off = total = 0
        for i in sorted(self.kept) if self.kept else []:
            b = i % ctx.params["pool"]
            mag = channel.llr_magnitude(np.float32(self.qber[b]))
            bob = torch.as_tensor(self.bob[b], device=ctx.device)
            llr = torch.where(bob == 1, -mag, mag).to(torch.float32)
            z, iters, ok = decode(dec, g, llr, torch.as_tensor(self.syn[b], device=ctx.device))
            out = self.kept[i]
            same = ((torch.as_tensor(out.bits, device=ctx.device) == z).all(dim=1)
                    & (torch.as_tensor(out.iterations, device=ctx.device) == iters)
                    & (torch.as_tensor(out.syndromes_match, device=ctx.device) == ok))
            off += int((~same).sum())
            total += same.numel()
        want = min(ctx.cell["check"]["blocks"], self.n_due) * ctx.params["frames"]
        off += want - total  # sampled blocks with no answer
        return [("frames_off", off / max(want, 1), ctx.cell["check"]["limits"]["frames_off"])]
