"""Traffic kind ``serve_blind``: an open loop of sifted-key blocks into one
``serve.Reconciler`` made with an all-punctured adapter, each block one blind
session (``Reconciler.blind_session``: round 0 with every modulated position
punctured, then rounds over the frames that failed, each after Alice reveals
the next punctured bits) and its ``finalize`` (tags, then amplification at
each frame's own length).

The configuration's ``blind`` fixes the ``d`` punctured positions (their
seed), the reveal step, the QBER hint that sets the channel LLRs'
magnitude (the node has no estimate), the tag bits and the security margin.
A block is ``frames`` frames of the payload's length ``l = N - d``; its QBER
``k / l`` takes one of ``pool`` error counts ``k`` spaced evenly over
``[floor(qber_lo l), floor(qber_hi l)]`` (an order drawn from the seed),
each frame with exactly ``k`` flips.

Alice's side is made in set-up by the plain reference
(``reference/rate_adapt.py``, ``reference/toeplitz.py``): her payloads, her
punctured bits (a frame key a pool entry), her frames and syndromes, and her
tags under each block's fresh tag key; each block also has a fresh
amplification key.  Alice answers a reveal by slicing her set-up frames at
the requested positions of the frames still going: no link round trip is
modelled, so a block's service is the node's own work, its turns included.

Blocks are due periodically at ``blocks_per_s`` from the window's start;
one server takes them in order; a block not answered a minute after the
window's last due time has failed.  After the window the sampled blocks'
frames are held against the reference's rounds and chain on the same block
(``reference/blind.py``)."""

from __future__ import annotations

import math
import random
import sys
import time

import numpy as np
import torch

from portbench import harness
from portbench.reference import blind, channel, rate_adapt, threefry, toeplitz

GRACE_S = 60.0
POOL_KEYS = 0xFFFF0000  # a pool entry's frame key: unit index POOL_KEYS + entry
WARM = 0xFFFFFFFF  # the warm-up blocks' unit indices count down from here
# Set-up batches (few operations, so that a traced run's set-up stays small):
# blocks whose tags one product makes, keys whose seed bits one call draws,
# pool entries whose punctured bits one call draws.
TAG_BATCH, KEY_BATCH, POOL_BATCH = 8, 256, 4
# the endpoint's counters a block adds to, kept with its unit
COUNTERS = ("frame_iterations", "blind_rounds", "bits_revealed", "lanes_dispatched",
            "live_frame_rounds")


def program_endpoint():
    """The program's adapter and endpoint classes; a program whose endpoint
    has no blind session cannot run this cell and fails here, before any
    set-up."""
    from qkd_ldpc_tpu_torch.decoder.rate_adapt import RateAdapter
    from qkd_ldpc_tpu_torch.serve import Reconciler

    if not hasattr(Reconciler, "blind_session"):
        raise RuntimeError("the program's Reconciler has no blind_session: it cannot "
                           "reconcile a block blind, round by round")
    return RateAdapter, Reconciler


def block_keys(seed: int, units) -> tuple[torch.Tensor, torch.Tensor]:
    """The tag and amplification keys (int64 ``[n, 2]``) of the blocks whose
    unit indices are ``units``."""
    unit = threefry.fold_in(threefry.key(seed), torch.as_tensor(list(units),
                                                               dtype=torch.int64))
    return threefry.fold_in(unit, 1), threefry.fold_in(unit, 2)


class Driver:
    def __init__(self, ctx: harness.Context):
        RateAdapter, Reconciler = program_endpoint()
        p, bl = ctx.params, ctx.config["blind"]
        self.ctx, self.bl = ctx, bl
        g = harness.reference_graph(ctx)
        self.N, self.M = g.n_vars, g.n_checks
        self.l = self.N - bl["d"]
        self.plan = rate_adapt.plan(self.N, self.M, bl["d"], bl["d"], bl["seed"])
        self.make_pool(g)
        del g
        code = harness.program_code(ctx)
        adapter = RateAdapter.make(code, n_punctured=bl["d"], seed=bl["seed"])
        self.rec = Reconciler(code, harness.decode_options(ctx), lanes=p["lanes"],
                              adapter=adapter, device=ctx.device)
        self.rec.max_inflight_chunks = p["inflight_chunks"]
        # every pool entry once: the blind program's capture, and every
        # amplification length the pool's blocks reach
        warm = {WARM - b: b for b in range(p["pool"])}
        self.prepare(warm)
        for i, b in warm.items():
            self.one_block(i, b)
        self.rec.counters.reset()

    def make_pool(self, g) -> None:
        """Alice's side by the plain reference: her frames ``[P, F, N]``,
        payloads ``[P, F, l]`` and syndromes ``[P, F, M]`` and Bob's payloads
        ``[P, F, l]``, uint8 on the host, and the error counts and QBERs."""
        ctx, p, bl = self.ctx, self.ctx.params, self.bl
        l, F = self.l, p["frames"]
        ks = np.linspace(int(p["qber_lo"] * l), int(p["qber_hi"] * l), p["pool"]).round()
        gen = torch.Generator(device=ctx.device)
        gen.manual_seed(ctx.seed)
        order = torch.randperm(p["pool"], generator=gen, device=ctx.device).tolist()
        self.ks = [int(ks[i]) for i in order]
        self.qber = [k / l for k in self.ks]
        self.frames = np.empty((p["pool"], F, self.N), np.uint8)
        self.alice = np.empty((p["pool"], F, l), np.uint8)
        self.bob = np.empty((p["pool"], F, l), np.uint8)
        self.syn = np.empty((p["pool"], F, self.M), np.uint8)
        keys = torch.stack([ctx.key(POOL_KEYS + b) for b in range(p["pool"])]).to(ctx.device)
        words = torch.cat([rate_adapt.punctured_words(keys[b:b + POOL_BATCH], F, bl["d"])
                           for b in range(0, p["pool"], POOL_BATCH)])
        for b, k in enumerate(self.ks):
            alice = torch.randint(0, 2, (F, l), generator=gen, device=ctx.device,
                                  dtype=torch.uint8)
            pos = torch.rand((F, l), generator=gen, device=ctx.device).argsort(dim=1)[:, :k]
            flips = torch.zeros((F, l), dtype=torch.uint8, device=ctx.device)
            flips.scatter_(1, pos, 1)
            frames = rate_adapt.frames(self.plan, alice, keys[b], 0, words[b])
            self.frames[b] = frames.cpu().numpy()
            self.alice[b] = alice.cpu().numpy()
            self.bob[b] = (alice ^ flips).cpu().numpy()
            self.syn[b] = channel.syndromes(g, frames).to(torch.uint8).cpu().numpy()

    def prepare(self, units: dict) -> None:
        """The fresh keys of the blocks ``units`` (unit index -> pool entry)
        and Alice's tags under them, ``TAG_BATCH`` blocks a product."""
        bl, dev = self.bl, self.ctx.device
        tks, pks = block_keys(self.ctx.seed, units)
        idx, entries = list(units), torch.as_tensor(list(units.values()), dtype=torch.int64)
        self.tag_key = dict(zip(idx, tks))
        self.pa_key = dict(zip(idx, pks))
        self.tags = {}
        alice = torch.as_tensor(self.alice, device=dev)
        seeds = torch.cat([toeplitz.seed_bits(tks[lo:lo + KEY_BATCH].to(dev),
                                              self.l + bl["tag_bits"] - 1)
                           for lo in range(0, len(idx), KEY_BATCH)])
        for lo in range(0, len(idx), TAG_BATCH):
            sel = entries[lo:lo + TAG_BATCH].to(dev)
            tags = toeplitz.hash_seeded(alice.index_select(0, sel), seeds[lo:lo + TAG_BATCH],
                                        bl["tag_bits"]).cpu().numpy()
            self.tags.update(zip(idx[lo:lo + TAG_BATCH], tags))

    def one_block(self, i: int, b: int | None = None):
        """Block ``i`` (pool entry ``b``, by default ``i`` mod the pool): one
        blind session through the endpoint, Alice answering from her frames,
        then its ``finalize``.  Returns ``(SecureBlindResult, syndrome flags)``."""
        bl = self.bl
        b = i % self.ctx.params["pool"] if b is None else b
        frames = self.frames[b]
        s = self.rec.blind_session(self.bob[b], self.syn[b], bl["qber_hint"],
                                   reveal_step=bl["reveal_step"])
        res = s.run(lambda positions, rows: frames[np.ix_(rows, positions)])
        out = s.finalize(self.tags[i], self.tag_key[i], self.pa_key[i],
                         tag_bits=bl["tag_bits"], security_bits=bl["security_bits"])
        return out, res.ok

    def run(self, window: harness.Window) -> None:
        p = self.ctx.params
        rate = p["blocks_per_s"]
        self.units, self.spans, self.kept, self.late = [], [], {}, []
        self.n_due = math.ceil(window.seconds * rate)
        self.prepare({i: i % p["pool"] for i in range(self.n_due)})
        sample = set(random.Random(self.ctx.seed).sample(
            range(self.n_due), min(self.ctx.cell["check"]["blocks"], self.n_due)))
        counters = self.rec.counters
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
            before = [getattr(counters, c) for c in COUNTERS]
            with harness.span("portbench.blind", self.spans):
                out = self.one_block(i)
            start, done = self.spans[-1]
            if free <= due:  # the server was idle: how late the generator ran
                self.late.append(start - due)
            free = done
            self.units.append(dict(index=i, block=i % p["pool"], due=due, t0=start, t1=done,
                                   **{c: getattr(counters, c) - v
                                      for c, v in zip(COUNTERS, before)}))
            if i in sample:
                self.kept[i] = out
            if window.tracer is not None:
                window.tracer.unit_done(done)
        window.close(free)
        if self.late:
            print(f"portbench: generator lateness p50 {np.median(self.late) * 1e3:.4f} ms, "
                  f"max {max(self.late) * 1e3:.4f} ms over {len(self.late)} idle arrivals",
                  file=sys.stderr)
        by_round = dict(sorted(counters.frames_by_round.items()))
        n = sum(by_round.values())
        if n:
            print(f"portbench: frames by finishing round {by_round}, mean rounds "
                  f"{sum(r * k for r, k in by_round.items()) / n:.4f}, rounds dispatched "
                  f"{counters.blind_rounds}, bits revealed {counters.bits_revealed}, "
                  f"verified {counters.frames_verified} of {n}", file=sys.stderr)

    def end_to_end(self, window: harness.Window) -> dict:
        return {"frames_per_s": len(self.units) * self.ctx.params["frames"] / window.length}

    def attempted_failed(self) -> tuple[int, int]:
        return self.n_due, self.n_due - len(self.units)

    def release(self) -> None:
        self.rec = None

    def reference_block(self, i: int, g, dec) -> dict:
        """The reference's rounds and chain on block ``i``: per frame its key
        row, verified flag, rounds, leak, final length, iteration count and
        syndrome flag."""
        ctx, bl, dev = self.ctx, self.bl, self.ctx.device
        b = i % ctx.params["pool"]
        mag = channel.llr_magnitude(np.float32(bl["qber_hint"]))
        out = blind.rounds(dec, g, self.plan, torch.as_tensor(self.bob[b], device=dev),
                           torch.as_tensor(self.syn[b], device=dev),
                           torch.as_tensor(self.frames[b], device=dev), mag, bl["reveal_step"])
        sec = blind.chain(out, torch.as_tensor(self.tags[i], device=dev), self.tag_key[i],
                          self.pa_key[i], bl["tag_bits"], bl["security_bits"])
        return dict(sec, rounds=out["rounds"], iterations=out["iterations"], ok=out["ok"])

    def check(self) -> list:
        """``blind_off``: the share of the sampled blocks' frames whose key
        row, verified flag, rounds, leak, final length, iteration count or
        syndrome flag differ from the reference's on the same block; a
        sampled block that was never answered counts all of its frames."""
        ctx = self.ctx
        g = harness.reference_graph(ctx)
        dec = harness.reference_decoder(ctx)
        off = total = 0
        dev = ctx.device

        def got(x):
            return torch.as_tensor(np.asarray(x), device=dev)

        for i in sorted(self.kept):
            ref = self.reference_block(i, g, dec)
            out, ok = self.kept[i]
            key, want = got(out.key), ref["key"]
            width = max(key.shape[1], want.shape[1])  # rows compared zero-padded
            key = torch.nn.functional.pad(key, (0, width - key.shape[1]))
            want = torch.nn.functional.pad(want, (0, width - want.shape[1]))
            same = ((key == want).all(dim=1)
                    & (got(out.verified) == ref["verified"])
                    & (got(out.rounds) == ref["rounds"])
                    & (got(out.leak_bits) == ref["leak"])
                    & (got(out.final_bits) == ref["final"])
                    & (got(out.iterations) == ref["iterations"])
                    & (got(ok) == ref["ok"]))
            off += int((~same).sum())
            total += same.numel()
        want = min(ctx.cell["check"]["blocks"], self.n_due) * ctx.params["frames"]
        off += want - total  # sampled blocks with no answer
        return [("blind_off", off / max(want, 1), ctx.cell["check"]["limits"]["blind_off"])]
