"""Traffic kind ``serve_secure``: an open loop of sifted-key blocks into one
rate-agile ``serve.Reconciler`` (``rates=RateFamily``), each block one
``reconcile_secure`` call at the step its QBER sets.

The configuration's ``rate_adaptation`` fixes the family (``d`` modulated
positions of the mother code, the grid, the positions' seed, the shared seed
of the shortened bits), the efficiency ``f`` of the step rule, the tag bits
and the security margin.  A block is ``frames`` frames of the payload's
length ``l = N - d``; its QBER ``k / l`` takes one of ``pool`` error counts
``k`` spaced evenly over ``[floor(qber_lo l), floor(qber_hi l)]`` (an order
drawn from the seed), each frame with exactly ``k`` flips.

Alice's side is made in set-up by the plain reference
(``reference/rate_adapt.py``, ``reference/toeplitz.py``): her payloads, her
punctured bits (a frame key a pool entry), her frames and syndromes at the
step the reference's rule gives, and her tags under each block's fresh tag
key.  Each block also has a fresh amplification key.  Nothing is generated
inside the window.  Bob's node sets the step with the program's own rule.

Blocks are due periodically at ``blocks_per_s`` from the window's start;
one server takes them in order; a block not answered a minute after the
window's last due time has failed.  After the window the sampled blocks'
frames are held against the reference's chain on the same block: its
adapted LLRs, its decode (``reference/decode.py``), tags, verification,
leak, final length and amplified keys."""

from __future__ import annotations

import math
import random
import sys
import time

import numpy as np
import torch

from portbench import arith_secure, harness
from portbench.reference import channel, rate_adapt, threefry, toeplitz
from portbench.reference.decode import decode

GRACE_S = 60.0
POOL_KEYS = 0xFFFF0000  # a pool entry's frame key: unit index POOL_KEYS + entry
WARM = 0xFFFFFFFF  # the warm-up blocks' unit indices count down from here
# Set-up batches: a traced run records set-up too, and its read-out slows with
# the number of operations recorded, so the reference makes Alice's side in
# batches: of blocks whose tags one product makes, of keys whose seed bits one
# call draws, of pool entries whose punctured bits one call draws.
TAG_BATCH, KEY_BATCH, POOL_BATCH = 8, 256, 4


def program_endpoint():
    """The program's rate family and endpoint classes; a program without a
    rate-agile endpoint cannot run this cell and fails here, before any
    set-up."""
    import inspect

    from qkd_ldpc_tpu_torch.serve import Reconciler

    try:
        from qkd_ldpc_tpu_torch.decoder.rate_adapt import RateFamily
    except ImportError as e:
        raise RuntimeError("the program has no rate family (decoder.rate_adapt.RateFamily): "
                           "it cannot serve a rate that changes block by block") from e
    if "rates" not in inspect.signature(Reconciler).parameters:
        raise RuntimeError("the program's Reconciler takes no rates=: it cannot serve a "
                           "rate that changes block by block")
    return RateFamily, Reconciler


def block_keys(seed: int, units) -> tuple[torch.Tensor, torch.Tensor]:
    """The tag and amplification keys (int64 ``[n, 2]``) of the blocks whose
    unit indices are ``units``."""
    unit = threefry.fold_in(threefry.key(seed), torch.as_tensor(list(units),
                                                               dtype=torch.int64))
    return threefry.fold_in(unit, 1), threefry.fold_in(unit, 2)


class Driver:
    def __init__(self, ctx: harness.Context):
        RateFamily, Reconciler = program_endpoint()
        p, ra = ctx.params, ctx.config["rate_adaptation"]
        self.ctx, self.ra = ctx, ra
        g = harness.reference_graph(ctx)
        self.N, self.M = g.n_vars, g.n_checks
        self.l = self.N - ra["d"]
        self.plans = [rate_adapt.plan(self.N, self.M, ra["d"], p_, ra["seed"])
                      for p_ in range(0, ra["d"] + 1, ra["grid"])]
        self.make_pool(g)
        del g
        code = harness.program_code(ctx)
        self.family = RateFamily.make(code, d=ra["d"], seed=ra["seed"], grid=ra["grid"])
        self.rec = Reconciler(code, harness.decode_options(ctx), lanes=p["lanes"],
                              rates=self.family, shared_seed=ra["shared_seed"],
                              device=ctx.device)
        self.rec.max_inflight_chunks = p["inflight_chunks"]
        self.rec.warmup()
        # every step of the pool once: its amplification's shapes
        first = {}
        for b, s in enumerate(self.ref_steps):
            first.setdefault(s, b)
        warm = {WARM - w: b for w, b in enumerate(first.values())}
        self.prepare(warm)
        for i, b in warm.items():
            self.one_block(i, b)
        self.rec.counters.reset()

    def make_pool(self, g) -> None:
        """Alice's side by the plain reference: ``bob [P, F, l]`` and
        ``syn [P, F, M]`` uint8 and her payloads on the host, the error
        counts, QBERs and the reference's steps."""
        ctx, p, ra = self.ctx, self.ctx.params, self.ra
        l, F = self.l, p["frames"]
        ks = np.linspace(int(p["qber_lo"] * l), int(p["qber_hi"] * l), p["pool"]).round()
        gen = torch.Generator(device=ctx.device)
        gen.manual_seed(ctx.seed)
        order = torch.randperm(p["pool"], generator=gen, device=ctx.device).tolist()
        self.ks = [int(ks[i]) for i in order]
        self.qber = [k / l for k in self.ks]
        self.ref_steps = [rate_adapt.step(self.N, self.M, ra["d"], ra["grid"], q,
                                          ra["efficiency"]) for q in self.qber]
        self.alice = np.empty((p["pool"], F, l), np.uint8)
        self.bob = np.empty((p["pool"], F, l), np.uint8)
        self.syn = np.empty((p["pool"], F, self.M), np.uint8)
        keys = torch.stack([ctx.key(POOL_KEYS + b) for b in range(p["pool"])]).to(ctx.device)
        words = torch.cat([rate_adapt.punctured_words(keys[b:b + POOL_BATCH], F, ra["d"])
                           for b in range(0, p["pool"], POOL_BATCH)])
        for b, k in enumerate(self.ks):
            alice = torch.randint(0, 2, (F, l), generator=gen, device=ctx.device,
                                  dtype=torch.uint8)
            pos = torch.rand((F, l), generator=gen, device=ctx.device).argsort(dim=1)[:, :k]
            flips = torch.zeros((F, l), dtype=torch.uint8, device=ctx.device)
            flips.scatter_(1, pos, 1)
            frames = rate_adapt.frames(self.plans[self.ref_steps[b]], alice, keys[b],
                                       ra["shared_seed"], words[b])
            self.alice[b] = alice.cpu().numpy()
            self.bob[b] = (alice ^ flips).cpu().numpy()
            self.syn[b] = channel.syndromes(g, frames).to(torch.uint8).cpu().numpy()

    def prepare(self, units: dict) -> None:
        """The fresh keys of the blocks ``units`` (unit index -> pool entry)
        and Alice's tags under them, ``TAG_BATCH`` blocks a product (few
        operations, so that a traced run's set-up stays small)."""
        ra, dev = self.ra, self.ctx.device
        tks, pks = block_keys(self.ctx.seed, units)
        idx, entries = list(units), torch.as_tensor(list(units.values()), dtype=torch.int64)
        self.tag_key = dict(zip(idx, tks))
        self.pa_key = dict(zip(idx, pks))
        self.tags = {}
        alice = torch.as_tensor(self.alice, device=dev)
        seeds = torch.cat([toeplitz.seed_bits(tks[lo:lo + KEY_BATCH].to(dev),
                                              self.l + ra["tag_bits"] - 1)
                           for lo in range(0, len(idx), KEY_BATCH)])
        for lo in range(0, len(idx), TAG_BATCH):
            sel = entries[lo:lo + TAG_BATCH].to(dev)
            tags = toeplitz.hash_seeded(alice.index_select(0, sel), seeds[lo:lo + TAG_BATCH],
                                        ra["tag_bits"]).cpu().numpy()
            self.tags.update(zip(idx[lo:lo + TAG_BATCH], tags))

    def one_block(self, i: int, b: int | None = None):
        """Block ``i`` (pool entry ``b``, by default ``i`` mod the pool) through
        the endpoint; its step by the program's rule."""
        ra = self.ra
        b = i % self.ctx.params["pool"] if b is None else b
        step = self.family.step(self.qber[b], ra["efficiency"])
        return self.rec.reconcile_secure(
            self.bob[b], self.syn[b], self.qber[b], self.tags[i], self.tag_key[i],
            self.pa_key[i], tag_bits=ra["tag_bits"], security_bits=ra["security_bits"],
            rate=step)

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
            before = counters.frame_iterations
            with harness.span("portbench.secure", self.spans):
                out = self.one_block(i)
            start, done = self.spans[-1]
            if free <= due:  # the server was idle: how late the generator ran
                self.late.append(start - due)
            free = done
            self.units.append(dict(
                index=i, block=i % p["pool"], due=due, t0=start, t1=done,
                frame_iterations=counters.frame_iterations - before,
                pa_bytes=arith_secure.toeplitz_bytes(p["frames"], self.l, out.final_bits)))
            if i in sample:
                self.kept[i] = out
            if window.tracer is not None:
                window.tracer.unit_done(done)
        window.close(free)
        if self.late:
            print(f"portbench: generator lateness p50 {np.median(self.late) * 1e3:.4f} ms, "
                  f"max {max(self.late) * 1e3:.4f} ms over {len(self.late)} idle arrivals",
                  file=sys.stderr)

    def end_to_end(self, window: harness.Window) -> dict:
        return {"frames_per_s": len(self.units) * self.ctx.params["frames"] / window.length}

    def attempted_failed(self) -> tuple[int, int]:
        return self.n_due, self.n_due - len(self.units)

    def release(self) -> None:
        self.rec = self.family = None

    def reference_block(self, i: int, g, dec) -> dict:
        """The reference's chain on block ``i``: per frame its key row, the
        verified flag, leak, final length, iteration count and syndrome flag."""
        ctx, ra = self.ctx, self.ra
        b = i % ctx.params["pool"]
        pl = self.plans[self.ref_steps[b]]
        dev = ctx.device
        mag = channel.llr_magnitude(np.float32(self.qber[b]))
        llr = rate_adapt.llr(pl, torch.as_tensor(self.bob[b], device=dev), mag,
                             ra["shared_seed"])
        z, iters, ok = decode(dec, g, llr, torch.as_tensor(self.syn[b], device=dev))
        payload = z[:, torch.as_tensor(pl.key_idx, device=dev)]
        tags = toeplitz.hash_bits(payload, self.tag_key[i], ra["tag_bits"])
        verified = ok & (tags == torch.as_tensor(self.tags[i], device=dev)).all(dim=1)
        leak = pl.leak + ra["tag_bits"]
        final = max(0, self.l - leak - ra["security_bits"])
        return dict(key=toeplitz.hash_bits(payload, self.pa_key[i], final), verified=verified,
                    leak=leak, final=final, iterations=iters, ok=ok)

    def check(self) -> list:
        """``keys_off``: the share of the sampled blocks' frames whose key
        row, verified flag, leak, final length, iteration count or syndrome
        flag differ from the reference chain's on the same block; a sampled
        block that was never answered counts all of its frames."""
        ctx = self.ctx
        g = harness.reference_graph(ctx)
        dec = harness.reference_decoder(ctx)
        off = total = 0
        dev = ctx.device
        for i in sorted(self.kept):
            ref, out = self.reference_block(i, g, dec), self.kept[i]

            def got(x):
                return torch.as_tensor(np.asarray(x), device=dev)

            same = ((got(out.verified) == ref["verified"])
                    & (got(out.leak_bits) == ref["leak"])
                    & (got(out.iterations) == ref["iterations"])
                    & (got(out.syndromes_match) == ref["ok"]))
            if out.final_bits == ref["final"]:
                same &= (got(out.key) == ref["key"]).all(dim=1)
            else:
                same &= False
            off += int((~same).sum())
            total += same.numel()
        want = min(ctx.cell["check"]["blocks"], self.n_due) * ctx.params["frames"]
        off += want - total  # sampled blocks with no answer
        return [("keys_off", off / max(want, 1), ctx.cell["check"]["limits"]["keys_off"])]
