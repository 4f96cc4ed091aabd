"""Walkthrough: rate-adapted and blind reconciliation over one mother code.

Counterpart of ``examples/rate_adaptive_example.py``: the same decoder
serving a drifting channel from a single code —

1. fixed-rate reconciliation through the serving endpoint,
2. shortening the code when the channel degrades past its waterfall: the
   rate family's step for the QBER estimate, served by a rate-agile endpoint,
3. blind reconciliation when no QBER estimate exists at all,
4. verification and privacy amplification of the corrected keys.

Keys and channel errors come from the same threefry streams as the JAX
example's, so the frames are the same ones.

Run:  python -m qkd_ldpc_tpu_torch.examples.rate_adaptive_example [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np

from qkd_ldpc_tpu_torch.channel.keys import (
    generate_random_bits,
    introduce_errors,
    num_errors_for,
)
from qkd_ldpc_tpu_torch.channel.threefry import fold_in, prng_key
from qkd_ldpc_tpu_torch.codes import make_code
from qkd_ldpc_tpu_torch.decoder import DecodeOptions, RateFamily
from qkd_ldpc_tpu_torch.decoder.blind import blind_reconcile_sim
from qkd_ldpc_tpu_torch.postprocess import (
    amplified_key_bits,
    privacy_amplify,
    verification_tags,
)
from qkd_ldpc_tpu_torch.serve import Reconciler
from qkd_ldpc_tpu_torch.utils import resolve_device


def banner(s):
    print(f"\n=== {s} " + "=" * max(0, 60 - len(s)))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    dev = resolve_device(ap.parse_args(argv).device)

    # One mother code (R ~ 0.49, the flagship profile at a CPU-sized N).
    code = make_code(n=2048, m=1046, dv=3, seed=4, name="mother-2048")
    opts = DecodeOptions(max_iterations=60)
    rng = prng_key(7)

    banner(f"mother code {code.name}: R = {code.code_rate:.3f}")

    # --- 1. fixed-rate serving at a good channel (QBER 3%) --------------
    rec = Reconciler(code, opts, lanes=8, device=dev).warmup()
    alice = generate_random_bits(rng, code.n_vars, 8, device=dev)
    n_err = num_errors_for(code.n_vars, 0.03)
    bob = introduce_errors(fold_in(rng, 1), alice, n_err)
    syn = rec.syndromes(alice)
    out = rec.reconcile(bob, syn, qber=n_err / code.n_vars)
    assert out.syndromes_match.all()
    print(f"QBER 3.0%: 8/8 frames corrected via Reconciler, "
          f"mean {out.iterations.mean():.1f} iterations, "
          f"leak {rec.leak_bits} bits/frame")

    # --- 2. the channel degrades past the mother code's waterfall -------
    qber_bad = 0.095
    n_err = num_errors_for(code.n_vars, qber_bad)
    bob_bad = introduce_errors(fold_in(rng, 2), alice, n_err)
    out = rec.reconcile(bob_bad, syn, qber=n_err / code.n_vars)
    print(f"QBER {qber_bad:.1%}: mother code verifies "
          f"{int(out.syndromes_match.sum())}/8 frames — shorten instead:")

    # One rate family over the mother code: d = 512 modulated positions,
    # split between punctured and shortened on a grid of 64; both sides pick
    # the step from the QBER estimate (R_eff = 1 - f h(q), rounded down).
    family = RateFamily.make(code, d=512, seed=2, grid=64)
    step = family.step(qber_bad, efficiency=1.6)
    ad = family.member(step)
    l = family.payload_bits
    a_key = generate_random_bits(fold_in(rng, 3), l, 8, device=dev)
    ne = num_errors_for(l, qber_bad)
    b_key = introduce_errors(fold_in(rng, 4), a_key, ne)
    agile = Reconciler(code, opts, lanes=8, rates=family, device=dev)
    out = agile.reconcile(b_key, agile.syndromes(a_key, fold_in(rng, 5), rate=step),
                          ne / l, rate=step)
    assert out.syndromes_match.all()
    assert (out.bits == a_key.cpu().numpy()).all()
    print(f"  shortened s={ad.short_idx.size} (R_eff = {ad.effective_rate:.3f}, step "
          f"{step} of {family.steps}): 8/8 frames, "
          f"mean {out.iterations.mean():.1f} iterations")

    # --- 3. no QBER estimate at all: blind reconciliation ---------------
    d = 256
    l = code.n_vars - d
    a_key = generate_random_bits(fold_in(rng, 6), l, 8, device=dev)
    ne = num_errors_for(l, 0.05)
    b_key = introduce_errors(fold_in(rng, 7), a_key, ne)
    res, km = blind_reconcile_sim(
        code, a_key, b_key, n_punctured=d, qber_hint=0.05,
        opts=opts, reveal_step=64, device=dev,
    )
    assert km.all()
    print(f"blind (d={d} punctured, no estimate): 8/8 frames, "
          f"reveal rounds {sorted(set(res.rounds.tolist()))}, "
          f"per-frame leak {sorted(set(res.leak_bits.tolist()))} bits "
          f"(fixed-rate would leak {code.n_checks})")

    # --- 4. verify + amplify: the full production chain -----------------
    vkey, pkey = prng_key(99), prng_key(123)
    # back on the good channel from step 1
    good = rec.reconcile(bob, syn, qber=num_errors_for(code.n_vars, 0.03) / code.n_vars)
    tags_bob = verification_tags(good.bits, vkey, device=dev).cpu().numpy()
    # (deployed Alice computes hers over her own key; here we are Alice too)
    tags_alice = verification_tags(alice, vkey).cpu().numpy()
    verified = (tags_bob == tags_alice).all(axis=1)
    k_final = amplified_key_bits(code.n_vars, rec.leak_bits)
    final = privacy_amplify(good.bits[verified], pkey, k_final, device=dev)
    assert verified.all()
    print(f"verify + amplify: {int(verified.sum())}/8 frames verified, "
          f"final secret key {k_final} bits/frame "
          f"(from {code.n_vars} sifted bits, leak {rec.leak_bits} + tag 64 "
          f"+ security 100)")
    assert final.shape[1] == k_final

    banner("done")


if __name__ == "__main__":
    main()
