"""Walkthrough: the full QKD post-processing chain on a structured code.

Counterpart of ``examples/secure_chain_example.py``: what a deployed pair
of nodes runs, over the quasi-cyclic code family —

1. both sides agree on a QC mother code (girth >= 6),
2. Alice transmits syndromes + verification tags over the classical
   channel,
3. Bob runs ``reconcile_secure``: decode -> tag comparison -> privacy
   amplification, with the leakage ledger setting the final key length,
4. the amplified keys match Alice's amplification of her own key —
   without either side ever revealing key material,
5. bonus: one BlindSession exchange (no QBER estimate at all).

Run:  python -m qkd_ldpc_tpu_torch.examples.secure_chain_example [--device cpu]
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
from qkd_ldpc_tpu_torch.codes import make_qc_code
from qkd_ldpc_tpu_torch.decoder import DecodeOptions, RateAdapter
from qkd_ldpc_tpu_torch.decoder.blind import BlindSession
from qkd_ldpc_tpu_torch.postprocess import privacy_amplify
from qkd_ldpc_tpu_torch.serve import Reconciler
from qkd_ldpc_tpu_torch.utils import resolve_device


def banner(s):
    print(f"\n=== {s} ===")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    dev = resolve_device(ap.parse_args(argv).device)

    code = make_qc_code(z=64, nb=16, mb=8, dv=3, seed=7)
    print(f"mother code: {code}")
    print(f"parity-check fingerprint (binds endpoints): {code.fingerprint}")

    opts = DecodeOptions(max_iterations=80)
    rec = Reconciler(code, opts, lanes=8, device=dev)
    qber = 0.03
    n_err = num_errors_for(code.n_vars, qber)

    banner("sifted keys + quantum channel")
    kk = prng_key(1)
    alice = generate_random_bits(kk, code.n_vars, 8, device=dev)
    bob = introduce_errors(fold_in(kk, 1), alice, n_err)
    alice, bob = alice.cpu().numpy(), bob.cpu().numpy()
    print(f"8 frames x {code.n_vars} bits, exactly {n_err} errors/frame "
          f"(QBER {n_err / code.n_vars:.3f})")

    banner("classical channel: Alice -> Bob")
    tag_key, pa_key = prng_key(11), prng_key(12)
    syn = rec.syndromes(alice)
    a_tags = rec.tags(alice, tag_key)
    print(f"syndromes: {syn.shape[1]} bits/frame; tags: {a_tags.shape[1]} "
          f"bits/frame; hash seeds are shared protocol randomness")

    banner("Bob: reconcile -> verify -> amplify (one call)")
    sec = rec.reconcile_secure(bob, syn, qber, a_tags, tag_key, pa_key)
    print(f"verified: {int(sec.verified.sum())}/8  "
          f"iterations: {sec.iterations.tolist()}")
    print(f"leakage ledger: {int(sec.leak_bits[0])} bits/frame "
          f"(syndrome {rec.leak_bits} + tag 64)")
    print(f"final key: {sec.final_bits} bits/frame after the leftover-hash "
          f"budget (security margin 100)")

    a_final = privacy_amplify(alice, pa_key, sec.final_bits, device=dev).cpu().numpy()
    assert (sec.key[sec.verified] == a_final[sec.verified]).all()
    print("Alice's and Bob's amplified keys are IDENTICAL on every "
          "verified frame.")

    banner("bonus: blind reconciliation (no QBER estimate)")
    d = 128
    ad = RateAdapter.make(code, n_punctured=d, seed=0)
    l = ad.payload_bits
    a_pay = generate_random_bits(fold_in(kk, 2), l, 4, device=dev)
    b_pay = introduce_errors(fold_in(kk, 3), a_pay, num_errors_for(l, 0.05))
    frames = ad.build_frames(a_pay, prng_key(4))
    frames_np = frames.cpu().numpy()
    s = BlindSession(ad, b_pay, ad.syndromes(frames), qber_hint=0.05,
                     opts=opts, reveal_step=32, device=dev)
    pos = s.begin()
    n_msgs = 0
    while pos is not None:  # each round = one classical-channel message
        n_msgs += 1
        pos = s.provide(frames_np[:, pos])
    out = s.result()
    assert (out.key == a_pay.cpu().numpy()).all() and out.ok.all()
    print(f"all 4 frames reconciled blind in {n_msgs} reveal round(s); "
          f"per-frame leakage {out.leak_bits.tolist()} bits "
          f"(adaptive — no channel estimate was ever made)")


if __name__ == "__main__":
    main()
