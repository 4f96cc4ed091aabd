"""Golden walkthrough: Johnson, *Introducing LDPC Codes*, example 2.5.

Counterpart of ``examples/qkd_ldpc_example.py``: fixed 6-bit Alice/Bob keys
differing in bit 0 (nominal QBER 0.2), the regular (N=6, M=4) toy
parity-check matrix, sum-product decoding with all three trace levels on
(100-iteration cap, LLR clamp +-100) on the host float64 oracle — a fully
traced known-answer run of one reconciliation step — and then the same
frame through the device decoder (the kernels on the card).

Run:  python -m qkd_ldpc_tpu_torch.examples.qkd_ldpc_example [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np

from qkd_ldpc_tpu_torch.codes import from_dense
from qkd_ldpc_tpu_torch.decoder import DecodeOptions, reconcile
from qkd_ldpc_tpu_torch.sim.tracing import TraceFlags, traced_reconcile

H = [
    [1, 1, 0, 1, 0, 0],
    [0, 1, 1, 0, 1, 0],
    [1, 0, 0, 0, 1, 1],
    [0, 0, 1, 1, 0, 1],
]
ALICE = np.array([0, 0, 1, 0, 1, 1], np.uint8)
BOB = np.array([1, 0, 1, 0, 1, 1], np.uint8)  # bit 0 flipped
QBER = 0.2


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device of the device decode (default: the card)")
    args = ap.parse_args(argv)

    code = from_dense(np.array(H), name="johnson-ex-2.5")
    print(f"Code: {code}")
    print(f"Alice key: {ALICE.tolist()}")
    print(f"Bob key:   {BOB.tolist()}  (error in bit 0, QBER {QBER})")
    print()

    res, keys_match = traced_reconcile(
        code, ALICE, BOB, QBER,
        max_iterations=100,
        clip_messages=True,
        message_threshold=100.0,
        flags=TraceFlags(qkd_ldpc=True, sum_product=True, sum_product_llr=True),
    )

    assert keys_match, "walkthrough must recover Alice's key"
    assert res.iterations <= 5, "toy example converges in a few iterations"
    print()
    print(f"Recovered Alice's key in {res.iterations} iteration(s).")

    dev = reconcile(code, ALICE, BOB, QBER, DecodeOptions(max_iterations=100),
                    device=args.device)
    assert bool(dev.keys_match), "the device decoder must recover Alice's key"
    print(f"Device decoder ({dev.bits.device}): Alice's key in "
          f"{int(dev.iterations)} iteration(s).")


if __name__ == "__main__":
    main()
