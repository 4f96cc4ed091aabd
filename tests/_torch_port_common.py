"""Shared helpers of the tests/test_torch_*.py files: the same inputs, made
from a seed with numpy, go to the JAX package and to the PyTorch port."""

import numpy as np

from qkd_ldpc_tpu import codes as jcodes
from qkd_ldpc_tpu_torch import codes as tcodes

CODE_SPECS = {
    "irregular": ("make_code", dict(n=256, m=131, dv=3, seed=1)),
    "qc": ("make_qc_code", dict(z=32, nb=12, mb=6, dv=3, seed=5)),
}
_cache = {}


def code_pair(which):
    """(JAX package's code, port's code) built by each package's own
    generator from the same seed."""
    if which not in _cache:
        fn, kw = CODE_SPECS[which]
        _cache[which] = (getattr(jcodes, fn)(**kw), getattr(tcodes, fn)(**kw))
    return _cache[which]


def make_frames(n_bits, batch, n_err, seed):
    """Alice's keys and Bob's copies with exactly n_err flips each (uint8)."""
    rng = np.random.default_rng(seed)
    alice = rng.integers(0, 2, (batch, n_bits), dtype=np.uint8)
    bob = alice.copy()
    for b in range(batch):
        bob[b, rng.choice(n_bits, n_err, replace=False)] ^= 1
    return alice, bob
