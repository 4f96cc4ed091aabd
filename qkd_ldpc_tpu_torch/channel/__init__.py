"""Channel model: sifted-key generation + exact-weight error injection."""

from qkd_ldpc_tpu_torch.channel.keys import (
    derive_point_key,
    make_trial_batch,
    make_trials_from_ids,
    master_key,
    num_errors_for,
)

__all__ = [
    "derive_point_key",
    "master_key",
    "make_trial_batch",
    "make_trials_from_ids",
    "num_errors_for",
]
