"""The JAX package's three example programs, ported: each runs with
``python -m qkd_ldpc_tpu_torch.examples.<name>`` on the card, or on the
host with ``--device cpu``."""
