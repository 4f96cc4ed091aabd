"""Traffic kinds: one driver per kind, found by name."""
