"""Random LDPC code construction.

Counterpart of ``qkd_ldpc_tpu/codes/generate.py`` (numpy only;
reproduces its arrays bit for bit from the same seed).  Builds random
column-regular (optionally row-irregular) codes — e.g.
``make_code(n=10240, m=5231, dv=3)`` yields a column-weight-3 code whose
row weights split E = N*dv as evenly as possible over M checks (666 rows
of weight 5 and 4565 of weight 6).

Construction is stub matching (configuration model) with duplicate-edge
repair: variable stubs are dealt into check slots by a seeded permutation,
then any check containing a repeated variable swaps the offender with a
stub from another check until the graph is simple.
"""

from __future__ import annotations

import numpy as np

from qkd_ldpc_tpu_torch.codes.ldpc_code import LDPCCode, from_check_adjacency


def balanced_row_degrees(n_edges: int, n_checks: int) -> np.ndarray:
    """Split ``n_edges`` over ``n_checks`` rows as evenly as possible.

    Low-degree rows come first, matching how an even split is usually
    emitted; the order is irrelevant to code performance.
    """
    base, rem = divmod(n_edges, n_checks)
    if base == 0:
        raise ValueError("More checks than edges: some rows would be empty")
    deg = np.full(n_checks, base, dtype=np.int64)
    deg[n_checks - rem :] += 1
    return deg


def make_code(
    n: int,
    m: int,
    dv: int = 3,
    seed: int = 0,
    name: str = "",
    max_repair_rounds: int = 1000,
) -> LDPCCode:
    """Build a random column-regular LDPC code with N=n, M=m, column weight dv."""
    if not (0 < m < n):
        raise ValueError("Need 0 < m < n")
    rng = np.random.default_rng(seed)
    n_edges = n * dv
    row_deg = balanced_row_degrees(n_edges, m)
    offsets = np.concatenate([[0], np.cumsum(row_deg)])

    stubs = np.repeat(np.arange(n, dtype=np.int64), dv)
    rng.shuffle(stubs)

    # Repair duplicate edges: a check row must not contain the same variable
    # twice (it would cancel in GF(2) and break the simple-graph assumption
    # of the adjacency-list representation).
    row_of = np.repeat(np.arange(m, dtype=np.int64), row_deg)
    for _ in range(max_repair_rounds):
        key = row_of * n + stubs
        order = np.argsort(key, kind="stable")
        sorted_key = key[order]
        dup_mask_sorted = np.concatenate([[False], sorted_key[1:] == sorted_key[:-1]])
        dup_positions = order[dup_mask_sorted]
        if dup_positions.size == 0:
            break
        # Swap each duplicate stub with a uniformly random other stub.
        # Sequential transpositions: a simultaneous fancy-index swap loses
        # or duplicates stub values whenever partner indices repeat or
        # overlap dup_positions (two writes to one slot), silently changing
        # the column-degree profile.  Duplicates are few, so the loop is
        # cheap, and every transposition preserves the stub multiset —
        # column regularity is invariant by construction.
        partners = rng.integers(0, n_edges, size=dup_positions.size)
        for p, q in zip(dup_positions, partners):
            stubs[p], stubs[q] = stubs[q], stubs[p]
    else:
        raise RuntimeError("Failed to remove duplicate edges; try another seed")

    check_neighbors = [
        np.sort(stubs[offsets[c] : offsets[c + 1]]) for c in range(m)
    ]
    if not name:
        r = 1.0 - m / n
        name = f"(N={n},M={m},R={r:.2f},CW={dv},SEED={seed}).txt"
    return from_check_adjacency(check_neighbors, n_vars=n, name=name)
