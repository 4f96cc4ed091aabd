"""The parity-check graph of a configuration, built again from its stated
construction: a quasi-cyclic lift (a frozen copy of the documented
construction, NumPy only) or an alist file read as text.

A graph is its per-check neighbour lists in slot order: ascending base
column in a QC row, file order in an alist row.  A variable lists its checks
in ascending check order.  The decode sums and multiplies in those orders.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Graph:
    n_vars: int
    n_checks: int
    checks: list  # [M] int64 arrays: variables of each check, in slot order

    @property
    def n_edges(self) -> int:
        return sum(len(c) for c in self.checks)

    @property
    def dc_max(self) -> int:
        return max(len(c) for c in self.checks)

    def dense_adjacency(self):
        """``(chk_adj [M, dc] int64, chk_mask [M, dc] bool)``."""
        dc = self.dc_max
        adj = np.zeros((self.n_checks, dc), np.int64)
        mask = np.zeros((self.n_checks, dc), bool)
        for c, vs in enumerate(self.checks):
            adj[c, :len(vs)] = vs
            mask[c, :len(vs)] = True
        return adj, mask

    def variable_slots(self):
        """``(var_edge [N, dv] int64, var_mask [N, dv] bool)``: the flat
        slot-major edge ``j * M + c`` of each variable's checks, ascending
        check order; padded slots point at ``dc * M`` (a zero message)."""
        adj, mask = self.dense_adjacency()
        M, dc = adj.shape
        c_idx, j_idx = np.nonzero(mask)  # check-major order
        v = adj[c_idx, j_idx]
        order = np.lexsort((c_idx, v))
        v, c_idx, j_idx = v[order], c_idx[order], j_idx[order]
        deg = np.bincount(v, minlength=self.n_vars)
        if (deg == 0).any():
            raise ValueError("a variable without checks")
        dv = int(deg.max())
        k = np.arange(v.size) - np.concatenate([[0], np.cumsum(deg)])[v]
        edge = np.full((self.n_vars, dv), dc * M, np.int64)
        vmask = np.zeros((self.n_vars, dv), bool)
        edge[v, k] = j_idx * M + c_idx
        vmask[v, k] = True
        return edge, vmask


@dataclasses.dataclass(frozen=True)
class DeviceGraph:
    """A graph's index tensors on one device (batch-last decode layout)."""

    n_vars: int
    n_checks: int
    dc: int
    dv: int
    chk_adj_T: torch.Tensor  # [dc * M] int64 (slot-major gather of variables)
    chk_mask_T: torch.Tensor  # [dc, M, 1] bool
    var_edge_T: torch.Tensor  # [dv * N] int64 into the flat [dc * M + 1] messages
    chk_adj: torch.Tensor  # [M, dc] int64 (syndromes)
    chk_mask: torch.Tensor  # [M, dc] bool
    irregular: bool


def on_device(g: Graph, device) -> DeviceGraph:
    adj, mask = g.dense_adjacency()
    edge, _ = g.variable_slots()
    M, dc = adj.shape

    def put(x, dtype):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype, device=device)

    return DeviceGraph(
        n_vars=g.n_vars, n_checks=M, dc=dc, dv=edge.shape[1],
        chk_adj_T=put(adj.T.reshape(-1), torch.int64),
        chk_mask_T=put(mask.T[:, :, None], torch.bool),
        var_edge_T=put(edge.T.reshape(-1), torch.int64),
        chk_adj=put(adj, torch.int64), chk_mask=put(mask, torch.bool),
        irregular=not bool(mask.all()),
    )


# ---------------------------------------------------------------------------
# Quasi-cyclic lift (random column-weight-dv base graph with balanced rows,
# random circulant shifts repaired until no 4-cycle is left).


def _balanced_base_rows(nb, mb, dv, rng):
    deg = np.zeros(mb, dtype=np.int64)
    cols = []
    for _ in range(nb):
        order = np.lexsort((rng.permutation(mb), deg))
        rows = sorted(order[:dv].tolist())
        for r in rows:
            deg[r] += 1
        cols.append(rows)
    return cols


def _four_cycles(cells, z):
    by_row = {}
    for (i, j) in cells:
        by_row.setdefault(i, []).append(j)
    rows = sorted(by_row)
    out = []
    for a in range(len(rows)):
        for b in range(a + 1, len(rows)):
            i1, i2 = rows[a], rows[b]
            common = sorted(set(by_row[i1]) & set(by_row[i2]))
            for x in range(len(common)):
                for y in range(x + 1, len(common)):
                    j1, j2 = common[x], common[y]
                    d = (cells[(i1, j1)] - cells[(i1, j2)]
                         + cells[(i2, j2)] - cells[(i2, j1)]) % z
                    if d == 0:
                        out.append((i1, i2, j1, j2))
    return out


def qc_graph(z: int, nb: int, mb: int, dv: int, seed: int, repair_rounds: int = 200) -> Graph:
    """The lifted graph: check ``i*z + r`` joins variable ``j*z + (r + s) % z``
    for each base cell ``(i, j)`` of shift ``s``, slots by base column."""
    rng = np.random.default_rng(seed)
    cols = _balanced_base_rows(nb, mb, dv, rng)
    cells = {}
    for j, rows in enumerate(cols):
        for i in rows:
            cells[(i, j)] = int(rng.integers(0, z))
    for _ in range(repair_rounds):
        bad = _four_cycles(cells, z)
        if not bad:
            break
        for (i1, i2, j1, j2) in bad:
            pick = [(i1, j1), (i1, j2), (i2, j1), (i2, j2)][rng.integers(0, 4)]
            cells[pick] = int(rng.integers(0, z))
    else:
        raise RuntimeError("4-cycles left after the repair rounds")
    row_cols = {}
    for (i, j) in cells:
        row_cols.setdefault(i, []).append(j)
    checks = []
    for i in range(mb):
        js = sorted(row_cols[i])
        for r in range(z):
            checks.append(np.array([j * z + (r + cells[(i, j)]) % z for j in js], np.int64))
    return Graph(n_vars=nb * z, n_checks=mb * z, checks=checks)


def alist_graph(path: str | Path) -> Graph:
    """The check rows of an alist file (1-based, zero padding dropped)."""
    lines = [[int(t) for t in ln.split()] for ln in Path(path).read_text().splitlines()
             if ln.strip()]
    n_cols, n_rows = lines[0]
    rows = lines[4 + n_cols:4 + n_cols + n_rows]
    if len(rows) != n_rows:
        raise ValueError(f"{path}: fewer check rows than declared")
    return Graph(n_vars=n_cols, n_checks=n_rows,
                 checks=[np.array([x - 1 for x in r if x != 0], np.int64) for r in rows])


def build(spec: dict, base: Path) -> Graph:
    """The graph of a configuration's ``code`` entry."""
    if spec["kind"] == "qc":
        return qc_graph(spec["z"], spec["nb"], spec["mb"], spec["dv"], spec["seed"])
    if spec["kind"] == "alist":
        return alist_graph(base / spec["file"])
    raise ValueError(f"unknown code kind {spec['kind']!r}")
