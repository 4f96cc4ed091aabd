"""Layered sum-product decode toward a target syndrome, in plain PyTorch.

The arithmetic the program's layered schedule documents
(``decoder/layered.py`` of the package under test), written again here from
the quasi-cyclic graph.  A layer is one base row: the ``z`` consecutive
checks ``i z .. i z + z - 1``, whose variables are all distinct.  Per frame
and sweep, layer after layer in base-row order:

- ``Lq = clip(t[v] - load(Lr))`` for each of the layer's edges, where ``t``
  are the float32 totals (the a-priori LLRs at the start, not rounded) and
  ``Lr`` the layer's stored messages (zero at the start);
- the check update of ``decode.py``: ``tanh(Lq / 2)`` products left to right
  and right to left in slot order, ``log1p(2x / (1 - x))``, clipped, rounded
  to the storage type;
- ``t[v] += load(Lr') - load(Lr)`` at once, so the next layer sees it.

After the last layer the decisions ``t <= 0`` are held against the target
syndrome; a frame that matches stops with the sweep's number, and one that
never does reports the iteration cap.  There is no check before the first
sweep, and both message directions clip.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import channel, codes
from portbench.reference.decode import Decoder


class Layers:
    """A quasi-cyclic graph's layers: for base row ``i``, the variables of
    its checks as ``[deg, z]`` int64 (slot by check) on the device."""

    def __init__(self, g: codes.Graph, z: int, device):
        if g.n_checks % z:
            raise ValueError("the checks do not split into layers of z")
        self.n_vars, self.n_checks, self.z = g.n_vars, g.n_checks, z
        self.var = []
        for i in range(g.n_checks // z):
            rows = g.checks[i * z:(i + 1) * z]
            if len({len(r) for r in rows}) != 1:
                raise ValueError("a layer's checks differ in degree")
            v = np.stack(rows, axis=1)  # [deg, z]
            if np.unique(v).size != v.size:
                raise ValueError("a layer touches a variable twice")
            self.var.append(torch.as_tensor(v, dtype=torch.int64, device=device))


def _check(dec: Decoder, lq: torch.Tensor, sign: torch.Tensor) -> torch.Tensor:
    """Stored messages ``[b, deg, z]`` from ``lq [b, deg, z]`` float32."""
    t = torch.tanh(lq * 0.5)
    deg = lq.shape[1]
    one = torch.ones_like(t[:, 0])
    pre, suf = [None] * deg, [None] * deg
    acc = one
    for k in range(deg):
        pre[k] = acc
        acc = acc * t[:, k]
    acc = one
    for k in range(deg - 1, -1, -1):
        suf[k] = acc
        acc = acc * t[:, k]
    x = torch.stack(pre, dim=1) * torch.stack(suf, dim=1) * sign[:, None, :]
    lr = torch.log1p(2.0 * x / (1.0 - x))
    if dec.clip:
        lr = torch.clamp(lr, -dec.threshold, dec.threshold)
    return dec.store(lr)


def decode(dec: Decoder, layers: Layers, gdev: codes.DeviceGraph, llr: torch.Tensor,
           syn: torch.Tensor):
    """``llr [B, N]`` float32, ``syn [B, M]`` int -> ``(z [B, N] uint8,
    iterations [B] int32, converged [B] bool)``."""
    B, N = llr.shape
    z_, dev = layers.z, llr.device
    syn = syn.to(torch.int8)
    t = llr.to(torch.float32).clone()
    sign = [torch.where(syn[:, i * z_:(i + 1) * z_] == 1, -1.0, 1.0)
            for i in range(len(layers.var))]
    Lr = [dec.store(torch.zeros((B, v.shape[0], z_), device=dev)) for v in layers.var]
    z = torch.zeros((B, N), dtype=torch.uint8, device=dev)
    iters = torch.full((B,), dec.max_iterations, dtype=torch.int32, device=dev)
    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    lanes = torch.arange(B, device=dev)
    for it in range(1, dec.max_iterations + 1):
        for i, v in enumerate(layers.var):
            old = dec.load(Lr[i])
            tv = t[:, v]  # [b, deg, z]
            lq = tv - old
            if dec.clip:
                lq = torch.clamp(lq, -dec.threshold, dec.threshold)
            new = _check(dec, lq, sign[i])
            t[:, v] = tv + (dec.load(new) - old)
            Lr[i] = new
        zl = (t <= 0).to(torch.uint8)
        ok = (channel.syndromes(gdev, zl) == syn).all(dim=1)
        if bool(ok.any()):
            hit = lanes[ok]
            z[hit], iters[hit], done[hit] = zl[ok], it, True
        go = ~ok
        if it == dec.max_iterations:
            z[lanes[go]] = zl[go]
        if not bool(go.any()):
            break
        if not bool(go.all()):
            lanes, t, syn = lanes[go], t[go].contiguous(), syn[go]
            sign = [s[go] for s in sign]
            Lr = [x[go] for x in Lr]
    return z, iters, done


def point(dec: Decoder, layers: Layers, gdev: codes.DeviceGraph, point_key: torch.Tensor,
          n_err: int, n_trials: int, width: int = 4096) -> dict:
    """The statistics of trials ``0 .. n_trials-1`` of a point decoded by
    the layered schedule (``stats.point``'s, with this decode)."""
    mag = channel.trial_magnitude(n_err, gdev.n_vars)
    out = dict(n_trials=0, n_sp=0, n_ldpc=0, sum_it=0, sum_it2=0, min_it=None, max_it=0)
    for lo in range(0, n_trials, width):
        ids = torch.arange(lo, min(lo + width, n_trials), dtype=torch.int64,
                           device=gdev.chk_adj.device)
        alice, bob = channel.trials(point_key, ids, gdev.n_vars, n_err)
        llr = torch.where(bob == 1, -mag, mag).to(torch.float32)
        zd, iters, ok = decode(dec, layers, gdev, llr, channel.syndromes(gdev, alice))
        match = (zd == alice).all(dim=1)
        it = iters[ok].to(torch.int64)
        out["n_trials"] += ids.numel()
        out["n_sp"] += int(ok.sum())
        out["n_ldpc"] += int((ok & match).sum())
        out["sum_it"] += int(it.sum())
        out["sum_it2"] += int((it * it).sum())
        if it.numel():
            lo_it = int(it.min())
            out["min_it"] = lo_it if out["min_it"] is None else min(out["min_it"], lo_it)
            out["max_it"] = max(out["max_it"], int(it.max()))
    return out
