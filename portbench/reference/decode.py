"""Flooding sum-product decode toward a target syndrome, in plain PyTorch.

Per frame: iteration 1 is the check update on the a-priori LLRs rounded to
the message storage type; every pass then forms each variable's total
``store(llr + sum of its check messages)`` (summed in ascending check order),
takes the decisions ``total <= 0``, and stops the frame when their syndrome
equals the target; otherwise the check update runs on
``Lq = clip(total - Lr)`` with ``tanh`` products taken left to right (the
prefix) and right to left (the suffix) in slot order and
``Lr = store(clip(log1p(2x / (1 - x))))``.  A frame that never stops reports
the iteration cap.  Arithmetic is float32; storage rounds to nearest even
(bfloat16) or to ``clip(round(x / scale), +-127)`` (int8 fixed point).

Frames are independent, so a pass runs on the frames still going only.
"""

from __future__ import annotations

import dataclasses

import torch

STORAGE = {"float32": torch.float32, "bfloat16": torch.bfloat16, "int8": torch.int8}


@dataclasses.dataclass(frozen=True)
class Decoder:
    max_iterations: int = 100
    threshold: float = 100.0
    clip: bool = True
    storage: str = "bfloat16"
    int8_scale: float = 0.25

    def store(self, x):
        dt = STORAGE[self.storage]
        if dt != torch.int8:
            return x.to(dt)
        s = torch.full((), self.int8_scale, dtype=torch.float32, device=x.device)
        return torch.clamp(torch.round(x / s), -127.0, 127.0).to(torch.int8)

    def load(self, q):
        x = q.to(torch.float32)
        return x * self.int8_scale if q.dtype == torch.int8 else x


def _check(dec: Decoder, g, lq, syn_sign):
    """Messages ``[dc, M, B]`` (stored) from ``lq [dc, M, B]`` float32."""
    one = torch.ones_like(lq[0])
    t = torch.tanh(lq * 0.5)
    if g.irregular:
        t = torch.where(g.chk_mask_T, t, one)
    dc = lq.shape[0]
    pre, suf = [None] * dc, [None] * dc
    acc = one
    for j in range(dc):
        pre[j] = acc
        acc = acc * t[j]
    acc = one
    for j in range(dc - 1, -1, -1):
        suf[j] = acc
        acc = acc * t[j]
    x = torch.stack(pre) * torch.stack(suf) * syn_sign
    lr = torch.log1p(2.0 * x / (1.0 - x))
    if dec.clip:
        lr = torch.clamp(lr, -dec.threshold, dec.threshold)
    return dec.store(lr)


def decode(dec: Decoder, g, llr: torch.Tensor, syn: torch.Tensor):
    """``llr [B, N]`` float32, ``syn [B, M]`` int -> ``(z [B, N] uint8,
    iterations [B] int32, converged [B] bool)``."""
    B, N = llr.shape
    M, dc = g.n_checks, g.dc
    dev = llr.device
    llr_t = llr.T.contiguous()  # [N, B]
    syn_t = syn.T.to(torch.int32).contiguous()  # [M, B]
    z = torch.zeros((N, B), dtype=torch.uint8, device=dev)
    iters = torch.zeros((B,), dtype=torch.int32, device=dev)
    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    lanes = torch.arange(B, device=dev)
    sign = torch.where(syn_t == 1, -1.0, 1.0)
    first = dec.load(dec.store(llr_t)).index_select(0, g.chk_adj_T).view(dc, M, B)
    Lr = _check(dec, g, first, sign)
    for it in range(1, dec.max_iterations + 1):
        b = lanes.numel()
        flat = torch.cat([Lr.view(dc * M, b), Lr.new_zeros((1, b))])
        msg = dec.load(flat.index_select(0, g.var_edge_T)).view(-1, N, b)
        acc = msg[0]
        for k in range(1, msg.shape[0]):
            acc = acc + msg[k]
        total = dec.store(llr_t + acc)
        zl = (total <= 0).to(torch.uint8)
        z[:, lanes] = zl
        iters[lanes] = it
        par = torch.where(g.chk_mask_T, zl.index_select(0, g.chk_adj_T).view(dc, M, b), 0)
        ok = ((par.to(torch.int32).sum(dim=0) & 1) == syn_t).all(dim=0)
        done[lanes[ok]] = True
        go = ~ok
        if not bool(go.any()) or it == dec.max_iterations:
            break
        lq = (dec.load(total).index_select(0, g.chk_adj_T).view(dc, M, b)
              - dec.load(Lr))
        if dec.clip:
            lq = torch.clamp(lq, -dec.threshold, dec.threshold)
        Lr = _check(dec, g, lq, sign)
        if not bool(go.all()):
            keep = go.nonzero().flatten()
            lanes, Lr = lanes[keep], Lr[:, :, keep].contiguous()
            llr_t, syn_t, sign = (t[:, keep].contiguous() for t in (llr_t, syn_t, sign))
    iters = torch.where(done, iters, dec.max_iterations)
    return z.T.contiguous(), iters, done
