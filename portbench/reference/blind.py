"""Blind reconciliation and its secure chain, worked out again from the
protocol (Martinez-Mateo, Elkouss and Martin, "Blind reconciliation").

- Positions: all ``d`` modulated positions of ``rate_adapt.plan`` are
  punctured (``p = d``); their ascending order is the reveal order.
- Round 0 decodes every frame from ``rate_adapt.llr`` of Bob's payload: the
  channel's ``+-mag`` at the payload, 0 at every punctured position.  Before
  round ``r`` Alice has revealed the first ``min(r * step, d)`` punctured bits
  of the frames still going, and those positions carry her bit pinned
  (``+64`` for a 0, ``-64`` for a 1).
- Each round decodes the frames not yet verified (``decode.py``).  A frame
  finishes at the first round whose decisions meet the syndrome, with that
  round's decisions and iteration count.  The rounds stop when every frame
  has finished, all ``d`` bits are revealed or ``max_rounds`` rounds followed
  the first; a frame still going then keeps the last round's iteration count
  and that round as its own.
- A frame's leak is ``M - d + 2 min(rounds * step, d)``.  Its key is the
  payload of its decisions where it verified, else zeros.  Then the chain:
  tags of the keys, verified where the syndrome and the tag both match, the
  final length ``max(0, l - leak - tag - margin)`` (0 where unverified) and
  the key row: the amplification's first ``final`` bits (a prefix of the
  hash at the longest length), zeros past them.
"""

from __future__ import annotations

import torch

from portbench.reference import rate_adapt, toeplitz
from portbench.reference.decode import decode


def rounds(dec, g, pl: rate_adapt.Plan, bob: torch.Tensor, syn: torch.Tensor,
           alice_frames: torch.Tensor, mag: float, step: int,
           max_rounds: int | None = None) -> dict:
    """Bob's rounds on payloads ``bob [F, l]`` toward ``syn [F, M]``, Alice's
    full frames ``alice_frames [F, N]`` answering the reveals: per frame the
    key ``[F, l]`` uint8, ``ok``, ``rounds``, ``iterations`` and ``leak``."""
    F, dev = bob.shape[0], bob.device
    d = pl.punct_idx.size
    n_rounds = max_rounds if max_rounds is not None else -(-d // step)
    punct = torch.as_tensor(pl.punct_idx, device=dev)
    key_idx = torch.as_tensor(pl.key_idx, device=dev)
    base = rate_adapt.llr(pl, bob, mag, 0)
    key = torch.zeros((F, pl.key_idx.size), dtype=torch.uint8, device=dev)
    ok = torch.zeros((F,), dtype=torch.bool, device=dev)
    rnd = torch.zeros((F,), dtype=torch.int32, device=dev)
    iters = torch.zeros((F,), dtype=torch.int32, device=dev)
    going = torch.arange(F, device=dev)
    r = revealed = 0
    while True:
        llr = base[going].clone()
        shown = punct[:revealed]
        llr[:, shown] = torch.where(alice_frames[going][:, shown] == 1, -rate_adapt.KNOWN_LLR,
                                    rate_adapt.KNOWN_LLR)
        z, it, good = decode(dec, g, llr, syn[going])
        iters[going] = it
        won = going[good]
        key[won] = z[good][:, key_idx]
        ok[won] = True
        rnd[won] = r
        going = going[~good]
        if not going.numel() or revealed >= d or r == n_rounds:
            break
        revealed = min(revealed + step, d)
        r += 1
    rnd[going] = r
    leak = pl.n_checks - d + 2 * torch.clamp(rnd.to(torch.int64) * step, max=d)
    return dict(key=key, ok=ok, rounds=rnd, iterations=iters, leak=leak)


def chain(out: dict, alice_tags: torch.Tensor, tag_key: torch.Tensor, pa_key: torch.Tensor,
          tag_bits: int, security_bits: int) -> dict:
    """The secure chain on :func:`rounds`' result: ``verified``, the ledger
    ``leak`` (tags included), ``final`` lengths and the key rows ``key
    [F, max(final)]``."""
    key, l = out["key"], out["key"].shape[1]
    tags = toeplitz.hash_bits(key, tag_key, tag_bits)
    verified = out["ok"] & (tags == alice_tags.to(tags.device)).all(dim=1)
    leak = out["leak"] + tag_bits
    final = torch.where(verified, torch.clamp(l - leak - security_bits, min=0), 0)
    width = int(final.max()) if final.numel() else 0
    rows = torch.zeros((key.shape[0], width), dtype=torch.uint8, device=key.device)
    if width:
        col = torch.arange(width, device=key.device)[None, :]
        rows = torch.where(col < final[:, None], toeplitz.hash_bits(key, pa_key, width), 0)
    return dict(key=rows.to(torch.uint8), verified=verified, leak=leak, final=final)
