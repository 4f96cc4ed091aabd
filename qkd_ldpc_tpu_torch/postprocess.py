"""Post-reconciliation stages: error verification + privacy amplification.

Counterpart of ``qkd_ldpc_tpu/postprocess.py``.  A deployed QKD
post-processor needs two stages after reconciliation:

- **Error verification**: syndrome convergence does NOT imply key
  equality.  Both sides exchange a short universal hash of the reconciled
  key and discard frames that disagree (undetected-error probability
  2^-tag_bits).
- **Privacy amplification**: compress the verified key by the disclosed
  information plus a security margin with a 2-universal hash.

Both use seeded binary TOEPLITZ hashing: ``T[i, j] = s[i - j + n - 1]``
from a shared seed sequence of n + k - 1 bits (the threefry stream of
``bernoulli(seed_key, 0.5, (n + k - 1,))``, the JAX package's bits for the
same key).  The GF(2) product is an integer matrix product whose parity
is taken mod 2.  The JAX package multiplies bf16 0/1 operands with float32
accumulation on the TPU; a bf16 ``torch.matmul`` *returns* bf16, which
holds integers exactly only up to 256, so the port takes every product
from an exact result (:func:`_products`): int8 operands with int32
accumulation (``torch._int_mm``) where its shape rules allow, else float32
operands (0/1 entries and sums below 2**24 are exact, also under TF32).
The JAX module has no Pallas kernel; these products are library matmuls,
as the JAX package leaves them to XLA.

Four evaluation methods, bit-identical (same seed stream, same matrix):

- **dense** — materialize T once, one [B, n] x [n, k] product.  Right for
  tag-sized outputs and small frames; at N = 262,144 the matrix itself
  (~125k x 262k) cannot exist.
- **blocked** — T with square [c, c] blocks is block-Toeplitz: only
  nI + nJ - 1 distinct blocks exist.  Build them once (int8, shear tiling,
  contiguous copies only) and accumulate ``out[I] += D[I - J] @ x[J]``
  with one contiguous [nI*c, c] slice of the stack per J, int32 carry.
- **blocked-xor** — the same scan with the parity of each step's product
  XORed into an int8 carry.
- **blocked-diag** — one scan step per DIAGONAL: ``D[e]`` times a
  contiguous [c, nI*B] window of the zero-extended frame matrix, so the
  stack is read once; int8 XOR carry.

Tensors stay on the device they come in on; numpy inputs go to
``device`` (``None`` = the card, which raises without one).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from qkd_ldpc_tpu_torch.channel.keys import block_words
from qkd_ldpc_tpu_torch.channel.threefry import bernoulli_half
from qkd_ldpc_tpu_torch.utils import resolve_device, tensor_on


def _seed_bits(seed_key: torch.Tensor, n: int, device) -> torch.Tensor:
    """``bernoulli(seed_key, 0.5, (n,))`` as uint8 on ``device``."""
    return bernoulli_half(block_words(seed_key, (n,), device))


def _products(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a [m, k] @ b [k, n]`` of 0/1 int8 operands as exact int32 sums:
    ``torch._int_mm`` (int32 accumulation) where its shape rules allow —
    more than 16 rows, k a multiple of 8, n padded to a multiple of 8 —
    else in float32 (exact for sums below 2**24)."""
    m, k = a.shape
    n = b.shape[1]
    if m > 16 and k % 8 == 0:
        return torch._int_mm(a.contiguous(), F.pad(b, (0, -n % 8)).contiguous())[:, :n]
    return (a.to(torch.float32) @ b.to(torch.float32)).to(torch.int32)


def toeplitz_matrix(seed_key: torch.Tensor, n_in: int, n_out: int,
                    device=None) -> torch.Tensor:
    """Binary Toeplitz matrix [n_out, n_in] (float32 0/1) from n_in + n_out
    - 1 seeded bits.

    Built by the shear-tiling identity (contiguous copies only): tiling a
    period-(L + 1) sequence into rows of length L = n_in + n_out - 1 shifts
    each row's phase by one, so with v = flip(s) + one junk element,
    columns [n_out - 1, n_out - 1 + n_in) are exactly T[i, j] = s[i - j +
    n_in - 1]."""
    if n_out < 1 or n_in < 1:
        raise ValueError("hash dimensions must be >= 1")
    L = n_in + n_out - 1
    s = _seed_bits(seed_key, L, resolve_device(device))
    v = torch.cat([torch.flip(s, (0,)), s.new_zeros(1)])
    t = v.expand(n_out, L + 1).reshape(-1)[: n_out * L]
    return t.view(n_out, L)[:, n_out - 1: n_out - 1 + n_in].to(torch.float32)


def _hash_apply(T: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    # float32 0/1 operands: the sums (at most n_in) are exact; parity mod 2.
    acc = bits.to(torch.float32) @ T.T
    return (acc.to(torch.int32) & 1).to(torch.uint8)


def _build_diag_stack(s: torch.Tensor, n_in: int, n_out: int, c: int) -> torch.Tensor:
    """[nD, c, c] int8 stack of the distinct block-Toeplitz diagonals, built
    by shear tiling (contiguous copies only).

    With s' = [Np - n_in zeros | s | Mp - n_out zeros] (the front zeros pair
    with the zero-padded tail of x, the rear zeros land in discarded rows),
    block (I, J) entry (a, b) is s'[c*(I - J) + (a - b) + Np - 1], so the
    block of diagonal e = I - J + nJ - 1 is built from s'[c*e : c*e + 2c - 1]."""
    nI, nJ = -(-n_out // c), -(-n_in // c)
    nD = nI + nJ - 1
    Np, Mp = nJ * c, nI * c
    s = s.to(torch.int8)
    z = s.new_zeros
    spad = torch.cat([z(Np - n_in), s, z(Mp - n_out)])  # [Mp + Np - 1]
    A = torch.cat([spad, z(1)]).view(nD + 1, c)
    locs = torch.cat([A[:-1], A[1:, : c - 1]], dim=1)  # [nD, 2c-1]
    V = torch.cat([torch.flip(locs, (1,)), z((nD, 1))], dim=1)  # [nD, 2c]
    Vr = torch.cat([V[:, c - 1:], V[:, : c - 1]], dim=1)
    return (Vr[:, None, :].expand(nD, c, 2 * c).reshape(nD, 2 * c * c)[:, : c * (2 * c - 1)]
            .reshape(nD, c, 2 * c - 1)[:, :, :c].contiguous())


def _pad_frame_blocks(bits: torch.Tensor, n_in: int, nJ: int, c: int) -> torch.Tensor:
    """[nJ, c, B] int8 zero-extended column blocks of the frame batch."""
    x = F.pad(bits.to(torch.int8), (0, nJ * c - n_in))
    return x.T.reshape(nJ, c, bits.shape[0])


def _hash_apply_blocked(s, bits, n_in: int, n_out: int, c: int) -> torch.Tensor:
    """Streaming block-Toeplitz hash, int32 carry: per column block J, the
    nI diagonals that pair with x[J] (e = I - J + nJ - 1, consecutive in I)
    are one contiguous [nI*c, c] row slice of the stack."""
    B = bits.shape[0]
    nI, nJ = -(-n_out // c), -(-n_in // c)
    Dflat = _build_diag_stack(s, n_in, n_out, c).view(-1, c)
    xb = _pad_frame_blocks(bits, n_in, nJ, c)
    acc = torch.zeros((nI * c, B), dtype=torch.int32, device=bits.device)
    for J in range(nJ):
        e0 = (nJ - 1 - J) * c
        acc += _products(Dflat[e0: e0 + nI * c], xb[J])
    return (acc[:n_out] & 1).to(torch.uint8).T


def _hash_apply_blocked_xor(s, bits, n_in: int, n_out: int, c: int) -> torch.Tensor:
    """:func:`_hash_apply_blocked` with XOR-parity accumulation: each step's
    product is reduced mod 2 at once and the carry is int8."""
    B = bits.shape[0]
    nI, nJ = -(-n_out // c), -(-n_in // c)
    Dflat = _build_diag_stack(s, n_in, n_out, c).view(-1, c)
    xb = _pad_frame_blocks(bits, n_in, nJ, c)
    acc = torch.zeros((nI * c, B), dtype=torch.int8, device=bits.device)
    for J in range(nJ):
        e0 = (nJ - 1 - J) * c
        acc ^= (_products(Dflat[e0: e0 + nI * c], xb[J]) & 1).to(torch.int8)
    return acc[:n_out].to(torch.uint8).T


def _hash_apply_blocked_diag(s, bits, n_in: int, n_out: int, c: int) -> torch.Tensor:
    """Per-DIAGONAL block-Toeplitz hash: the stack is read once.  Out block I
    accumulates D[e] @ x[I - e + nJ - 1]; for fixed e those x blocks are
    consecutive, one contiguous [c, nI*B] window of the zero-extended frame
    matrix.  XOR-parity carry, int8."""
    B = bits.shape[0]
    nI, nJ = -(-n_out // c), -(-n_in // c)
    nD = nI + nJ - 1
    D = _build_diag_stack(s, n_in, n_out, c)
    xb = _pad_frame_blocks(bits, n_in, nJ, c)
    z = xb.new_zeros((nI - 1, c, B))
    # column group p holds x block p - (nI - 1)
    Xmat = torch.cat([z, xb, z]).permute(1, 0, 2).reshape(c, -1)
    acc = torch.zeros((c, nI * B), dtype=torch.int8, device=bits.device)
    for e in range(nD):
        p0 = (nI + nJ - 2 - e) * B
        acc ^= (_products(D[e], Xmat[:, p0: p0 + nI * B]) & 1).to(torch.int8)
    out = acc.view(c, nI, B).permute(1, 0, 2).reshape(nI * c, B)
    return out[:n_out].to(torch.uint8).T


_BLOCKED_KERNELS = {
    "blocked": _hash_apply_blocked,
    "blocked-xor": _hash_apply_blocked_xor,
    "blocked-diag": _hash_apply_blocked_diag,
}
# What "auto" resolves to above _DENSE_LIMIT: the JAX package's default; the
# three are bit-identical and differ only in traffic.
_BLOCKED_DEFAULT = "blocked"

# Above this many T entries the dense path would materialize an
# unreasonable matrix and the streaming path takes over.
_DENSE_LIMIT = 1 << 26


def toeplitz_hash(bits, seed_key: torch.Tensor, n_out: int, block_out: int = 256,
                  method: str = "auto", device=None) -> torch.Tensor:
    """Hash key frames [B, n] (or [n]) to [B, n_out] (or [n_out]) uint8 bits.

    ``method='auto'`` uses the dense product for tag-sized work and the
    streaming block-Toeplitz path (``_BLOCKED_DEFAULT``) once T would exceed
    ``_DENSE_LIMIT`` entries; every method produces bit-identical output for
    the same seed and any ``block_out``."""
    x = tensor_on(bits, device, torch.uint8)
    arr = torch.atleast_2d(x)
    n_in = arr.shape[-1]
    if method == "auto":
        method = "dense" if n_in * n_out <= _DENSE_LIMIT else _BLOCKED_DEFAULT
    if method == "dense":
        out = _hash_apply(toeplitz_matrix(seed_key, n_in, n_out, arr.device), arr)
    elif method in _BLOCKED_KERNELS:
        s = _seed_bits(seed_key, n_in + n_out - 1, arr.device)
        out = _BLOCKED_KERNELS[method](s, arr, n_in, n_out, min(block_out, n_out))
    else:
        raise ValueError(f"Unknown method {method!r}")
    return out[0] if x.ndim == 1 else out


def verification_tags(bits, seed_key: torch.Tensor, tag_bits: int = 64,
                      device=None) -> torch.Tensor:
    """Short verification hash per frame ([.., tag_bits] uint8).  The tag is
    disclosed — count ``tag_bits`` into the leakage budget."""
    return toeplitz_hash(bits, seed_key, tag_bits, device=device)


def amplified_key_bits(payload_bits: int, leak_bits: int, tag_bits: int = 64,
                       security_bits: int = 100) -> int:
    """Final-key length after privacy amplification: payload minus all
    disclosed information minus the security parameter (0 if the frame
    yields no key)."""
    return max(0, payload_bits - leak_bits - tag_bits - security_bits)


def privacy_amplify(bits, seed_key: torch.Tensor, final_bits: int,
                    device=None) -> torch.Tensor:
    """Compress verified key frames to ``final_bits`` with a 2-universal
    Toeplitz hash ([.., final_bits] uint8)."""
    if final_bits < 1:
        raise ValueError(
            "no key material left after the leakage budget; use a lower "
            "rate (shorten) or a better channel"
        )
    return toeplitz_hash(bits, seed_key, final_bits, device=device)
