"""The continuation's outer-loop steps: CUDA kernel wrappers and plain versions.

The JAX package runs the whole continuation as one ``while_loop``
(``qkd_ldpc_tpu/sim/continuation.py::_continuation_core``); its steps around
the decode are closures of that program.  The port runs them as the kernels
of ``csrc/continuation.cu``, launched into buffers made before a capture, so
the continuation is one CUDA graph (``sim/continuation.py``).  Beside each
kernel is its plain PyTorch version, in place on the same tensors, which the
CPU and ``backend="xla"`` run and which the card holds each kernel against:

====================  ==============================================  ============
step                  JAX lines (``sim/continuation.py``)             kernel
====================  ==============================================  ============
:func:`start`         the initial carry :266-292, ``outer_cond`` :262  cont_start
:func:`stage_step`    ``regen``'s scalars :111-131                     stage_step
:func:`stage_fill`    ``regen``'s staging arrays :132-139              stage_fill
:func:`refill_lanes`  ``refill``'s lanes :154, :166-170, :189-197      refill_lanes
:func:`refill_copy`   ``refill``'s blends :156-188                     refill_copy
:func:`pass_step`     the segment pass's bookkeeping :225-233 (the     pass_step
                      last pass's; the others in the next pass's
                      variable update, ``cuda_kernels.PassFold``)
:func:`bank`          the banking :241-259, ``outer_cond`` :262        bank
====================  ==============================================  ============

The carry is one int32 vector ``st`` (slots :data:`BASE` ... :data:`FAULT`)
beside the ``[7, P]`` accumulators ``acc``; the per-call inputs are the int32
vector ``x`` (:data:`TRIALS`, :data:`OFFSET`, :data:`OUTER_CAP`, then the P
point keys' raw words, the P error counts and the P float32 LLR magnitudes'
bits).  Each loop has a bound that its structure never reaches (see
:func:`loop_caps`); a loop past it stops and raises a bit of ``st[FAULT]``,
which the caller turns into an error — a fault of the program cannot spin
the card forever.  The lanes' flags are bool ``[B]``, their ages and points
int32 ``[B]``.  The loops' tests write their verdicts into the uint8 ``flags
[4]`` (the eager program fetches them) and, inside a capture, set the
conditional nodes' handles.
``passes`` (int64 ``[1]`` on the card, or None) is a conditional body's
counter: the kernel adds one to it each time the body runs.

The refill loop's test (``want_lanes`` :205-209 and the cond's ``pos >= S``
:211-213, :func:`want_plain`) has no kernel of its own: ``test=``
(:class:`RefillTest`) hands it to the step it follows, which runs it last —
:func:`start` and :func:`bank` the test before the refill loop (where the
outer loop goes on), :func:`refill_lanes` and :func:`stage_step` the test
after a refill or a regeneration.  A plain version runs :func:`want_plain`
after its own work.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from qkd_ldpc_tpu_torch import _build
from qkd_ldpc_tpu_torch.decoder.cuda_kernels import PassFold, fold_plain

# Slots of the int32 carry (csrc/continuation.cu names them alike).  BASE, POS
# and SP are the staging block's first trial id, read position and point;
# NEXT_ID the ids consumed of that point; LIVE_N the live lanes; OUTER,
# REFILLS and GENS the loops' counts; KEY0..ID_BASE the staged point's key
# words, error count, LLR magnitude bits and first trial id (read on the card
# by K4, K3, KT and stage_fill); COL0 and N_NEW the last refill's first staged
# column and trial count; EXCESS K3's excess-ties flag; TICKET the banking
# kernel's block counter; INNER the refill loop's passes in this outer step;
# FAULT the bits of a loop stopped at its bound (FAULT_INNER, FAULT_OUTER).
(BASE, POS, SP, NEXT_ID, LIVE_N, OUTER, REFILLS, GENS, KEY0, KEY1, K, MAG, ID_BASE,
 COL0, N_NEW, EXCESS, TICKET, INNER, FAULT) = range(19)
SLOTS = 19
FAULT_INNER, FAULT_OUTER = 1, 2
# Fields of the input vector: then the P keys' words, error counts, magnitudes.
TRIALS, OFFSET, OUTER_CAP, KEYS = 0, 1, 2, 3
# Bytes of the verdicts: the outer loop's test, the refill loop's test, and
# the cond's two branches.
OUTER_GO, IN_GO, REGEN, REFILL = range(4)

KERNEL_START = "cont_start"
KERNEL_STAGE = "stage_step"
KERNEL_FILL = "stage_fill"
KERNEL_FILL_LAYERED = "stage_fill_layered"  # the layered trial chunk's staging
KERNEL_LANES = "refill_lanes"
KERNEL_COPY = "refill_copy"
KERNEL_PASS = "pass_step"
KERNEL_BANK = "bank"
KERNELS = (KERNEL_START, KERNEL_STAGE, KERNEL_FILL, KERNEL_LANES, KERNEL_COPY, KERNEL_PASS,
           KERNEL_BANK)

_I = ctypes.c_int
_P = ctypes.c_void_p
_H = ctypes.c_ulonglong


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch(name: str, argtypes: list, tensors, *args) -> None:
    """Check that ``tensors`` are contiguous and on one card, launch the C
    entry ``name`` of the library on the current stream, count the launch."""
    tensors = [t for t in tensors if t is not None]
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev or not t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} needs contiguous CUDA tensors on one device")
    fn = _build.function("continuation", name, argtypes + [_P])
    with torch.cuda.device(dev):
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    _build.check_launch(name, err)


def _more_ids(x: torch.Tensor, st: torch.Tensor, P: int) -> torch.Tensor:
    """JAX's ``_more_ids`` (:201-203): a later point, or ids left of this one."""
    return (st[SP] < P - 1) | (st[NEXT_ID] < x[TRIALS])


def _offsets_fit_int32(what: str, *sizes: int) -> None:
    """The kernels index with 32-bit integers: raise where an array's element
    count would not fit."""
    if max(sizes) >= 2**31:
        raise ValueError(f"{what}: arrays of 2**31 or more elements exceed the kernel's "
                         "32-bit offsets")


def _as_int32(v: torch.Tensor) -> torch.Tensor:
    """An int64 value in [0, 2**32) as the int32 with the same bits."""
    return torch.where(v >= 2**31, v - 2**32, v).to(torch.int32)


# ---------------------------------------------------------------------------
# the refill loop's test and the cond's predicate, run by the step before it

def loop_caps(trials: int, P: int, B: int, S: int, K: int, max_it: int,
              segment: int) -> tuple[int, int]:
    """(outer steps, refill passes an outer step) that the program never
    exceeds.  A trial occupies a lane for at most ``max_it + 1`` passes, so
    at most ``L = ceil((max_it + 1) / segment)`` outer steps pass without a
    refill while ids remain, and every refill moves at least one of the ``P
    * trials`` trials: at most ``(P * trials + 1) * (L + 1)`` outer steps.
    An outer step's refill loop fills at most ``B`` lanes (``B / K + 1``
    refills of trials), regenerates once per ``S / K`` refills, and crosses
    each point boundary with at most ``S / K + 2`` passes (a tail, refills
    past the tail, the regeneration that advances).  A pass here is JAX's:
    one regeneration or one refill."""
    L = -(-(max_it + 1) // segment)
    outer = min((P * trials + 1) * (L + 1), 2**31 - 1)
    inner = 2 * (B // K + 1) + P * (S // K + 3) + 4
    return outer, inner


def want_plain(x, st, B, P, K, S, inner_cap, entry, flags):
    """``want_lanes`` and the cond's predicates into ``flags[IN_GO:]``;
    ``entry``: the test before the refill loop (``st[INNER]`` starts at 0),
    else the test after a regeneration or a refill."""
    live_n = st[LIVE_N]
    go = _more_ids(x, st, P) & ((B - live_n >= K) | (live_n == 0))
    st[INNER] = 0 if entry else st[INNER] + 1
    stop = go & (st[INNER] >= inner_cap)
    st[FAULT] |= stop.to(torch.int32) * FAULT_INNER
    go = go & ~stop
    flags[IN_GO] = go
    flags[REGEN] = go & (st[POS] >= S)
    flags[REFILL] = go & (st[POS] < S)


class _WantArgs(ctypes.Structure):
    """``struct WantTest`` of ``csrc/continuation.cu``, field for field."""

    _fields_ = [("flags", ctypes.c_void_p), ("h_in", ctypes.c_ulonglong),
                ("h_regen", ctypes.c_ulonglong), ("h_refill", ctypes.c_ulonglong)] + [
        (name, ctypes.c_int) for name in ("B", "P", "K", "S", "inner_cap", "set_handle")]


class RefillTest(NamedTuple):
    """The refill loop's test (:func:`want_plain`), handed to the step that
    runs it last; ``handles`` = (the refill loop's, regen's, refill's)
    inside a capture."""

    B: int
    P: int
    K: int
    S: int
    inner_cap: int
    flags: torch.Tensor  # uint8 [4]
    handles: tuple | None = None

    def plain(self, x, st, entry: bool) -> None:
        want_plain(x, st, self.B, self.P, self.K, self.S, self.inner_cap, entry, self.flags)

    def args(self):
        """The kernel's argument (a pointer to it), or None without a test."""
        h = self.handles or (0, 0, 0)
        return ctypes.byref(_WantArgs(self.flags.data_ptr(), *h, self.B, self.P, self.K,
                                      self.S, self.inner_cap, int(self.handles is not None)))


def _args(test):
    return None if test is None else test.args()


# ---------------------------------------------------------------------------
# cont_start: the initial carry and the outer loop's entry test

def start_plain(x, acc, st, lanes, S, max_it, flags, test=None):
    """``lanes`` = (live, run, done, fresh, age, lane_p); ``test`` (where
    the outer loop starts) the refill loop's test before its first pass."""
    live, run, done, fresh, age, lane_p = lanes
    for t in (live, run, done, fresh, age, lane_p):
        t.zero_()
    acc.zero_()
    acc[5].fill_(max_it)  # min_it's neutral element
    st.zero_()
    st[BASE] = -S  # the first regenerated block holds trials 0..S-1
    st[POS] = S  # an empty staging block: the first pass regenerates
    flags[OUTER_GO] = _more_ids(x, st, acc.shape[1])
    if test is not None and bool(flags[OUTER_GO]):
        test.plain(x, st, True)


def start_cuda(x, acc, st, lanes, S, max_it, flags, handle=None, test=None):
    live, run, done, fresh, age, lane_p = lanes
    _launch(KERNEL_START, [_P] * 9 + [_I] * 4 + [_P, _H, _I, _P],
            (x, acc, st, *lanes, flags),
            x.data_ptr(), acc.data_ptr(), st.data_ptr(), live.data_ptr(), run.data_ptr(),
            done.data_ptr(), fresh.data_ptr(), age.data_ptr(), lane_p.data_ptr(),
            live.shape[0], acc.shape[1], S, max_it, flags.data_ptr(),
            handle or 0, int(handle is not None), _args(test))


def start(x, acc, st, lanes, S, max_it, flags, *, use_kernel, handle=None, test=None):
    if use_kernel:
        start_cuda(x, acc, st, lanes, S, max_it, flags, handle, test)
    else:
        start_plain(x, acc, st, lanes, S, max_it, flags, test)


# ---------------------------------------------------------------------------
# stage_step: regen's scalars

def stage_step_plain(x, st, S, P, passes=None, test=None):
    base = st[BASE] + S
    adv = base >= x[TRIALS]  # the current point's ids are exhausted: advance
    st[BASE] = torch.where(adv, 0, base)
    st[SP] = torch.where(adv, torch.clamp(st[SP] + 1, max=P - 1), st[SP])
    st[NEXT_ID] = torch.where(adv, 0, st[NEXT_ID])
    sp = st[SP].long()
    st[KEY0:KEY1 + 1] = x[KEYS:KEYS + 2 * P].view(P, 2)[sp]
    st[K] = x[KEYS + 2 * P + sp]
    st[MAG] = x[KEYS + 3 * P + sp]
    first = (x[OFFSET].long() & 0xFFFFFFFF) + st[BASE].long()
    st[ID_BASE] = _as_int32(first & 0xFFFFFFFF)  # ids mod 2**32
    st[POS] = 0
    st[EXCESS] = 0  # K3 only raises its flag
    st[GENS] += 1
    if passes is not None:
        passes += 1
    if test is not None:
        test.plain(x, st, False)


def stage_step_cuda(x, st, S, P, passes=None, test=None):
    _launch(KERNEL_STAGE, [_P, _P, _I, _I, _P, _P], (x, st, passes),
            x.data_ptr(), st.data_ptr(), S, P, _ptr(passes), _args(test))


def stage_step(x, st, S, P, *, use_kernel, passes=None, test=None):
    if use_kernel:
        stage_step_cuda(x, st, S, P, passes, test)
    else:
        stage_step_plain(x, st, S, P, passes, test)


# ---------------------------------------------------------------------------
# stage_fill: regen's staging arrays, transposed, with Alice's syndrome

def stage_fill_plain(alice_rows, bob, maps, mag, llr_s, syn_s, alice_s):
    """From Alice's and Bob's ``[S, N]`` uint8 rows: ``llr_s [N, S]`` float32
    (the a-priori LLR; ``mag`` is the int32 ``[1]`` holding its magnitude's
    float32 bits: the continuation's ``st[MAG]``, the trial chunk's input
    vector), ``syn_s [M, S]`` int8 (Alice's syndrome, ``decoder/syndrome.py``'s
    parity) and ``alice_s [N, S]`` int8.  ``maps`` is the code's
    ``LDPCCode.to_device``."""
    mag = mag.view(torch.float32)
    llr_s.copy_(torch.where(bob.T == 1, -mag, mag))
    alice_s.copy_(alice_rows.T)
    gathered = torch.where(maps.chk_mask, alice_rows.to(torch.int32)[:, maps.chk_adj], 0)
    syn_s.copy_((gathered.sum(dim=-1, dtype=torch.int32) & 1).T)


def fill_bits_shape(S: int, N: int) -> tuple[int, int]:
    """The kernel's packed bits between its two launches: int32 ``[N,
    ceil(S / 32)]``, Alice's bits of 32 adjacent trials a word."""
    return N, -(-S // 32)


def stage_fill_cuda(alice_rows, bob, maps, mag, llr_s, syn_s, alice_s, bits=None):
    """Two launches (the transpose that packs Alice's bits, then the syndrome
    from the words; ``csrc/continuation.cu``), one count.  ``bits``
    (:func:`fill_bits_shape`, int32) is made when not given."""
    S, N = alice_rows.shape
    dc, M = maps.chk_adj_T_i32.shape
    if bob.shape != (S, N) or llr_s.shape != (N, S) or alice_s.shape != (N, S) or (
            syn_s.shape != (M, S)):
        raise ValueError("stage_fill: the rows are [S, N], the staging arrays [N, S] / [M, S]")
    if mag.shape != (1,) or mag.dtype != torch.int32:
        raise ValueError("stage_fill: mag is the int32 [1] of the magnitude's float32 bits")
    _offsets_fit_int32("stage_fill", N * S, M * S)
    if bits is None:
        bits = torch.empty(fill_bits_shape(S, N), dtype=torch.int32, device=alice_rows.device)
    elif bits.shape != fill_bits_shape(S, N) or bits.dtype != torch.int32:
        raise ValueError(f"stage_fill: bits must be int32 {fill_bits_shape(S, N)}")
    _launch(KERNEL_FILL, [_P] * 9 + [_I] * 4,
            (alice_rows, bob, maps.chk_adj_T_i32, maps.chk_mask_T_i32, mag, llr_s, syn_s,
             alice_s, bits),
            alice_rows.data_ptr(), bob.data_ptr(), maps.chk_adj_T_i32.data_ptr(),
            maps.chk_mask_T_i32.data_ptr(), mag.data_ptr(), llr_s.data_ptr(),
            syn_s.data_ptr(), alice_s.data_ptr(), bits.data_ptr(), S, N, M, dc)


def stage_fill_widths(alice_rows, bob, llr_s, syn_s, alice_s) -> dict[str, int]:
    """Bytes an access of the instances :func:`stage_fill_cuda` launches for
    these tensors, from N, S and the base addresses: ``rows`` along Alice's
    and Bob's ``[S, N]`` rows (16, 8, 4 or 1), ``staging`` along ``alice_s``
    (4, with a float4 of ``llr_s``, or 1), ``syndrome`` along ``syn_s`` (16,
    8, 4 or 1)."""
    fn = _build.function("continuation", "stage_fill_widths", [_P] * 5 + [_I, _I])
    S, N = alice_rows.shape
    w = int(fn(alice_rows.data_ptr(), bob.data_ptr(), llr_s.data_ptr(), syn_s.data_ptr(),
               alice_s.data_ptr(), S, N))
    return {"rows": w & 0xFF, "staging": (w >> 8) & 0xFF, "syndrome": w >> 16}


def stage_fill_layered_plain(alice_rows, bob, tables, mag, t, syn, alice_l):
    """The staging in the layered sweep's own layout (``decoder/layered.py``),
    for the layered trial chunk: from Alice's and Bob's ``[S, N]`` uint8
    rows, ``t [nb, S, z]`` float32 (the a-priori LLRs, ``mag`` as in
    :func:`stage_fill_plain`), ``syn [mb, S, z]`` int8 (Alice's syndrome:
    check ``k`` of base row ``i`` is the parity of her bits ``j z + (k + s)
    mod z`` over the row's cells ``(j, s)``) and ``alice_l [nb, S, z]`` int8.
    ``tables`` is the code's ``layered.layer_tables``.  The ``[N, S]``
    staging's arrays, each row ``j z + k`` moved to ``[j, :, k]``."""
    nb, S, z = t.shape
    mag = mag.view(torch.float32)
    t.copy_(torch.where(bob == 1, -mag, mag).view(S, nb, z).transpose(0, 1))
    runs = alice_rows.view(S, nb, z).transpose(0, 1)
    alice_l.copy_(runs)
    for i, row in enumerate(tables.rows):
        parity = torch.zeros_like(runs[0])
        for _, j, s in row:
            parity = parity ^ torch.roll(runs[j], -s, dims=-1)
        syn[i].copy_(parity & 1)


def stage_fill_layered_cuda(alice_rows, bob, tables, mag, t, syn, alice_l):
    """One launch (``csrc/continuation.cu``'s ``stage_fill_layered``)."""
    S, N = alice_rows.shape
    nb, mb, z = tables.nb, tables.mb, tables.z
    if bob.shape != (S, N) or N != nb * z or t.shape != (nb, S, z) or (
            alice_l.shape != (nb, S, z) or syn.shape != (mb, S, z)):
        raise ValueError("stage_fill: the rows are [S, nb z], the layered staging "
                         "[nb, S, z] / [mb, S, z]")
    if t.dtype != torch.float32 or syn.dtype != torch.int8 or alice_l.dtype != torch.int8:
        raise ValueError("stage_fill: t is float32, syn and alice_l int8")
    if mag.shape != (1,) or mag.dtype != torch.int32:
        raise ValueError("stage_fill: mag is the int32 [1] of the magnitude's float32 bits")
    _offsets_fit_int32("stage_fill", N * S, mb * z * S)
    _launch(KERNEL_FILL_LAYERED, [_P] * 9 + [_I] * 4,
            (alice_rows, bob, tables.row_ptr, tables.col, tables.shift, mag, t, syn, alice_l),
            alice_rows.data_ptr(), bob.data_ptr(), tables.row_ptr.data_ptr(),
            tables.col.data_ptr(), tables.shift.data_ptr(), mag.data_ptr(), t.data_ptr(),
            syn.data_ptr(), alice_l.data_ptr(), S, nb, mb, z)


def stage_fill_layered_width(alice_rows, bob, t, syn, alice_l) -> int:
    """Positions a thread of :func:`stage_fill_layered_cuda` takes: 4 where
    ``z`` and the base addresses allow it, else 1."""
    fn = _build.function("continuation", "stage_fill_layered_width", [_P] * 5 + [_I])
    return int(fn(alice_rows.data_ptr(), bob.data_ptr(), t.data_ptr(), syn.data_ptr(),
                  alice_l.data_ptr(), t.shape[2]))


def stage_fill(alice_rows, bob, maps, mag, llr_s, syn_s, alice_s, *, use_kernel, bits=None):
    """The staging in the layout of ``llr_s``: ``[N, S]`` (``maps`` the
    code's ``LDPCCode.to_device``), or the layered sweep's ``[nb, S, z]``
    (``maps`` its ``layered.layer_tables``; ``bits`` unused)."""
    if llr_s.ndim == 3:
        fill = stage_fill_layered_cuda if use_kernel else stage_fill_layered_plain
        fill(alice_rows, bob, maps, mag, llr_s, syn_s, alice_s)
    elif use_kernel:
        stage_fill_cuda(alice_rows, bob, maps, mag, llr_s, syn_s, alice_s, bits)
    else:
        stage_fill_plain(alice_rows, bob, maps, mag, llr_s, syn_s, alice_s)


# ---------------------------------------------------------------------------
# refill_lanes: the first n_new empty lanes, and their carry

def refill_lanes_plain(x, st, lanes, lane_of, K, passes=None, test=None):
    """``lane_of [K]`` int32 gets the chosen lanes in lane order (-1 past
    n_new); the refilled lanes start with age -1, not done, live, running,
    fresh, on point ``st[SP]``."""
    live, run, done, fresh, age, lane_p = lanes
    pos = st[POS].clone()
    n_new = torch.clamp(x[TRIALS] - (st[BASE] + pos), 0, K)
    empty = ~live
    rank = empty.cumsum(0, dtype=torch.int32) - 1
    pick = empty & (rank < n_new)
    chosen = pick.nonzero().flatten()  # in lane order
    lane_of.fill_(-1)
    lane_of[:chosen.shape[0]] = chosen.to(torch.int32)
    age[pick] = -1
    done[pick] = False
    live |= pick
    run |= pick
    fresh |= pick  # back-to-back refills accumulate
    lane_p[pick] = st[SP]
    st[COL0] = pos
    st[N_NEW] = n_new
    st[NEXT_ID] += n_new
    st[LIVE_N] += n_new
    st[POS] = pos + K  # by K even at a point's tail
    st[REFILLS] += (n_new > 0).to(torch.int32)
    if passes is not None:
        passes += 1
    if test is not None:
        test.plain(x, st, False)


def refill_lanes_cuda(x, st, lanes, lane_of, K, passes=None, test=None):
    live, run, done, fresh, age, lane_p = lanes
    if lane_of.shape != (K,) or lane_of.dtype != torch.int32:
        raise ValueError("lane_of must be int32 [K]")
    _launch(KERNEL_LANES, [_P] * 9 + [_I, _I, _P, _P], (x, st, *lanes, lane_of, passes),
            x.data_ptr(), st.data_ptr(), live.data_ptr(), run.data_ptr(), done.data_ptr(),
            fresh.data_ptr(), age.data_ptr(), lane_p.data_ptr(), lane_of.data_ptr(),
            live.shape[0], K, _ptr(passes), _args(test))


def refill_lanes(x, st, lanes, lane_of, K, *, use_kernel, passes=None, test=None):
    if use_kernel:
        refill_lanes_cuda(x, st, lanes, lane_of, K, passes, test)
    else:
        refill_lanes_plain(x, st, lanes, lane_of, K, passes, test)


# ---------------------------------------------------------------------------
# refill_copy: the staged columns into the chosen lanes

def refill_copy_plain(st, lane_of, staged, pool):
    """``staged`` = (llr_s, syn_s, alice_s), ``pool`` = (llr, syn, alice,
    Lr): columns ``COL0 ..`` of the staging arrays into lanes ``lane_of[:
    N_NEW]``, and those lanes' messages zeroed (the lane's next variable
    update makes its totals the a-priori LLRs, which completes no
    iteration)."""
    n_new, col0 = int(st[N_NEW]), int(st[COL0])
    if n_new == 0:
        return
    lanes = lane_of[:n_new].long()
    for src, dst in zip(staged, pool):
        dst.index_copy_(1, lanes, src[:, col0:col0 + n_new])
    pool[3].index_fill_(2, lanes, 0)


def refill_copy_cuda(st, lane_of, staged, pool):
    llr_s, syn_s, alice_s = staged
    llr, syn, alice, Lr = pool
    N, S = llr_s.shape
    M, B = syn.shape
    dc = Lr.shape[0]
    if Lr.shape != (dc, M, B) or llr.shape != (N, B) or alice.shape != (N, B) or (
            syn_s.shape != (M, S) or alice_s.shape != (N, S)):
        raise ValueError("refill_copy: staging arrays [N | M, S], lanes [N | M, B], "
                         "Lr [dc, M, B]")
    _offsets_fit_int32("refill_copy", N * S, N * B, dc * M * B)
    _launch(KERNEL_COPY, [_P] * 9 + [_I] * 7, (st, lane_of, *staged, *pool),
            st.data_ptr(), lane_of.data_ptr(), llr_s.data_ptr(), syn_s.data_ptr(),
            alice_s.data_ptr(), llr.data_ptr(), syn.data_ptr(), alice.data_ptr(),
            Lr.data_ptr(), Lr.element_size(), N, M, dc * M, B, S, lane_of.shape[0])


def refill_copy(st, lane_of, staged, pool, *, use_kernel):
    if use_kernel:
        refill_copy_cuda(st, lane_of, staged, pool)
    else:
        refill_copy_plain(st, lane_of, staged, pool)


# ---------------------------------------------------------------------------
# pass_step: the bookkeeping of a segment's last pass

def pass_step_plain(ok, done, run, age, fresh, max_it, first, out=None):
    """``conv = ok & run``; ``done |= conv``; ``run = (run ^ conv) & (age <
    max_it)``; the first pass of a segment clears ``fresh``.  ``out = (run,
    age, ok)``: the lane buffers that receive the new ``run`` and copies of
    ``age`` and ``ok`` (the inputs themselves when None).  The segment's
    earlier passes run this inside the next pass's variable update
    (``cuda_kernels.PassFold``), into the other set of buffers; the last one
    brings the lanes home."""
    run_out, age_out, ok_out = (run, age, ok) if out is None else out
    fold_plain(PassFold(ok=ok, done=done, run=run_out, count=age_out,
                        fresh=fresh if first else None, max_it=max_it), age, run)
    if ok_out is not ok:
        ok_out.copy_(ok)


def pass_step_cuda(ok, done, run, age, fresh, max_it, first, out=None):
    run_out, age_out, ok_out = (run, age, ok) if out is None else out
    _launch(KERNEL_PASS, [_P] * 8 + [_I] * 3,
            (ok, done, run, age, fresh, run_out, age_out, ok_out),
            ok.data_ptr(), done.data_ptr(), run.data_ptr(), age.data_ptr(), fresh.data_ptr(),
            run_out.data_ptr(), age_out.data_ptr(), ok_out.data_ptr(), max_it, int(first),
            done.shape[0])


def pass_step(ok, done, run, age, fresh, max_it, first, *, use_kernel, out=None):
    if use_kernel:
        pass_step_cuda(ok, done, run, age, fresh, max_it, first, out)
    else:
        pass_step_plain(ok, done, run, age, fresh, max_it, first, out)


# ---------------------------------------------------------------------------
# bank: finished lanes into their points' accumulators, and the outer test

def bank_plain(x, acc, st, lanes, z, alice, mis, max_it, flags, passes=None, test=None):
    """``lanes`` = (live, run, done, age, lane_p); ``mis [B]`` int32 is the
    kernel's scratch (all 0 before and after); ``test`` (where the outer
    loop goes on) the next refill loop's test before its first pass."""
    live, run, done, age, lane_p = lanes
    P = acc.shape[1]
    finished = live & ~run
    sp_r = finished & done
    keys = (z == alice).all(dim=0)  # keys_match (only used where sp_r)
    it_sp = torch.where(sp_r, age, 0)
    lp = lane_p.long()
    i32 = torch.int32
    acc[0].index_add_(0, lp, finished.to(i32))
    acc[1].index_add_(0, lp, sp_r.to(i32))
    acc[2].index_add_(0, lp, (sp_r & keys).to(i32))
    acc[3].index_add_(0, lp, it_sp)
    acc[4].index_add_(0, lp, it_sp * it_sp)
    # Unfinished/dead lanes contribute the neutral elements.
    acc[5].scatter_reduce_(0, lp, torch.where(sp_r, age, max_it), "amin", include_self=True)
    acc[6].scatter_reduce_(0, lp, it_sp, "amax", include_self=True)
    live &= ~finished
    mis.zero_()
    st[LIVE_N] = live.sum(dtype=i32)
    st[OUTER] += 1
    st[TICKET] = 0
    go = _more_ids(x, st, P) | (st[LIVE_N] > 0)
    stop = go & (st[OUTER] >= x[OUTER_CAP])
    st[FAULT] |= stop.to(torch.int32) * FAULT_OUTER
    flags[OUTER_GO] = go & ~stop
    if passes is not None:
        passes += 1
    if test is not None and bool(flags[OUTER_GO]):
        test.plain(x, st, True)


def bank_cuda(x, acc, st, lanes, z, alice, mis, max_it, flags, passes=None, handle=None,
              test=None):
    live, run, done, age, lane_p = lanes
    N, B = z.shape
    if alice.shape != (N, B) or mis.shape != (B,) or mis.dtype != torch.int32:
        raise ValueError("bank: z and alice [N, B] int8, mis int32 [B]")
    _offsets_fit_int32("bank", N * B)
    _launch(KERNEL_BANK, [_P] * 11 + [_I] * 3 + [_P, _P, _H, _I, _P],
            (x, acc, st, *lanes, z, alice, mis, flags, passes),
            x.data_ptr(), acc.data_ptr(), st.data_ptr(), live.data_ptr(), run.data_ptr(),
            done.data_ptr(), age.data_ptr(), lane_p.data_ptr(), z.data_ptr(),
            alice.data_ptr(), mis.data_ptr(), N, B, acc.shape[1], flags.data_ptr(),
            _ptr(passes), handle or 0, int(handle is not None), _args(test))


def bank_width(z, alice) -> int:
    """Bytes a load of the banking kernel's instance for these tensors: 16,
    or 8, 4, 1 where the row stride ``B`` or a base address is not 16-byte
    aligned (chosen at launch, as :func:`bank_cuda` does)."""
    fn = _build.function("continuation", "bank_width", [_P, _P, _I])
    return int(fn(z.data_ptr(), alice.data_ptr(), z.shape[1]))


def bank(x, acc, st, lanes, z, alice, mis, max_it, flags, *, use_kernel, passes=None,
         handle=None, test=None):
    if use_kernel:
        bank_cuda(x, acc, st, lanes, z, alice, mis, max_it, flags, passes, handle, test)
    else:
        bank_plain(x, acc, st, lanes, z, alice, mis, max_it, flags, passes, test)
