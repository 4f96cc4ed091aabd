"""The continuation's segment with each pass's bookkeeping folded into the
next pass's variable update, and the staging arrays of ``stage_fill``.

On the card a segment is ``KV, K5`` for pass 0, ``KV`` with the previous
pass's bookkeeping folded in (``cuda_kernels.PassFold``) and ``K5`` for every
later pass, then one ``pass_step`` that brings the lanes home.  Here, on the
CPU, the same structure runs through the plain versions: the folded step
must equal ``pass_step_plain`` followed by ``variable_update_plain`` exactly,
and a whole segment must leave every lane tensor as the unfolded sequence
``segment x (KV, K5, pass_step)`` does, for both parities of ``segment``.
``stage_fill``'s plain version is held against the arrays of JAX's
``regen`` (``qkd_ldpc_tpu/sim/continuation.py:132-139``) on an irregular code
with padded check slots and at ragged staging widths.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qkd_ldpc_tpu import codes as jcodes
from qkd_ldpc_tpu.decoder.reconcile import apriori_llr as j_apriori_llr
from qkd_ldpc_tpu.decoder.syndrome import syndrome as j_syndrome
from qkd_ldpc_tpu_torch import codes as tcodes
from qkd_ldpc_tpu_torch.decoder import cuda_kernels
from qkd_ldpc_tpu_torch.decoder.bp import DecodeOptions
from qkd_ldpc_tpu_torch.decoder.cuda_kernels import PassFold
from qkd_ldpc_tpu_torch.decoder.reconcile import llr_magnitude
from qkd_ldpc_tpu_torch.sim import continuation as tcont
from qkd_ldpc_tpu_torch.sim import cuda_continuation as steps

torch.set_num_threads(1)
CPU = torch.device("cpu")
SEED = 20261018
B, MAX_IT = 16, 5
# an irregular code: rows of 5 and 6 checks' slots, so padded check slots
IRREGULAR = dict(n=1003, m=502, dv=3, seed=5)
STORAGE = {"float32": None, "bfloat16": None, "int8": 0.25}


@pytest.fixture(scope="module")
def code():
    return tcodes.make_code(**IRREGULAR)


def _lanes(rng, b=B):
    """Lane flags and ages as the previous pass's update leaves them (a lane
    that ran may have reached the cap there): some lanes at the cap or one
    below it, some fresh."""
    live = rng.random(b) < 0.8
    age = rng.integers(-1, MAX_IT + 1, b).astype(np.int32)
    age[rng.random(b) < 0.3] = MAX_IT - 1
    age[rng.random(b) < 0.2] = MAX_IT
    done = live & (rng.random(b) < 0.3)
    fresh = live & (rng.random(b) < 0.3)
    ok = rng.random(b) < 0.5
    # lanes 0..3, running: one at the cap, one converging, one reaching the
    # cap in this pass, one fresh
    live[:4], done[:4], ok[:4] = True, False, [False, True, False, False]
    age[:4], fresh[:4] = [MAX_IT, 2, MAX_IT - 1, -1], [False, False, False, True]
    run = live & ~done
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    return dict(run=t(run), age=t(age), done=t(done), fresh=t(fresh), ok=t(ok))


def _state(code, rng, dtype_name):
    """Messages, LLRs and decisions of ``B`` lanes in the storage type."""
    N, M, dc = code.n_vars, code.n_checks, code.dc_max
    scale = STORAGE[dtype_name]
    mdt = cuda_kernels.STORAGE_DTYPES[dtype_name]
    Lr = cuda_kernels._store(torch.from_numpy(2.0 * rng.standard_normal((dc, M, B)).astype(
        np.float32)), mdt, scale)
    return dict(Lr=Lr, llr=torch.from_numpy(4.0 * rng.standard_normal((N, B)).astype(np.float32)),
                z=torch.from_numpy(rng.integers(0, 2, (N, B)).astype(np.int8)),
                total=torch.zeros((N, B), dtype=mdt), **_lanes(rng))


def _clone(state):
    return {k: v.clone() for k, v in state.items()}


@pytest.mark.parametrize("dtype_name", list(STORAGE))
@pytest.mark.parametrize("which", ["pass_1", "later_pass", "last_pass"])
def test_folded_step_equals_pass_step_then_variable_update(code, dtype_name, which):
    """``variable_update_plain(fold=...)`` is ``pass_step_plain`` into the
    second set of buffers, then ``variable_update_plain`` on them: every
    tensor bit for bit, with lanes reaching the cap in the pass and fresh
    lanes (cleared on pass 1 only).  The last pass then brings the lanes home
    with ``pass_step_plain(out=...)``."""
    rng = np.random.default_rng(SEED + len(which) + len(dtype_name))
    maps, scale = code.to_device(CPU), STORAGE[dtype_name]
    state = _state(code, rng, dtype_name)
    state.update(run2=torch.from_numpy(rng.random(B) < 0.5),
                 age2=torch.zeros(B, dtype=torch.int32), ok2=torch.from_numpy(rng.random(B) < 0.5))
    fused, seq = _clone(state), _clone(state)
    pass_1 = which == "pass_1"

    fold = PassFold(ok=fused["ok"], done=fused["done"], run=fused["run2"], count=fused["age2"],
                    fresh=fused["fresh"] if pass_1 else None, max_it=MAX_IT)
    got = cuda_kernels.variable_update_plain(fused["Lr"], fused["llr"], fused["z"], fused["age"],
                                             fused["run"], maps, scale=scale,
                                             out=(fused["total"], fused["ok2"]), fold=fold)
    assert got[2] is fused["age2"] and got[3] is fused["ok2"]
    steps.pass_step_plain(seq["ok"], seq["done"], seq["run"], seq["age"], seq["fresh"], MAX_IT,
                          pass_1, out=(seq["run2"], seq["age2"], seq["ok2"]))
    cuda_kernels.variable_update_plain(seq["Lr"], seq["llr"], seq["z"], seq["age2"], seq["run2"],
                                       maps, scale=scale, out=(seq["total"], seq["ok2"]))
    if which == "last_pass":
        for t in (fused, seq):
            steps.pass_step_plain(t["ok2"], t["done"], t["run2"], t["age2"], t["fresh"], MAX_IT,
                                  False, out=(t["run"], t["age"], t["ok"]))
    for k in state:
        assert torch.equal(fused[k], seq[k]), k
    # the pass did something: a lane stopped at the cap, a lane converged
    capped = state["run"] & ~state["ok"] & (state["age"] >= MAX_IT)
    conv = state["run"] & state["ok"]
    assert bool(capped.any()) and bool(conv.any())
    assert torch.equal(fused["run2"], state["run"] & ~conv & (state["age"] < MAX_IT))
    assert torch.equal(fused["fresh"], torch.zeros_like(state["fresh"]) if pass_1
                       else state["fresh"])
    assert torch.equal(fused["ok"], state["ok"] if which != "last_pass" else fused["ok2"])


def test_folded_update_needs_out(code):
    state = _state(code, np.random.default_rng(SEED), "float32")
    fold = PassFold(ok=state["ok"], done=state["done"], run=state["run"].clone(),
                    count=state["age"].clone(), fresh=None, max_it=MAX_IT)
    with pytest.raises(ValueError, match="writes into out"):
        cuda_kernels.variable_update_plain(state["Lr"], state["llr"], state["z"], state["age"],
                                           state["run"], code.to_device(CPU), scale=None,
                                           fold=fold)


def test_pass_step_out_copies_age_and_ok():
    """``pass_step_plain(out=...)`` writes the new run into ``out`` and copies
    age and ok there, leaving its inputs (but done and fresh) untouched."""
    lanes = _lanes(np.random.default_rng(SEED + 1))
    before = _clone(lanes)
    out = (torch.zeros(B, dtype=torch.bool), torch.zeros(B, dtype=torch.int32),
           torch.zeros(B, dtype=torch.bool))
    steps.pass_step_plain(lanes["ok"], lanes["done"], lanes["run"], lanes["age"], lanes["fresh"],
                          MAX_IT, True, out=out)
    conv = before["ok"] & before["run"]
    assert torch.equal(out[0], before["run"] & ~conv & (before["age"] < MAX_IT))
    assert torch.equal(out[1], before["age"]) and torch.equal(out[2], before["ok"])
    for k in ("run", "age", "ok"):
        assert torch.equal(lanes[k], before[k]), k
    assert torch.equal(lanes["done"], before["done"] | conv) and not lanes["fresh"].any()


@pytest.mark.parametrize("dtype_name", list(STORAGE))
@pytest.mark.parametrize("segment", [1, 3, 4])
def test_segment_equals_the_unfolded_sequence(code, monkeypatch, segment, dtype_name):
    """The program's segment (pass 0's plain update, the folded updates of
    passes 1 .. segment - 1 alternating between two sets of lane buffers,
    one ``pass_step`` home) leaves run, done, age, ok, fresh, z, the totals
    and the messages as ``segment x (KV, K5, pass_step)`` does: both parities
    of ``segment`` end at home, and ``segment = 1`` clears fresh in its one
    ``pass_step``."""
    monkeypatch.setattr(steps, "bank", lambda *a, **k: None)  # the segment alone
    rng = np.random.default_rng(SEED + 10 * segment + len(dtype_name))
    opts = DecodeOptions(max_iterations=MAX_IT, algorithm="min-sum", message_dtype=dtype_name)
    prog = tcont._ContinuationProgram(code, 1, B, segment, 4, opts, "threefry", CPU)
    b = prog._buffers(CPU)
    state = _state(code, rng, dtype_name)
    state["syn"] = torch.from_numpy(rng.integers(0, 2, (code.n_checks, B)).astype(np.int8))
    state["Lr"][:, :, state["fresh"]] = 0  # a refilled lane starts from zero messages
    for k, v in state.items():
        getattr(b, k).copy_(v)
    b.run2.fill_(True)
    b.ok2.fill_(False)  # stale values in the second set must not leak
    b.age2.fill_(77)
    ref = SimpleLanes({k: getattr(b, k).clone() for k in state})
    prog._segment_and_bank(None, b)

    core = prog.core
    for i in range(segment):
        core.variable_update(ref.Lr, ref.llr, ref.z, ref.age, ref.run, out=(ref.total, ref.ok))
        core.check_update_fused(ref.total, ref.Lr, ref.syn, fresh=ref.fresh, ok=ref.ok,
                                out=ref.Lr)
        steps.pass_step_plain(ref.ok, ref.done, ref.run, ref.age, ref.fresh, MAX_IT, i == 0)
    for k in state:
        assert torch.equal(getattr(b, k), getattr(ref, k)), k
    assert not b.fresh.any()
    # lanes moved: some converged or stopped in the segment
    assert not torch.equal(b.run, state["run"])


class SimpleLanes:
    def __init__(self, d):
        self.__dict__.update(d)


@pytest.mark.parametrize("which,width", [("irregular", 101), ("irregular", 16),
                                         ("reference-alist", 37)])
def test_stage_fill_equals_jax_regen_on_padded_slots(which, width):
    """``stage_fill_plain`` against ``regen``'s arrays (:132-139) —
    ``apriori_llr(bob, q).T``, ``syndrome(code, alice).T``, ``alice.T`` — on
    an irregular code with padded check slots (N = 1003) at a ragged width
    S = 101 and at S = 16, and on the reference's own alist (rows of 5 and
    6) at S = 37; the LLR magnitude read from the carry as the program
    stages it."""
    if which == "irregular":
        jc, tc = jcodes.make_code(**IRREGULAR), tcodes.make_code(**IRREGULAR)
    else:
        path = ("data/alist_sparse_matrices/(N=10240,M=5231,R=0.49,CW=3,GEN=666).alist")
        jc, tc = jcodes.read_alist(path), tcodes.read_alist(path)
    maps = tc.to_device(CPU)
    assert not bool(maps.chk_mask_T.all())  # padded slots
    rng = np.random.default_rng(SEED + width)
    N, M = tc.n_vars, tc.n_checks
    n_err = int(N * 0.07)
    alice = rng.integers(0, 2, (width, N)).astype(np.uint8)
    bob = alice ^ (rng.random((width, N)) < 0.07).astype(np.uint8)
    q = np.float32(n_err) / np.float32(N)
    st = torch.zeros(steps.SLOTS, dtype=torch.int32)
    st[steps.MAG] = torch.from_numpy(llr_magnitude(q).astype(np.float32).reshape(1)).view(
        torch.int32)[0]
    llr_s = torch.zeros((N, width))
    syn_s, alice_s = (torch.zeros((M, width), dtype=torch.int8),
                      torch.zeros((N, width), dtype=torch.int8))
    steps.stage_fill_plain(torch.from_numpy(alice), torch.from_numpy(bob), maps,
                           st[steps.MAG:steps.MAG + 1], llr_s, syn_s, alice_s)
    want_llr = np.asarray(j_apriori_llr(jnp.asarray(bob), q)).T.astype(np.float32)
    want_syn = np.asarray(j_syndrome(jc, jnp.asarray(alice))).T.astype(np.int32)
    assert np.array_equal(llr_s.numpy(), want_llr)
    assert np.array_equal(syn_s.numpy().astype(np.int32), want_syn)
    assert np.array_equal(alice_s.numpy(), alice.T.astype(np.int8))


def test_stage_fill_bits_scratch():
    """The kernel's packed words between its two launches: ``[N, ceil(S /
    32)]`` int32; the wrapper refuses a scratch of another shape before it
    looks for the card."""
    assert steps.fill_bits_shape(512, 10240) == (10240, 16)
    assert steps.fill_bits_shape(101, 1003) == (1003, 4)
    tc = tcodes.make_code(**IRREGULAR)
    S, N, M = 40, tc.n_vars, tc.n_checks
    rows = torch.zeros((S, N), dtype=torch.uint8)
    args = (rows, rows, tc.to_device(CPU), torch.zeros(1, dtype=torch.int32),
            torch.zeros((N, S)), torch.zeros((M, S), dtype=torch.int8),
            torch.zeros((N, S), dtype=torch.int8))
    with pytest.raises(ValueError, match="bits must be int32"):
        steps.stage_fill_cuda(*args, bits=torch.zeros((N, 1), dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA"):
        steps.stage_fill_cuda(*args, bits=torch.zeros((N, 2), dtype=torch.int32))
