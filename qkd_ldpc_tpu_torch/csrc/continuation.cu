// The continuation runner's outer loop on the card: the steps of JAX's
// _continuation_core (qkd_ldpc_tpu/sim/continuation.py:62-295) that surround
// the decode, as kernels of one captured CUDA graph.
//
// JAX runs the continuation as one while_loop: an outer loop (:262, :294)
// whose body is a while_loop of refills (:205-219) choosing between regen
// (:111-140) and refill (:142-199) with lax.cond (:211-213), the segment's
// fori_loop (:235) and the banking of finished lanes (:241-259).  Here the
// loops are WHILE nodes and the choice two IF nodes (decoder/device_loop.py),
// and each step below is a kernel that reads and writes the carry in device
// memory, so no host value reaches the program after its capture:
//
//   cont_start    the initial carry (:266-292) and the outer loop's entry test;
//   stage_step    regen's scalars (:111-131): the next block's base, point,
//                 key, error count, LLR magnitude and first trial id;
//   stage_fill    regen's staging arrays (:132-139) from K4's Alice row and
//                 K3's Bob row (a transpose that packs Alice's bits, then
//                 the syndrome from the packed words: two launches); its
//                 instance stage_fill_layered stages the layered trial
//                 chunk's batches in the sweep's [nb, S, z] layout instead;
//   refill_lanes  refill's lane choice (:154, :166-170) and the carry updates
//                 of the refilled lanes (:189-197);
//   refill_copy   refill's column copies into the chosen lanes (:156-188);
//   pass_step     the bookkeeping (:225-233) of a segment's last pass (the
//                 other passes' runs in the next pass's variable update);
//   bank          the banking (:241-259), live_n and the outer loop's test.
//
// The carry is int32 `st` (slots below, shared with sim/cuda_continuation.py)
// and the accumulators `acc [7, P]`; the per-call inputs are the int32 vector
// `x` = [trials, trial_offset, outer_cap, keys [P, 2], error counts [P], LLR
// magnitudes [P] as float32 bits].  Both loops carry a bound that their
// structure never reaches (outer_cap outer steps; inner_cap refill passes an
// outer step): past it the loop stops and st[kFault] says so, and the host
// raises, so a fault in the program cannot spin the card forever.  Lane flags
// are bytes (torch.bool).  Every kernel that ends a conditional body adds one
// to `passes` (an int64, may be null), so the host can count the body's
// launches afterwards; the tests write their verdicts to `flags` (the eager
// loop fetches them) and, inside a graph, set the conditional nodes' handles
// with cudaGraphSetConditional.
//
// The refill loop's test (want_lanes, :205-209, and the cond's pos >= S,
// :211-213; want_test below) has no kernel of its own: the kernel that ends
// each step the test follows runs it, as its last work.  Before the refill
// loop that is cont_start (the first outer step) or bank's last block (the
// next one, where the outer loop goes on); after a refill, refill_lanes; after
// a regeneration, stage_step.  A regeneration's test sets the refill IF node
// that follows it in the same pass of the refill loop: the pass's body is the
// two IF nodes alone, regen then refill, so a pass is a regeneration and the
// refill after it, or a refill alone (JAX's steps in JAX's order, two of its
// passes in one).  The refill loop's bound counts JAX's passes (st[kInner],
// one a test) as before.
//
// Bound on this card: launch latency for all but three; the carry is a few
// bytes a lane.  stage_fill moves the staging block (S x N Alice and Bob bytes
// in, 6 S N bytes out plus the syndrome), refill_copy the refilled columns,
// bank reads z and Alice's bits of the lanes that bank a success.  The three
// were redesigned for this card, each with a note below.
#include <cstdint>
#include <cuda_runtime.h>

#include "lane_groups.cuh"

namespace {

// Slots of the int32 carry `st` (sim/cuda_continuation.py names them alike).
constexpr int kBase = 0, kPos = 1, kSp = 2, kNextId = 3, kLiveN = 4, kOuter = 5,
              kRefills = 6, kGens = 7, kKey0 = 8, kKey1 = 9, kK = 10, kMag = 11,
              kIdBase = 12, kCol0 = 13, kNNew = 14, kExcess = 15, kTicket = 16, kInner = 17,
              kFault = 18;
constexpr int kSlots = 19;
// Fields of the input vector `x`.
constexpr int kTrials = 0, kOffset = 1, kOuterCap = 2, kKeys = 3;
// Bits of st[kFault]: a loop went past the bound that its structure allows
// (a fault of the program, never of the data), so it was stopped.
constexpr int kFaultInner = 1, kFaultOuter = 2;
// Bytes of `flags`.
constexpr int kOuterGo = 0, kInGo = 1, kRegen = 2, kRefill = 3;
constexpr int kThreads = 256;

__device__ __forceinline__ bool more_ids(const int* x, const int* st, int P) {
    return st[kSp] < P - 1 || st[kNextId] < x[kTrials];  // JAX's _more_ids (:201-203)
}

__device__ __forceinline__ void count_pass(long long* passes) {
    if (passes != nullptr) *passes += 1;
}

// The refill loop's test, which the kernels that end its steps run (null
// `flags`: none).  Layout: sim/cuda_continuation.py's _WantArgs (ctypes).
struct WantTest {
    uint8_t* flags;  // [4] the verdicts
    unsigned long long h_in, h_regen, h_refill;  // the refill loop's, regen's, refill's
    int B, P, K, S, inner_cap;
    int set_handle;  // inside a graph
};

// want_lanes (:205-209) and the cond's predicates (:211-213), by one thread.
// `entry`: the test before the refill loop (its count of passes starts at 0);
// else the test after a regeneration or a refill.
__device__ void want_test(const int* x, int* st, const WantTest& w, bool entry) {
    const int live_n = st[kLiveN];
    bool want = more_ids(x, st, w.P) && (w.B - live_n >= w.K || live_n == 0);
    const int inner = entry ? 0 : st[kInner] + 1;
    st[kInner] = inner;
    if (want && inner >= w.inner_cap) {
        want = false;
        st[kFault] |= kFaultInner;
    }
    const bool regen = want && st[kPos] >= w.S;
    const bool refill = want && st[kPos] < w.S;
    w.flags[kInGo] = want ? 1 : 0;
    w.flags[kRegen] = regen ? 1 : 0;
    w.flags[kRefill] = refill ? 1 : 0;
    if (w.set_handle) {
        cudaGraphSetConditional(w.h_in, want ? 1u : 0u);
        cudaGraphSetConditional(w.h_regen, regen ? 1u : 0u);
        cudaGraphSetConditional(w.h_refill, refill ? 1u : 0u);
    }
}

int lane_threads(int B) {
    return B < 1024 ? ((B + 31) / 32) * 32 : 1024;
}

__global__ void cont_start_kernel(const int* __restrict__ x, int* __restrict__ acc,
                                  int* __restrict__ st, uint8_t* __restrict__ live,
                                  uint8_t* __restrict__ run, uint8_t* __restrict__ done,
                                  uint8_t* __restrict__ fresh, int* __restrict__ age,
                                  int* __restrict__ lane_p, int B, int P, int S, int max_it,
                                  uint8_t* __restrict__ flags,
                                  cudaGraphConditionalHandle h_out, int set_handle,
                                  const WantTest want) {
    for (int b = threadIdx.x; b < B; b += blockDim.x) {
        live[b] = run[b] = done[b] = fresh[b] = 0;
        age[b] = lane_p[b] = 0;
    }
    // n_trials, n_sp, n_ldpc, sum_it, sum_it2, min_it (neutral: max_it), max_it
    for (int i = threadIdx.x; i < 7 * P; i += blockDim.x) acc[i] = i / P == 5 ? max_it : 0;
    if (threadIdx.x == 0) {
        for (int i = 0; i < kSlots; ++i) st[i] = 0;
        st[kBase] = -S;  // the first regenerated block holds trials 0..S-1
        st[kPos] = S;    // an empty staging block: the first pass regenerates
        const bool go = more_ids(x, st, P);  // outer_cond with no lane live
        flags[kOuterGo] = go ? 1 : 0;
        if (set_handle) cudaGraphSetConditional(h_out, go ? 1u : 0u);
        if (go && want.flags != nullptr) want_test(x, st, want, true);
    }
}

__global__ void stage_step_kernel(const int* __restrict__ x, int* __restrict__ st, int S, int P,
                                  long long* __restrict__ passes, const WantTest want) {
    int base = st[kBase] + S;
    int sp = st[kSp];
    if (base >= x[kTrials]) {  // the current point's ids are exhausted: advance
        base = 0;
        sp = min(sp + 1, P - 1);
        st[kNextId] = 0;
    }
    st[kBase] = base;
    st[kSp] = sp;
    st[kKey0] = x[kKeys + 2 * sp];
    st[kKey1] = x[kKeys + 2 * sp + 1];
    st[kK] = x[kKeys + 2 * P + sp];
    st[kMag] = x[kKeys + 3 * P + sp];
    st[kIdBase] = static_cast<int>(static_cast<uint32_t>(x[kOffset]) +
                                   static_cast<uint32_t>(base));  // ids mod 2**32
    st[kPos] = 0;
    st[kExcess] = 0;  // K3 only raises its flag
    st[kGens] += 1;
    count_pass(passes);
    if (want.flags != nullptr) want_test(x, st, want, false);
}

// stage_fill: the [S, N] rows of Alice's and Bob's bits into the staging
// arrays alice_s [N, S] (int8) and llr_s [N, S] (float32, Bob's bit 1 -> -mag,
// else +mag), and Alice's syndrome syn_s [M, S] (int8).  The magnitude's
// float32 bits are read on the card from `mag`: the continuation's st[kMag],
// the trial chunk's input vector (sim/runner.py, whose batches of S trials
// it stages the same way).
//
// Bound on this card: the bytes (2 S N in, 5 S N + M S out: 39.6 MB at the
// flagship, 11.8 us).  A syndrome computed one thread a (check, trial), trials
// fastest, reads 32 rows N bytes apart a warp, a sector a byte: 15.7 M sector
// reads through L2 for 2.6 MB of syndrome at the flagship.  The design: two
// kernels in stream order.
//   stage_fill_kernel transposes tiles of kTileS trials x kTileN variables
//   through shared memory.  It loads R bytes a thread along n (a warp: four
//   rows of 128 bytes).  A lane then reads four rows of one 4-variable word
//   and turns them into four columns of 4 trials by byte permutes; the 16
//   lanes of a half-warp hold trials 0 .. 63 of one word, so each store of a
//   column is 256 contiguous bytes of llr_s (a float4 a lane) and 64 of
//   alice_s (4 bytes a lane), two rows a warp.  (Lanes that each store 16
//   trials of one variable, 16 bytes, touch 32 lines a warp store: 53 us at
//   the flagship on an H100.)  Word w of tile row r lies at w ^ (2 (r / 4 mod 16)),
//   so the 16-byte loads of a row and the column reads of 16 rows both meet
//   32 distinct banks.  While the columns are in registers, three shuffles
//   gather the bits of 32 adjacent trials into one word: bits [N, G] (G =
//   ceil(S / 32)), 655 KB at the flagship, which stay in L2.
//   stage_syndrome_kernel gives one thread a (check, group of 32 trials),
//   groups fastest: it XORs the words of the check's real slots (32 trials'
//   parities an instruction) and writes the 32 syndrome bytes W2 bytes a store.
//   So the syndrome reads M dc G words (0.49 M at the flagship) where it read
//   M dc S bytes.
// The syndrome needs every column of the transpose, so it runs as a second
// launch; a ticket would leave one block to do all of it.  R (16, 8, 4 or 1),
// W (4 or 1) and W2 (16, 8, 4 or 1) are the widest accesses that N, S and the
// base addresses allow (stage_fill_widths); the grids follow the shapes alone,
// as a replay repeats them.  Rows past S or N load zeros and store nothing, so
// the bits of trials past S are 0.
constexpr int kTileS = 64;                 // trials a tile: 16 lanes x 4
constexpr int kTileN = 128;                // variables a tile: 32 words of 4
constexpr int kFillThreads = 128;
constexpr int kSyndromeThreads = 256;

// v[0..3] <- 16 bytes at p, R bytes a load; bytes at or past `avail` read 0.
template <int R>
__device__ __forceinline__ void load16(const uint8_t* p, int avail, uint32_t (&v)[4]) {
    if constexpr (R == 16) {
        if (avail >= 16) {
            const uint4 u = *reinterpret_cast<const uint4*>(p);
            v[0] = u.x, v[1] = u.y, v[2] = u.z, v[3] = u.w;
        } else {
            v[0] = v[1] = v[2] = v[3] = 0u;
        }
    } else if constexpr (R == 8) {
#pragma unroll
        for (int k = 0; k < 2; ++k) {
            const uint2 u = 8 * k < avail ? reinterpret_cast<const uint2*>(p)[k]
                                          : make_uint2(0u, 0u);
            v[2 * k] = u.x, v[2 * k + 1] = u.y;
        }
    } else if constexpr (R == 4) {
#pragma unroll
        for (int k = 0; k < 4; ++k) v[k] = 4 * k < avail ? reinterpret_cast<const uint32_t*>(p)[k] : 0u;
    } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            uint32_t w = 0u;
#pragma unroll
            for (int b = 0; b < 4; ++b) {
                if (4 * k + b < avail) w |= static_cast<uint32_t>(p[4 * k + b]) << (8 * b);
            }
            v[k] = w;
        }
    }
}

// 16 bytes v[0..3] to p, W bytes a store; the bytes at or past `avail` are
// not stored (W divides S, so a store lies wholly before or past it).
template <int W>
__device__ __forceinline__ void store16(int8_t* p, int avail, const uint32_t (&v)[4]) {
    if constexpr (W == 16) {
        if (avail >= 16) *reinterpret_cast<uint4*>(p) = make_uint4(v[0], v[1], v[2], v[3]);
    } else if constexpr (W == 8) {
#pragma unroll
        for (int k = 0; k < 2; ++k) {
            if (8 * k < avail) reinterpret_cast<uint2*>(p)[k] = make_uint2(v[2 * k], v[2 * k + 1]);
        }
    } else if constexpr (W == 4) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            if (4 * k < avail) reinterpret_cast<uint32_t*>(p)[k] = v[k];
        }
    } else {
#pragma unroll
        for (int k = 0; k < 16; ++k) {
            if (k < avail) p[k] = static_cast<int8_t>(v[k >> 2] >> (8 * (k & 3)));
        }
    }
}

// Four rows w0..w3 of four bytes -> four columns c[0..3]: byte i of c[j] is
// byte j of row i.
__device__ __forceinline__ void transpose4x4(uint32_t w0, uint32_t w1, uint32_t w2,
                                             uint32_t w3, uint32_t (&c)[4]) {
    const uint32_t t0 = __byte_perm(w0, w1, 0x5140);  // w0.b0 w1.b0 w0.b1 w1.b1
    const uint32_t t1 = __byte_perm(w2, w3, 0x5140);
    const uint32_t t2 = __byte_perm(w0, w1, 0x7362);  // w0.b2 w1.b2 w0.b3 w1.b3
    const uint32_t t3 = __byte_perm(w2, w3, 0x7362);
    c[0] = __byte_perm(t0, t1, 0x5410);
    c[1] = __byte_perm(t0, t1, 0x7632);
    c[2] = __byte_perm(t2, t3, 0x5410);
    c[3] = __byte_perm(t2, t3, 0x7632);
}

// The low bits of four bytes as a nibble (byte i -> bit i).
__device__ __forceinline__ uint32_t nibble(uint32_t w) {
    const uint32_t y = w & 0x01010101u;
    return (y | y >> 7 | y >> 14 | y >> 21) & 0xfu;
}

// The swizzle of tile row r: word w lies at w ^ swizzle(r) (an even number,
// so a 16-byte group stays a group, its two halves swapped where bit 1 is set).
__device__ __forceinline__ int swizzle(int r) {
    return ((r >> 2) & 15) << 1;
}

template <int R, int W>
__global__ void __launch_bounds__(kFillThreads)
stage_fill_kernel(const uint8_t* __restrict__ alice_rows, const uint8_t* __restrict__ bob,
                  const int* __restrict__ mag_bits, float* __restrict__ llr_s,
                  int8_t* __restrict__ alice_s, uint32_t* __restrict__ bits, int S, int N,
                  int G) {
    __shared__ __align__(16) uint32_t ta[kTileS][kTileN / 4];
    __shared__ __align__(16) uint32_t tb[kTileS][kTileN / 4];
    const int n0 = blockIdx.x * kTileN, s0 = blockIdx.y * kTileS;
    const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
    // load: 16 bytes of one row a step, a row's 8 pieces on adjacent lanes
    constexpr int kPieces = kTileN / 16;
#pragma unroll
    for (int k = 0; k < kTileS * kPieces / kFillThreads; ++k) {
        const int i = t + k * kFillThreads;
        const int r = i / kPieces, p = i % kPieces, n = n0 + 16 * p, s = s0 + r;
        const int avail = s < S ? N - n : 0;
        uint32_t a[4], b[4];
        const size_t o = static_cast<size_t>(s) * N + n;
        load16<R>(alice_rows + o, avail, a);
        load16<R>(bob + o, avail, b);
        const int sw = swizzle(r), at = 4 * p ^ sw;  // the group's words, halves swapped by bit 1
        const bool swap = (sw & 2) != 0;
        *reinterpret_cast<uint4*>(&ta[r][at & ~3]) =
            swap ? make_uint4(a[2], a[3], a[0], a[1]) : make_uint4(a[0], a[1], a[2], a[3]);
        *reinterpret_cast<uint4*>(&tb[r][at & ~3]) =
            swap ? make_uint4(b[2], b[3], b[0], b[1]) : make_uint4(b[0], b[1], b[2], b[3]);
    }
    __syncthreads();
    // store: a lane takes trials 4 q .. 4 q + 3 of the tile (q = lane mod 16) and
    // the word w (variables 4 w .. 4 w + 3) of its half-warp, two words a warp
    // an iteration
    const float mag = __int_as_float(*mag_bits);
    const int q = lane & 15, r0 = 4 * q, s = s0 + r0, avail = S - s;
    const int h = (lane >> 3) & 1;  // the 32-trial group of the lane's trials
#pragma unroll
    for (int it = 0; it < kTileN / 4 / 2 / (kFillThreads / 32); ++it) {
        const int w = 2 * (warp + it * (kFillThreads / 32)) + (lane >> 4);
        const int pw = w ^ swizzle(r0);  // the same for rows r0 .. r0 + 3
        uint32_t ac[4], bc[4];
        transpose4x4(ta[r0][pw], ta[r0 + 1][pw], ta[r0 + 2][pw], ta[r0 + 3][pw], ac);
        transpose4x4(tb[r0][pw], tb[r0 + 1][pw], tb[r0 + 2][pw], tb[r0 + 3][pw], bc);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int n = n0 + 4 * w + j;
            // the bits of the group's 32 trials: 8 lanes' nibbles
            uint32_t word = nibble(ac[j]) << (4 * (lane & 7));
            word |= __shfl_xor_sync(0xffffffffu, word, 1);
            word |= __shfl_xor_sync(0xffffffffu, word, 2);
            word |= __shfl_xor_sync(0xffffffffu, word, 4);
            const int g = s0 / 32 + h;
            if ((lane & 7) == 0 && n < N && g < G) bits[static_cast<size_t>(n) * G + g] = word;
            if (n >= N || avail <= 0) continue;
            const size_t o = static_cast<size_t>(n) * S + s;
            float f[4];
#pragma unroll
            for (int k = 0; k < 4; ++k) f[k] = ((bc[j] >> (8 * k)) & 0xffu) == 1u ? -mag : mag;
            if constexpr (W == 4) {
                *reinterpret_cast<uint32_t*>(alice_s + o) = ac[j];
                *reinterpret_cast<float4*>(llr_s + o) = make_float4(f[0], f[1], f[2], f[3]);
            } else {
#pragma unroll
                for (int k = 0; k < 4; ++k) {
                    if (k < avail) {
                        alice_s[o + k] = static_cast<int8_t>(ac[j] >> (8 * k));
                        llr_s[o + k] = f[k];
                    }
                }
            }
        }
    }
}

template <int W>
__global__ void __launch_bounds__(kSyndromeThreads)
stage_syndrome_kernel(const uint32_t* __restrict__ bits, const int* __restrict__ adj_T,
                      const int* __restrict__ mask_T, int8_t* __restrict__ syn_s, int S, int M,
                      int dc, int G) {
    const int i = blockIdx.x * kSyndromeThreads + threadIdx.x;
    if (i >= M * G) return;
    const int m = i / G, g = i - m * G;
    uint32_t parity = 0u;
#pragma unroll 4
    for (int j = 0; j < dc; ++j) {  // a padded slot's index is 0, a row that exists
        const uint32_t w = bits[adj_T[j * M + m] * G + g];
        parity ^= mask_T[j * M + m] ? w : 0u;
    }
    const int s = 32 * g, avail = S - s;
    int8_t* out = syn_s + static_cast<size_t>(m) * S + s;
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // 16 trials a half: byte k of the half <- bit 16 h + k
        uint32_t v[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) v[k] = ((parity >> (16 * h + 4 * k)) & 0xfu) * 0x00204081u & 0x01010101u;
        store16<W>(out + 16 * h, avail - 16 * h, v);
    }
}

// stage_fill_layered: the trial chunk's staging in the layered sweep's own
// layout (decoder/layered.py), from the same [S, N] rows, for a QC code of nb
// base columns and mb base rows lifted by z (N = nb z):
//   t [nb, S, z] float32     t[(j S + b) z + k] = Bob's bit (b, j z + k) == 1 ? -mag : mag
//   alice_l [nb, S, z] int8  Alice's bit (b, j z + k)
//   syn [mb, S, z] int8      syn[(i S + b) z + k] = the parity of Alice's bits
//                            (b, j z + (k + s) mod z) over the cells (j, s) of row i
// (the cells: the layer tables' CSR, row_ptr / col / shift).  A trial's row
// [N] = [nb, z] is already z-contiguous, so t and alice_l reorder whole runs
// of z positions (2 KB of t at z = 512) and need no transpose; and each of a
// trial's checks reads that trial's row alone, so the syndrome needs no
// packed words.  Bound on this card: the bytes, as the [N, S] staging's (2 S
// N in, 5 S N + M S out: 39.3 MB at the flagship, 11.7 us).  The design: a
// block a trial (blockIdx.x; blockIdx.y splits a trial's work where S alone
// gives fewer than two blocks an SM), V positions a thread: 4 where z and the
// base addresses allow it (a 4-byte load of each row, a float4 of t and 4
// bytes of alice_l: a warp stores 512 and 128 contiguous bytes), else 1.  The
// same block then computes its trial's syndrome, V adjacent checks of one
// base row a thread: for each cell the V bytes at (k + s) mod z of run j, two
// aligned words funnel-shifted (V = 4), XORed over the row's cells and stored
// at once (a warp: 128 contiguous bytes).  It re-reads the row its block has
// just streamed, through L1 (2 M dc / V words a trial).  The grid follows the
// shapes alone, as a replay repeats it.
constexpr int kLayeredThreads = 256;

template <int V>
__global__ void __launch_bounds__(kLayeredThreads)
stage_fill_layered_kernel(const uint8_t* __restrict__ alice_rows, const uint8_t* __restrict__ bob,
                          const int* __restrict__ row_ptr, const int* __restrict__ col,
                          const int* __restrict__ shift, const int* __restrict__ mag_bits,
                          float* __restrict__ t, int8_t* __restrict__ syn,
                          int8_t* __restrict__ alice_l, int S, int nb, int mb, int z) {
    const int b = blockIdx.x, zv = z / V;  // groups of V positions a run
    const size_t row = static_cast<size_t>(b) * nb * z;
    const uint8_t* a_row = alice_rows + row;
    const uint8_t* b_row = bob + row;
    const float mag = __int_as_float(*mag_bits);
    const int first = blockIdx.y * kLayeredThreads + threadIdx.x;
    const int step = gridDim.y * kLayeredThreads;
    // the LLRs and Alice's bits: positions k .. k + V - 1 of run j
#pragma unroll 4
    for (int g = first; g < nb * zv; g += step) {
        const int j = g / zv, k = (g - j * zv) * V, n = j * z + k;
        const size_t o = (static_cast<size_t>(j) * S + b) * z + k;
        if constexpr (V == 4) {
            const uint32_t a = *reinterpret_cast<const uint32_t*>(a_row + n);
            const uint32_t w = *reinterpret_cast<const uint32_t*>(b_row + n);
            float f[4];
#pragma unroll
            for (int q = 0; q < 4; ++q) f[q] = ((w >> (8 * q)) & 0xffu) == 1u ? -mag : mag;
            *reinterpret_cast<float4*>(t + o) = make_float4(f[0], f[1], f[2], f[3]);
            *reinterpret_cast<uint32_t*>(alice_l + o) = a;
        } else {
            t[o] = b_row[n] == 1 ? -mag : mag;
            alice_l[o] = static_cast<int8_t>(a_row[n]);
        }
    }
    // the syndrome: checks k .. k + V - 1 of base row i
    for (int g = first; g < mb * zv; g += step) {
        const int i = g / zv, k = (g - i * zv) * V;
        uint32_t parity = 0u;
        for (int c = row_ptr[i]; c < row_ptr[i + 1]; ++c) {
            const uint8_t* run = a_row + static_cast<size_t>(col[c]) * z;
            int p = k + shift[c];
            if (p >= z) p -= z;
            if constexpr (V == 4) {
                const int a0 = p & ~3, a1 = a0 + 4 == z ? 0 : a0 + 4;
                const uint32_t w0 = __ldg(reinterpret_cast<const unsigned int*>(run + a0));
                const uint32_t w1 = __ldg(reinterpret_cast<const unsigned int*>(run + a1));
                parity ^= __funnelshift_r(w0, w1, 8 * (p & 3));
            } else {
                parity ^= __ldg(run + p);
            }
        }
        const size_t o = (static_cast<size_t>(i) * S + b) * z + k;
        if constexpr (V == 4) {
            *reinterpret_cast<uint32_t*>(syn + o) = parity & 0x01010101u;
        } else {
            syn[o] = static_cast<int8_t>(parity & 1u);
        }
    }
}

// Exclusive prefix sum of `v` over the block (blockDim a multiple of 32, at
// most 1024); returns it and the block's total in `total`.
__device__ int block_exclusive_scan(int v, int* warp_sums, int& total) {
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    const int warps = blockDim.x / 32;
    int incl = v;
    for (int o = 1; o < 32; o <<= 1) {
        const int t = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += t;
    }
    if (lane == 31) warp_sums[warp] = incl;
    __syncthreads();
    if (warp == 0) {
        int w = lane < warps ? warp_sums[lane] : 0;
        for (int o = 1; o < 32; o <<= 1) {
            const int t = __shfl_up_sync(0xffffffffu, w, o);
            if (lane >= o) w += t;
        }
        if (lane < warps) warp_sums[lane] = w;
    }
    __syncthreads();
    const int before = warp == 0 ? 0 : warp_sums[warp - 1];
    total = warp_sums[warps - 1];
    __syncthreads();  // warp_sums is reused by the next call
    return before + incl - v;
}

// One block: the first n_new empty lanes in lane order (JAX's
// nonzero(~live, size=K)), n_new = min(max(trials - (base + pos), 0), K).
__global__ void refill_lanes_kernel(const int* __restrict__ x, int* __restrict__ st,
                                    uint8_t* __restrict__ live, uint8_t* __restrict__ run,
                                    uint8_t* __restrict__ done, uint8_t* __restrict__ fresh,
                                    int* __restrict__ age, int* __restrict__ lane_p,
                                    int* __restrict__ lane_of, int B, int K,
                                    long long* __restrict__ passes, const WantTest want) {
    __shared__ int warp_sums[32];
    const int pos = st[kPos], sp = st[kSp];
    const int n_new = min(max(x[kTrials] - (st[kBase] + pos), 0), K);
    for (int i = threadIdx.x; i < K; i += blockDim.x) lane_of[i] = -1;
    __syncthreads();
    int taken = 0;
    for (int b0 = 0; b0 < B && taken < n_new; b0 += blockDim.x) {
        const int b = b0 + threadIdx.x;
        const int empty = b < B && live[b] == 0 ? 1 : 0;
        int total;
        const int rank = taken + block_exclusive_scan(empty, warp_sums, total);
        if (empty && rank < n_new) {
            lane_of[rank] = b;
            age[b] = -1;  // the lane's first pass forms its a-priori totals
            done[b] = 0;
            live[b] = run[b] = 1;
            fresh[b] = 1;  // |=: back-to-back refills accumulate
            lane_p[b] = sp;
        }
        taken += total;  // uniform across the block
    }
    __syncthreads();  // every thread has read pos and base
    if (threadIdx.x == 0) {
        st[kCol0] = pos;
        st[kNNew] = n_new;
        st[kNextId] += n_new;
        st[kLiveN] += n_new;
        st[kPos] = pos + K;  // by K even at a point's tail (:197)
        if (n_new > 0) st[kRefills] += 1;
        count_pass(passes);
        if (want.flags != nullptr) want_test(x, st, want, false);
    }
}

// refill_copy: staged column col0 + i into lane lane_of[i], for i < n_new,
// of the rows of llr and Alice's bits [N], the syndrome [M], and the messages
// Lr [dc * M] (zeroed; ELEM bytes an entry, one instance per width).
//
// Bound on this card: the partly written 32-byte sectors.  The reads are
// n_new contiguous columns of a staged row; the writes land one element a
// lane at the freed lanes, so a row's writes touch nearly every sector of the
// row (64 of 512 lanes at random: about 50 MB of sectors at the flagship,
// Lr's [dc * M, B] rows most of it, against 11 MB of elements), and a sector
// written in part is merged with its old bytes, which the memory must read.
// The same copy into 64 contiguous lanes (whole sectors) runs in about a
// third of the time.  The design: threadIdx.x runs over the K new trials (a
// warp a row reads 32 adjacent staged columns and writes 32 ascending lanes),
// rows over threadIdx.y and the blocks, two rows a thread, and each array has
// its own range of blocks, so no item takes a division, a branch on its row
// or a switch on the element width.  n_new, col0 and the lanes are read once
// a block into shared memory, and the columns past n_new leave at once.  The
// grid comes from the shapes alone: a replay repeats it whatever n_new is.
constexpr int kCopyRowsPerThread = 2;

template <int ELEM> struct Word;
template <> struct Word<4> { using T = uint32_t; };
template <> struct Word<2> { using T = uint16_t; };
template <> struct Word<1> { using T = uint8_t; };

template <int ELEM>
__global__ void __launch_bounds__(kThreads)
refill_copy_kernel(const int* __restrict__ st, const int* __restrict__ lane_of,
                   const float* __restrict__ llr_s, const int8_t* __restrict__ syn_s,
                   const int8_t* __restrict__ alice_s, float* __restrict__ llr,
                   int8_t* __restrict__ syn, int8_t* __restrict__ alice, void* __restrict__ Lr,
                   int N, int M, int dcM, int B, int S, int K, int blocks_n, int blocks_m) {
    extern __shared__ int lanes[];  // lane_of[0 .. n_new)
    __shared__ int n_new_s, col0_s;
    const int tid = threadIdx.y * blockDim.x + threadIdx.x;
    if (tid == 0) {
        n_new_s = st[kNNew];
        col0_s = st[kCol0];
    }
    __syncthreads();
    const int n_new = n_new_s, col0 = col0_s;
    for (int i = tid; i < n_new; i += blockDim.x * blockDim.y) lanes[i] = lane_of[i];
    __syncthreads();
    const int rows_step = blockDim.y;
    const int blk = blockIdx.x;
    for (int i = threadIdx.x; i < n_new; i += blockDim.x) {
        const int lane = lanes[i], col = col0 + i;
        if (blk < blocks_n) {  // llr and Alice's bits share the row index
            const int stride = blocks_n * rows_step;
#pragma unroll 4
            for (int r = blk * rows_step + threadIdx.y; r < N; r += stride) {
                llr[r * B + lane] = llr_s[r * S + col];
                alice[r * B + lane] = alice_s[r * S + col];
            }
        } else if (blk < blocks_n + blocks_m) {
            const int b = blk - blocks_n, stride = blocks_m * rows_step;
#pragma unroll 4
            for (int r = b * rows_step + threadIdx.y; r < M; r += stride) {
                syn[r * B + lane] = syn_s[r * S + col];
            }
        } else {
            const int b = blk - blocks_n - blocks_m;
            const int stride = (gridDim.x - blocks_n - blocks_m) * rows_step;
            typename Word<ELEM>::T* out = static_cast<typename Word<ELEM>::T*>(Lr);
#pragma unroll 4
            for (int r = b * rows_step + threadIdx.y; r < dcM; r += stride) out[r * B + lane] = 0;
        }
    }
}

// The segment's last pass's bookkeeping, from that pass's run, age and ok to
// the lane buffers that bank and refill_lanes read (run_out, age_out, ok_out;
// each may be its input: a thread reads its lane before it writes it).  The
// segment's earlier passes run theirs inside the next pass's variable update
// (csrc/check_update.cu, FOLD).
__global__ void pass_step_kernel(const uint8_t* ok, uint8_t* __restrict__ done,
                                 const uint8_t* run, const int* age, uint8_t* __restrict__ fresh,
                                 uint8_t* run_out, int* age_out, uint8_t* ok_out, int max_it,
                                 int first, int B) {
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= B) return;
    const bool r = run[b] != 0;
    const uint8_t o = ok[b];
    const int a = age[b];
    const bool conv = o != 0 && r;
    if (conv) done[b] = 1;
    run_out[b] = (r && !conv && a < max_it) ? 1 : 0;
    age_out[b] = a;
    ok_out[b] = o;
    if (first) fresh[b] = 0;  // a refilled lane is fresh for one pass only
}

// bank: every block marks the lanes that bank a success and whose decision
// differs from Alice's bits somewhere (mis[b] = 1); the last block to finish
// banks every finished lane into its point's accumulators (integer atomics:
// exact in any order), frees the lanes, and writes live_n and the outer
// loop's test.
//
// Bound on this card: a chain of dependent steps more than the bytes.  Only
// the lanes that bank a success (live, stopped, done) need their z and
// Alice's bits read; those bytes alone are 0.65 us at the flagship (106 of
// 512 lanes), but scattered over each row they leave few 32-byte sectors
// untouched, so the sector floor is near the full read of both [N, B] arrays
// (3.1 us).  Around the read lie the flags' load, the ticket that elects the
// last block and the last block's banking, each a round trip to memory.  The
// design: each block first builds in shared memory a 16-bit mask of the
// banking lanes of each group of 16 adjacent lanes, and their count, from the
// B flag bytes (L2); if no lane banks, nothing is read.  A thread owns one
// group and walks rows with a stride, loading 16 bytes of z and of Alice's
// bits a row (W bytes a load where B or a base address is not 16-byte
// aligned: the row stride is B bytes), and ORs their XOR into a register; a
// group with no banking lane is skipped.  The grid is a few blocks an SM, so
// the ticket is taken a few hundred times, not thousands.  Index arithmetic
// is 32-bit; the one division (a thread's group and first row) is made once
// a thread.
constexpr int kBankThreads = 512;
constexpr int kBankBlocksPerSm = 2;

template <int W>
__global__ void __launch_bounds__(kBankThreads)
bank_kernel(const int* __restrict__ x, int* __restrict__ acc, int* __restrict__ st,
            uint8_t* __restrict__ live, const uint8_t* __restrict__ run,
            const uint8_t* __restrict__ done, const int* __restrict__ age,
            const int* __restrict__ lane_p, const int8_t* __restrict__ z,
            const int8_t* __restrict__ alice, int* __restrict__ mis, int N, int B, int P,
            uint8_t* __restrict__ flags, long long* __restrict__ passes,
            cudaGraphConditionalHandle h_out, int set_handle, const WantTest want) {
    extern __shared__ uint16_t group_mask[];  // [G]: bit j = lane 16 g + j banks a success
    __shared__ int n_bank, last, live_n;
    const int G = (B + 15) >> 4;
    if (threadIdx.x == 0) n_bank = 0;
    __syncthreads();
    for (int b0 = 0; b0 < B; b0 += kBankThreads) {  // uniform: every warp ballots
        const int b = b0 + threadIdx.x;
        const bool banks = b < B && live[b] != 0 && run[b] == 0 && done[b] != 0;
        const unsigned m = __ballot_sync(0xffffffffu, banks);
        if ((threadIdx.x & 31) == 0) {
            const int g = b >> 4;  // b is a multiple of 32 here
            if (g < G) group_mask[g] = static_cast<uint16_t>(m & 0xffffu);
            if (g + 1 < G) group_mask[g + 1] = static_cast<uint16_t>(m >> 16);
            if (m != 0) atomicAdd(&n_bank, __popc(m));
        }
    }
    __syncthreads();
    if (n_bank > 0) {
        const int t = blockIdx.x * kBankThreads + threadIdx.x;
        const int row_step = (gridDim.x * kBankThreads) / G;
        const int g = t % G, r0 = t / G;
        const unsigned mask = group_mask[g];
        if (r0 < row_step && mask != 0) {
            const int lane0 = g << 4, avail = B - lane0;
            uint32_t diff[4] = {0u, 0u, 0u, 0u};
#pragma unroll 4
            for (int r = r0; r < N; r += row_step) {
                const int o = r * B + lane0;
                xor_or<W>(z + o, alice + o, avail, diff);
            }
#pragma unroll
            for (int j = 0; j < 16; ++j) {
                if (((mask >> j) & 1u) && ((diff[j >> 2] >> (8 * (j & 3))) & 0xffu)) {
                    mis[lane0 + j] = 1;  // idempotent
                }
            }
        }
    }
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) {
        last = atomicAdd(&st[kTicket], 1) == static_cast<int>(gridDim.x) - 1;
        live_n = 0;
    }
    __syncthreads();
    if (!last) return;
    __threadfence();
    volatile int* seen = mis;
    int mine = 0;
    for (int b = threadIdx.x; b < B; b += kBankThreads) {
        const bool l = live[b] != 0;
        const bool finished = l && run[b] == 0;
        if (finished) {
            const int p = lane_p[b];
            atomicAdd(&acc[p], 1);  // n_trials
            if (done[b] != 0) {  // a success: sp_r
                const int a = age[b];
                atomicAdd(&acc[P + p], 1);
                if (seen[b] == 0) atomicAdd(&acc[2 * P + p], 1);  // keys_match
                atomicAdd(&acc[3 * P + p], a);
                atomicAdd(&acc[4 * P + p], a * a);
                atomicMin(&acc[5 * P + p], a);
                atomicMax(&acc[6 * P + p], a);
            }
            live[b] = 0;
        }
        seen[b] = 0;
        mine += l && !finished ? 1 : 0;
    }
    atomicAdd(&live_n, mine);
    __syncthreads();
    if (threadIdx.x == 0) {
        st[kLiveN] = live_n;
        st[kOuter] += 1;
        st[kTicket] = 0;
        count_pass(passes);
        bool go = more_ids(x, st, P) || live_n > 0;  // outer_cond (:262-263)
        if (go && st[kOuter] >= x[kOuterCap]) {
            go = false;
            st[kFault] |= kFaultOuter;
        }
        flags[kOuterGo] = go ? 1 : 0;
        if (set_handle) cudaGraphSetConditional(h_out, go ? 1u : 0u);
        // the next outer step's refill loop: its test before the first pass
        if (go && want.flags != nullptr) want_test(x, st, want, true);
    }
}

int last_error() {
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The refill loop's test that a kernel runs last: `want` may be null (none).
static WantTest want_or_none(const void* want) {
    return want != nullptr ? *static_cast<const WantTest*>(want) : WantTest{};
}

// Each entry launches one kernel on `stream` and returns cudaGetLastError();
// `want` (WantTest, may be null) is the refill loop's test, run last.
extern "C" int cont_start(const void* x, void* acc, void* st, void* live, void* run, void* done,
                          void* fresh, void* age, void* lane_p, int B, int P, int S, int max_it,
                          void* flags, unsigned long long h_out, int set_handle,
                          const void* want, void* stream) {
    cont_start_kernel<<<1, lane_threads(B), 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(x), static_cast<int*>(acc), static_cast<int*>(st),
        static_cast<uint8_t*>(live), static_cast<uint8_t*>(run), static_cast<uint8_t*>(done),
        static_cast<uint8_t*>(fresh), static_cast<int*>(age), static_cast<int*>(lane_p), B, P,
        S, max_it, static_cast<uint8_t*>(flags), h_out, set_handle, want_or_none(want));
    return last_error();
}

extern "C" int stage_step(const void* x, void* st, int S, int P, void* passes, const void* want,
                          void* stream) {
    stage_step_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(x), static_cast<int*>(st), S, P,
        static_cast<long long*>(passes), want_or_none(want));
    return last_error();
}

// The access widths stage_fill launches with, packed as R | W << 8 | W2 << 16:
// R along the [S, N] rows (N and both row bases), W along alice_s (4 where S
// and alice_s's base allow it and llr_s is 16-byte aligned, its float4 a lane,
// else 1), W2 along syn_s (S and its base).
static int fill_widths(const void* alice_rows, const void* bob, const void* llr_s,
                       const void* syn_s, const void* alice_s, int S, int N) {
    const int R = access_width(static_cast<unsigned long long>(N) |
                               reinterpret_cast<uintptr_t>(alice_rows) |
                               reinterpret_cast<uintptr_t>(bob));
    const int W = access_width(static_cast<unsigned long long>(S) |
                               reinterpret_cast<uintptr_t>(alice_s)) >= 4 &&
                  reinterpret_cast<uintptr_t>(llr_s) % 16 == 0 ? 4 : 1;
    const int W2 = access_width(static_cast<unsigned long long>(S) |
                                reinterpret_cast<uintptr_t>(syn_s));
    return R | W << 8 | W2 << 16;
}

extern "C" int stage_fill_widths(const void* alice_rows, const void* bob, const void* llr_s,
                                 const void* syn_s, const void* alice_s, int S, int N) {
    return fill_widths(alice_rows, bob, llr_s, syn_s, alice_s, S, N);
}

template <int R>
static void launch_fill(int W, dim3 grid, cudaStream_t stream, const uint8_t* alice_rows,
                        const uint8_t* bob, const int* mag, float* llr_s, int8_t* alice_s,
                        uint32_t* bits, int S, int N, int G) {
    if (W == 4) {
        stage_fill_kernel<R, 4><<<grid, kFillThreads, 0, stream>>>(
            alice_rows, bob, mag, llr_s, alice_s, bits, S, N, G);
    } else {
        stage_fill_kernel<R, 1><<<grid, kFillThreads, 0, stream>>>(
            alice_rows, bob, mag, llr_s, alice_s, bits, S, N, G);
    }
}

// `bits`: uint32 [N, ceil(S / 32)], the packed bits between the two kernels;
// `mag`: the int32 bits of the float32 LLR magnitude.
extern "C" int stage_fill(const void* alice_rows, const void* bob, const void* adj_T,
                          const void* mask_T, const void* mag, void* llr_s, void* syn_s,
                          void* alice_s, void* bits, int S, int N, int M, int dc, void* stream) {
    const auto s = static_cast<cudaStream_t>(stream);
    const int G = (S + 31) / 32;
    const int widths = fill_widths(alice_rows, bob, llr_s, syn_s, alice_s, S, N);
    const int R = widths & 0xff, W = (widths >> 8) & 0xff, W2 = widths >> 16;
    const dim3 grid((N + kTileN - 1) / kTileN, (S + kTileS - 1) / kTileS);
    const auto* a = static_cast<const uint8_t*>(alice_rows);
    const auto* b = static_cast<const uint8_t*>(bob);
    const auto* mag_p = static_cast<const int*>(mag);
    auto* llr = static_cast<float*>(llr_s);
    auto* al = static_cast<int8_t*>(alice_s);
    auto* words = static_cast<uint32_t*>(bits);
    switch (R) {
        case 16: launch_fill<16>(W, grid, s, a, b, mag_p, llr, al, words, S, N, G); break;
        case 8: launch_fill<8>(W, grid, s, a, b, mag_p, llr, al, words, S, N, G); break;
        case 4: launch_fill<4>(W, grid, s, a, b, mag_p, llr, al, words, S, N, G); break;
        default: launch_fill<1>(W, grid, s, a, b, mag_p, llr, al, words, S, N, G); break;
    }
    const int err = last_error();
    if (err != 0) return err;
    const unsigned blocks = static_cast<unsigned>(
        (static_cast<long long>(M) * G + kSyndromeThreads - 1) / kSyndromeThreads);
    const auto* adj = static_cast<const int*>(adj_T);
    const auto* mask = static_cast<const int*>(mask_T);
    auto* syn = static_cast<int8_t*>(syn_s);
    switch (W2) {
        case 16: stage_syndrome_kernel<16><<<blocks, kSyndromeThreads, 0, s>>>(
                     words, adj, mask, syn, S, M, dc, G); break;
        case 8: stage_syndrome_kernel<8><<<blocks, kSyndromeThreads, 0, s>>>(
                    words, adj, mask, syn, S, M, dc, G); break;
        case 4: stage_syndrome_kernel<4><<<blocks, kSyndromeThreads, 0, s>>>(
                    words, adj, mask, syn, S, M, dc, G); break;
        default: stage_syndrome_kernel<1><<<blocks, kSyndromeThreads, 0, s>>>(
                     words, adj, mask, syn, S, M, dc, G); break;
    }
    return last_error();
}

// The positions a thread of stage_fill_layered takes: 4 where z and the base
// addresses allow it (t 16-byte aligned, the rest 4), else 1.
static int fill_layered_width(const void* alice_rows, const void* bob, const void* t,
                              const void* syn, const void* alice_l, int z) {
    const auto words = static_cast<unsigned long long>(z) |
                       reinterpret_cast<uintptr_t>(alice_rows) |
                       reinterpret_cast<uintptr_t>(bob) | reinterpret_cast<uintptr_t>(syn) |
                       reinterpret_cast<uintptr_t>(alice_l);
    return words % 4 == 0 && reinterpret_cast<uintptr_t>(t) % 16 == 0 ? 4 : 1;
}

extern "C" int stage_fill_layered_width(const void* alice_rows, const void* bob, const void* t,
                                        const void* syn, const void* alice_l, int z) {
    return fill_layered_width(alice_rows, bob, t, syn, alice_l, z);
}

// `row_ptr` [mb + 1], `col` and `shift` [cells]: the layer tables; `mag`: the
// int32 bits of the float32 LLR magnitude.
extern "C" int stage_fill_layered(const void* alice_rows, const void* bob, const void* row_ptr,
                                  const void* col, const void* shift, const void* mag, void* t,
                                  void* syn, void* alice_l, int S, int nb, int mb, int z,
                                  void* stream) {
    int device = 0, sms = 0;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    const dim3 grid(S, (2 * sms + S - 1) / S);
    auto launch = [&](auto kernel) {
        kernel<<<grid, kLayeredThreads, 0, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const uint8_t*>(alice_rows), static_cast<const uint8_t*>(bob),
            static_cast<const int*>(row_ptr), static_cast<const int*>(col),
            static_cast<const int*>(shift), static_cast<const int*>(mag), static_cast<float*>(t),
            static_cast<int8_t*>(syn), static_cast<int8_t*>(alice_l), S, nb, mb, z);
    };
    if (fill_layered_width(alice_rows, bob, t, syn, alice_l, z) == 4) {
        launch(stage_fill_layered_kernel<4>);
    } else {
        launch(stage_fill_layered_kernel<1>);
    }
    return last_error();
}

extern "C" int refill_lanes(const void* x, void* st, void* live, void* run, void* done,
                            void* fresh, void* age, void* lane_p, void* lane_of, int B, int K,
                            void* passes, const void* want, void* stream) {
    refill_lanes_kernel<<<1, lane_threads(B), 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(x), static_cast<int*>(st), static_cast<uint8_t*>(live),
        static_cast<uint8_t*>(run), static_cast<uint8_t*>(done), static_cast<uint8_t*>(fresh),
        static_cast<int*>(age), static_cast<int*>(lane_p), static_cast<int*>(lane_of), B, K,
        static_cast<long long*>(passes), want_or_none(want));
    return last_error();
}

extern "C" int refill_copy(const void* st, const void* lane_of, const void* llr_s,
                           const void* syn_s, const void* alice_s, void* llr, void* syn,
                           void* alice, void* Lr, int elem, int N, int M, int dcM, int B, int S,
                           int K, void* stream) {
    // threadIdx.x over the K columns (a warp at least), threadIdx.y over rows
    const int bx = K < kThreads ? (K + 31) / 32 * 32 : kThreads;
    const dim3 block(bx, kThreads / bx);
    const int rows_a_block = static_cast<int>(block.y) * kCopyRowsPerThread;
    const int blocks_n = (N + rows_a_block - 1) / rows_a_block;
    const int blocks_m = (M + rows_a_block - 1) / rows_a_block;
    const int blocks_l = (dcM + rows_a_block - 1) / rows_a_block;
    const unsigned grid = static_cast<unsigned>(blocks_n + blocks_m + blocks_l);
    const size_t shared = static_cast<size_t>(K) * sizeof(int);
    auto launch = [&](auto kernel) {
        if (shared > 48 * 1024) {
            cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(shared));
        }
        kernel<<<grid, block, shared, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const int*>(st), static_cast<const int*>(lane_of),
            static_cast<const float*>(llr_s), static_cast<const int8_t*>(syn_s),
            static_cast<const int8_t*>(alice_s), static_cast<float*>(llr),
            static_cast<int8_t*>(syn), static_cast<int8_t*>(alice), Lr, N, M, dcM, B, S, K,
            blocks_n, blocks_m);
    };
    if (elem == 4) launch(refill_copy_kernel<4>);
    else if (elem == 2) launch(refill_copy_kernel<2>);
    else if (elem == 1) launch(refill_copy_kernel<1>);
    else return static_cast<int>(cudaErrorInvalidValue);
    return last_error();
}

extern "C" int pass_step(const void* ok, void* done, const void* run, const void* age,
                         void* fresh, void* run_out, void* age_out, void* ok_out, int max_it,
                         int first, int B, void* stream) {
    pass_step_kernel<<<(B + kThreads - 1) / kThreads, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(ok), static_cast<uint8_t*>(done),
        static_cast<const uint8_t*>(run), static_cast<const int*>(age),
        static_cast<uint8_t*>(fresh), static_cast<uint8_t*>(run_out), static_cast<int*>(age_out),
        static_cast<uint8_t*>(ok_out), max_it, first, B);
    return last_error();
}

// The widest load (16, 8, 4 or 1 bytes) that every row's groups of z and
// Alice's bits allow: B and both base addresses divisible by it.
static int bank_load_width(const void* z, const void* alice, int B) {
    return access_width(static_cast<unsigned long long>(B) | reinterpret_cast<uintptr_t>(z) |
                        reinterpret_cast<uintptr_t>(alice));
}

extern "C" int bank_width(const void* z, const void* alice, int B) {
    return bank_load_width(z, alice, B);
}

extern "C" int bank(const void* x, void* acc, void* st, void* live, const void* run,
                    const void* done, const void* age, const void* lane_p, const void* z,
                    const void* alice, void* mis, int N, int B, int P, void* flags, void* passes,
                    unsigned long long h_out, int set_handle, const void* want,
                    void* stream) {
    int device = 0, sms = 0;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    // a few blocks an SM, fewer where the rows' groups need fewer threads,
    // never fewer than one thread a group
    const long long G = (B + 15) / 16;
    const long long need = (G * N + kBankThreads - 1) / kBankThreads;
    const long long floor_blocks = (G + kBankThreads - 1) / kBankThreads;
    long long blocks = need < static_cast<long long>(sms) * kBankBlocksPerSm
                           ? need : static_cast<long long>(sms) * kBankBlocksPerSm;
    if (blocks < floor_blocks) blocks = floor_blocks;
    if (blocks < 1) blocks = 1;
    const size_t shared = static_cast<size_t>(G) * sizeof(uint16_t);
    auto launch = [&](auto kernel) {
        kernel<<<static_cast<unsigned>(blocks), kBankThreads, shared,
                 static_cast<cudaStream_t>(stream)>>>(
            static_cast<const int*>(x), static_cast<int*>(acc), static_cast<int*>(st),
            static_cast<uint8_t*>(live), static_cast<const uint8_t*>(run),
            static_cast<const uint8_t*>(done), static_cast<const int*>(age),
            static_cast<const int*>(lane_p), static_cast<const int8_t*>(z),
            static_cast<const int8_t*>(alice), static_cast<int*>(mis), N, B, P,
            static_cast<uint8_t*>(flags), static_cast<long long*>(passes), h_out, set_handle,
            want_or_none(want));
    };
    switch (bank_load_width(z, alice, B)) {
        case 16: launch(bank_kernel<16>); break;
        case 8: launch(bank_kernel<8>); break;
        case 4: launch(bank_kernel<4>); break;
        default: launch(bank_kernel<1>); break;
    }
    return last_error();
}
