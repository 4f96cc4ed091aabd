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
//   cont_want     want_lanes (:205-209) and the pos >= S predicate of the cond,
//                 written together before either branch runs;
//   stage_step    regen's scalars (:111-131): the next block's base, point,
//                 key, error count, LLR magnitude and first trial id;
//   stage_fill    regen's staging arrays (:132-139) from K4's Alice row and
//                 K3's Bob row (transposes and syndrome fused);
//   refill_lanes  refill's lane choice (:154, :166-170) and the carry updates
//                 of the refilled lanes (:189-197);
//   refill_copy   refill's column copies into the chosen lanes (:156-188);
//   pass_step     a segment pass's bookkeeping (:225-233);
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
// launches afterwards; the test kernels write their verdicts to `flags` (the
// eager loop fetches them) and, inside a graph, set the conditional nodes'
// handles with cudaGraphSetConditional.
//
// Bound on this card: launch latency for all but three; the carry is a few
// bytes a lane.  stage_fill moves the staging block (S x N Alice and Bob bytes
// in, 6 S N bytes out plus the syndrome), refill_copy the refilled columns,
// bank reads z and Alice's bits of the lanes that bank a success.  These are
// simple first versions: one thread an element, the copies coalesced along the
// staged columns, the syndrome read through L2 (a staging block's Alice bits,
// 5 MB at the flagship, stay there).
#include <cstdint>
#include <cuda_runtime.h>

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

int lane_threads(int B) {
    return B < 1024 ? ((B + 31) / 32) * 32 : 1024;
}

__global__ void cont_start_kernel(const int* __restrict__ x, int* __restrict__ acc,
                                  int* __restrict__ st, uint8_t* __restrict__ live,
                                  uint8_t* __restrict__ run, uint8_t* __restrict__ done,
                                  uint8_t* __restrict__ fresh, int* __restrict__ age,
                                  int* __restrict__ lane_p, int B, int P, int S, int max_it,
                                  uint8_t* __restrict__ flags,
                                  cudaGraphConditionalHandle h_out, int set_handle) {
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
    }
}

// `entry`: the test before the refill loop (starts its count of passes);
// else the test after a pass.
__global__ void cont_want_kernel(const int* __restrict__ x, int* __restrict__ st, int B, int P,
                                 int K, int S, int inner_cap, int entry,
                                 uint8_t* __restrict__ flags, long long* __restrict__ passes,
                                 cudaGraphConditionalHandle h_in,
                                 cudaGraphConditionalHandle h_regen,
                                 cudaGraphConditionalHandle h_refill, int set_handle) {
    const int live_n = st[kLiveN];
    bool want = more_ids(x, st, P) && (B - live_n >= K || live_n == 0);
    const int inner = entry ? 0 : st[kInner] + 1;
    st[kInner] = inner;
    if (want && inner >= inner_cap) {
        want = false;
        st[kFault] |= kFaultInner;
    }
    const bool regen = want && st[kPos] >= S;
    const bool refill = want && st[kPos] < S;
    flags[kInGo] = want ? 1 : 0;
    flags[kRegen] = regen ? 1 : 0;
    flags[kRefill] = refill ? 1 : 0;
    count_pass(passes);
    if (set_handle) {
        cudaGraphSetConditional(h_in, want ? 1u : 0u);
        cudaGraphSetConditional(h_regen, regen ? 1u : 0u);
        cudaGraphSetConditional(h_refill, refill ? 1u : 0u);
    }
}

__global__ void stage_step_kernel(const int* __restrict__ x, int* __restrict__ st, int S, int P,
                                  long long* __restrict__ passes) {
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
}

// Blocks [0, tiles) transpose 32 x 32 tiles of the [S, N] rows into the [N, S]
// staging arrays (Alice's bits, and the a-priori LLR of Bob's); the others
// compute syndrome bits (m, s), s fastest.
__global__ void __launch_bounds__(kThreads)
stage_fill_kernel(const uint8_t* __restrict__ alice_rows, const uint8_t* __restrict__ bob,
                  const int* __restrict__ adj_T, const int* __restrict__ mask_T,
                  const int* __restrict__ st, float* __restrict__ llr_s,
                  int8_t* __restrict__ syn_s, int8_t* __restrict__ alice_s, int S, int N,
                  int M, int dc, int tiles_n, int tiles) {
    __shared__ uint8_t ta[32][33];
    __shared__ uint8_t tb[32][33];
    if (static_cast<int>(blockIdx.x) < tiles) {
        const int n0 = (blockIdx.x % tiles_n) * 32, s0 = (blockIdx.x / tiles_n) * 32;
        const int cx = threadIdx.x % 32, cy = threadIdx.x / 32;  // 32 x 8
        for (int r = cy; r < 32; r += kThreads / 32) {
            const int s = s0 + r, n = n0 + cx;
            if (s < S && n < N) {
                ta[r][cx] = alice_rows[static_cast<size_t>(s) * N + n];
                tb[r][cx] = bob[static_cast<size_t>(s) * N + n];
            }
        }
        __syncthreads();
        const float mag = __int_as_float(st[kMag]);
        for (int r = cy; r < 32; r += kThreads / 32) {
            const int n = n0 + r, s = s0 + cx;
            if (s < S && n < N) {
                const size_t o = static_cast<size_t>(n) * S + s;
                alice_s[o] = static_cast<int8_t>(ta[cx][r]);
                llr_s[o] = tb[cx][r] == 1 ? -mag : mag;
            }
        }
        return;
    }
    const long long i = static_cast<long long>(blockIdx.x - tiles) * kThreads + threadIdx.x;
    if (i >= static_cast<long long>(M) * S) return;
    const int m = static_cast<int>(i / S), s = static_cast<int>(i % S);
    const uint8_t* row = alice_rows + static_cast<size_t>(s) * N;
    int parity = 0;
    for (int j = 0; j < dc; ++j) {
        if (mask_T[j * M + m]) parity ^= row[adj_T[j * M + m]];
    }
    syn_s[i] = static_cast<int8_t>(parity & 1);
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
                                    long long* __restrict__ passes) {
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
    }
}

// Item (row, i), i fastest: staged column col0 + i into lane lane_of[i], for
// i < n_new; rows are llr and Alice's bits [N], the syndrome [M], and the
// messages Lr [dc * M] (zeroed; `elem` bytes an entry).
__global__ void __launch_bounds__(kThreads)
refill_copy_kernel(const int* __restrict__ st, const int* __restrict__ lane_of,
                   const float* __restrict__ llr_s, const int8_t* __restrict__ syn_s,
                   const int8_t* __restrict__ alice_s, float* __restrict__ llr,
                   int8_t* __restrict__ syn, int8_t* __restrict__ alice, void* __restrict__ Lr,
                   int elem, int N, int M, int dcM, int B, int S, int K) {
    const int n_new = st[kNNew], col0 = st[kCol0];
    const long long items = static_cast<long long>(N + M + dcM) * K;
    for (long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; t < items;
         t += static_cast<long long>(gridDim.x) * kThreads) {
        const int i = static_cast<int>(t % K);
        if (i >= n_new) continue;
        const int row = static_cast<int>(t / K);
        const size_t lane = lane_of[i], col = col0 + i;
        if (row < N) {
            llr[row * static_cast<size_t>(B) + lane] = llr_s[row * static_cast<size_t>(S) + col];
            alice[row * static_cast<size_t>(B) + lane] =
                alice_s[row * static_cast<size_t>(S) + col];
        } else if (row < N + M) {
            const size_t r = row - N;
            syn[r * B + lane] = syn_s[r * S + col];
        } else {
            const size_t o = static_cast<size_t>(row - N - M) * B + lane;
            if (elem == 4) static_cast<uint32_t*>(Lr)[o] = 0;
            else if (elem == 2) static_cast<uint16_t*>(Lr)[o] = 0;
            else static_cast<uint8_t*>(Lr)[o] = 0;
        }
    }
}

__global__ void pass_step_kernel(const uint8_t* __restrict__ ok, uint8_t* __restrict__ done,
                                 uint8_t* __restrict__ run, const int* __restrict__ age,
                                 uint8_t* __restrict__ fresh, int max_it, int first, int B) {
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= B) return;
    const bool r = run[b] != 0;
    const bool conv = ok[b] != 0 && r;
    if (conv) done[b] = 1;
    run[b] = (r && !conv && age[b] < max_it) ? 1 : 0;
    if (first) fresh[b] = 0;  // a refilled lane is fresh for one pass only
}

// Every block marks the lanes that bank a success and whose decision differs
// from Alice's bits somewhere (mis[b] = 1); the last block to finish banks
// every finished lane into its point's accumulators (integer atomics: exact in
// any order), frees the lanes, and writes live_n and the outer loop's test.
__global__ void __launch_bounds__(kThreads)
bank_kernel(const int* __restrict__ x, int* __restrict__ acc, int* __restrict__ st,
            uint8_t* __restrict__ live, const uint8_t* __restrict__ run,
            const uint8_t* __restrict__ done, const int* __restrict__ age,
            const int* __restrict__ lane_p, const int8_t* __restrict__ z,
            const int8_t* __restrict__ alice, int* __restrict__ mis, int N, int B, int P,
            uint8_t* __restrict__ flags, long long* __restrict__ passes,
            cudaGraphConditionalHandle h_out, int set_handle) {
    const long long items = static_cast<long long>(N) * B;
    for (long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; t < items;
         t += static_cast<long long>(gridDim.x) * kThreads) {
        const int b = static_cast<int>(t % B);
        if (live[b] != 0 && run[b] == 0 && done[b] != 0 && z[t] != alice[t]) mis[b] = 1;
    }
    __threadfence();
    __syncthreads();
    __shared__ int last, live_n;
    if (threadIdx.x == 0) {
        last = atomicAdd(&st[kTicket], 1) == static_cast<int>(gridDim.x) - 1;
        live_n = 0;
    }
    __syncthreads();
    if (!last) return;
    __threadfence();
    volatile int* seen = mis;
    int mine = 0;
    for (int b = threadIdx.x; b < B; b += kThreads) {
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
    }
}

int last_error() {
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Each entry launches one kernel on `stream` and returns cudaGetLastError().
extern "C" int cont_start(const void* x, void* acc, void* st, void* live, void* run, void* done,
                          void* fresh, void* age, void* lane_p, int B, int P, int S, int max_it,
                          void* flags, unsigned long long h_out, int set_handle, void* stream) {
    cont_start_kernel<<<1, lane_threads(B), 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(x), static_cast<int*>(acc), static_cast<int*>(st),
        static_cast<uint8_t*>(live), static_cast<uint8_t*>(run), static_cast<uint8_t*>(done),
        static_cast<uint8_t*>(fresh), static_cast<int*>(age), static_cast<int*>(lane_p), B, P,
        S, max_it, static_cast<uint8_t*>(flags), h_out, set_handle);
    return last_error();
}

extern "C" int cont_want(const void* x, void* st, int B, int P, int K, int S, int inner_cap,
                         int entry, void* flags, void* passes, unsigned long long h_in,
                         unsigned long long h_regen, unsigned long long h_refill,
                         int set_handle, void* stream) {
    cont_want_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(x), static_cast<int*>(st), B, P, K, S, inner_cap, entry,
        static_cast<uint8_t*>(flags), static_cast<long long*>(passes), h_in, h_regen, h_refill,
        set_handle);
    return last_error();
}

extern "C" int stage_step(const void* x, void* st, int S, int P, void* passes, void* stream) {
    stage_step_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(x), static_cast<int*>(st), S, P,
        static_cast<long long*>(passes));
    return last_error();
}

extern "C" int stage_fill(const void* alice_rows, const void* bob, const void* adj_T,
                          const void* mask_T, const void* st, void* llr_s, void* syn_s,
                          void* alice_s, int S, int N, int M, int dc, void* stream) {
    const int tiles_n = (N + 31) / 32;
    const int tiles = tiles_n * ((S + 31) / 32);
    const long long syn_blocks = (static_cast<long long>(M) * S + kThreads - 1) / kThreads;
    stage_fill_kernel<<<static_cast<unsigned>(tiles + syn_blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(alice_rows), static_cast<const uint8_t*>(bob),
        static_cast<const int*>(adj_T), static_cast<const int*>(mask_T),
        static_cast<const int*>(st), static_cast<float*>(llr_s), static_cast<int8_t*>(syn_s),
        static_cast<int8_t*>(alice_s), S, N, M, dc, tiles_n, tiles);
    return last_error();
}

extern "C" int refill_lanes(const void* x, void* st, void* live, void* run, void* done,
                            void* fresh, void* age, void* lane_p, void* lane_of, int B, int K,
                            void* passes, void* stream) {
    refill_lanes_kernel<<<1, lane_threads(B), 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(x), static_cast<int*>(st), static_cast<uint8_t*>(live),
        static_cast<uint8_t*>(run), static_cast<uint8_t*>(done), static_cast<uint8_t*>(fresh),
        static_cast<int*>(age), static_cast<int*>(lane_p), static_cast<int*>(lane_of), B, K,
        static_cast<long long*>(passes));
    return last_error();
}

extern "C" int refill_copy(const void* st, const void* lane_of, const void* llr_s,
                           const void* syn_s, const void* alice_s, void* llr, void* syn,
                           void* alice, void* Lr, int elem, int N, int M, int dcM, int B, int S,
                           int K, void* stream) {
    const long long items = static_cast<long long>(N + M + dcM) * K;
    const long long blocks = (items + kThreads - 1) / kThreads;
    refill_copy_kernel<<<static_cast<unsigned>(blocks < 4096 ? blocks : 4096), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(st), static_cast<const int*>(lane_of),
        static_cast<const float*>(llr_s), static_cast<const int8_t*>(syn_s),
        static_cast<const int8_t*>(alice_s), static_cast<float*>(llr),
        static_cast<int8_t*>(syn), static_cast<int8_t*>(alice), Lr, elem, N, M, dcM, B, S, K);
    return last_error();
}

extern "C" int pass_step(const void* ok, void* done, void* run, const void* age, void* fresh,
                         int max_it, int first, int B, void* stream) {
    pass_step_kernel<<<(B + kThreads - 1) / kThreads, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(ok), static_cast<uint8_t*>(done),
        static_cast<uint8_t*>(run), static_cast<const int*>(age), static_cast<uint8_t*>(fresh),
        max_it, first, B);
    return last_error();
}

extern "C" int bank(const void* x, void* acc, void* st, void* live, const void* run,
                    const void* done, const void* age, const void* lane_p, const void* z,
                    const void* alice, void* mis, int N, int B, int P, void* flags, void* passes,
                    unsigned long long h_out, int set_handle, void* stream) {
    const long long items = static_cast<long long>(N) * B;
    const long long blocks = (items + kThreads - 1) / kThreads;
    bank_kernel<<<static_cast<unsigned>(blocks < 2048 ? blocks : 2048), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(x), static_cast<int*>(acc), static_cast<int*>(st),
        static_cast<uint8_t*>(live), static_cast<const uint8_t*>(run),
        static_cast<const uint8_t*>(done), static_cast<const int*>(age),
        static_cast<const int*>(lane_p), static_cast<const int8_t*>(z),
        static_cast<const int8_t*>(alice), static_cast<int*>(mis), N, B, P,
        static_cast<uint8_t*>(flags), static_cast<long long*>(passes), h_out, set_handle);
    return last_error();
}
