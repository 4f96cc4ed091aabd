// trial_stats: a trial batch's key check and statistics, merged on the card
// into its chunk's seven int32 partials (sim/runner.py's _ChunkProgram).
//
// It replaces no TPU kernel.  In JAX these are the tensor passes of
// qkd_ldpc_tpu/sim/runner.py's point_batch_partials (:120-131: keys_match
// from reconcile, the valid mask, reduce_trials) and the scan's
// merge_partials_tree (:159-163), which XLA fuses into the chunk's program.
// On the card they were about 25 PyTorch launches a batch (the [B, N] compare
// and its all, the mask, reduce_trials' sums, the merge, the stack); this is
// one, a node of the chunk's graph.
//
//   sp[b]   = ok[b] && b < valid - offset            (a counted success)
//   keys[b] = z[:, b] == alice[:, b]                 (read only where sp[b];
//             the layered chunk's instance below: (t[:, b, :] <= 0) == alice[:, b, :])
//   n_trials, n_sp, n_ldpc, sum_it, sum_it2, min_it, max_it as
//   sim/stats.py's reduce_trials, in the same int32 arithmetic (sums wrap as
//   torch's int32 sums do; min over sp ? it : max_it, max over sp ? it : 0),
//   then written (first batch) or merged (sums add, min and max) into out[7].
//
// Bound on this card: the bytes.  Only the lanes that count a success need
// their z and Alice's bits read, but scattered over a row they leave few
// 32-byte sectors untouched, so the floor is the read of both [N, B] int8
// arrays: 10.5 MB at the flagship (N 10,240, B 512), 3.1 us at 3.35 TB/s.
// Around it lie the flags' load and the ticket that elects the block that
// reduces.  The design is the banking kernel's (continuation.cu, bank): each
// block builds in shared memory a 16-bit mask of the success lanes of each
// group of 16 adjacent lanes from the B flag bytes (if none, nothing is read);
// a thread owns one group and walks rows with a stride, loading 16 bytes of z
// and of Alice's bits a row (W bytes where B or a base address is not 16-byte
// aligned), and ORs their XOR into a register; a lane whose bits differ
// anywhere marks mis[b] (idempotent stores).  Every block but the last by
// index counts itself on a ticket once its marks are visible
// (loop_step.cuh's count_unless_elected); the last waits for the count,
// reduces the B lanes' seven values over the block (warp shuffles, then one
// word a warp in shared memory), writes or merges them, and leaves mis and the
// ticket at 0 for the next launch.  The grid is a few blocks an SM, from N, B
// and the card alone: a replay repeats it.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "lane_groups.cuh"
#include "loop_step.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kBlocksPerSm = 2;
constexpr int kWarps = kThreads / 32;
// Fields of the partials (sim/stats.py's STAT_KEYS).
constexpr int kTrials = 0, kSp = 1, kLdpc = 2, kSumIt = 3, kSumIt2 = 4, kMinIt = 5,
              kMaxIt = 6, kFields = 7;

// The block's sum / min / max of v over its threads, in thread 0 (every
// thread calls it; `red` holds a word a warp).
template <typename Op>
__device__ __forceinline__ unsigned block_reduce(unsigned v, unsigned* red, Op op) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(0xffffffffu, v, o));
    if (lane == 0) red[warp] = v;
    __syncthreads();
    if (threadIdx.x == 0) {
        for (int w = 1; w < kWarps; ++w) v = op(v, red[w]);
    }
    __syncthreads();  // red is reused by the next call
    return v;
}

// Every block of a statistics launch calls this once its marks are stored
// (`stored`: a thread of the block stored one): every block but the last by
// index counts itself on the ticket; the last waits for the count, reduces the
// B lanes' seven values over the block, writes (first batch) or merges them
// into out, and leaves the marks and the ticket at 0 for the next launch.
__device__ __forceinline__ void merge_statistics(bool stored, const uint8_t* __restrict__ ok,
                                                 const int* __restrict__ iters,
                                                 int* __restrict__ out, int* __restrict__ mis,
                                                 int* __restrict__ ticket, int n_valid, int max_it,
                                                 int B, int first, unsigned* red) {
    if (!count_unless_elected(ticket, stored)) return;
    if (threadIdx.x == 0) {
        const volatile int* count = ticket;
        while (*count < static_cast<int>(gridDim.x) - 1) {
        }
        __threadfence();  // the other blocks' marks before this block reads them
    }
    __syncthreads();
    // reduce_trials over the B lanes, in int32 arithmetic (unsigned adds and
    // products: the low 32 bits of torch's wrapping int32 ones)
    unsigned trials = 0u, sps = 0u, ldpc = 0u, s1 = 0u, s2 = 0u;
    int lo = INT_MAX, hi = INT_MIN;
    for (int b = threadIdx.x; b < B; b += kThreads) {
        const bool v = b < n_valid;
        const bool sp = v && ok[b] != 0;
        const int it = iters[b];
        const bool miss = __ldcg(mis + b) != 0;
        if (miss) mis[b] = 0;
        const unsigned it_sp = sp ? static_cast<unsigned>(it) : 0u;
        trials += v ? 1u : 0u;
        sps += sp ? 1u : 0u;
        ldpc += sp && !miss ? 1u : 0u;
        s1 += it_sp;
        s2 += it_sp * it_sp;
        lo = min(lo, sp ? it : max_it);
        hi = max(hi, static_cast<int>(it_sp));
    }
    const auto add = [](unsigned a, unsigned b) { return a + b; };
    const auto mn = [](unsigned a, unsigned b) {
        return static_cast<unsigned>(min(static_cast<int>(a), static_cast<int>(b)));
    };
    const auto mx = [](unsigned a, unsigned b) {
        return static_cast<unsigned>(max(static_cast<int>(a), static_cast<int>(b)));
    };
    unsigned v[kFields];
    v[kTrials] = block_reduce(trials, red, add);
    v[kSp] = block_reduce(sps, red, add);
    v[kLdpc] = block_reduce(ldpc, red, add);
    v[kSumIt] = block_reduce(s1, red, add);
    v[kSumIt2] = block_reduce(s2, red, add);
    v[kMinIt] = block_reduce(static_cast<unsigned>(lo), red, mn);
    v[kMaxIt] = block_reduce(static_cast<unsigned>(hi), red, mx);
    if (threadIdx.x == 0) {
        if (!first) {  // merge_partials_tree
            for (int k = kTrials; k <= kSumIt2; ++k) v[k] += static_cast<unsigned>(out[k]);
            v[kMinIt] = mn(v[kMinIt], static_cast<unsigned>(out[kMinIt]));
            v[kMaxIt] = mx(v[kMaxIt], static_cast<unsigned>(out[kMaxIt]));
        }
        for (int k = 0; k < kFields; ++k) out[k] = static_cast<int>(v[k]);
        *ticket = 0;
    }
}

template <int W>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
trial_stats_kernel(const int8_t* __restrict__ z, const int8_t* __restrict__ alice,
                   const uint8_t* __restrict__ ok, const int* __restrict__ iters,
                   const int* __restrict__ valid_total, int* __restrict__ out,
                   int* __restrict__ mis, int* __restrict__ ticket, int offset, int max_it,
                   int N, int B, int first) {
    extern __shared__ uint16_t group_mask[];  // [G]: bit j = lane 16 g + j counts a success
    __shared__ int n_sp;
    __shared__ unsigned red[kWarps];
    const int G = (B + 15) >> 4;
    const int n_valid = *valid_total - offset;  // the lanes below it count
    if (threadIdx.x == 0) n_sp = 0;
    __syncthreads();
    for (int b0 = 0; b0 < B; b0 += kThreads) {  // uniform: every warp ballots
        const int b = b0 + threadIdx.x;
        const bool sp = b < B && b < n_valid && ok[b] != 0;
        const unsigned m = __ballot_sync(0xffffffffu, sp);
        if ((threadIdx.x & 31) == 0) {
            const int g = b >> 4;  // b is a multiple of 32 here
            if (g < G) group_mask[g] = static_cast<uint16_t>(m & 0xffffu);
            if (g + 1 < G) group_mask[g + 1] = static_cast<uint16_t>(m >> 16);
            if (m != 0) atomicAdd(&n_sp, __popc(m));
        }
    }
    __syncthreads();
    int stored = 0;
    if (n_sp > 0) {
        const int t = blockIdx.x * kThreads + threadIdx.x;
        const int row_step = (gridDim.x * kThreads) / G;
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
                    stored = 1;
                }
            }
        }
    }
    stored = __syncthreads_or(stored);
    merge_statistics(stored != 0, ok, iters, out, mis, ticket, n_valid, max_it, B, first, red);
}

// The layered trial chunk's instance: it keeps the sweep's layout to the end,
// so the decisions are t <= 0 read from the final totals t [nb, B, z] float32
// and Alice's bits come as alice [nb, B, z] int8 (sim/cuda_continuation.py's
// stage_fill_layered); the marks, the ticket and the reduction are the
// [N, B] instance's.  Bound on this card: the bytes of the counted successes'
// runs of t and Alice's bits, 26.2 MB at the flagship when every lane
// succeeds, 7.8 us (the [N, B] instance reads 10.5 MB, but its decisions cost
// the decode three PyTorch passes over t: the compare, the cast and the
// transpose).  A warp takes one run (block column j of lane b: z positions,
// contiguous in both arrays) at a time, runs in memory order, and skips a run
// whose lane does not count a success; its lanes load V floats of t and V
// bytes of Alice's bits a step (V = 4 where z and the base addresses allow
// it: a warp's load is 512 contiguous bytes of t), turn the floats into
// decision bytes and OR their XOR with Alice's into a register; a run that
// differs anywhere marks mis[b].
template <int V>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
trial_stats_layered_kernel(const float* __restrict__ t, const int8_t* __restrict__ alice,
                           const uint8_t* __restrict__ ok, const int* __restrict__ iters,
                           const int* __restrict__ valid_total, int* __restrict__ out,
                           int* __restrict__ mis, int* __restrict__ ticket, int offset,
                           int max_it, int nb, int B, int z, int first) {
    __shared__ unsigned red[kWarps];
    const int n_valid = *valid_total - offset;  // the lanes below it count
    const int lane = threadIdx.x & 31;
    int stored = 0;
    for (int r = blockIdx.x * kWarps + (threadIdx.x >> 5); r < nb * B; r += gridDim.x * kWarps) {
        const int b = r % B;  // run r = j B + b
        if (b >= n_valid || ok[b] == 0) continue;  // uniform over the warp
        const float* tr = t + static_cast<size_t>(r) * z;
        const int8_t* ar = alice + static_cast<size_t>(r) * z;
        uint32_t diff = 0u;
#pragma unroll 4
        for (int k = V * lane; k < z; k += 32 * V) {
            if constexpr (V == 4) {
                const float4 f = *reinterpret_cast<const float4*>(tr + k);
                const uint32_t d = (f.x <= 0.f ? 1u : 0u) | (f.y <= 0.f ? 1u : 0u) << 8 |
                                   (f.z <= 0.f ? 1u : 0u) << 16 | (f.w <= 0.f ? 1u : 0u) << 24;
                diff |= d ^ *reinterpret_cast<const uint32_t*>(ar + k);
            } else {
                diff |= (tr[k] <= 0.f ? 1u : 0u) ^ static_cast<uint8_t>(ar[k]);
            }
        }
        if (__any_sync(0xffffffffu, diff != 0u)) {
            if (lane == 0) mis[b] = 1;  // idempotent
            stored = 1;
        }
    }
    stored = __syncthreads_or(stored);
    merge_statistics(stored != 0, ok, iters, out, mis, ticket, n_valid, max_it, B, first, red);
}

// The widest load (16, 8, 4 or 1 bytes) that every row's groups of z and
// Alice's bits allow: B and both base addresses divisible by it.
int load_width(const void* z, const void* alice, int B) {
    return access_width(static_cast<unsigned long long>(B) | reinterpret_cast<uintptr_t>(z) |
                        reinterpret_cast<uintptr_t>(alice));
}

}  // namespace

extern "C" int trial_stats_width(const void* z, const void* alice, int B) {
    return load_width(z, alice, B);
}

// One launch on `stream`; returns cudaGetLastError().  `scratch` is int32
// [B + 1] (the lanes' marks, then the ticket), all 0 before and after.
extern "C" int trial_stats(const void* z, const void* alice, const void* ok, const void* iters,
                           const void* valid_total, void* out, void* scratch, int offset,
                           int max_it, int N, int B, int first, void* stream) {
    int device = 0, sms = 0;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    // a few blocks an SM, fewer where the rows' groups need fewer threads,
    // never fewer than one thread a group
    const long long G = (B + 15) / 16;
    const long long need = (G * N + kThreads - 1) / kThreads;
    const long long floor_blocks = (G + kThreads - 1) / kThreads;
    long long blocks = need < static_cast<long long>(sms) * kBlocksPerSm
                           ? need : static_cast<long long>(sms) * kBlocksPerSm;
    if (blocks < floor_blocks) blocks = floor_blocks;
    if (blocks < 1) blocks = 1;
    const size_t shared = static_cast<size_t>(G) * sizeof(uint16_t);
    auto* marks = static_cast<int*>(scratch);
    auto launch = [&](auto kernel) {
        kernel<<<static_cast<unsigned>(blocks), kThreads, shared,
                 static_cast<cudaStream_t>(stream)>>>(
            static_cast<const int8_t*>(z), static_cast<const int8_t*>(alice),
            static_cast<const uint8_t*>(ok), static_cast<const int*>(iters),
            static_cast<const int*>(valid_total), static_cast<int*>(out), marks, marks + B,
            offset, max_it, N, B, first);
    };
    switch (load_width(z, alice, B)) {
        case 16: launch(trial_stats_kernel<16>); break;
        case 8: launch(trial_stats_kernel<8>); break;
        case 4: launch(trial_stats_kernel<4>); break;
        default: launch(trial_stats_kernel<1>); break;
    }
    return static_cast<int>(cudaGetLastError());
}

// The floats of t a lane of trial_stats_layered loads a step: 4 where z and
// the base addresses allow it (t 16-byte aligned, Alice's bits 4), else 1.
static int layered_width(const void* t, const void* alice, int z) {
    return z % 4 == 0 && reinterpret_cast<uintptr_t>(t) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(alice) % 4 == 0 ? 4 : 1;
}

extern "C" int trial_stats_layered_width(const void* t, const void* alice, int z) {
    return layered_width(t, alice, z);
}

// The layered instance: `t` float32 and `alice` int8 [nb, B, z]; the rest as
// trial_stats.  A warp a run: a few blocks an SM, fewer where the runs need
// fewer warps.
extern "C" int trial_stats_layered(const void* t, const void* alice, const void* ok,
                                   const void* iters, const void* valid_total, void* out,
                                   void* scratch, int offset, int max_it, int nb, int B, int z,
                                   int first, void* stream) {
    int device = 0, sms = 0;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    const long long need = (static_cast<long long>(nb) * B + kWarps - 1) / kWarps;
    const long long most = static_cast<long long>(sms) * kBlocksPerSm;
    const long long blocks = need < 1 ? 1 : need < most ? need : most;
    auto* marks = static_cast<int*>(scratch);
    auto launch = [&](auto kernel) {
        kernel<<<static_cast<unsigned>(blocks), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const float*>(t), static_cast<const int8_t*>(alice),
            static_cast<const uint8_t*>(ok), static_cast<const int*>(iters),
            static_cast<const int*>(valid_total), static_cast<int*>(out), marks, marks + B,
            offset, max_it, nb, B, z, first);
    };
    if (layered_width(t, alice, z) == 4) {
        launch(trial_stats_layered_kernel<4>);
    } else {
        launch(trial_stats_layered_kernel<1>);
    }
    return static_cast<int>(cudaGetLastError());
}
