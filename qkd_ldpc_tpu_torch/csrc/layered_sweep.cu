// One whole sweep of the serial check-layered BP schedule on a quasi-cyclic code,
// plus the decision-syndrome check.
//
// Replaces the TPU kernel _sweep_kernel of qkd_ldpc_tpu/decoder/pallas_layered.py
// (launched by `sweep` in `_decode`).  What it computes is one pass of the plain
// loop in decoder/layered.py: for every base row i in order (one layer = z lifted
// checks), and every cell (ci, j, s) of the row,
//     Lq  = clip(t[j][(r + s) mod z] - Lr[ci][r])
//     Lr' = storage(clip(check_update(all Lq of the row, syn[i][r])))
//     t[j][(r + s) mod z] += Lr' - Lr[ci][r]           (seen by the next layer)
// and after the last layer ok = all parities of (t <= 0) equal the target.
//
// State layout: t [nb, B, z] float32, Lr [ncells, B, z] storage, syn [mb, B, z]
// int8 — z fastest, so a layer's accesses coalesce.  Both t and Lr are updated
// IN PLACE.
//
// What bounds it on this card is not its bytes but how little of its work overlaps:
// a frame's layers are serial through t, so a block alternates between waiting for
// memory and arithmetic, and registers (64 a thread at 512 threads) hold an SM to two
// blocks.  Measured on an H100 at the flagship shape (bfloat16, sum-product): the
// kernel without arithmetic, parity pass, Lr stores and copy-out takes 0.066 ms, the
// check arithmetic adds 0.063 ms (min-sum: 0.024), the parity pass 0.011, the
// copy-out and the Lr stores 0.007 to 0.02 each.  The design:
//  - One thread block per frame, one thread per lifted check of a layer; a frame's t
//    (nb * z floats, 40 KB at z = 512, nb = 20) lives in dynamic shared memory for
//    the whole sweep (SHARED = true), copied in and out with 16-byte accesses where
//    t is aligned and z a multiple of 4.  A frame whose t exceeds what a block may have is
//    updated where it lies in global memory instead (SHARED = false: same
//    arithmetic, same order; a block's barrier also orders its global writes).
//  - The row tables (row_ptr, col, shift) are copied to shared memory once per
//    block, so no layer and no parity step waits on global memory for an index.
//  - What does not depend on t leaves the serial chain: the next step's Lr cells
//    and syn bits are loaded into registers before this step's arithmetic starts,
//    so only the shared-memory reads of t stay between one layer and the next.  The
//    syn bits are one byte each and are kept (one bit a layer) for the parity pass.
//  - One lifted check per thread.  Several adjacent checks per thread (vector
//    loads and stores of Lr and syn, fewer and fatter threads, every frame resident
//    in one wave) measured slower on the H100 at every width, for sum-product by
//    24 to 120 %: fewer warps are left to hide the arithmetic's latency.
// Row degrees.  The instances above unroll the cells of a row (DC = 2..8): a
// check's messages sit in registers, and the next step's are fetched ahead.  Any
// larger base-row degree runs the DC = 0 instance, the loop form of the same update
// (check_messages_loop in check_math.cuh), which keeps nothing per cell in
// registers (a row of 60 cells would otherwise spill hundreds of values a thread)
// and equals the plain sweep bit for bit as the unrolled instances do.  Its
// sum-product keeps a check's prefix products in a float32 scratch [dc_max, B, z]
// that the caller allocates.  The second pass reads t and Lr again: a cell's
// position of t is written only by the pass that has just read it.  This instance
// loads nothing ahead and keeps no target bits for the parity pass.
// Inside a layer no barrier is needed: a base row has at most one cell per column
// j and r -> (r + s) mod z is a bijection, so whichever thread owns check r is the
// only one of its layer to read or write t[j][(r + s) mod z], and a thread takes
// its own checks (z above 1024) one after the other.  One __syncthreads() separates
// layers.  Any z and any alignment is taken; only the copy of t narrows.
//
// Inside a decode loop (decoder/layered.py) the sweep is the whole pass, and its
// TAIL instances also run the pass's bookkeeping (loop_step.cuh: done, active,
// iters, it, the condition of the loop's WHILE node) in the launch's last block,
// once every other block has counted itself on a ticket, which each does as
// soon as its frame's ok is stored.  The pass then needs no bookkeeping launch.
//
// Gating: a frame whose act flag is 0 is left untouched (its block returns at
// once) and its ok is written as 0; the plain version multiplies the update by
// the flag instead, which is the same for finite state.  The caller uses ok only
// on active frames.
//
// Byte bound: per active frame t read and written (2 * nb * z * 4), Lr read and
// written (2 * ncells * z * itemsize), syn read (mb * z).  Compiled without
// fast-math and without fma contraction, once per storage type.
#include <type_traits>

#include "check_math.cuh"
#include "loop_step.cuh"

namespace {

constexpr int kMaxThreads = 1024;

__host__ __device__ constexpr size_t round_up_16(size_t n) { return (n + 15) / 16 * 16; }

// One step of a thread: its check r of layer i.  A thread walks its steps layer by
// layer; within a layer, chunk c is check threadIdx.x + c * blockDim.x.
template <int DC>
struct StepData {
    storage_t lr[DC];
    int8_t syn;
};

template <int DC>
__device__ __forceinline__ void fetch_step(const storage_t* __restrict__ lr,
                                           const int8_t* __restrict__ syn,
                                           const int* __restrict__ row_ptr, int step,
                                           int chunks, int z, size_t Bz, size_t frame,
                                           StepData<DC>* out) {
    const int i = step / chunks;
    const int r = threadIdx.x + (step - i * chunks) * blockDim.x;
    if (r >= z) return;
    const int c0 = row_ptr[i];
    const int d = row_ptr[i + 1] - c0;
#pragma unroll
    for (int k = 0; k < DC; ++k) {
        if (k < d) out->lr[k] = lr[(c0 + k) * Bz + frame + r];
    }
    out->syn = syn[i * Bz + frame + r];
}

// TAIL: every block counts itself once its ok is stored, and the launch's last
// block runs the loop's bookkeeping over ok (step).
template <int ALG, bool CLIP, int DC, bool SHARED, bool TAIL>
__global__ void __launch_bounds__(kMaxThreads, 1)
layered_sweep_kernel(float* __restrict__ t,             // [nb, B, z]
                     storage_t* __restrict__ lr,        // [ncells, B, z]
                     const int8_t* __restrict__ syn,    // [mb, B, z]
                     const uint8_t* __restrict__ act,   // [B]
                     uint8_t* __restrict__ ok,          // [B]
                     const int* __restrict__ row_ptr_g,  // [mb + 1]
                     const int* __restrict__ col_g,      // [ncells]
                     const int* __restrict__ shift_g,    // [ncells]
                     float* __restrict__ scratch,        // [dc_max, B, z] (DC = 0, SP)
                     int nb, int mb, int ncells, int z, int B, bool wide_copy,
                     float threshold, float alpha, float beta, float scale,
                     const LoopStep step) {
    // [nb * z floats of t when SHARED][mb + 1 | ncells | ncells ints of tables]
    extern __shared__ __align__(16) unsigned char smem[];
    const int b = blockIdx.x;
    if (act[b] == 0) {
        if (threadIdx.x == 0) ok[b] = 0;
        if constexpr (TAIL) {  // thread 0 stored the block's one flag
            if (count_unless_elected(step.ticket, true)) elected_tail<kLoopLayered>(ok, step);
        }
        return;
    }
    const size_t Bz = static_cast<size_t>(B) * z;
    const size_t frame = static_cast<size_t>(b) * z;
    const size_t t_bytes = SHARED ? static_cast<size_t>(nb) * z * sizeof(float) : 0;
    float* const sm_t = reinterpret_cast<float*>(smem);
    int* const row_ptr = reinterpret_cast<int*>(smem + t_bytes);
    int* const col = row_ptr + mb + 1;
    int* const shift = col + ncells;
    for (int e = threadIdx.x; e <= mb; e += blockDim.x) row_ptr[e] = row_ptr_g[e];
    for (int e = threadIdx.x; e < ncells; e += blockDim.x) {
        col[e] = col_g[e];
        shift[e] = shift_g[e];
    }

    // The frame's totals as tt[j * tstride + p].
    using pos_t = typename std::conditional<SHARED, int, size_t>::type;
    float* const tt = SHARED ? sm_t : t + frame;
    const pos_t tstride = SHARED ? static_cast<pos_t>(z) : static_cast<pos_t>(Bz);
    // The copy of t in and out moves 16 bytes an access where t is aligned and z a
    // multiple of 4, else one float.
    auto copy_t = [&](auto width, bool in) {
        constexpr int W = decltype(width)::value;
        const int per_row = z / W;
        for (int e = threadIdx.x; e < nb * per_row; e += blockDim.x) {
            const int j = e / per_row;
            const int p = (e - j * per_row) * W;
            float* const g = t + j * Bz + frame + p;
            float* const s = sm_t + j * z + p;
            if (in) store_vec<W>(s, load_vec<W>(g));
            else store_vec<W>(g, load_vec<W>(s));
        }
    };
    if (SHARED) {
        if (wide_copy) copy_t(std::integral_constant<int, 4>{}, true);
        else copy_t(std::integral_constant<int, 1>{}, true);
    }
    __syncthreads();  // tables and totals are in place

    const int chunks = (z + blockDim.x - 1) / blockDim.x;
    // The target bits of a thread's check, kept for the parity pass when they fit.
    const bool keep_targets = DC > 0 && chunks == 1 && mb <= 64;
    unsigned long long targets = 0;
    if constexpr (DC > 0) {
        const int steps = mb * chunks;
        StepData<DC> cur, next;
        fetch_step<DC>(lr, syn, row_ptr, 0, chunks, z, Bz, frame, &next);
        for (int i = 0; i < mb; ++i) {
            const int c0 = row_ptr[i];
            const int d = row_ptr[i + 1] - c0;
            int cj[DC], sh[DC];
#pragma unroll
            for (int k = 0; k < DC; ++k) {
                cj[k] = k < d ? col[c0 + k] : 0;
                sh[k] = k < d ? shift[c0 + k] : 0;
            }
            for (int c = 0; c < chunks; ++c) {
                const int step = i * chunks + c;
                const int r = threadIdx.x + c * blockDim.x;
                cur = next;
                // the next step's loads do not depend on t: start them before this
                // step's arithmetic
                if (step + 1 < steps) {
                    fetch_step<DC>(lr, syn, row_ptr, step + 1, chunks, z, Bz, frame, &next);
                }
                if (r >= z) continue;
                const float sgn = cur.syn == 1 ? -1.0f : 1.0f;
                if (keep_targets) targets |= static_cast<unsigned long long>(cur.syn & 1) << i;
                float lq[DC], old[DC], was[DC], out[DC];
                bool valid[DC];
                pos_t pos[DC];
#pragma unroll
                for (int k = 0; k < DC; ++k) {
                    valid[k] = k < d;
                    lq[k] = 0.0f;
                    old[k] = 0.0f;
                    was[k] = 0.0f;
                    pos[k] = 0;
                    if (valid[k]) {
                        int p = r + sh[k];
                        if (p >= z) p -= z;
                        pos[k] = cj[k] * tstride + p;
                        old[k] = from_storage(cur.lr[k], scale);
                        was[k] = tt[pos[k]];
                        const float v = was[k] - old[k];
                        lq[k] = CLIP ? clipf(v, threshold) : v;
                    }
                }
                check_messages<ALG, CLIP, DC>(lq, valid, sgn, threshold, alpha, beta, out);
#pragma unroll
                for (int k = 0; k < DC; ++k) {
                    if (valid[k]) {
                        const storage_t q = to_storage(out[k], scale);
                        cur.lr[k] = q;
                        const float delta = from_storage(q, scale) - old[k];
                        tt[pos[k]] = was[k] + delta;
                    }
                }
#pragma unroll
                for (int k = 0; k < DC; ++k) {
                    if (k < d) lr[(c0 + k) * Bz + frame + r] = cur.lr[k];
                }
            }
            __syncthreads();  // the next layer reads what this one added to t
        }
    } else {
        for (int i = 0; i < mb; ++i) {
            const int c0 = row_ptr[i];
            const int d = row_ptr[i + 1] - c0;
            for (int c = 0; c < chunks; ++c) {
                const int r = threadIdx.x + c * blockDim.x;
                if (r >= z) continue;
                const float sgn[1] = {syn[i * Bz + frame + r] == 1 ? -1.0f : 1.0f};
                // Cell k of this check: its position of t, the old message and the
                // total, kept for the write that follows the second pass's read.
                pos_t pos;
                float old, was;
                auto read = [&](int k, bool, float (&lq)[1]) {
                    int p = r + shift[c0 + k];
                    if (p >= z) p -= z;
                    pos = col[c0 + k] * tstride + p;
                    old = from_storage(lr[(c0 + k) * Bz + frame + r], scale);
                    was = tt[pos];
                    const float v = was - old;
                    lq[0] = CLIP ? clipf(v, threshold) : v;
                    return true;
                };
                auto write = [&](int k, const float (&out)[1]) {
                    const storage_t q = to_storage(out[0], scale);
                    lr[(c0 + k) * Bz + frame + r] = q;
                    tt[pos] = was + (from_storage(q, scale) - old);
                };
                check_messages_loop<ALG, CLIP, 1>(d, sgn, threshold, alpha, beta, scratch,
                                                  frame + r, Bz, read, write);
            }
            __syncthreads();  // the next layer reads what this one added to t
        }
    }

    // Decision syndrome of the post-sweep totals (t <= 0 -> bit 1).
    int bad = 0;
    for (int c = 0; c < chunks; ++c) {
        const int r = threadIdx.x + c * blockDim.x;
        if (r >= z) continue;
        for (int i = 0; i < mb; ++i) {
            const int target = keep_targets ? static_cast<int>((targets >> i) & 1)
                                            : syn[i * Bz + frame + r];
            int parity = 0;
            for (int ci = row_ptr[i]; ci < row_ptr[i + 1]; ++ci) {
                int p = r + shift[ci];
                if (p >= z) p -= z;
                parity ^= tt[col[ci] * tstride + p] <= 0.0f ? 1 : 0;
            }
            bad |= parity ^ target;
        }
    }
    // also the barrier between the parity reads and nothing later writing t
    const int any_bad = __syncthreads_or(bad);
    if (threadIdx.x == 0) ok[b] = any_bad == 0 ? 1 : 0;
    // thread 0 stored the block's one flag, and counts the block at once
    const bool elected = TAIL && count_unless_elected(step.ticket, true);

    if (SHARED) {
        if (wide_copy) copy_t(std::integral_constant<int, 4>{}, false);
        else copy_t(std::integral_constant<int, 1>{}, false);
    }
    if (elected) elected_tail<kLoopLayered>(ok, step);
}

struct Args {
    float* t;
    storage_t* lr;
    const int8_t* syn;
    const uint8_t* act;
    uint8_t* ok;
    const int* row_ptr;
    const int* col;
    const int* shift;
    float* scratch;
    const LoopStep* step;  // null: no bookkeeping (the plain instances)
    int nb, mb, ncells, z, B;
    bool wide_copy;  // t starts on a 16-byte boundary and z is a multiple of 4
    float threshold, alpha, beta, scale;
    cudaStream_t stream;
};

constexpr size_t kStaticSharedLimit = 48 * 1024;
constexpr size_t kBlockSharedLimit = 227 * 1024;  // what a block may have on sm_90
size_t table_bytes(const Args& p) {
    return round_up_16((static_cast<size_t>(p.mb) + 1 + 2 * p.ncells) * sizeof(int));
}

size_t totals_bytes(const Args& p) {
    return static_cast<size_t>(p.nb) * p.z * sizeof(float);
}

// The rule is the shape's alone: totals that fit a block's shared memory beside
// the row tables go there, larger ones stay in global memory.
bool totals_in_shared(const Args& p) {
    return totals_bytes(p) + table_bytes(p) <= kBlockSharedLimit;
}

template <int ALG, bool CLIP, int DC, bool SHARED, bool TAIL>
int launch_kernel(const Args& p) {
    const size_t shared = (SHARED ? totals_bytes(p) : 0) + table_bytes(p);
    const auto kernel = layered_sweep_kernel<ALG, CLIP, DC, SHARED, TAIL>;
    if (shared > kStaticSharedLimit) {
        const cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(shared));
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    int threads = (p.z + 31) / 32 * 32;  // whole warps
    if (threads > kMaxThreads) threads = kMaxThreads;
    kernel<<<p.B, threads, shared, p.stream>>>(
        p.t, p.lr, p.syn, p.act, p.ok, p.row_ptr, p.col, p.shift, p.scratch, p.nb, p.mb,
        p.ncells,
        p.z, p.B, p.wide_copy, p.threshold, p.alpha, p.beta, p.scale,
        p.step != nullptr ? *p.step : LoopStep{});
    return static_cast<int>(cudaGetLastError());
}

template <int ALG, bool CLIP, int DC, bool SHARED>
int launch_tail(const Args& p) {
    return p.step != nullptr ? launch_kernel<ALG, CLIP, DC, SHARED, true>(p)
                             : launch_kernel<ALG, CLIP, DC, SHARED, false>(p);
}

template <int ALG, bool CLIP, int DC>
int launch(const Args& p) {
    return totals_in_shared(p) ? launch_tail<ALG, CLIP, DC, true>(p)
                               : launch_tail<ALG, CLIP, DC, false>(p);
}

template <int ALG, bool CLIP>
int launch_dc(int dc, const Args& p) {
    switch (dc) {
        case 2: return launch<ALG, CLIP, 2>(p);
        case 3: return launch<ALG, CLIP, 3>(p);
        case 4: return launch<ALG, CLIP, 4>(p);
        case 5: return launch<ALG, CLIP, 5>(p);
        case 6: return launch<ALG, CLIP, 6>(p);
        case 7: return launch<ALG, CLIP, 7>(p);
        case 8: return launch<ALG, CLIP, 8>(p);
        default: return launch<ALG, CLIP, 0>(p);
    }
}

constexpr int kMaxUnrolledDegree = 8;

int launch_flags(int algorithm, int clip, int dc, const Args& p) {
    if (algorithm == kMinSum) {
        return clip ? launch_dc<kMinSum, true>(dc, p) : launch_dc<kMinSum, false>(dc, p);
    }
    return clip ? launch_dc<kSumProduct, true>(dc, p) : launch_dc<kSumProduct, false>(dc, p);
}

}  // namespace

// The largest row degree whose instance is unrolled; above it the loop instance
// runs, whose sum-product needs the scratch.
extern "C" int layered_sweep_max_unrolled_degree() { return kMaxUnrolledDegree; }

// `aligned`: t starts on a 16-byte boundary (the 16-byte copies of t need it, and a z
// that is a multiple of 4).  `dc` is the largest row degree; `scratch` is float32
// [dc, B, z] and may be null where it is not used; `step` (loop_step.cuh, may be
// null) is the loop's bookkeeping after this sweep, run in the launch's last block.
// Returns cudaGetLastError() (or the error of raising the shared-memory limit), -1
// when dc < 2, or -3 when the loop instance of sum-product is given no scratch.
extern "C" int layered_sweep(int algorithm, int clip, int dc, int aligned, void* t,
                             void* lr, const void* syn, const void* act, void* ok,
                             const void* row_ptr, const void* col, const void* shift,
                             void* scratch, int nb, int mb, int ncells, int z, int B,
                             float threshold, float alpha, float beta, float scale,
                             const void* step, void* stream) {
    if (dc < 2) return -1;
    if (dc > kMaxUnrolledDegree && algorithm != kMinSum && scratch == nullptr) return -3;
    const Args p{static_cast<float*>(t),
                 static_cast<storage_t*>(lr),
                 static_cast<const int8_t*>(syn),
                 static_cast<const uint8_t*>(act),
                 static_cast<uint8_t*>(ok),
                 static_cast<const int*>(row_ptr),
                 static_cast<const int*>(col),
                 static_cast<const int*>(shift),
                 static_cast<float*>(scratch),
                 static_cast<const LoopStep*>(step),
                 nb, mb, ncells, z, B, aligned != 0 && z % 4 == 0, threshold, alpha, beta, scale,
                 static_cast<cudaStream_t>(stream)};
    return launch_flags(algorithm, clip, dc, p);
}
