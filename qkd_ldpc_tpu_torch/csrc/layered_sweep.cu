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
// int32 — z fastest, so a layer's accesses coalesce.  Both t and Lr are updated
// IN PLACE.
//
// Design: one thread block per frame, threads over the z lifted checks.  Frames
// are independent, and so are the z checks of a layer; only layers are serial,
// through t.  The frame's t (nb * z floats, 40 KB at z = 512, nb = 20) lives in
// dynamic shared memory for the whole sweep (SHARED = true); a frame whose t
// exceeds what a block may have (227 KB) is updated where it lies in global
// memory instead (SHARED = false: same arithmetic, same order, and a block's
// barrier also orders its global writes).  Each Lr cell is read and written
// once, by the same thread; the circulant roll is an index into t; the row's
// <= DC Lq are registers.  Inside a layer no barrier is needed: a base
// row has at most one cell per column j and r -> (r + s) mod z is a bijection, so
// the thread of check r is the only one of its layer to read or write
// t[j][(r + s) mod z].  One __syncthreads() separates layers.  The row table
// (row_ptr, col, shift) is a small int32 input, not unrolled code.
//
// Gating: a frame whose act flag is 0 is left untouched (its block returns at
// once) and its ok is written as 0; the plain version multiplies the update by
// the flag instead, which is the same for finite state.  The caller uses ok only
// on active frames.
//
// Bound on this card: memory traffic — per active frame t read and written
// (2 * nb * z * 4), Lr read and written (2 * ncells * z * itemsize), syn read
// (mb * z * 4); the two transcendentals per edge stay under the float rate.
// Compiled without fast-math and without fma contraction, once per storage type.
#include <type_traits>

#include "check_math.cuh"

namespace {

template <int ALG, bool CLIP, int DC, bool SHARED>
__global__ void layered_sweep_kernel(float* __restrict__ t,        // [nb, B, z]
                                     storage_t* __restrict__ lr,   // [ncells, B, z]
                                     const int* __restrict__ syn,  // [mb, B, z]
                                     const uint8_t* __restrict__ act,  // [B]
                                     uint8_t* __restrict__ ok,         // [B]
                                     const int* __restrict__ row_ptr,  // [mb + 1]
                                     const int* __restrict__ col,      // [ncells]
                                     const int* __restrict__ shift,    // [ncells]
                                     int nb, int mb, int z, int B, float threshold,
                                     float alpha, float beta, float scale) {
    extern __shared__ float sm_t[];  // [nb, z]: this frame's totals (SHARED)
    __shared__ int sm_bad[32];
    const int b = blockIdx.x;
    if (act[b] == 0) {
        if (threadIdx.x == 0) ok[b] = 0;
        return;
    }
    const size_t Bz = static_cast<size_t>(B) * z;
    const size_t frame = static_cast<size_t>(b) * z;

    // The frame's totals as tt[j * tstride + position].
    using pos_t = typename std::conditional<SHARED, int, size_t>::type;
    float* const tt = SHARED ? sm_t : t + frame;
    const pos_t tstride = SHARED ? static_cast<pos_t>(z) : static_cast<pos_t>(Bz);
    if (SHARED) {
        for (int e = threadIdx.x; e < nb * z; e += blockDim.x) {
            const int j = e / z;
            sm_t[e] = t[j * Bz + frame + (e - j * z)];
        }
        __syncthreads();
    }

    for (int i = 0; i < mb; ++i) {
        const int c0 = row_ptr[i];
        const int d = row_ptr[i + 1] - c0;
        for (int r = threadIdx.x; r < z; r += blockDim.x) {
            const float sgn = syn[i * Bz + frame + r] == 1 ? -1.0f : 1.0f;
            float lq[DC], old[DC], out[DC];
            bool valid[DC];
            pos_t pos[DC];
#pragma unroll
            for (int k = 0; k < DC; ++k) {
                valid[k] = k < d;
                lq[k] = 0.0f;
                old[k] = 0.0f;
                pos[k] = 0;
                if (valid[k]) {
                    const int ci = c0 + k;
                    int p = r + shift[ci];
                    if (p >= z) p -= z;
                    pos[k] = col[ci] * tstride + p;
                    old[k] = from_storage(lr[ci * Bz + frame + r], scale);
                    const float v = tt[pos[k]] - old[k];
                    lq[k] = CLIP ? clipf(v, threshold) : v;
                }
            }
            check_messages<ALG, CLIP, DC>(lq, valid, sgn, threshold, alpha, beta, out);
#pragma unroll
            for (int k = 0; k < DC; ++k) {
                if (valid[k]) {
                    const storage_t q = to_storage(out[k], scale);
                    lr[(c0 + k) * Bz + frame + r] = q;
                    const float delta = from_storage(q, scale) - old[k];
                    tt[pos[k]] = tt[pos[k]] + delta;
                }
            }
        }
        __syncthreads();  // the next layer reads what this one added to t
    }

    // Decision syndrome of the post-sweep totals (t <= 0 -> bit 1).
    int bad = 0;
    for (int r = threadIdx.x; r < z; r += blockDim.x) {
        for (int i = 0; i < mb; ++i) {
            int parity = 0;
            for (int ci = row_ptr[i]; ci < row_ptr[i + 1]; ++ci) {
                int p = r + shift[ci];
                if (p >= z) p -= z;
                parity ^= tt[col[ci] * tstride + p] <= 0.0f ? 1 : 0;
            }
            bad += parity ^ syn[i * Bz + frame + r];
        }
    }
    for (int off = 16; off > 0; off >>= 1) bad += __shfl_down_sync(0xffffffffu, bad, off);
    if ((threadIdx.x & 31) == 0) sm_bad[threadIdx.x >> 5] = bad;
    __syncthreads();
    if (threadIdx.x == 0) {
        int total = 0;
        for (int w = 0; w < (blockDim.x >> 5); ++w) total += sm_bad[w];
        ok[b] = total == 0 ? 1 : 0;
    }

    if (SHARED) {
        for (int e = threadIdx.x; e < nb * z; e += blockDim.x) {
            const int j = e / z;
            t[j * Bz + frame + (e - j * z)] = sm_t[e];
        }
    }
}

struct Args {
    float* t;
    storage_t* lr;
    const int* syn;
    const uint8_t* act;
    uint8_t* ok;
    const int* row_ptr;
    const int* col;
    const int* shift;
    int nb, mb, z, B;
    float threshold, alpha, beta, scale;
    cudaStream_t stream;
};

constexpr size_t kStaticSharedLimit = 48 * 1024;
constexpr size_t kBlockSharedLimit = 227 * 1024;  // what a block may have on sm_90

template <int ALG, bool CLIP, int DC, bool SHARED>
int launch_kernel(const Args& p, size_t shared) {
    if (shared > kStaticSharedLimit) {
        const cudaError_t err = cudaFuncSetAttribute(
            layered_sweep_kernel<ALG, CLIP, DC, SHARED>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(shared));
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    int threads = (p.z + 31) / 32 * 32;  // whole warps: the reduction shuffles
    if (threads > 1024) threads = 1024;
    layered_sweep_kernel<ALG, CLIP, DC, SHARED><<<p.B, threads, shared, p.stream>>>(
        p.t, p.lr, p.syn, p.act, p.ok, p.row_ptr, p.col, p.shift, p.nb, p.mb, p.z,
        p.B, p.threshold, p.alpha, p.beta, p.scale);
    return static_cast<int>(cudaGetLastError());
}

// The rule is the shape's alone: totals that fit a block's shared memory go
// there, larger ones stay in global memory.
template <int ALG, bool CLIP, int DC>
int launch(const Args& p) {
    const size_t shared = static_cast<size_t>(p.nb) * p.z * sizeof(float);
    if (shared <= kBlockSharedLimit) return launch_kernel<ALG, CLIP, DC, true>(p, shared);
    return launch_kernel<ALG, CLIP, DC, false>(p, 0);
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
        default: return -1;
    }
}

}  // namespace

// Returns cudaGetLastError() (or the error of raising the shared-memory limit),
// or -1 when the largest row degree `dc` has no compiled instance.
extern "C" int layered_sweep(int algorithm, int clip, int dc, void* t, void* lr,
                             const void* syn, const void* act, void* ok,
                             const void* row_ptr, const void* col, const void* shift,
                             int nb, int mb, int z, int B, float threshold,
                             float alpha, float beta, float scale, void* stream) {
    const Args p{static_cast<float*>(t),
                 static_cast<storage_t*>(lr),
                 static_cast<const int*>(syn),
                 static_cast<const uint8_t*>(act),
                 static_cast<uint8_t*>(ok),
                 static_cast<const int*>(row_ptr),
                 static_cast<const int*>(col),
                 static_cast<const int*>(shift),
                 nb, mb, z, B, threshold, alpha, beta, scale,
                 static_cast<cudaStream_t>(stream)};
    if (algorithm == kMinSum) {
        return clip ? launch_dc<kMinSum, true>(dc, p) : launch_dc<kMinSum, false>(dc, p);
    }
    return clip ? launch_dc<kSumProduct, true>(dc, p)
                : launch_dc<kSumProduct, false>(dc, p);
}
