// Check-node update of the flooding BP decoder, with the bit-node update fused in.
//
// Replaces two TPU kernels of qkd_ldpc_tpu/decoder/pallas_kernels.py:
//   check_update_pallas (_check_kernel)  -> FIRST = true : the inputs are the
//       gathered, never clipped a-priori LLRs of iteration 1;
//   fused_update_pallas (_fused_kernel)  -> FIRST = false: the inputs are
//       Lq = clip(tot_chk - Lr_prev), recomputed in registers, so the
//       bit-to-check messages never exist in device memory.
// Both then run the same check update and store in the message storage type.
//
// Messages are dc-first, [DC, M, B] with the frame axis B fastest.  Sum-product:
// t_j = tanh(Lq_j / 2) (1 on padded slots), leave-one-out by exclusive prefix and
// suffix products times the syndrome sign, 2 atanh(x) = log1p(2x / (1 - x)); a
// saturated product x = +-1 gives +-inf, which the clip then bounds — x is not
// clamped early.  Min-sum: top-2 minima with the first occurrence of the row
// minimum excluded (strict <), sign parity by an integer count, offset beta and
// scale alpha.
//
// Bound on this card: memory traffic only — (2 or 3) * DC * M * B * itemsize bytes
// per launch plus the [M, B] sign plane; the two transcendentals per edge stay
// under the float rate at that bandwidth.  Design: one thread per (check, frame)
// with the frame fastest, so every load and store of plane j is coalesced along B
// and a warp reads one mask word per slot; the DC inputs live in registers (DC is
// a template parameter, loops fully unrolled), arithmetic is float32, and the
// rounding points are the plain version's: bf16 round-to-nearest-even, int8
// rint(x / scale) saturated at +-127.  Compiled without fast-math and without fma
// contraction.  The file is built once per storage type (-DSTORAGE=0|1|2).
#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#ifndef STORAGE
#define STORAGE 0
#endif

namespace {

#if STORAGE == 0
using storage_t = float;
__device__ __forceinline__ float load(const storage_t* p, size_t i, float) { return p[i]; }
__device__ __forceinline__ void store(storage_t* p, size_t i, float x, float) { p[i] = x; }
#elif STORAGE == 1
using storage_t = __nv_bfloat16;
__device__ __forceinline__ float load(const storage_t* p, size_t i, float) {
    return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store(storage_t* p, size_t i, float x, float) {
    p[i] = __float2bfloat16_rn(x);
}
#else
using storage_t = int8_t;
__device__ __forceinline__ float load(const storage_t* p, size_t i, float scale) {
    return static_cast<float>(p[i]) * scale;
}
__device__ __forceinline__ void store(storage_t* p, size_t i, float x, float scale) {
    float q = rintf(x / scale);  // round half to even, as the plain version
    q = q < -127.0f ? -127.0f : (q > 127.0f ? 127.0f : q);
    p[i] = static_cast<int8_t>(q);
}
#endif

constexpr int kSumProduct = 0;
constexpr int kMinSum = 1;

// min(max(x, -t), t) that lets a NaN through, as the plain version's clamp.
__device__ __forceinline__ float clipf(float x, float t) {
    return x < -t ? -t : (x > t ? t : x);
}

template <int ALG, bool FIRST, bool CLIP, int DC>
__global__ void __launch_bounds__(256)
check_update_kernel(const storage_t* __restrict__ a,        // Lq (FIRST) or tot_chk
                    const storage_t* __restrict__ lr_prev,  // unused when FIRST
                    const int* __restrict__ mask,           // [DC, M]
                    const float* __restrict__ syn_sign,     // [M, B]
                    storage_t* __restrict__ out, int M, int B, float threshold,
                    float alpha, float beta, float scale) {
    const size_t MB = static_cast<size_t>(M) * B;
    const size_t idx = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
    if (idx >= MB) return;
    const int m = static_cast<int>(idx / B);
    const float syn = syn_sign[idx];

    float lq[DC];
    bool valid[DC];
#pragma unroll
    for (int j = 0; j < DC; ++j) {
        const size_t e = j * MB + idx;
        float v = load(a, e, scale);
        if (!FIRST) {
            v = v - load(lr_prev, e, scale);
            if (CLIP) v = clipf(v, threshold);
        }
        lq[j] = v;
        valid[j] = mask[j * M + m] != 0;
    }

    if (ALG == kSumProduct) {
        float t[DC], pre[DC];
#pragma unroll
        for (int j = 0; j < DC; ++j) t[j] = valid[j] ? tanhf(lq[j] * 0.5f) : 1.0f;
        float acc = 1.0f;
#pragma unroll
        for (int j = 0; j < DC; ++j) {
            pre[j] = acc;
            acc = acc * t[j];
        }
        acc = 1.0f;  // running suffix product
#pragma unroll
        for (int j = DC - 1; j >= 0; --j) {
            const float x = pre[j] * acc * syn;
            float lr = log1pf(2.0f * x / (1.0f - x));
            if (CLIP) lr = clipf(lr, threshold);
            store(out, j * MB + idx, lr, scale);
            acc = acc * t[j];
        }
    } else {
        float absl[DC];
        int neg[DC];
#pragma unroll
        for (int j = 0; j < DC; ++j) {
            absl[j] = valid[j] ? fabsf(lq[j]) : INFINITY;
            neg[j] = (valid[j] && lq[j] < 0.0f) ? 1 : 0;
        }
        float m1 = absl[0];
        int s1 = 0, tot_neg = neg[0];
#pragma unroll
        for (int j = 1; j < DC; ++j) {
            if (absl[j] < m1) {  // strict: keeps the first occurrence
                s1 = j;
                m1 = absl[j];
            }
            tot_neg += neg[j];
        }
        float m2 = INFINITY;
#pragma unroll
        for (int j = 0; j < DC; ++j) {
            const float c = (s1 == j) ? INFINITY : absl[j];
            m2 = c < m2 ? c : m2;
        }
#pragma unroll
        for (int j = 0; j < DC; ++j) {
            float loo = (s1 == j) ? m2 : m1;
            if (beta != 0.0f) loo = fmaxf(loo - beta, 0.0f);
            const float sign = (((tot_neg - neg[j]) & 1) ? -1.0f : 1.0f) * syn;
            float lr = alpha * sign * loo;
            if (CLIP) lr = clipf(lr, threshold);
            store(out, j * MB + idx, lr, scale);
        }
    }
}

struct Args {
    const storage_t* a;
    const storage_t* lr_prev;
    const int* mask;
    const float* syn_sign;
    storage_t* out;
    int M, B;
    float threshold, alpha, beta, scale;
    cudaStream_t stream;
};

template <int ALG, bool FIRST, bool CLIP, int DC>
void launch(const Args& p) {
    const size_t total = static_cast<size_t>(p.M) * p.B;
    const unsigned blocks = static_cast<unsigned>((total + 255) / 256);
    check_update_kernel<ALG, FIRST, CLIP, DC><<<blocks, 256, 0, p.stream>>>(
        p.a, p.lr_prev, p.mask, p.syn_sign, p.out, p.M, p.B, p.threshold,
        p.alpha, p.beta, p.scale);
}

template <int ALG, bool FIRST, bool CLIP>
bool launch_dc(int dc, const Args& p) {
    switch (dc) {
        case 2: launch<ALG, FIRST, CLIP, 2>(p); return true;
        case 3: launch<ALG, FIRST, CLIP, 3>(p); return true;
        case 4: launch<ALG, FIRST, CLIP, 4>(p); return true;
        case 5: launch<ALG, FIRST, CLIP, 5>(p); return true;
        case 6: launch<ALG, FIRST, CLIP, 6>(p); return true;
        case 7: launch<ALG, FIRST, CLIP, 7>(p); return true;
        case 8: launch<ALG, FIRST, CLIP, 8>(p); return true;
        default: return false;
    }
}

template <int ALG>
bool launch_flags(bool first, bool clip, int dc, const Args& p) {
    if (first) {
        return clip ? launch_dc<ALG, true, true>(dc, p)
                    : launch_dc<ALG, true, false>(dc, p);
    }
    return clip ? launch_dc<ALG, false, true>(dc, p)
                : launch_dc<ALG, false, false>(dc, p);
}

}  // namespace

// Returns cudaGetLastError(), or -1 when dc has no compiled instance.
extern "C" int check_update(int algorithm, int first, int clip, int dc,
                            const void* a, const void* lr_prev, const void* mask,
                            const void* syn_sign, void* out, int M, int B,
                            float threshold, float alpha, float beta, float scale,
                            void* stream) {
    const Args p{static_cast<const storage_t*>(a),
                 static_cast<const storage_t*>(lr_prev),
                 static_cast<const int*>(mask),
                 static_cast<const float*>(syn_sign),
                 static_cast<storage_t*>(out), M, B, threshold, alpha, beta, scale,
                 static_cast<cudaStream_t>(stream)};
    const bool ok = algorithm == kMinSum
                        ? launch_flags<kMinSum>(first != 0, clip != 0, dc, p)
                        : launch_flags<kSumProduct>(first != 0, clip != 0, dc, p);
    if (!ok) return -1;
    return static_cast<int>(cudaGetLastError());
}
