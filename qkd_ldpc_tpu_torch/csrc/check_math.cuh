// What the check-node kernels share: the message storage type with its two
// rounding points, the clip, aligned vector accesses, and the leave-one-out check
// update on a row held in registers.  Included by check_update.cu (flooding) and layered_sweep.cu
// (layered), so both schedules round exactly alike.
//
// Sum-product: t_j = tanh(Lq_j / 2) (1 on padded slots), leave-one-out by
// exclusive prefix and suffix products times the syndrome sign,
// 2 atanh(x) = log1p(2x / (1 - x)); a saturated product x = +-1 gives +-inf,
// which the clip then bounds — x is not clamped early.  Min-sum: top-2 minima
// with the first occurrence of the row minimum excluded (strict <), sign parity
// by an integer count, offset beta and scale alpha.  A padded slot multiplies by
// exactly 1 (sum-product) or carries +inf and no sign (min-sum), so a row of
// degree d < DC gives the results of a DC = d instance bit for bit.
//
// check_messages_loop is the same update for a row of any degree, the slots walked
// in loops with nothing per slot in registers; its arithmetic is the unrolled
// form's in the same order, so the two agree bit for bit.
//
// Arithmetic is float32; compiled without fast-math and without fma contraction.
// The including file is built once per storage type (-DSTORAGE=0|1|2).
#pragma once

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
__device__ __forceinline__ float from_storage(storage_t q, float) { return q; }
__device__ __forceinline__ storage_t to_storage(float x, float) { return x; }
#elif STORAGE == 1
using storage_t = __nv_bfloat16;
__device__ __forceinline__ float from_storage(storage_t q, float) {
    return __bfloat162float(q);
}
__device__ __forceinline__ storage_t to_storage(float x, float) {
    return __float2bfloat16_rn(x);
}
#else
using storage_t = int8_t;
__device__ __forceinline__ float from_storage(storage_t q, float scale) {
    return static_cast<float>(q) * scale;
}
__device__ __forceinline__ storage_t to_storage(float x, float scale) {
    float q = rintf(x / scale);  // round half to even, as the plain version
    q = q < -127.0f ? -127.0f : (q > 127.0f ? 127.0f : q);
    return static_cast<int8_t>(q);
}
#endif

// N adjacent elements moved as one aligned access (16 bytes is the widest a
// thread can make): N = 1 is the plain scalar access.
template <typename T, int N>
struct alignas(sizeof(T) * N) Vec {
    T v[N];
};

template <int N, typename T>
__device__ __forceinline__ Vec<T, N> load_vec(const T* p) {
    return *reinterpret_cast<const Vec<T, N>*>(p);
}

template <int N, typename T>
__device__ __forceinline__ void store_vec(T* p, const Vec<T, N>& x) {
    *reinterpret_cast<Vec<T, N>*>(p) = x;
}

// Elements of the storage type in one 16-byte access.
constexpr int kStorageVec = 16 / static_cast<int>(sizeof(storage_t));

constexpr int kSumProduct = 0;
constexpr int kMinSum = 1;

// min(max(x, -t), t) that lets a NaN through, as the plain version's clamp.
__device__ __forceinline__ float clipf(float x, float t) {
    return x < -t ? -t : (x > t ? t : x);
}

// Check-to-bit messages of one check from its DC bit-to-check inputs (clipped to
// +-threshold when CLIP), not yet rounded to storage.
template <int ALG, bool CLIP, int DC>
__device__ __forceinline__ void check_messages(const float (&lq)[DC],
                                               const bool (&valid)[DC], float syn,
                                               float threshold, float alpha,
                                               float beta, float (&out)[DC]) {
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
            out[j] = lr;
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
            out[j] = lr;
        }
    }
}

// check_messages for a row of `dc` slots, VEC frames at once, in two passes over
// the slots: nothing per slot stays in registers, so a row of 60 or 200 slots costs
// no spills.  `read(j, first_pass, lq)` gives slot j's inputs lq[VEC] (clipped as
// the caller's Lq is) and returns whether the slot is real; `write(j, out)` takes
// slot j's messages right after the second pass has read slot j.  Sum-product
// writes the exclusive prefix products of t_j to the float32 `scratch` (slot j's
// VEC frames at scratch[at + j * stride], VEC-aligned) going forward and combines
// them with the running suffix product going back (pre[j] * suf[j] is not
// total / t_j); min-sum finds the two minima (the first occurrence of the row
// minimum is the excluded slot) and the sign count in the first pass and writes
// in the second.  Min-sum does not touch the scratch, which may then be null.
template <int ALG, bool CLIP, int VEC, typename Read, typename Write>
__device__ __forceinline__ void check_messages_loop(int dc, const float (&syn)[VEC],
                                                    float threshold, float alpha,
                                                    float beta, float* scratch,
                                                    size_t at, size_t stride, Read read,
                                                    Write write) {
    float lq[VEC], out[VEC];
    if (ALG == kSumProduct) {
        float acc[VEC];
#pragma unroll
        for (int f = 0; f < VEC; ++f) acc[f] = 1.0f;
        for (int j = 0; j < dc; ++j) {  // forward: prefix products to scratch
            const bool valid = read(j, true, lq);
            Vec<float, VEC> pre;
#pragma unroll
            for (int f = 0; f < VEC; ++f) {
                pre.v[f] = acc[f];
                acc[f] = acc[f] * (valid ? tanhf(lq[f] * 0.5f) : 1.0f);
            }
            store_vec<VEC>(scratch + at + j * stride, pre);
        }
#pragma unroll
        for (int f = 0; f < VEC; ++f) acc[f] = 1.0f;  // running suffix product
        for (int j = dc - 1; j >= 0; --j) {
            const bool valid = read(j, false, lq);
            const Vec<float, VEC> pre = load_vec<VEC>(scratch + at + j * stride);
#pragma unroll
            for (int f = 0; f < VEC; ++f) {
                const float x = pre.v[f] * acc[f] * syn[f];
                float lr = log1pf(2.0f * x / (1.0f - x));
                if (CLIP) lr = clipf(lr, threshold);
                out[f] = lr;
                acc[f] = acc[f] * (valid ? tanhf(lq[f] * 0.5f) : 1.0f);
            }
            write(j, out);
        }
    } else {
        float m1[VEC], m2[VEC];
        int s1[VEC], tot_neg[VEC];
        for (int j = 0; j < dc; ++j) {  // the two minima and the sign count
            const bool valid = read(j, true, lq);
#pragma unroll
            for (int f = 0; f < VEC; ++f) {
                const float a = valid ? fabsf(lq[f]) : INFINITY;
                const int neg = (valid && lq[f] < 0.0f) ? 1 : 0;
                if (j == 0) {  // as the unrolled form, also for a NaN
                    m1[f] = a;
                    s1[f] = 0;
                    m2[f] = INFINITY;
                    tot_neg[f] = neg;
                } else {
                    if (a < m1[f]) {  // strict: keeps the first occurrence
                        m2[f] = m1[f];
                        m1[f] = a;
                        s1[f] = j;
                    } else {
                        m2[f] = a < m2[f] ? a : m2[f];
                    }
                    tot_neg[f] += neg;
                }
            }
        }
        for (int j = 0; j < dc; ++j) {
            const bool valid = read(j, false, lq);
#pragma unroll
            for (int f = 0; f < VEC; ++f) {
                const int neg = (valid && lq[f] < 0.0f) ? 1 : 0;
                float loo = (s1[f] == j) ? m2[f] : m1[f];
                if (beta != 0.0f) loo = fmaxf(loo - beta, 0.0f);
                const float sign = (((tot_neg[f] - neg) & 1) ? -1.0f : 1.0f) * syn[f];
                float lr = alpha * sign * loo;
                if (CLIP) lr = clipf(lr, threshold);
                out[f] = lr;
            }
            write(j, out);
        }
    }
}

}  // namespace
