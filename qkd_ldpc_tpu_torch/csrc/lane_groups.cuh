// What the kernels that read int8 [N, B] rows by groups of 16 adjacent lanes
// share (continuation.cu's bank, trial_stats.cu): the XOR of two arrays' loads
// over a group, ORed into four words, and the widest access that a row stride
// and the base addresses allow.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

// XOR of W-byte loads of z and a over one group's 16 lanes (`avail` lanes of
// the row lie in it), ORed into the four words of `acc` (lane j in byte j).
template <int W>
__device__ __forceinline__ void xor_or(const int8_t* z, const int8_t* a, int avail,
                                       uint32_t (&acc)[4]) {
    if constexpr (W == 16) {
        const uint4 u = *reinterpret_cast<const uint4*>(z);
        const uint4 v = *reinterpret_cast<const uint4*>(a);
        acc[0] |= u.x ^ v.x;
        acc[1] |= u.y ^ v.y;
        acc[2] |= u.z ^ v.z;
        acc[3] |= u.w ^ v.w;
    } else if constexpr (W == 8) {
#pragma unroll
        for (int k = 0; k < 2; ++k) {
            if (8 * k < avail) {
                const uint2 u = reinterpret_cast<const uint2*>(z)[k];
                const uint2 v = reinterpret_cast<const uint2*>(a)[k];
                acc[2 * k] |= u.x ^ v.x;
                acc[2 * k + 1] |= u.y ^ v.y;
            }
        }
    } else if constexpr (W == 4) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            if (4 * k < avail) {
                acc[k] |= reinterpret_cast<const uint32_t*>(z)[k] ^
                          reinterpret_cast<const uint32_t*>(a)[k];
            }
        }
    } else {
#pragma unroll
        for (int k = 0; k < 16; ++k) {
            if (k < avail) {
                acc[k >> 2] |= static_cast<uint32_t>(static_cast<uint8_t>(z[k] ^ a[k]))
                               << (8 * (k & 3));
            }
        }
    }
}

// The widest access (16, 8, 4 or 1 bytes) that divides `bits` (a row
// stride ORed with the base addresses).
inline int access_width(unsigned long long bits) {
    return bits % 16 == 0 ? 16 : bits % 8 == 0 ? 8 : bits % 4 == 0 ? 4 : 1;
}
