// Per-trial random bit blocks (Threefry-2x32, 20 rounds).
//
// Replaces qkd_ldpc_tpu/channel/pallas_prng.py::trial_words_pallas, which
// reseeds the TPU's hardware generator per trial.  That stream exists only
// on a TPU, so this kernel writes the portable threefry stream instead:
// word i of row r is x0 ^ x1 of threefry2x32(key[r], (0, i)), which is
// jax.random.bits(key[r], (n,)) bit for bit.
//
// Bound on this card: the write of rows * n uint32 words; the ~100 integer
// operations per word sit well under the card's integer rate at that
// bandwidth.  Design: one thread per word, all 20 rounds in registers,
// neighbouring threads write neighbouring words (coalesced); the grid's x
// axis walks the rows so any batch size fits.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
    return (x << r) | (x >> (32 - r));
}

__global__ void threefry_words_kernel(const uint32_t* __restrict__ keys,
                                      uint32_t* __restrict__ out, int n) {
    const int i = blockIdx.y * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const size_t row = blockIdx.x;
    const uint32_t ks0 = keys[2 * row], ks1 = keys[2 * row + 1];
    const uint32_t ks[3] = {ks0, ks1, ks0 ^ ks1 ^ 0x1BD11BDAu};
    const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
    uint32_t x0 = 0u + ks[0];
    uint32_t x1 = static_cast<uint32_t>(i) + ks[1];
#pragma unroll
    for (int g = 0; g < 5; ++g) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
            x0 += x1;
            x1 = rotl(x1, rot[g & 1][r]) ^ x0;
        }
        x0 += ks[(g + 1) % 3];
        x1 += ks[(g + 2) % 3] + static_cast<uint32_t>(g + 1);
    }
    out[row * static_cast<size_t>(n) + i] = x0 ^ x1;
}

}  // namespace

extern "C" int threefry_words(const void* keys, void* out, int rows, int n,
                              void* stream) {
    const int threads = 256;
    dim3 grid(rows, (n + threads - 1) / threads);
    threefry_words_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(keys), static_cast<uint32_t*>(out), n);
    return static_cast<int>(cudaGetLastError());
}
