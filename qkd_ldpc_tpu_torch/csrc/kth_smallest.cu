// Per-row k-th smallest of uint32 scores by a 32-pass bitwise prefix search.
//
// Replaces qkd_ldpc_tpu/channel/pallas_select.py::kth_smallest_pallas.  The
// search keeps the largest prefix P with count(s < P) < k, one bit per pass;
// after 32 passes P is the k-th smallest value of the row, exactly.
//
// Bound on this card: one read of the [rows, n] score block from device
// memory.  Design: one block per row; the row is copied once into dynamic
// shared memory (40 KB at n = 10240; above 48 KB the launcher raises the
// kernel's limit) and all 32 passes count on chip — a warp-shuffle sum, then
// one __syncthreads per pass over double-buffered per-warp partials.  Rows
// that exceed the 227 KB a block may hold are re-read from device memory on
// every pass instead of being refused.  Scores compare as unsigned directly.
// k is per row, so the channel's tie path uses the same kernel.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr size_t kMaxShared = 232448;  // bytes a block may use on sm_90

template <bool IN_SHARED>
__global__ void __launch_bounds__(kThreads)
kth_smallest_kernel(const uint32_t* __restrict__ scores,
                    const int* __restrict__ k_rows, int k_all,
                    uint32_t* __restrict__ out, int n) {
    extern __shared__ uint32_t row_smem[];
    __shared__ int warp_cnt[2][kWarps];
    const size_t row = blockIdx.x;
    const uint32_t* src = scores + row * static_cast<size_t>(n);
    const int tid = threadIdx.x;
    const uint32_t* s = src;
    if (IN_SHARED) {
        for (int i = tid; i < n; i += kThreads) row_smem[i] = src[i];
        __syncthreads();
        s = row_smem;
    }
    const int k = k_rows ? k_rows[row] : k_all;  // per-row k, or one k for all
    uint32_t prefix = 0u;
    for (int j = 0; j < 32; ++j) {
        const uint32_t test = prefix | (1u << (31 - j));
        int c = 0;
        for (int i = tid; i < n; i += kThreads) c += (s[i] < test) ? 1 : 0;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
            c += __shfl_down_sync(0xFFFFFFFFu, c, off);
        if ((tid & 31) == 0) warp_cnt[j & 1][tid >> 5] = c;
        __syncthreads();
        int total = 0;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) total += warp_cnt[j & 1][w];
        if (total < k) prefix = test;
    }
    if (tid == 0) out[row] = prefix;
}

}  // namespace

// k_rows == nullptr: every row searches for its k_all-th smallest.
extern "C" int kth_smallest(const void* scores, const void* k_rows, int k_all,
                            void* out, int rows, int n, void* stream) {
    const size_t bytes = static_cast<size_t>(n) * sizeof(uint32_t);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const uint32_t* s = static_cast<const uint32_t*>(scores);
    const int* k = static_cast<const int*>(k_rows);
    uint32_t* o = static_cast<uint32_t*>(out);
    // The static per-warp partials share the block's budget with the row.
    if (bytes + sizeof(int) * 2 * kWarps <= kMaxShared) {
        if (bytes > 48 * 1024) {
            cudaError_t e = cudaFuncSetAttribute(
                kth_smallest_kernel<true>,
                cudaFuncAttributeMaxDynamicSharedMemorySize,
                static_cast<int>(bytes));
            if (e != cudaSuccess) return static_cast<int>(e);
        }
        kth_smallest_kernel<true><<<rows, kThreads, bytes, st>>>(s, k, k_all, o, n);
    } else {
        kth_smallest_kernel<false><<<rows, kThreads, 0, st>>>(s, k, k_all, o, n);
    }
    return static_cast<int>(cudaGetLastError());
}
