// Per-trial random rows of the channel (Threefry-2x32, 20 rounds), with the
// trial keys derived on chip.
//
// Replaces qkd_ldpc_tpu/channel/pallas_prng.py::trial_words_pallas, which
// reseeds the TPU's hardware generator per trial.  That stream exists only
// on a TPU, so this kernel writes the portable threefry stream instead, as
// jax.random gives it:
//   trial key  tk = fold_in(point_key, id)        fold_in(k, d) = threefry(k, (0, d))
//   Alice      ak = fold_in(tk, 0)   bit i = 1 - (word_i >> 31)   (bernoulli 0.5)
//   scores     sk = fold_in(tk, 1)   word i
//   tie words  fold_in(sk, 1)        word i
// where word_i = x0 ^ x1 of threefry(key, (0, i)) (jax.random.bits).  The trial
// id of row r is ids[r] (mod 2^32) or, without an id array, base + first + r
// (mod 2^32).  The point key and the base may be read from device memory: a
// captured trial chunk (sim/runner.py) replays the same launch for every point
// and chunk, whose key and first trial id the replay copies in.
//
// Bound on this card: the integer work of the 20-round loop, one threefry
// block per emitted word; the writes (Alice's bit as a byte and the score
// word: 5 bytes a position) take about a sixth of that time at the INT32
// lanes' rate.  Design: a block covers kWordsPerBlock
// words of one trial; its first warp derives the row keys once (2-3 threefry
// blocks, lanes in parallel) and stages them in shared memory, so the key tree
// costs no host launch and under 1 % of the block's work; every thread then
// runs the unchanged word loop for each emitted row, neighbouring threads on
// neighbouring words (coalesced).  A null output pointer skips that row.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWordsPerThread = 4;
constexpr int kWordsPerBlock = kThreads * kWordsPerThread;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
    return (x << r) | (x >> (32 - r));
}

// x0 ^ x1 of threefry2x32(key, (0, counter)); the key derivation keeps both.
__device__ __forceinline__ uint2 threefry(uint32_t k0, uint32_t k1, uint32_t counter) {
    const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
    const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
    uint32_t x0 = 0u + ks[0];
    uint32_t x1 = counter + ks[1];
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
    return make_uint2(x0, x1);
}

__global__ void __launch_bounds__(kThreads)
trial_rows_kernel(uint32_t pk0, uint32_t pk1, const uint32_t* __restrict__ key,
                  const int64_t* __restrict__ ids, uint32_t first,
                  const uint32_t* __restrict__ first_dev, int n,
                  uint8_t* __restrict__ alice, uint32_t* __restrict__ scores,
                  uint32_t* __restrict__ ties, const int* __restrict__ gate) {
    __shared__ uint2 row_key[3];  // Alice, scores, tie words
    // the tie rows of a batch whose excess-ties flag (K3's) is 0 are not needed
    if (gate != nullptr && *gate == 0) return;
    const size_t row = blockIdx.x;
    const int tid = threadIdx.x;
    if (tid < 32) {
        const uint32_t base = first_dev ? *first_dev : 0u;
        const uint32_t id = ids ? static_cast<uint32_t>(ids[row])
                                : base + first + static_cast<uint32_t>(row);
        const uint2 tk = key ? threefry(key[0], key[1], id) : threefry(pk0, pk1, id);
        if (tid == 0 && alice) row_key[0] = threefry(tk.x, tk.y, 0u);
        if (tid == 1 && (scores || ties)) {
            const uint2 sk = threefry(tk.x, tk.y, 1u);
            row_key[1] = sk;
            if (ties) row_key[2] = threefry(sk.x, sk.y, 1u);
        }
    }
    __syncthreads();
    const size_t base = row * static_cast<size_t>(n);
#pragma unroll
    for (int j = 0; j < kWordsPerThread; ++j) {
        const int i = blockIdx.y * kWordsPerBlock + j * kThreads + tid;
        if (i >= n) break;
        if (alice) {
            const uint2 w = threefry(row_key[0].x, row_key[0].y, static_cast<uint32_t>(i));
            alice[base + i] = static_cast<uint8_t>(((w.x ^ w.y) >> 31) ^ 1u);
        }
        if (scores) {
            const uint2 w = threefry(row_key[1].x, row_key[1].y, static_cast<uint32_t>(i));
            scores[base + i] = w.x ^ w.y;
        }
        if (ties) {
            const uint2 w = threefry(row_key[2].x, row_key[2].y, static_cast<uint32_t>(i));
            ties[base + i] = w.x ^ w.y;
        }
    }
}

// The flat block of jax.random.bits(key, shape, uint32): word i = x0 ^ x1 of
// threefry(key, (0, i)) for the flat row-major index i (< 2^32), as
// channel/threefry.py::random_bits gives it.  The protocol's key blocks
// (qkd_ldpc_tpu/channel/keys.py:171-184 draws them with jax.random outside any
// Pallas kernel) and the tie words of introduce_errors, which JAX draws only
// under lax.cond(has_excess) (keys.py:167): here `gate` (K3's excess flag, on
// the card) skips the block where it reads 0.  Bound: the same integer work as
// trial_rows_kernel, one threefry block a word; each thread writes
// kWordsPerThread words kThreads apart (coalesced).
__global__ void __launch_bounds__(kThreads)
block_words_kernel(uint32_t pk0, uint32_t pk1, const uint32_t* __restrict__ key,
                   uint32_t* __restrict__ out, long long count, const int* __restrict__ gate) {
    if (gate != nullptr && *gate == 0) return;
    const uint32_t k0 = key ? key[0] : pk0, k1 = key ? key[1] : pk1;
    const long long first = static_cast<long long>(blockIdx.x) * kWordsPerBlock;
#pragma unroll
    for (int j = 0; j < kWordsPerThread; ++j) {
        const long long i = first + j * kThreads + threadIdx.x;
        if (i >= count) break;
        const uint2 w = threefry(k0, k1, static_cast<uint32_t>(i));
        out[i] = w.x ^ w.y;
    }
}

}  // namespace

// The point key is (pk0, pk1), or the two words at `key` (uint32 on the card,
// may be null) where given.  ids == nullptr: row r is trial base + first + r
// (mod 2^32), base the uint32 at `first_dev` (on the card; 0 when null).
// alice / scores / ties may each be nullptr (that row is not emitted).  gate
// (an int on the card, may be null): where it reads 0 the launch writes
// nothing (the tie path, lax.cond of qkd_ldpc_tpu/channel/keys.py:167, taken
// on the card: the gate is K3's excess-ties flag).
extern "C" int trial_rows(unsigned int pk0, unsigned int pk1, const void* key, const void* ids,
                          unsigned int first, const void* first_dev, int batch, int n,
                          void* alice, void* scores, void* ties, const void* gate,
                          void* stream) {
    dim3 grid(batch, (n + kWordsPerBlock - 1) / kWordsPerBlock);
    trial_rows_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        pk0, pk1, static_cast<const uint32_t*>(key), static_cast<const int64_t*>(ids), first,
        static_cast<const uint32_t*>(first_dev), n, static_cast<uint8_t*>(alice),
        static_cast<uint32_t*>(scores), static_cast<uint32_t*>(ties),
        static_cast<const int*>(gate));
    return static_cast<int>(cudaGetLastError());
}

// `count` words of the flat block of the key (pk0, pk1), or of the two words at
// `key` (uint32 on the card) where given, into `out`; nothing where the int at
// `gate` (may be null) reads 0.  count < 2^32.
extern "C" int block_words(unsigned int pk0, unsigned int pk1, const void* key, void* out,
                           long long count, const void* gate, void* stream) {
    const long long blocks = (count + kWordsPerBlock - 1) / kWordsPerBlock;
    block_words_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        pk0, pk1, static_cast<const uint32_t*>(key), static_cast<uint32_t*>(out), count,
        static_cast<const int*>(gate));
    return static_cast<int>(cudaGetLastError());
}
