// The exact-weight channel's common path in one pass: per row, the k-th
// smallest of n uint32 scores, then Bob's row = Alice's row ^ flip.
//
// Replaces qkd_ldpc_tpu/channel/pallas_select.py::kth_smallest_pallas and the
// passes around it in qkd_ldpc_tpu/channel/keys.py::_exact_weight_mask.  The
// threshold t is the k-th smallest value of the row, which is unique, so it is
// the same value as the 32-pass bitwise search of the plain version.  The flip
// is  s < t,  plus the ties s == t  when their count n_at is at most
// need = k - count(s < t)  (then n_at == need); otherwise the first `need` ties
// in index order, and the row raises the excess flag, which sends the batch to
// the second-word tie path (complete_ties_kernel below, gated on the flag on the
// card).  k <= 0 flips nothing (threshold 0).
//
// Bound on this card: one read of the scores and of Alice's row, one write of
// Bob's row.  Design: one block of 512 threads per row.  A row of up to
// 512 * 20 words is read from device memory once, into registers, together
// with its Alice bytes (two register widths: 8 words a thread for rows up to
// 4096 words, 20 for rows up to 10240, the repo's N = 4096 and N = 10240
// codes); where n % 4 == 0 and the rows are aligned, a thread
// holds groups of 4 consecutive words (16-byte loads, 4-byte Alice / Bob
// accesses), else single words.  Group g of thread tid is group
// tid + 512 g of the row.  The threshold comes from a radix select: four 8-bit
// digits from the top, each a 256-bin shared histogram of the words that
// still share the chosen prefix and a one-warp scan that picks the digit and
// the rank left within it, two barriers a digit.  The last digit's bin gives
// n_at and the rank left gives need, so the mask costs no further reduction.
// The index-ordered tie completion walks the row in chunks of 512 groups
// (a warp scan of each thread's tie count, one barrier a chunk).  Rows wider
// than the registers hold re-read the row from device memory in every digit
// pass instead (the same code).  Without Alice's row the kernel returns the
// threshold only (per-row k: the tie path's second-word ranking).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

// One group of VEC consecutive words and their Alice bytes.
template <int VEC>
struct Group {
    uint32_t s[VEC];
    uint32_t a;  // VEC Alice bytes, little-endian
};

template <int VEC>
__device__ __forceinline__ void load_scores(Group<VEC>& g, const uint32_t* row, int q) {
    if constexpr (VEC == 4) {
        const uint4 x = reinterpret_cast<const uint4*>(row)[q];
        g.s[0] = x.x; g.s[1] = x.y; g.s[2] = x.z; g.s[3] = x.w;
    } else {
        g.s[0] = row[q];
    }
}

template <int VEC>
__device__ __forceinline__ uint32_t load_bytes(const uint8_t* row, int q) {
    if constexpr (VEC == 4) return reinterpret_cast<const uint32_t*>(row)[q];
    else return row[q];
}

template <int VEC>
__device__ __forceinline__ void store_bytes(uint8_t* row, int q, uint32_t x) {
    if constexpr (VEC == 4) reinterpret_cast<uint32_t*>(row)[q] = x;
    else row[q] = static_cast<uint8_t>(x);
}

// G groups of VEC words per thread held in registers; G == 0 re-reads the row
// from device memory.  Every thread calls the same barriers: the branches on
// k, on alice and on n_at > need are uniform across the block.
template <int G, int VEC>
__global__ void __launch_bounds__(kThreads, G > 0 ? 2 : 1)
select_flip_kernel(const uint32_t* __restrict__ scores, const int* __restrict__ k_rows,
                   int k_stride, int k_all, const uint8_t* __restrict__ alice,
                   uint8_t* __restrict__ bob,
                   uint32_t* __restrict__ thresh, int* __restrict__ excess, int n) {
    __shared__ int hist[2][256];
    __shared__ int warp_count[2][kWarps];
    __shared__ int pick[2][3];  // digit, rank left within it, count at it
    const size_t row = blockIdx.x;
    const size_t base = row * static_cast<size_t>(n);
    const uint32_t* src = scores + base;
    const uint8_t* a_row = alice ? alice + base : nullptr;
    uint8_t* b_row = bob ? bob + base : nullptr;
    const int tid = threadIdx.x;
    const int lane = tid & 31, warp = tid >> 5;
    const int k = k_rows ? k_rows[row * k_stride] : k_all;
    const int groups = n / VEC;  // n % VEC == 0

    Group<VEC> reg[G > 0 ? G : 1];
    if constexpr (G > 0) {
#pragma unroll
        for (int g = 0; g < G; ++g) {
            const int q = tid + g * kThreads;
            if (q < groups) {
                load_scores<VEC>(reg[g], src, q);
                reg[g].a = a_row ? load_bytes<VEC>(a_row, q) : 0u;
            }
        }
    }
    // f(group, q) over this thread's groups of the row.
    auto each = [&](auto&& f) {
        if constexpr (G > 0) {
#pragma unroll
            for (int g = 0; g < G; ++g) {
                const int q = tid + g * kThreads;
                if (q < groups) f(reg[g], q);
            }
        } else {
            for (int q = tid; q < groups; q += kThreads) {
                Group<VEC> x;
                load_scores<VEC>(x, src, q);
                x.a = a_row ? load_bytes<VEC>(a_row, q) : 0u;
                f(x, q);
            }
        }
    };

    if (k <= 0) {  // nothing flips; the plain search's threshold is 0
        if (tid == 0) thresh[row] = 0u;
        if (alice) each([&](const Group<VEC>& x, int q) { store_bytes<VEC>(b_row, q, x.a); });
        return;
    }

    if (tid < 256) hist[0][tid] = 0;
    else hist[1][tid - 256] = 0;
    __syncthreads();

    uint32_t prefix = 0u;  // the digits chosen so far, in place
    int left = k;          // rank of the answer among the words sharing prefix
    int n_at = 0;
#pragma unroll
    for (int d = 0; d < 4; ++d) {
        const int shift = 24 - 8 * d;
        const uint32_t high = d == 0 ? 0u : ~0u << (shift + 8);
        int* h = hist[d & 1];
        each([&](const Group<VEC>& x, int) {
#pragma unroll
            for (int j = 0; j < VEC; ++j)
                if ((x.s[j] & high) == prefix) atomicAdd(&h[(x.s[j] >> shift) & 0xFFu], 1);
        });
        if (tid < 256) hist[(d + 1) & 1][tid] = 0;  // read last in digit d - 1
        __syncthreads();
        if (warp == 0) {
            // Lane l owns bins 8l .. 8l + 7; an inclusive scan of the lanes'
            // sums finds the lane, then the lane its bin.  A rank beyond the
            // row (k > n) takes bin 255, as the bitwise search sets every bit.
            int c[8], sum = 0;
#pragma unroll
            for (int j = 0; j < 8; ++j) sum += (c[j] = h[8 * lane + j]);
            int incl = sum;
#pragma unroll
            for (int off = 1; off < 32; off <<= 1) {
                const int up = __shfl_up_sync(0xFFFFFFFFu, incl, off);
                if (lane >= off) incl += up;
            }
            int below = incl - sum;
            if (below < left && (left <= incl || lane == 31)) {
                int j = 0, at = c[0];
#pragma unroll
                for (int jj = 0; jj < 7; ++jj) {
                    if (j == jj && below + c[jj] < left) {
                        below += c[jj];
                        j = jj + 1;
                        at = c[jj + 1];
                    }
                }
                pick[d & 1][0] = 8 * lane + j;
                pick[d & 1][1] = left - below;
                pick[d & 1][2] = at;
            }
        }
        __syncthreads();
        prefix |= static_cast<uint32_t>(pick[d & 1][0]) << shift;
        left = pick[d & 1][1];
        n_at = pick[d & 1][2];
    }
    const uint32_t t = prefix;
    const int need = left;  // k - count(s < t), 1 <= need <= n_at
    if (tid == 0) {
        thresh[row] = t;
        if (alice && n_at > need) *excess = 1;
    }
    if (!alice) return;

    if (n_at <= need) {
        each([&](const Group<VEC>& x, int q) {
            uint32_t flip = 0u;
#pragma unroll
            for (int j = 0; j < VEC; ++j) flip |= static_cast<uint32_t>(x.s[j] <= t) << (8 * j);
            store_bytes<VEC>(b_row, q, x.a ^ flip);
        });
        return;
    }
    // Excess ties: the first `need` of them in index order.  Chunk c holds
    // groups 512 c .. 512 c + 511, group 512 c + tid on thread tid.
    int taken = 0;  // ties in the chunks before this one
    auto chunk = [&](int c, const Group<VEC>& x) {
        const int q = c * kThreads + tid;
        int mine = 0;
#pragma unroll
        for (int j = 0; j < VEC; ++j) mine += (q < groups && x.s[j] == t) ? 1 : 0;
        int incl = mine;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
            const int up = __shfl_up_sync(0xFFFFFFFFu, incl, off);
            if (lane >= off) incl += up;
        }
        if (lane == 31) warp_count[c & 1][warp] = incl;
        __syncthreads();
        int rank = taken + incl - mine, total = 0;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
            const int cw = warp_count[c & 1][w];
            rank += w < warp ? cw : 0;
            total += cw;
        }
        if (q < groups) {
            uint32_t flip = 0u;
#pragma unroll
            for (int j = 0; j < VEC; ++j) {
                const bool at = x.s[j] == t;
                flip |= static_cast<uint32_t>(x.s[j] < t || (at && rank < need)) << (8 * j);
                rank += at ? 1 : 0;
            }
            store_bytes<VEC>(b_row, q, x.a ^ flip);
        }
        taken += total;
    };
    if constexpr (G > 0) {
#pragma unroll
        for (int c = 0; c < G; ++c) chunk(c, reg[c]);
    } else {
        const int chunks = (groups + kThreads - 1) / kThreads;
        for (int c = 0; c < chunks; ++c) {
            const int q = c * kThreads + tid;
            Group<VEC> x{};
            if (q < groups) {
                load_scores<VEC>(x, src, q);
                x.a = load_bytes<VEC>(a_row, q);
            }
            chunk(c, x);
        }
    }
}

// Words per thread held in registers, in increasing order (multiples of 4).
constexpr int kRegisterWidths[] = {8, 20};

template <int W, int VEC>
int launch(int rows, const uint32_t* s, const int* k, int ks, int k_all, const uint8_t* a,
           uint8_t* b, uint32_t* t, int* e, int n, cudaStream_t st) {
    select_flip_kernel<W / VEC, VEC><<<rows, kThreads, 0, st>>>(s, k, ks, k_all, a, b, t, e, n);
    return static_cast<int>(cudaGetLastError());
}

template <int VEC>
int launch_width(int width, int rows, const uint32_t* s, const int* k, int ks, int k_all,
                 const uint8_t* a, uint8_t* b, uint32_t* t, int* e, int n, cudaStream_t st) {
    switch (width) {
        case 8: return launch<8, VEC>(rows, s, k, ks, k_all, a, b, t, e, n, st);
        case 20: return launch<20, VEC>(rows, s, k, ks, k_all, a, b, t, e, n, st);
        default: return launch<0, VEC>(rows, s, k, ks, k_all, a, b, t, e, n, st);
    }
}

}  // namespace

// Words per thread of the instance that takes rows of n words: the smallest
// register width that holds them, or 0 (rows re-read from device memory).
extern "C" int select_flip_width(int n) {
    for (int w : kRegisterWidths)
        if (n <= w * kThreads) return w;
    return 0;
}

// Words per access: 4 where n % 4 == 0 and every row starts 16-byte aligned
// (scores) and 4-byte aligned (Alice, Bob), else 1.
extern "C" int select_flip_vector(int n, const void* scores, const void* alice,
                                  const void* bob) {
    const bool aligned = reinterpret_cast<uintptr_t>(scores) % 16 == 0 &&
                         reinterpret_cast<uintptr_t>(alice) % 4 == 0 &&
                         reinterpret_cast<uintptr_t>(bob) % 4 == 0;
    return n % 4 == 0 && aligned ? 4 : 1;
}

// k_rows == nullptr: every row takes k_all; else row r takes k_rows[r * k_stride]
// (k_stride 0: one k on the card for every row, as a captured trial chunk
// passes the point's error count).  alice == nullptr: the threshold only (bob
// and excess unused).  *excess must be 0 on entry; the kernel sets it to 1 if
// any row has more ties at its threshold than it needs.
extern "C" int select_flip(const void* scores, const void* k_rows, int k_stride, int k_all,
                           const void* alice, void* bob, void* thresh, void* excess,
                           int rows, int n, void* stream) {
    const uint32_t* s = static_cast<const uint32_t*>(scores);
    const int* k = static_cast<const int*>(k_rows);
    const uint8_t* a = static_cast<const uint8_t*>(alice);
    uint8_t* b = static_cast<uint8_t*>(bob);
    uint32_t* t = static_cast<uint32_t*>(thresh);
    int* e = static_cast<int*>(excess);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int width = select_flip_width(n);
    if (select_flip_vector(n, scores, alice, bob) == 4)
        return launch_width<4>(width, rows, s, k, k_stride, k_all, a, b, t, e, n, st);
    return launch_width<1>(width, rows, s, k, k_stride, k_all, a, b, t, e, n, st);
}

// ---------------------------------------------------------------------------
// The second-word tie path on the card: the lax.cond of
// qkd_ldpc_tpu/channel/keys.py:158-167 (uniform_ties under the excess flag).
// Plain version: keys._uniform_ties (and its use in keys._exact_weight_flip).
//
// select_flip completes a row's count from its threshold ties in index order.
// Where a row has more ties than it needs (n_at > need, probability ~(N-1)/2^32
// a frame) the JAX package ranks those ties by a second word instead, then by
// index, so the flip set's law is exactly uniform.  complete_ties_kernel does
// that for every row of a batch whose excess flag (select_flip's, in device
// memory) is set, and returns at once when it is 0: the host never reads it.
// Per row (one block): need = k - count(s < t); the need-th smallest second
// word t2 among the ties, by the same radix select as above (four 8-bit digits,
// a 256-bin shared histogram each; the scan of the bins runs on one thread: this
// path is rare); then flip  s < t,  the ties with a second word below t2, and
// of the ties whose second word equals t2 the first need2 in index order (a
// block scan over chunks of kThreads words).  Bob's row is rewritten whole:
// alice ^ flip.  A row with n_at == need, or k <= 0, keeps select_flip's row,
// which is the same.  Bound: latency (six passes over a rare row).
namespace {

__global__ void __launch_bounds__(kThreads)
complete_ties_kernel(const uint32_t* __restrict__ scores, const uint32_t* __restrict__ thresh,
                     const int* __restrict__ k_dev, int k_arg,
                     const uint32_t* __restrict__ second, const uint8_t* __restrict__ alice,
                     uint8_t* __restrict__ bob, const int* __restrict__ excess, int n) {
    if (*excess == 0) return;
    const int k = k_dev ? *k_dev : k_arg;
    __shared__ unsigned hist[256];
    __shared__ int counts[2];
    __shared__ unsigned digit_state[2];  // prefix, rank left
    __shared__ int warp_sums[kWarps];
    const int tid = threadIdx.x;
    const size_t base = static_cast<size_t>(blockIdx.x) * n;
    const uint32_t* s = scores + base;
    const uint32_t* s2 = second + base;
    const uint32_t t = thresh[blockIdx.x];
    if (tid < 2) counts[tid] = 0;
    __syncthreads();
    int below = 0, at = 0;
    for (int i = tid; i < n; i += kThreads) {
        below += s[i] < t;
        at += s[i] == t;
    }
    atomicAdd(&counts[0], below);
    atomicAdd(&counts[1], at);
    __syncthreads();
    const int need = k - counts[0];
    if (k <= 0 || counts[1] <= need) return;  // select_flip's row is this row
    // t2: the need-th smallest second word among the ties
    uint32_t prefix = 0, mask = 0;
    if (tid == 0) digit_state[1] = static_cast<unsigned>(need);
    for (int d = 3; d >= 0; --d) {
        for (int b = tid; b < 256; b += kThreads) hist[b] = 0;
        __syncthreads();
        for (int i = tid; i < n; i += kThreads) {
            if (s[i] == t && (s2[i] & mask) == prefix) atomicAdd(&hist[(s2[i] >> (8 * d)) & 255u], 1u);
        }
        __syncthreads();
        if (tid == 0) {
            unsigned rank = digit_state[1], b = 0;
            while (hist[b] < rank) rank -= hist[b++];
            digit_state[0] = b;
            digit_state[1] = rank;
        }
        __syncthreads();
        prefix |= digit_state[0] << (8 * d);
        mask |= 255u << (8 * d);
        __syncthreads();
    }
    const uint32_t t2 = prefix;
    const int need2 = static_cast<int>(digit_state[1]);  // ties at t2 still needed
    // flip, the ties at t2 taken in index order, chunk by chunk
    int taken = 0;  // ties at t2 before this chunk
    const int lane = tid & 31, warp = tid >> 5;
    for (int c = 0; c < n; c += kThreads) {
        const int i = c + tid;
        const bool in = i < n;
        const bool tie = in && s[i] == t;
        const bool at2 = tie && s2[i] == t2;
        const unsigned ballot = __ballot_sync(0xffffffffu, at2);
        if (lane == 0) warp_sums[warp] = __popc(ballot);
        __syncthreads();
        int before = taken + __popc(ballot & ((1u << lane) - 1u));
        int chunk = 0;
        for (int w = 0; w < kWarps; ++w) {
            if (w < warp) before += warp_sums[w];
            chunk += warp_sums[w];
        }
        if (in) {
            const bool flip = s[i] < t || (tie && s2[i] < t2) || (at2 && before < need2);
            bob[base + i] = alice[base + i] ^ static_cast<uint8_t>(flip);
        }
        taken += chunk;
        __syncthreads();
    }
}

}  // namespace

// Rewrites bob [rows, n] where some row's ties need the second word (see
// complete_ties_kernel); a no-op launch when *excess == 0.  `scores`, `second`
// [rows, n] uint32, `thresh` [rows] uint32; k is the int at `k_dev` (on the
// card) where that is not null, else `k`.  Returns cudaGetLastError().
extern "C" int complete_ties(const void* scores, const void* thresh, const void* k_dev, int k,
                             const void* second, const void* alice, void* bob,
                             const void* excess, int rows, int n, void* stream) {
    complete_ties_kernel<<<rows, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(scores), static_cast<const uint32_t*>(thresh),
        static_cast<const int*>(k_dev), k,
        static_cast<const uint32_t*>(second), static_cast<const uint8_t*>(alice),
        static_cast<uint8_t*>(bob), static_cast<const int*>(excess), n);
    return static_cast<int>(cudaGetLastError());
}
