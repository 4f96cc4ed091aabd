// One flooding BP iteration as two kernels: the check-node update (with the
// bit-node update and the decision syndrome fused in) and the variable-node
// update.  Between them the loop carries only total [N, B] and Lr [DC, M, B].
//
// check_update_kernel replaces three TPU kernels of
// qkd_ldpc_tpu/decoder/pallas_kernels.py:
//   check_update_pallas (_check_kernel)  -> FIRST = true : the inputs are the
//       never clipped a-priori LLRs of iteration 1, in storage type;
//   fused_update_pallas (_fused_kernel)  -> FIRST = false: the inputs are
//       Lq = clip(total[var] - Lr_prev), recomputed in registers, so the
//       bit-to-check messages never exist in device memory;
//   fused_update_fresh_pallas (_fused_kernel_fresh) -> FIRST = false with a
//       per-frame `fresh` flag: a fresh frame's Lq skips the clip, so its
//       (total = a-priori, Lr = 0) state replays iteration 1 exactly (the
//       continuation runner restarts lanes in the middle of a batch).  The flag is
//       a runtime pointer, null for the plain fused update.
// All run the same check update (check_math.cuh) and store in the message storage
// type.  Messages are dc-first, [DC, M, B] with the frame axis B fastest.
//
// The TPU kernels read a gathered copy tot_chk [DC, M, B] of the totals, made by a
// tensor pass between launches.  Here the kernel gathers for itself: slot j of
// check m reads row adj[j][m] of total [N, B].  Rows are contiguous along B, so
// the gather is as coalesced as a plane read, total is a third of the size of its
// gathered copy and stays in the L2 cache, and the copy is never made.
//
// With the totals of a check's variables in registers the kernel also has the
// decision syndrome: the parity of (total <= 0) over the check's real slots is
// compared with the target bit, and a mismatching check clears its frame's byte in
// ok [B], which the variable update (or the caller) has preset to 1 (a plain store
// of one value: no order dependence).  A fresh frame has run no iteration yet: its byte is cleared too.
// So ok describes the totals that went IN, i.e. the iteration before the one whose
// messages this launch computes.
//
// variable_update_kernel takes the place of the tensor passes that followed the
// TPU kernels (route, sum, requantise, decide): per (variable, frame) it reads the
// variable's check messages through slot [DV, N] (a padded slot contributes
// exactly 0), adds them in slot order in float32, adds the a-priori LLR, rounds to
// storage and writes total [N, B]; for the frames whose `active` flag is set it
// also writes the decision z = (total <= 0) and adds one to the frame's iteration
// count, and it sets every frame's byte of ok to 1 for the check update that
// follows, so the per-lane bookkeeping of the loop needs no passes of its own.
//
// Bound on this card: memory traffic.  Check update: total once (N * B), Lr read
// and written (2 * DC * M * B), one syndrome byte per (check, frame).  Variable
// update: Lr read, llr read (4 bytes), total and z written.  Design: each thread
// takes a vector of adjacent frames of one check (or variable), starts all its
// loads at once, computes frame by frame in registers and stores vectors; index
// and mask words are read once per thread.  The variable update, which only
// streams, is fastest at 16 bytes a thread.  The check update is not: measured on
// an H100 its time hardly moves between 2 and 8 bytes a thread and rises beyond
// (the frames of a vector are unrolled code, and the sum-product arithmetic, not
// the width of the accesses, is what its memory phases fail to hide), so it takes
// 4 frames a thread (2 of int8, whose conversions make it the slowest storage at
// any width).  A scalar instance of the same templates (VEC = 1) takes a B that is
// not a multiple of the vector or a pointer that is not 16-byte aligned; the caller
// chooses by shape and alignment.
//
// Check degrees.  The instances above unroll the slots of a check (DC = 2..8, the
// degrees of the flagship codes): every slot's inputs sit in registers at once.
// Any other dc_max runs check_update_any_kernel, the loop form of the same update
// (check_messages_loop in check_math.cuh), which keeps nothing per slot in
// registers, so a row of 60 or 200 slots costs no spills, and equals the plain
// version bit for bit as the unrolled instances do.  Its sum-product keeps the
// prefix products in a float32 scratch [dc, M, B] that the caller allocates.  The
// second pass reads the inputs again.
// Arithmetic is float32 with the plain version's rounding points; compiled without
// fast-math and without fma contraction, once per storage type (-DSTORAGE=0|1|2).
#include "check_math.cuh"

namespace {

constexpr int kThreads = 256;
// Adjacent frames per thread of the vector instances (powers of two).
constexpr int kCheckVec = sizeof(storage_t) == 1 ? 2 : 4;
constexpr int kVariableVec = kStorageVec < 8 ? kStorageVec : 8;

// N bytes read from the L2 cache, past the L1, as one access.
template <int N>
__device__ __forceinline__ Vec<uint8_t, N> load_bytes_l2(const uint8_t* p) {
    Vec<uint8_t, N> out;
    if constexpr (N == 16) {
        const uint4 w = __ldcg(reinterpret_cast<const uint4*>(p));
        memcpy(&out, &w, N);
    } else if constexpr (N == 8) {
        const uint2 w = __ldcg(reinterpret_cast<const uint2*>(p));
        memcpy(&out, &w, N);
    } else if constexpr (N == 4) {
        const unsigned w = __ldcg(reinterpret_cast<const unsigned*>(p));
        memcpy(&out, &w, N);
    } else if constexpr (N == 2) {
        const unsigned short w = __ldcg(reinterpret_cast<const unsigned short*>(p));
        memcpy(&out, &w, N);
    } else {
        static_assert(N == 1, "a vector of 1, 2, 4, 8 or 16 bytes");
        out.v[0] = __ldcg(p);
    }
    return out;
}

// The first index of this thread's vector of frames and its row, from a flat
// index over rows x (B / VEC) with the vector index fastest.
template <int VEC>
__device__ __forceinline__ bool locate(int rows, int B, int* row, int* b0) {
    const int vecs = B / VEC;
    const size_t idx = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
    if (idx >= static_cast<size_t>(rows) * vecs) return false;
    *row = static_cast<int>(idx / vecs);
    *b0 = static_cast<int>(idx - static_cast<size_t>(*row) * vecs) * VEC;
    return true;
}

// Clears ok[b0 + f] for every bit f of `bad`.  Every check of a frame may clear
// the same byte, and a byte that many blocks hammer is a hot spot of the L2 cache.
// So look first, with one access, and store only where the byte still stands.  The
// look comes last and goes to the L2 cache, past the SM's L1 (which other blocks'
// stores do not reach): a look made with the other loads, when no check has
// finished yet, sees every byte standing and measured 15 % slower.
template <int VEC>
__device__ __forceinline__ void clear_flags(uint8_t* __restrict__ ok, int b0,
                                            unsigned bad) {
    const Vec<uint8_t, VEC> seen = load_bytes_l2<VEC>(ok + b0);
#pragma unroll
    for (int f = 0; f < VEC; ++f) {
        if (((bad >> f) & 1u) && seen.v[f] != 0) ok[b0 + f] = 0;
    }
}

template <int ALG, bool FIRST, int DC, int VEC>
__global__ void __launch_bounds__(kThreads)
check_update_kernel(const storage_t* __restrict__ total,    // [N, B]
                    const int* __restrict__ adj,            // [DC, M] variable of a slot
                    const int* __restrict__ mask,           // [DC, M] 0 = padded slot
                    const storage_t* __restrict__ lr_prev,  // [DC, M, B]; unused when FIRST
                    const uint8_t* __restrict__ fresh,      // [B] or null
                    const int8_t* __restrict__ syn,         // [M, B] target syndrome bits
                    storage_t* __restrict__ out,            // [DC, M, B]
                    uint8_t* __restrict__ ok,               // [B] preset to 1, or null
                    int M, int B, bool clip, float threshold, float alpha, float beta,
                    float scale) {
    int m, b0;
    if (!locate<VEC>(M, B, &m, &b0)) return;
    const size_t MB = static_cast<size_t>(M) * B;
    const size_t e0 = static_cast<size_t>(m) * B + b0;

    Vec<storage_t, VEC> tv[DC], pv[DC], ov[DC];
    bool valid[DC];
#pragma unroll
    for (int j = 0; j < DC; ++j) {
        valid[j] = mask[j * M + m] != 0;
        // a padded slot's index is 0: a row that exists, whose values are ignored
        tv[j] = load_vec<VEC>(total + static_cast<size_t>(adj[j * M + m]) * B + b0);
        if (!FIRST) pv[j] = load_vec<VEC>(lr_prev + j * MB + e0);
    }
    const Vec<int8_t, VEC> sv = load_vec<VEC>(syn + e0);
    const bool flagged = !FIRST && fresh != nullptr;
    Vec<uint8_t, VEC> fv;
    if (flagged) fv = load_vec<VEC>(fresh + b0);

    unsigned bad = 0;  // bit f: frame b0 + f is not (yet) a codeword of the target
#pragma unroll
    for (int f = 0; f < VEC; ++f) {
        const bool is_fresh = flagged && fv.v[f] != 0;
        const bool clip_lq = clip && !is_fresh;
        float lq[DC], lr[DC];
        int parity = 0;
#pragma unroll
        for (int j = 0; j < DC; ++j) {
            float v = from_storage(tv[j].v[f], scale);
            if (valid[j] && v <= 0.0f) parity ^= 1;  // total <= 0 -> bit 1
            if (!FIRST) {
                v = v - from_storage(pv[j].v[f], scale);
                if (clip_lq) v = clipf(v, threshold);
            }
            lq[j] = v;
        }
        const int target = sv.v[f];
        const float sgn = target == 1 ? -1.0f : 1.0f;
        // the clip of the outputs is applied here, as its last operation there
        check_messages<ALG, false, DC>(lq, valid, sgn, threshold, alpha, beta, lr);
#pragma unroll
        for (int j = 0; j < DC; ++j) {
            ov[j].v[f] = to_storage(clip ? clipf(lr[j], threshold) : lr[j], scale);
        }
        if (parity != target || is_fresh) bad |= 1u << f;
    }
#pragma unroll
    for (int j = 0; j < DC; ++j) store_vec<VEC>(out + j * MB + e0, ov[j]);
    if (!FIRST && ok != nullptr && bad != 0) clear_flags<VEC>(ok, b0, bad);
}

// Slot j of check m for this thread's frames: whether it is real, Lq per frame
// (the unrolled kernel's arithmetic) and, when `parity` is given, the decision
// parity of the totals folded into it.
template <bool FIRST, int VEC>
__device__ __forceinline__ bool slot_inputs(
        const storage_t* __restrict__ total, const int* __restrict__ adj,
        const int* __restrict__ mask, const storage_t* __restrict__ lr_prev, int j,
        int m, int M, int B, int b0, size_t MB, size_t e0, const bool (&clip_lq)[VEC],
        float threshold, float scale, float (&lq)[VEC], int* parity) {
    const bool valid = mask[j * M + m] != 0;
    // a padded slot's index is 0: a row that exists, whose values are ignored
    const Vec<storage_t, VEC> tv =
        load_vec<VEC>(total + static_cast<size_t>(adj[j * M + m]) * B + b0);
    Vec<storage_t, VEC> pv;
    if (!FIRST) pv = load_vec<VEC>(lr_prev + j * MB + e0);
#pragma unroll
    for (int f = 0; f < VEC; ++f) {
        float v = from_storage(tv.v[f], scale);
        if (parity != nullptr && valid && v <= 0.0f) parity[f] ^= 1;
        if (!FIRST) {
            v = v - from_storage(pv.v[f], scale);
            if (clip_lq[f]) v = clipf(v, threshold);
        }
        lq[f] = v;
    }
    return valid;
}

// check_update_kernel for any dc: the slots in loops, nothing per slot in
// registers (see the header).  `scratch` [dc, M, B] float32 holds the prefix
// products of sum-product; min-sum does not use it.
template <int ALG, bool FIRST, int VEC>
__global__ void __launch_bounds__(kThreads)
check_update_any_kernel(const storage_t* __restrict__ total,    // [N, B]
                        const int* __restrict__ adj,            // [dc, M]
                        const int* __restrict__ mask,           // [dc, M]
                        const storage_t* __restrict__ lr_prev,  // [dc, M, B]; unused when FIRST
                        const uint8_t* __restrict__ fresh,      // [B] or null
                        const int8_t* __restrict__ syn,         // [M, B]
                        storage_t* __restrict__ out,            // [dc, M, B]
                        uint8_t* __restrict__ ok,               // [B] preset to 1, or null
                        float* __restrict__ scratch,            // [dc, M, B] (sum-product)
                        int dc, int M, int B, bool clip, float threshold, float alpha,
                        float beta, float scale) {
    int m, b0;
    if (!locate<VEC>(M, B, &m, &b0)) return;
    const size_t MB = static_cast<size_t>(M) * B;
    const size_t e0 = static_cast<size_t>(m) * B + b0;
    const Vec<int8_t, VEC> sv = load_vec<VEC>(syn + e0);
    const bool flagged = !FIRST && fresh != nullptr;
    Vec<uint8_t, VEC> fv;
    if (flagged) fv = load_vec<VEC>(fresh + b0);
    bool is_fresh[VEC], clip_lq[VEC];
    float sgn[VEC];
    int parity[VEC];
#pragma unroll
    for (int f = 0; f < VEC; ++f) {
        is_fresh[f] = flagged && fv.v[f] != 0;
        clip_lq[f] = clip && !is_fresh[f];
        sgn[f] = sv.v[f] == 1 ? -1.0f : 1.0f;
        parity[f] = 0;
    }
    // the second pass reads the inputs again; the first folds in the parity
    auto read = [&](int j, bool first_pass, float (&lq)[VEC]) {
        return slot_inputs<FIRST, VEC>(total, adj, mask, lr_prev, j, m, M, B, b0, MB, e0,
                                       clip_lq, threshold, scale, lq,
                                       first_pass ? parity : nullptr);
    };
    // the clip of the outputs is applied here, as in check_update_kernel
    auto write = [&](int j, const float (&lr)[VEC]) {
        Vec<storage_t, VEC> ov;
#pragma unroll
        for (int f = 0; f < VEC; ++f) {
            ov.v[f] = to_storage(clip ? clipf(lr[f], threshold) : lr[f], scale);
        }
        store_vec<VEC>(out + j * MB + e0, ov);
    };
    check_messages_loop<ALG, false, VEC>(dc, sgn, threshold, alpha, beta, scratch, e0, MB,
                                         read, write);
    unsigned bad = 0;
#pragma unroll
    for (int f = 0; f < VEC; ++f) {
        if (parity[f] != sv.v[f] || is_fresh[f]) bad |= 1u << f;
    }
    if (!FIRST && ok != nullptr && bad != 0) clear_flags<VEC>(ok, b0, bad);
}

// The check messages of one variable slot for this thread's frames; a padded slot
// (row index >= rows) gives exactly 0.
template <int VEC>
__device__ __forceinline__ void slot_values(const storage_t* __restrict__ lr, int s,
                                            int rows, int B, int b0, float scale,
                                            float (&val)[VEC]) {
    if (s < rows) {
        const Vec<storage_t, VEC> x = load_vec<VEC>(lr + static_cast<size_t>(s) * B + b0);
#pragma unroll
        for (int f = 0; f < VEC; ++f) val[f] = from_storage(x.v[f], scale);
    } else {
#pragma unroll
        for (int f = 0; f < VEC; ++f) val[f] = 0.0f;
    }
}

template <int VEC>
__global__ void __launch_bounds__(kThreads)
variable_update_kernel(const storage_t* __restrict__ lr,    // [rows, B] check messages
                       const int* __restrict__ slot,        // [DV, N] row of lr, or >= rows
                       const float* __restrict__ llr,       // [N, B]
                       const uint8_t* __restrict__ active,  // [B]
                       storage_t* __restrict__ total,       // [N, B]
                       int8_t* __restrict__ z,              // [N, B], active frames only
                       int* __restrict__ count,             // [B], += 1 on active frames
                       uint8_t* __restrict__ ok,            // [B], set to 1
                       int N, int B, int dv, int rows, float scale) {
    int v, b0;
    if (!locate<VEC>(N, B, &v, &b0)) return;
    const size_t e0 = static_cast<size_t>(v) * B + b0;

    float acc[VEC], val[VEC];
    slot_values<VEC>(lr, slot[v], rows, B, b0, scale, acc);
#pragma unroll 4
    for (int k = 1; k < dv; ++k) {  // slot order, as the plain version
        slot_values<VEC>(lr, slot[k * N + v], rows, B, b0, scale, val);
#pragma unroll
        for (int f = 0; f < VEC; ++f) acc[f] = acc[f] + val[f];
    }
    constexpr int FV = VEC < 4 ? VEC : 4;  // floats per 16-byte access
    Vec<storage_t, VEC> tv;
    Vec<int8_t, VEC> zv;
#pragma unroll
    for (int c = 0; c < VEC / FV; ++c) {
        const Vec<float, FV> a = load_vec<FV>(llr + e0 + c * FV);
#pragma unroll
        for (int i = 0; i < FV; ++i) {
            const int f = c * FV + i;
            const storage_t q = to_storage(a.v[i] + acc[f], scale);
            tv.v[f] = q;
            zv.v[f] = from_storage(q, scale) <= 0.0f ? 1 : 0;
        }
    }
    store_vec<VEC>(total + e0, tv);

    const Vec<uint8_t, VEC> av = load_vec<VEC>(active + b0);
    bool all = true;
#pragma unroll
    for (int f = 0; f < VEC; ++f) all = all && av.v[f] != 0;
    if (all) {
        store_vec<VEC>(z + e0, zv);
    } else {
#pragma unroll
        for (int f = 0; f < VEC; ++f) {
            if (av.v[f] != 0) z[e0 + f] = zv.v[f];
        }
    }
    if (v == 0) {  // one thread per frame vector keeps the frames' counts and flags
#pragma unroll
        for (int f = 0; f < VEC; ++f) {
            if (av.v[f] != 0) count[b0 + f] += 1;
        }
        Vec<uint8_t, VEC> ones;
#pragma unroll
        for (int f = 0; f < VEC; ++f) ones.v[f] = 1;
        store_vec<VEC>(ok + b0, ones);
    }
}

struct Args {
    const storage_t* total;
    const int* adj;
    const int* mask;
    const storage_t* lr_prev;
    const uint8_t* fresh;
    const int8_t* syn;
    storage_t* out;
    uint8_t* ok;
    float* scratch;
    int M, B;
    bool clip;
    float threshold, alpha, beta, scale;
    cudaStream_t stream;
};

unsigned blocks_for(int rows, int B, int vec) {
    const size_t work = static_cast<size_t>(rows) * (B / vec);
    return static_cast<unsigned>((work + kThreads - 1) / kThreads);
}

template <int ALG, bool FIRST, int DC, int VEC>
void launch(const Args& p) {
    check_update_kernel<ALG, FIRST, DC, VEC>
        <<<blocks_for(p.M, p.B, VEC), kThreads, 0, p.stream>>>(
            p.total, p.adj, p.mask, p.lr_prev, p.fresh, p.syn, p.out, p.ok, p.M, p.B,
            p.clip, p.threshold, p.alpha, p.beta, p.scale);
}

template <int ALG, bool FIRST, int VEC>
void launch_any(int dc, const Args& p) {
    check_update_any_kernel<ALG, FIRST, VEC>
        <<<blocks_for(p.M, p.B, VEC), kThreads, 0, p.stream>>>(
            p.total, p.adj, p.mask, p.lr_prev, p.fresh, p.syn, p.out, p.ok, p.scratch,
            dc, p.M, p.B, p.clip, p.threshold, p.alpha, p.beta, p.scale);
}

template <int ALG, bool FIRST, int VEC>
void launch_dc(int dc, const Args& p) {
    switch (dc) {
        case 2: launch<ALG, FIRST, 2, VEC>(p); return;
        case 3: launch<ALG, FIRST, 3, VEC>(p); return;
        case 4: launch<ALG, FIRST, 4, VEC>(p); return;
        case 5: launch<ALG, FIRST, 5, VEC>(p); return;
        case 6: launch<ALG, FIRST, 6, VEC>(p); return;
        case 7: launch<ALG, FIRST, 7, VEC>(p); return;
        case 8: launch<ALG, FIRST, 8, VEC>(p); return;
        default: launch_any<ALG, FIRST, VEC>(dc, p); return;
    }
}

template <int ALG, int VEC>
void launch_first(bool first, int dc, const Args& p) {
    if (first) launch_dc<ALG, true, VEC>(dc, p);
    else launch_dc<ALG, false, VEC>(dc, p);
}

template <int VEC>
void launch_algorithm(int algorithm, bool first, int dc, const Args& p) {
    if (algorithm == kMinSum) launch_first<kMinSum, VEC>(first, dc, p);
    else launch_first<kSumProduct, VEC>(first, dc, p);
}

constexpr int kMaxUnrolledDegree = 8;

}  // namespace

// Frames per thread of the vector instances: the caller passes `vec` = this value
// when B is a multiple of it and every pointer is 16-byte aligned, else 1.
extern "C" int check_update_vector_width() { return kCheckVec; }
extern "C" int variable_update_vector_width() { return kVariableVec; }

// The largest dc_max whose instance is unrolled; above it (and below 2) the loop
// instance runs, whose sum-product needs the scratch.
extern "C" int check_update_max_unrolled_degree() { return kMaxUnrolledDegree; }

// Returns cudaGetLastError(); -1 when dc < 1, -2 when `vec` is neither of the two,
// -3 when the loop instance of sum-product is given no scratch.  `lr_prev` is
// null exactly when `first`; `fresh` ([B] bytes, nonzero = the frame restarts) and
// `ok` ([B] bytes, preset to 1 by the caller) may be null; `scratch` is float32
// [dc, M, B] and may be null where it is not used.
extern "C" int check_update(int algorithm, int first, int clip, int dc, int vec,
                            const void* total, const void* adj, const void* mask,
                            const void* lr_prev, const void* fresh, const void* syn,
                            void* out, void* ok, void* scratch, int M, int B,
                            float threshold, float alpha, float beta, float scale,
                            void* stream) {
    const Args p{static_cast<const storage_t*>(total),
                 static_cast<const int*>(adj),
                 static_cast<const int*>(mask),
                 static_cast<const storage_t*>(lr_prev),
                 static_cast<const uint8_t*>(fresh),
                 static_cast<const int8_t*>(syn),
                 static_cast<storage_t*>(out),
                 static_cast<uint8_t*>(ok),
                 static_cast<float*>(scratch),
                 M, B, clip != 0, threshold, alpha, beta, scale,
                 static_cast<cudaStream_t>(stream)};
    if (dc < 1) return -1;
    const bool unrolled = dc >= 2 && dc <= kMaxUnrolledDegree;
    if (!unrolled && algorithm != kMinSum && scratch == nullptr) return -3;
    if (vec == kCheckVec && B % kCheckVec == 0) {
        launch_algorithm<kCheckVec>(algorithm, first != 0, dc, p);
    } else if (vec == 1) {
        launch_algorithm<1>(algorithm, first != 0, dc, p);
    } else {
        return -2;
    }
    return static_cast<int>(cudaGetLastError());
}

// Returns cudaGetLastError(), or -2 for a `vec` that is neither 1 nor the vector
// width.  `rows` = DC * M: a slot index >= rows marks a padded slot.
extern "C" int variable_update(int vec, const void* lr, const void* slot,
                               const void* llr, const void* active, void* total,
                               void* z, void* count, void* ok, int N, int B, int dv,
                               int rows, float scale, void* stream) {
    const auto s = static_cast<cudaStream_t>(stream);
    const auto* lr_p = static_cast<const storage_t*>(lr);
    const auto* slot_p = static_cast<const int*>(slot);
    const auto* llr_p = static_cast<const float*>(llr);
    const auto* act_p = static_cast<const uint8_t*>(active);
    auto* total_p = static_cast<storage_t*>(total);
    auto* z_p = static_cast<int8_t*>(z);
    auto* count_p = static_cast<int*>(count);
    auto* ok_p = static_cast<uint8_t*>(ok);
    if (vec == kVariableVec && B % kVariableVec == 0) {
        variable_update_kernel<kVariableVec>
            <<<blocks_for(N, B, kVariableVec), kThreads, 0, s>>>(
                lr_p, slot_p, llr_p, act_p, total_p, z_p, count_p, ok_p, N, B, dv, rows, scale);
    } else if (vec == 1) {
        variable_update_kernel<1><<<blocks_for(N, B, 1), kThreads, 0, s>>>(
            lr_p, slot_p, llr_p, act_p, total_p, z_p, count_p, ok_p, N, B, dv, rows, scale);
    } else {
        return -2;
    }
    return static_cast<int>(cudaGetLastError());
}
