// Check-node update of the flooding BP decoder, with the bit-node update fused in.
//
// Replaces three TPU kernels of qkd_ldpc_tpu/decoder/pallas_kernels.py:
//   check_update_pallas (_check_kernel)  -> FIRST = true : the inputs are the
//       gathered, never clipped a-priori LLRs of iteration 1;
//   fused_update_pallas (_fused_kernel)  -> FIRST = false: the inputs are
//       Lq = clip(tot_chk - Lr_prev), recomputed in registers, so the
//       bit-to-check messages never exist in device memory;
//   fused_update_fresh_pallas (_fused_kernel_fresh) -> FIRST = false with a
//       per-frame `fresh` flag: a fresh frame's Lq skips the clip, so its
//       (tot, Lr = 0) state replays iteration 1 exactly (the continuation runner
//       restarts lanes in the middle of a batch).  The flag is a runtime pointer,
//       null for the plain fused update: one predicated byte load per thread and
//       no further template instances.
// All then run the same check update (check_math.cuh) and store in the message
// storage type.  Messages are dc-first, [DC, M, B] with the frame axis B fastest.
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
#include "check_math.cuh"

namespace {

template <int ALG, bool FIRST, bool CLIP, int DC>
__global__ void __launch_bounds__(256)
check_update_kernel(const storage_t* __restrict__ a,        // Lq (FIRST) or tot_chk
                    const storage_t* __restrict__ lr_prev,  // unused when FIRST
                    const uint8_t* __restrict__ fresh,      // [B] or null
                    const int* __restrict__ mask,           // [DC, M]
                    const float* __restrict__ syn_sign,     // [M, B]
                    storage_t* __restrict__ out, int M, int B, float threshold,
                    float alpha, float beta, float scale) {
    const size_t MB = static_cast<size_t>(M) * B;
    const size_t idx = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
    if (idx >= MB) return;
    const int m = static_cast<int>(idx / B);
    const float syn = syn_sign[idx];
    bool clip_lq = CLIP;
    if (!FIRST && CLIP && fresh != nullptr) {
        clip_lq = fresh[idx - static_cast<size_t>(m) * B] == 0;
    }

    float lq[DC], lr[DC];
    bool valid[DC];
#pragma unroll
    for (int j = 0; j < DC; ++j) {
        const size_t e = j * MB + idx;
        float v = from_storage(a[e], scale);
        if (!FIRST) {
            v = v - from_storage(lr_prev[e], scale);
            if (clip_lq) v = clipf(v, threshold);
        }
        lq[j] = v;
        valid[j] = mask[j * M + m] != 0;
    }
    check_messages<ALG, CLIP, DC>(lq, valid, syn, threshold, alpha, beta, lr);
#pragma unroll
    for (int j = 0; j < DC; ++j) out[j * MB + idx] = to_storage(lr[j], scale);
}

struct Args {
    const storage_t* a;
    const storage_t* lr_prev;
    const uint8_t* fresh;
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
        p.a, p.lr_prev, p.fresh, p.mask, p.syn_sign, p.out, p.M, p.B, p.threshold,
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

// Returns cudaGetLastError(), or -1 when dc has no compiled instance.  `fresh`
// ([B] bytes, nonzero = the frame restarts) may be null.
extern "C" int check_update(int algorithm, int first, int clip, int dc,
                            const void* a, const void* lr_prev, const void* fresh,
                            const void* mask, const void* syn_sign, void* out,
                            int M, int B, float threshold, float alpha, float beta,
                            float scale, void* stream) {
    const Args p{static_cast<const storage_t*>(a),
                 static_cast<const storage_t*>(lr_prev),
                 static_cast<const uint8_t*>(fresh),
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
