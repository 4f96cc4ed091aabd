// The decode loops' control flow on the card: the carry of a loop pass, the
// loop's condition, and the WHILE nodes of a CUDA graph that test it.
//
// The JAX package compiles a whole decode into one device program:
// lax.while_loop (qkd_ldpc_tpu/decoder/bp.py:454, layered.py:225) around the
// iteration, lax.cond (bp.py:546) around the compaction's fallback phase.  Here
// the decode is captured into one CUDA graph, and each while_loop becomes a
// conditional WHILE node (CUDA 12.4+) whose body holds the iteration's kernels,
// the last of which also runs the pass's bookkeeping (loop_step.cuh).  A cond whose branches are "run the loop" and "do
// nothing" is the same node, its entry test being the cond's predicate.
//
// loop_entry_kernel is the test before a loop (loop_step.cuh's ENTRY), one
// block over the B frames.  The test after each pass runs in the last block of
// the pass's last kernel (check_update.cu, layered_sweep.cu), which sets the
// WHILE node's condition there: a pass launches no bookkeeping kernel.
// Bound: launch latency; it moves a few bytes a frame.
//
// while_handle / while_begin (or if_begin) / while_end insert a WHILE (or IF)
// node into the graph that a stream is capturing, as PyTorch's own IF-node
// capture does (CUDAGraph::begin_capture_to_if_node): the node depends on what
// the stream has captured so far, later work on the stream depends on the node,
// and the body is captured from a second stream into the node's child graph.
// The capturing stream may itself be capturing a body, so nodes nest (the
// continuation's outer loop holds its refill loop, which holds two IF nodes:
// sim/continuation.py); a handle made on the top-level graph serves a node at
// any depth below it.
//
// compact_partition, compact_gather and compact_scatter (the end of this file)
// are residency compaction's lane moves: the lanes left unconverged, moved into
// a narrower rung of lanes and back, under an IF node that a batch with no such
// lane skips.
#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

#include "loop_step.cuh"

namespace {

constexpr int kThreads = 1024;

__global__ void __launch_bounds__(kThreads) loop_entry_kernel(const LoopStep step) {
    loop_step_block<kLoopEntry>(nullptr, step);
}

cudaError_t capture_info(cudaStream_t s, cudaGraph_t* graph, const cudaGraphNode_t** deps,
                         size_t* n) {
    cudaStreamCaptureStatus status;
#if CUDART_VERSION >= 13000
    cudaError_t e = cudaStreamGetCaptureInfo(s, &status, nullptr, graph, deps, nullptr, n);
#else
    cudaError_t e = cudaStreamGetCaptureInfo(s, &status, nullptr, graph, deps, n);
#endif
    if (e == cudaSuccess && status != cudaStreamCaptureStatusActive) {
        return cudaErrorStreamCaptureImplicit;
    }
    return e;
}

}  // namespace

// The test before a loop.  Returns cudaGetLastError().  `frozen` and `go` may
// be null; `handle` is set only when `set_handle` (inside a graph).  `floor`:
// the loop runs only while more than `floor` frames are active (0: any).
extern "C" int loop_entry(void* done, void* active, const void* frozen, void* it, void* go,
                          int limit, int B, int floor, unsigned long long handle,
                          int set_handle, void* stream) {
    const LoopStep step{static_cast<uint8_t*>(done), static_cast<uint8_t*>(active),
                        static_cast<const uint8_t*>(frozen), static_cast<int*>(it),
                        nullptr, nullptr, static_cast<uint8_t*>(go), nullptr, nullptr,
                        handle, limit, B, set_handle, floor};
    const int threads = B < kThreads ? ((B + 31) / 32) * 32 : kThreads;
    loop_entry_kernel<<<1, threads, 0, static_cast<cudaStream_t>(stream)>>>(step);
    return static_cast<int>(cudaGetLastError());
}

// A new condition handle of the graph that `stream` is capturing (its value is
// set by the entry kernel before the node).  Returns a cudaError_t.
extern "C" int while_handle(void* stream, unsigned long long* handle) {
    cudaGraph_t graph;
    const cudaGraphNode_t* deps;
    size_t n;
    cudaError_t e = capture_info(static_cast<cudaStream_t>(stream), &graph, &deps, &n);
    if (e != cudaSuccess) return static_cast<int>(e);
    cudaGraphConditionalHandle h;
    e = cudaGraphConditionalHandleCreate(&h, graph, 0, 0);
    if (e == cudaSuccess) *handle = h;
    return static_cast<int>(e);
}

namespace {

// Adds a conditional node of `type` on `handle` after everything `stream` has
// captured (the stream may itself be capturing a conditional body: nodes nest),
// makes the stream's later work depend on it, and starts capturing
// `body_stream` into the node's body.  Returns a cudaError_t.
cudaError_t cond_begin(void* stream, void* body_stream, unsigned long long handle,
                       cudaGraphConditionalNodeType type) {
    const auto s = static_cast<cudaStream_t>(stream);
    cudaGraph_t graph;
    const cudaGraphNode_t* deps;
    size_t n;
    cudaError_t e = capture_info(s, &graph, &deps, &n);
    if (e != cudaSuccess) return e;
    cudaGraphNodeParams params = {};
    params.type = cudaGraphNodeTypeConditional;
    params.conditional.handle = handle;
    params.conditional.type = type;
    params.conditional.size = 1;
    cudaGraphNode_t node;
#if CUDART_VERSION >= 13000
    e = cudaGraphAddNode(&node, graph, deps, nullptr, n, &params);
#else
    e = cudaGraphAddNode(&node, graph, deps, n, &params);
#endif
    if (e != cudaSuccess) return e;
    const cudaGraph_t body = params.conditional.phGraph_out[0];
#if CUDART_VERSION >= 13000
    e = cudaStreamUpdateCaptureDependencies(s, &node, nullptr, 1,
                                            cudaStreamSetCaptureDependencies);
#else
    e = cudaStreamUpdateCaptureDependencies(s, &node, 1, cudaStreamSetCaptureDependencies);
#endif
    if (e != cudaSuccess) return e;
    return cudaStreamBeginCaptureToGraph(static_cast<cudaStream_t>(body_stream), body, nullptr,
                                         nullptr, 0, cudaStreamCaptureModeRelaxed);
}

}  // namespace

// A WHILE node (the body runs while the handle reads non-zero after it, and not
// at all if it reads zero before the node).  Returns a cudaError_t.
extern "C" int while_begin(void* stream, void* body_stream, unsigned long long handle) {
    return static_cast<int>(cond_begin(stream, body_stream, handle, cudaGraphCondTypeWhile));
}

// An IF node (the body runs once if the handle reads non-zero at the node).
// Returns a cudaError_t.
extern "C" int if_begin(void* stream, void* body_stream, unsigned long long handle) {
    return static_cast<int>(cond_begin(stream, body_stream, handle, cudaGraphCondTypeIf));
}

// Ends the capture of a conditional node's body.  Returns a cudaError_t.
extern "C" int while_end(void* body_stream) {
    cudaGraph_t body;
    return static_cast<int>(cudaStreamEndCapture(static_cast<cudaStream_t>(body_stream), &body));
}

// The number of top-level nodes (kernels, copies, memsets, WHILE nodes) of the
// graph that `stream` is capturing, so far.  Returns a cudaError_t.
extern "C" int capture_nodes(void* stream, unsigned long long* count) {
    cudaGraph_t graph;
    const cudaGraphNode_t* deps;
    size_t n;
    cudaError_t e = capture_info(static_cast<cudaStream_t>(stream), &graph, &deps, &n);
    if (e != cudaSuccess) return static_cast<int>(e);
    size_t nodes = 0;
    e = cudaGraphGetNodes(graph, nullptr, &nodes);
    *count = nodes;
    return static_cast<int>(e);
}

// ---------------------------------------------------------------------------
// Residency compaction's lane moves (decoder/device_loop.py::run_schedule).  The
// JAX package sorts the flags, takes the first B2 lanes of every state array
// and sets them back (qkd_ldpc_tpu/decoder/bp.py:516-532: argsort, _take_lanes,
// .at[idx].set), then runs the lanes past B2 on the full batch (phase C).  Here
// the batch's lanes descend a ladder of widths that halve from the batch down
// to B2: each rung's loop runs while its live lanes would not fit the next
// rung (the loop tail's floor, loop_step.cuh), then a partition moves the live
// lanes into the narrowest rung that holds them.  Each rung's lanes come from
// the batch and go back to it, so every partition reads the batch's flags.
//
//   compact_partition  one block: the flags' stable order (unconverged lanes
//                      first, each group in lane order) by a ballot and a
//                      prefix count, its first W lanes as idx (W the rung's
//                      width), k = min(#unconverged, W), the rung's flags,
//                      counts and loop state (what index_select and
//                      LoopState's fills left), the counts, and the condition
//                      of the IF node around the rung: k lanes left, all of
//                      them fit (n <= W) and not the next narrower rung (n >
//                      below), and passes left (it < limit).  The partition
//                      after phase A (`first`) also sets the condition of the
//                      IF node around the ladder: more lanes left than B2.  A
//                      batch with no lane left after phase A runs this kernel
//                      alone, and one whose lanes fit B2 runs phase B as before.
//   compact_gather     inside the rung's IF node: lane idx[s] -> slot s, for
//                      s < k, of every state tensor the rung reads.
//   compact_scatter    inside the IF node, after the rung's loop: slot s ->
//                      lane idx[s], for s < k, of the state the next rung or
//                      the decode reads, and the flags and counts.
//
// Slots k .. W are neither written nor read back: their lanes were done, and
// a done lane is inert in every pass (its flag never changes, its decisions
// and counts never move), so copying it changed nothing.
//
// Bound: the bytes of the k moved lanes; the partition moves a few bytes a
// lane and is bound by its launch.  A tensor is [rows, lanes, run]: the
// flooding state is batch-last (a run of one element, so the k lanes of a row
// are read scattered and their k slots written adjacent), the layered state
// [rows, B, z] (a run of z elements, copied in 16-byte units where the run and
// the base addresses allow it).  Units are numbered by row, then slot, then
// place in the run, and consecutive threads take consecutive units, so a
// warp's accesses to the part's arrays are contiguous.  The grid comes from
// the shapes and the card alone (a replay repeats it); blocks past the k
// lanes' units return at once.

namespace {

// The compaction counter's fields (decoder/device_loop.py COMPACTION_COUNTS).
enum Count {
    kBatches, kEngaged, kLanes, kOverflows,  // at the partition after phase A
    kLadderBatches, kRungs, kRungLanes,      // the ladder's
    kLanePasses,                             // the loop tails'
    kLastRungLanes,                          // of kRungLanes, the narrowest rung's
};

// decoder/device_loop.py's _PartitionArgs, field for field.
struct Partition {
    const uint8_t* done;         // [B] the batch's flags
    const int* iters;            // [B]
    const int* it;               // [1] passes so far
    int* idx;                    // [W] the stable order's first W lanes
    int* k;                      // [1] lanes moved
    uint8_t* go;                 // [1] the rung's IF condition (the eager program reads it)
    uint8_t* part_done;          // [W] the rung's loop state
    int* part_iters;             // [W]
    uint8_t* part_ok;            // [W]
    uint8_t* part_active;        // [W]
    int* part_ticket;            // [1]
    uint8_t* over;               // [1] or null: (first) the ladder's IF condition
    unsigned long long* counts;  // [9] or null: Count
    long long* passes;           // [1] or null: the enclosing body's count
    unsigned long long handle;   // the rung's IF node (when set_handle)
    unsigned long long over_handle;  // the ladder's IF node (first, when set_handle)
    int B;
    int W;                       // the rung's lanes
    int below;                   // the next narrower rung's lanes, 0 for the narrowest
    int limit;                   // the decode's cap
    int first;                   // the partition after phase A
    int set_handle;
};

__global__ void __launch_bounds__(kThreads) compact_partition_kernel(const Partition p) {
    __shared__ int warp_u[kThreads / 32];
    const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
    const int warps = static_cast<int>(blockDim.x) >> 5;
    int n_u = 0;  // unconverged lanes in all
    for (int base = 0; base < p.B; base += blockDim.x) {
        const int b = base + t;
        n_u += __syncthreads_count(b < p.B && p.done[b] == 0);
    }
    int before = 0;  // unconverged lanes of the earlier tiles
    for (int base = 0; base < p.B; base += blockDim.x) {
        const int b = base + t;
        const bool u = b < p.B && p.done[b] == 0;
        const unsigned ballot = __ballot_sync(0xffffffffu, u);
        if (lane == 0) warp_u[warp] = __popc(ballot);
        __syncthreads();
        int rank = before + __popc(ballot & ((1u << lane) - 1u));  // unconverged before b
        int tile = 0;
        for (int w = 0; w < warps; ++w) {
            const int c = warp_u[w];
            if (w < warp) rank += c;
            tile += c;
        }
        if (b < p.B) {
            // b's place in the stable order: the unconverged lanes, then the done
            const int pos = u ? rank : n_u + (b - rank);
            if (pos < p.W) {
                p.idx[pos] = b;
                p.part_done[pos] = u ? 0 : 1;
                p.part_iters[pos] = p.iters[b];
            }
        }
        before += tile;
        __syncthreads();  // the next tile rewrites warp_u
    }
    for (int s = t; s < p.W; s += blockDim.x) {
        p.part_ok[s] = 1;
        p.part_active[s] = 0;
    }
    if (t == 0) {
        const int k = min(n_u, p.W);
        const bool engage = n_u > 0 && n_u <= p.W && n_u > p.below && *p.it < p.limit;
        const bool over = p.first && n_u > p.W;
        *p.k = k;
        *p.go = engage ? 1 : 0;
        *p.part_ticket = 0;
        if (p.over != nullptr) *p.over = over ? 1 : 0;
        if (p.passes != nullptr) *p.passes += 1;
        unsigned long long* c = p.counts;
        if (c != nullptr && p.first) {
            atomicAdd(c + kBatches, 1ull);
            if (k > 0) atomicAdd(c + kEngaged, 1ull);
            atomicAdd(c + kLanes, static_cast<unsigned long long>(k));
            if (over) {
                atomicAdd(c + kOverflows, 1ull);
                atomicAdd(c + kLadderBatches, 1ull);
            }
        } else if (c != nullptr && engage) {
            atomicAdd(c + kRungs, 1ull);
            atomicAdd(c + kRungLanes, static_cast<unsigned long long>(k));
            if (p.below == 0) atomicAdd(c + kLastRungLanes, static_cast<unsigned long long>(k));
        }
        if (p.set_handle) {
            cudaGraphSetConditional(p.handle, engage ? 1u : 0u);
            if (p.first) cudaGraphSetConditional(p.over_handle, over ? 1u : 0u);
        }
    }
}

constexpr int kMaxCopies = 6;        // tensors one launch copies
constexpr int kCopyThreads = 256;
constexpr int kCopyBlocksPerSm = 8;
constexpr int kSharedLanes = 2048;   // idx staged in shared memory up to this k

// One tensor's lanes: `rows` x lanes x `units` units of `unit` bytes; src and
// dst are the full batch's tensor and the part's (gather), or the reverse.
struct CopyRun {
    const void* src;
    void* dst;
    int rows;
    int units;
    int unit;  // 16, 8, 4, 2 or 1
};

// decoder/device_loop.py's _CopyPlanArgs, field for field.  B2: the rung's lanes.
struct CopyPlan {
    CopyRun run[kMaxCopies];
    const int* idx;     // [B2]
    const int* k;       // [1]
    long long* passes;  // [1] or null: the IF body's count (the gather adds one)
    int n;              // tensors
    int B;              // lanes of the full batch
    int B2;             // lanes of the part
};

template <typename W, bool SCATTER>
__device__ __forceinline__ void copy_units(const CopyRun& r, const int* lanes, int k, int B,
                                           int B2, int first, int stride) {
    const W* __restrict__ src = static_cast<const W*>(r.src);
    W* __restrict__ dst = static_cast<W*>(r.dst);
    const int units = r.units, per_row = k * units, total = r.rows * per_row;
    for (int g = first; g < total; g += stride) {
        const int row = g / per_row;
        const int in_row = g - row * per_row;
        const int s = in_row / units;
        const int j = in_row - s * units;
        const int full = (row * B + lanes[s]) * units + j;
        const int part = (row * B2 + s) * units + j;
        if (SCATTER) {
            dst[full] = src[part];
        } else {
            dst[part] = src[full];
        }
    }
}

template <bool SCATTER>
__device__ __forceinline__ void copy_lanes(const CopyPlan& plan) {
    __shared__ int lane_s[kSharedLanes];
    if (plan.passes != nullptr && blockIdx.x == 0 && threadIdx.x == 0) *plan.passes += 1;
    const int k = *plan.k;
    int most = 0;  // units of the largest tensor's k lanes
    for (int e = 0; e < plan.n; ++e) most = max(most, plan.run[e].rows * plan.run[e].units);
    if (static_cast<long long>(blockIdx.x) * blockDim.x >= static_cast<long long>(most) * k) {
        return;  // the whole block lies past the k lanes' units
    }
    const int* lanes = plan.idx;
    if (k <= kSharedLanes) {
        for (int i = threadIdx.x; i < k; i += blockDim.x) lane_s[i] = plan.idx[i];
        __syncthreads();
        lanes = lane_s;
    }
    const int first = blockIdx.x * blockDim.x + threadIdx.x;
    const int stride = gridDim.x * blockDim.x;
    for (int e = 0; e < plan.n; ++e) {
        const CopyRun& r = plan.run[e];
        switch (r.unit) {
            case 16: copy_units<uint4, SCATTER>(r, lanes, k, plan.B, plan.B2, first, stride); break;
            case 8: copy_units<uint2, SCATTER>(r, lanes, k, plan.B, plan.B2, first, stride); break;
            case 4: copy_units<uint32_t, SCATTER>(r, lanes, k, plan.B, plan.B2, first, stride); break;
            case 2: copy_units<uint16_t, SCATTER>(r, lanes, k, plan.B, plan.B2, first, stride); break;
            default: copy_units<uint8_t, SCATTER>(r, lanes, k, plan.B, plan.B2, first, stride);
        }
    }
}

// The plan stays in the launch's parameter space (__grid_constant__): its
// tensors are indexed at run time.
__global__ void __launch_bounds__(kCopyThreads)
compact_gather_kernel(const __grid_constant__ CopyPlan plan) {
    copy_lanes<false>(plan);
}

__global__ void __launch_bounds__(kCopyThreads)
compact_scatter_kernel(const __grid_constant__ CopyPlan plan) {
    copy_lanes<true>(plan);
}

}  // namespace

// A partition (`args` a Partition).  Returns cudaGetLastError().
extern "C" int compact_partition(const void* args, void* stream) {
    const Partition& p = *static_cast<const Partition*>(args);
    const int threads = p.B < kThreads ? ((p.B + 31) / 32) * 32 : kThreads;
    compact_partition_kernel<<<1, threads, 0, static_cast<cudaStream_t>(stream)>>>(p);
    return static_cast<int>(cudaGetLastError());
}

// A rung's gather (scatter = 0) or scatter (scatter = 1) of the tensors of
// `plan` (a CopyPlan).  Returns cudaGetLastError(), or cudaErrorInvalidValue
// for a plan of no tensor or more than kMaxCopies.
extern "C" int compact_copy(const void* plan, int scatter, void* stream) {
    const CopyPlan& c = *static_cast<const CopyPlan*>(plan);
    if (c.n < 1 || c.n > kMaxCopies) return static_cast<int>(cudaErrorInvalidValue);
    long long most = 0;  // units of the largest tensor at k = B2
    for (int e = 0; e < c.n; ++e) {
        most = std::max(most, static_cast<long long>(c.run[e].rows) * c.run[e].units * c.B2);
    }
    int device = 0, sms = 0;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    const long long want = std::max(1LL, (most + kCopyThreads - 1) / kCopyThreads);
    const unsigned grid =
        static_cast<unsigned>(std::min(want, static_cast<long long>(sms) * kCopyBlocksPerSm));
    const auto s = static_cast<cudaStream_t>(stream);
    if (scatter) {
        compact_scatter_kernel<<<grid, kCopyThreads, 0, s>>>(c);
    } else {
        compact_gather_kernel<<<grid, kCopyThreads, 0, s>>>(c);
    }
    return static_cast<int>(cudaGetLastError());
}
