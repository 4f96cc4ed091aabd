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
// be null; `handle` is set only when `set_handle` (inside a graph).
extern "C" int loop_entry(void* done, void* active, const void* frozen, void* it, void* go,
                          int limit, int B, unsigned long long handle, int set_handle,
                          void* stream) {
    const LoopStep step{static_cast<uint8_t*>(done), static_cast<uint8_t*>(active),
                        static_cast<const uint8_t*>(frozen), static_cast<int*>(it),
                        nullptr, nullptr, static_cast<uint8_t*>(go), nullptr, handle,
                        limit, B, set_handle};
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
