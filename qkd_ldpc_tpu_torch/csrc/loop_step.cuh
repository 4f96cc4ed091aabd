// The bookkeeping of a decode loop: JAX's while_loop carry and condition
// (qkd_ldpc_tpu/decoder/bp.py:434-452, layered.py:213-225), run by one block
// over the B frames.
//   ENTRY    active = ~done & ~frozen; go = it < limit && live > floor, live
//            the count of active frames (JAX's `cond` before the first pass:
//            floor 0 is its any(active));
//   FLOODING the carry after a pass: done |= active & ok, it += 1 (the
//            variable update already moved z and the frames' counts), then
//            the ENTRY test;
//   LAYERED  the same, and iters = it where a frame newly converged.
// It writes `go` to a byte (the eager loop fetches it) and, inside a graph,
// sets the WHILE node's condition with cudaGraphSetConditional.  A floor above 0
// is residency compaction's ladder (decoder/device_loop.py::run_schedule): a
// rung's loop runs only while its live frames would not fit the next narrower
// rung.  The count costs what any() cost: one __syncthreads_count a tile of
// blockDim frames where __syncthreads_or was one barrier, the same for B up to
// blockDim.  `lane_passes`, where given, gains B a pass (the ladder's counter
// of lane-passes after phase A).
//
// ENTRY runs as a kernel of its own before the loop (device_loop.cu).  After a
// pass the bookkeeping needs every frame's flag of the pass, which the pass's
// last kernel writes from all of its blocks: so it runs in that kernel's last
// block (elected_tail), the check update of a flooding pass (check_update.cu) and
// the sweep of a layered one (layered_sweep.cu), and costs no launch of its
// own.  Every other block counts itself on a ticket once its flags are
// visible to the card; the launch's last block by index waits until all have
// counted, runs the bookkeeping and sets the ticket back to 0 for the next
// launch.  No block waits for its count, and the last block has the
// bookkeeping's other inputs in its L1 cache by then (elected_tail): measured
// on an H100, the fold adds about 2 us to the flagship check update, where a
// ticket whose answer each block waited for added 3 us.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

constexpr int kLoopEntry = 0;
constexpr int kLoopFlooding = 1;
constexpr int kLoopLayered = 2;

// What the bookkeeping reads and writes besides the pass's flags `ok`.  The
// layout is decoder/device_loop.py's _LoopStepArgs (ctypes); a kernel that
// ends a pass takes it by value.
struct LoopStep {
    uint8_t* done;             // [B]
    uint8_t* active;           // [B] the pass's, then the next's
    const uint8_t* frozen;     // [B] or null
    int* it;                   // [1] passes so far
    int* iters;                // [B] (LAYERED)
    long long* passes;         // [1] or null: the WHILE body's count
    uint8_t* go;               // [1] or null
    int* ticket;               // [1] blocks that finished this launch; 0 between launches
    unsigned long long* lane_passes;  // [1] or null: gains B a pass
    unsigned long long handle;  // the WHILE node's condition (when set_handle)
    int limit;
    int B;
    int set_handle;
    int floor;                 // go needs more than `floor` active frames
};

// The bookkeeping by the calling block (every thread calls it).  `ok` (not
// read by ENTRY) was written by other blocks of the same launch: it is read
// from the L2 cache, past the SM's L1.  Written for few registers, as it
// shares a kernel with a pass's update (a frame at a time, `it` read where it
// is used).
template <int MODE>
__device__ __forceinline__ void loop_step_block(const uint8_t* ok, const LoopStep& s) {
    int live = 0;
#pragma unroll 1
    for (int base = 0; base < s.B; base += blockDim.x) {  // every thread runs every tile
        const int b = base + threadIdx.x;
        bool a = false;
        if (b < s.B) {
            // a frame's flags are loaded at once: one round trip
            const bool was = s.done[b] != 0;
            const bool act = s.active[b] != 0;
            const bool conv = MODE != kLoopEntry && __ldcg(ok + b) != 0;
            const bool frz = s.frozen != nullptr && s.frozen[b] != 0;
            const bool d = was || (act && conv);
            if (d && !was) {
                s.done[b] = 1;
                if (MODE == kLoopLayered) s.iters[b] = *s.it + 1;
            }
            a = !d && !frz;
            s.active[b] = a ? 1 : 0;
        }
        live += __syncthreads_count(a);  // the last: every thread has read *it
    }
    if (threadIdx.x == 0) {
        const int it_new = *s.it + (MODE == kLoopEntry ? 0 : 1);
        const bool go = live > s.floor && it_new < s.limit;
        if (MODE != kLoopEntry) {
            *s.it = it_new;
            if (s.passes != nullptr) *s.passes += 1;
            if (s.lane_passes != nullptr) {
                atomicAdd(s.lane_passes, static_cast<unsigned long long>(s.B));
            }
        }
        if (s.go != nullptr) *s.go = go ? 1 : 0;
        if (s.set_handle) cudaGraphSetConditional(s.handle, go ? 1u : 0u);
    }
}

// Every block but the launch's last by index counts itself on the ticket
// once the flags it stored are visible to the card: thread 0 fences first
// where a thread of the block stored one (`stored`, after the barrier that
// ordered the block's stores; the fence waits for them), and the count wants
// no answer, so no block waits for it.  Returns whether this block is the
// launch's last, which runs the bookkeeping (elected_tail).  Grids are 1-D.
__device__ __forceinline__ bool count_unless_elected(int* ticket, bool stored) {
    const bool elected = blockIdx.x == gridDim.x - 1;
    if (!elected && threadIdx.x == 0) {
        if (stored) __threadfence();
        atomicAdd(ticket, 1);
    }
    return elected;
}

// The launch's last block: it brings the bookkeeping's inputs that no block
// of the launch writes into its L1 cache, waits until every other block has
// counted, runs the bookkeeping and sets the ticket back to 0.
template <int MODE>
__device__ __forceinline__ void elected_tail(const uint8_t* ok, const LoopStep& s) {
    // a warp an array: done, active, frozen (a line a lane); then it and passes
    const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
    if (lane < (s.B + 127) / 128) {
        if (warp == 0) {
            asm volatile("prefetch.global.L1 [%0];" ::"l"(s.done + 128 * lane));
        } else if (warp == 1) {
            asm volatile("prefetch.global.L1 [%0];" ::"l"(s.active + 128 * lane));
        } else if (warp == 2 && s.frozen != nullptr) {
            asm volatile("prefetch.global.L1 [%0];" ::"l"(s.frozen + 128 * lane));
        }
    }
    if (warp == 3 && lane == 0) asm volatile("prefetch.global.L1 [%0];" ::"l"(s.it));
    if (warp == 3 && lane == 1 && s.passes != nullptr) {
        asm volatile("prefetch.global.L1 [%0];" ::"l"(s.passes));
    }
    if (t == 0) {
        const volatile int* count = s.ticket;
        while (*count < static_cast<int>(gridDim.x) - 1) {
        }
        __threadfence();  // the other blocks' flags before this block reads them
    }
    __syncthreads();
    loop_step_block<MODE>(ok, s);
    if (t == 0) *s.ticket = 0;
}
