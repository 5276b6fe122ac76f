// Batched segment-vs-obstacle visibility (DESIGN.md §5 predicate) for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/segvis.py:_segvis_kernel (called
// by segvis.py:segvis).  out[i] = true where segment p[i]->q[i] is blocked
// by none of the E edges (ea[e], eb[e]; ec[e] is the CCW next vertex for the
// through-vertex rule), written straight into a torch.bool tensor.  Twin:
// repro_torch/kernels/ref.py segvis_ref, which it must equal bit for bit.
//
// Bound on the H100: operations, and only those the inputs need.  A
// (segment, edge) pair costs 34 float32 operations once the terms of the
// segment alone and of the edge alone are hoisted (blocked_pairs.cuh),
// against 24 bytes of input per segment and per edge, so at the main path's
// shapes (N = 256 * W segments, E = 128) the work is far above the memory
// line.  Every operation is a separate __fmul_rn/__fsub_rn/__fadd_rn for bit
// equality, so none fuses into an fma: one instruction is one operation,
// and the card issues at most 132 SMs * 128 lanes * 1.98 GHz = 33.5e12 of
// them a second, half the published 67e12 (which counts an fma as two).
// The only way below that is fewer instructions:
//
// * Degenerate edges (a == b) are left out when the block stages the edge
//   list: the packer pads every edge list to a multiple of 128 with them
//   (rooms-M: 56 real edges of 128).  One never blocks, in the twin either:
//   with a == b the cross products of signs 1 and 2 are (+-0) * x, so both
//   signs are zero and no straddle or touch holds; signs 3 and 4 take the
//   same operands up to the sign of a zero, so a zero sign 4 (the vertex
//   rule's precondition) makes sign 3 zero too, and the vertex rule needs
//   sign 3 nonzero.  NaN operands make every compare false, which is the
//   zero sign again.  So the OR over the kept edges is the OR over all.
// * Segment-only terms (dx, dy, l2, tau, l2 - tau) are computed once per
//   segment, and the edge-only differences bx - ax, by - ay once per edge
//   at staging (float4 pairs: ax ay bx by | cx cy bx-ax by-ay).
// * A group of G lanes (G a power of two, 1..32, aligned inside a warp)
//   takes one segment; its lanes stride the kept edges, G at a step.  After
//   each step the group ORs its verdicts with __any_sync over its own lane
//   mask and stops at the first step in which a lane blocks.  OR is
//   monotone, so stopping early cannot change the bit.  A block whose
//   groups are all blocked skips the rest of a long edge list
//   (__syncthreads_and at each tile boundary).
// * The wrapper (kernels/segvis.py launch_shape) picks G and the block size
//   from N: a warp per segment where N is small (the co-visibility launch,
//   N = 256), so that the launch still fills the 132 SMs, and one lane per
//   segment on the fold's N = 256 * W.  Both were the fastest G measured on
//   the main path's own segments: on the fold, a warp of G = 1 still runs
//   until its slowest segment is done, but wider groups pay the same wait
//   on fewer segments per warp plus a vote a step and the segment's setup
//   once per lane.
//
// Tried and taken out: groups that pull the next segment of their block's
// chunk from a shared counter as soon as they finish one, so that a warp
// does not wait for its slowest segment.  Measured on the main path's fold
// segments it was no faster at one segment per group and slower at more:
// the divergent switch to the next segment cost what the waiting saved.
//
// An edge list longer than EDGE_TILE is taken in tiles.  The ragged ends
// are masked: nothing is padded.

#include <cuda_runtime.h>

#include "blocked_pairs.cuh"

#define SEG_MAX_THREADS 256
#define EDGE_TILE 256

// Stage the n edges at ea/eb/ec that are not degenerate (a != b), in index
// order, into s_ab/s_cd; returns how many (the same in every thread).
// Called by every thread of the block; ends with a barrier, after which the
// staged edges are visible to all.
__device__ __forceinline__ int stage_edges(const float2 *__restrict__ ea,
                                           const float2 *__restrict__ eb,
                                           const float2 *__restrict__ ec,
                                           int n, float4 *s_ab, float4 *s_cd,
                                           int *s_warp_kept) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int warps = blockDim.x >> 5;
    int kept = 0;
    for (int base = 0; base < n; base += blockDim.x) {
        const int k = base + threadIdx.x;
        float2 a = make_float2(0.f, 0.f), b = a, c = a;
        bool keep = false;
        if (k < n) {
            a = ea[k];
            b = eb[k];
            c = ec[k];
            keep = !(a.x == b.x && a.y == b.y);
        }
        const unsigned vote = __ballot_sync(0xffffffffu, keep);
        if (lane == 0) s_warp_kept[warp] = __popc(vote);
        __syncthreads();
        int slot = kept, total = kept;
        for (int w = 0; w < warps; ++w) {
            slot += w < warp ? s_warp_kept[w] : 0;
            total += s_warp_kept[w];
        }
        if (keep) {
            slot += __popc(vote & ((1u << lane) - 1u));
            s_ab[slot] = make_float4(a.x, a.y, b.x, b.y);
            s_cd[slot] = make_float4(c.x, c.y, sub(b.x, a.x), sub(b.y, a.y));
        }
        kept = total;
        __syncthreads();
    }
    return kept;
}

template <int G>
__global__ void __launch_bounds__(SEG_MAX_THREADS)
segvis_kernel(const float2 *__restrict__ p, const float2 *__restrict__ q,
              const float2 *__restrict__ ea, const float2 *__restrict__ eb,
              const float2 *__restrict__ ec, bool *__restrict__ out, int n,
              int e) {
    __shared__ float4 s_ab[EDGE_TILE];      // ax, ay, bx, by
    __shared__ float4 s_cd[EDGE_TILE];      // cx, cy, bx - ax, by - ay
    __shared__ int s_warp_kept[SEG_MAX_THREADS / 32];

    const int lane = threadIdx.x % G;               // lane in the group
    const long long i = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / G;
    const bool live = i < n;                        // uniform in a group
    const unsigned mask = G == 32 ? 0xffffffffu
        : ((1u << (G % 32)) - 1u) << ((threadIdx.x & 31) & ~(G - 1));

    SegTerms seg = seg_terms(0.f, 0.f, 0.f, 0.f);
    if (live) {
        const float2 pi = p[i], qi = q[i];
        seg = seg_terms(pi.x, pi.y, qi.x, qi.y);
    }
    bool blocked = false;                           // uniform in a group
    for (int e0 = 0; e0 < e; e0 += EDGE_TILE) {
        // the barrier that frees the previous tile also ends the block's
        // walk once every live group in it is blocked
        if (e0 > 0 && __syncthreads_and(blocked || !live)) break;
        const int tile = stage_edges(ea + e0, eb + e0, ec + e0,
                                     min(EDGE_TILE, e - e0), s_ab, s_cd,
                                     s_warp_kept);
        if (live && !blocked) {
            for (int k0 = 0; k0 < tile; k0 += G) {
                const int k = k0 + lane;
                bool b = false;
                if (k < tile) {
                    const float4 ab = s_ab[k], cd = s_cd[k];
                    b = blocked_pair_terms(seg, ab.x, ab.y, ab.z, ab.w, cd.x,
                                           cd.y, cd.z, cd.w);
                }
                if (G == 1 ? b : __any_sync(mask, b)) {
                    blocked = true;
                    break;
                }
            }
        }
    }
    if (live && lane == 0) out[i] = !blocked;
}

template <int G>
static void launch(const void *p, const void *q, const void *ea,
                   const void *eb, const void *ec, void *out, int n, int e,
                   int threads, cudaStream_t stream) {
    const long long blocks = ((long long)n * G + threads - 1) / threads;
    segvis_kernel<G><<<(unsigned)blocks, threads, 0, stream>>>(
        (const float2 *)p, (const float2 *)q, (const float2 *)ea,
        (const float2 *)eb, (const float2 *)ec, (bool *)out, n, e);
}

// Launch on `stream`; returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for a shape the kernel does not take.  All pointers
// are device pointers to contiguous float32 [n, 2] / [e, 2] arrays and a
// bool [n] output.  `group` is a power of two in 1..32 and `threads` a
// multiple of 32 in 32..SEG_MAX_THREADS.
extern "C" int segvis_launch(const void *p, const void *q, const void *ea,
                             const void *eb, const void *ec, void *out,
                             int n, int e, int group, int threads,
                             void *stream) {
    if (group < 1 || group > 32 || (group & (group - 1)) || threads < 32 ||
        threads > SEG_MAX_THREADS || threads % 32)
        return (int)cudaErrorInvalidValue;
    if (n > 0) {
        cudaStream_t s = (cudaStream_t)stream;
        switch (group) {
        case 1: launch<1>(p, q, ea, eb, ec, out, n, e, threads, s); break;
        case 2: launch<2>(p, q, ea, eb, ec, out, n, e, threads, s); break;
        case 4: launch<4>(p, q, ea, eb, ec, out, n, e, threads, s); break;
        case 8: launch<8>(p, q, ea, eb, ec, out, n, e, threads, s); break;
        case 16: launch<16>(p, q, ea, eb, ec, out, n, e, threads, s); break;
        default: launch<32>(p, q, ea, eb, ec, out, n, e, threads, s); break;
        }
    }
    return (int)cudaGetLastError();
}
