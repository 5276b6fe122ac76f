// Batched segment-vs-obstacle visibility (DESIGN.md §5 predicate) for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/segvis.py:_segvis_kernel (called
// by segvis.py:segvis).  out[i] = 1 where segment p[i]->q[i] is blocked by at
// least one of the E edges (ea[e], eb[e]; ec[e] is the CCW next vertex for
// the through-vertex rule), else 0.  Twin: repro_torch/kernels/ref.py
// segvis_ref, which it must equal bit for bit.
//
// Bound on the H100: operations.  Each (segment, edge) pair costs ~84 float32
// operations (five banded cross signs plus the projection test) against 24
// bytes of input per segment and per edge, so at the main path's shapes
// (N = 256 * W segments, E = 128) the work is far above the memory line.
// Design: one thread per segment holds its endpoints in registers; the block
// stages the edge list in shared memory in tiles of EDGE_TILE edges (6
// floats each), which every thread of the block reads as a broadcast.  The
// ragged edges of both loops are masked, so nothing is padded.
//
// Rounding and the predicate body: blocked_pairs.cuh (shared with
// segvis_tiles.cu).

#include <cuda_runtime.h>
#include <stdint.h>

#include "blocked_pairs.cuh"

#define SEG_THREADS 256
#define EDGE_TILE 256

__global__ void __launch_bounds__(SEG_THREADS)
segvis_kernel(const float2 *__restrict__ p, const float2 *__restrict__ q,
              const float2 *__restrict__ ea, const float2 *__restrict__ eb,
              const float2 *__restrict__ ec, uint8_t *__restrict__ out,
              int n, int e) {
    __shared__ float2 sa[EDGE_TILE];
    __shared__ float2 sb[EDGE_TILE];
    __shared__ float2 sc[EDGE_TILE];

    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    const bool live = i < n;
    float2 pi = make_float2(0.f, 0.f), qi = make_float2(0.f, 0.f);
    if (live) {
        pi = p[i];
        qi = q[i];
    }
    bool blocked = false;
    for (int e0 = 0; e0 < e; e0 += EDGE_TILE) {
        const int tile = min(EDGE_TILE, e - e0);
        __syncthreads();
        for (int k = threadIdx.x; k < tile; k += blockDim.x) {
            sa[k] = ea[e0 + k];
            sb[k] = eb[e0 + k];
            sc[k] = ec[e0 + k];
        }
        __syncthreads();
        if (live) {
            for (int k = 0; k < tile; ++k) {
                blocked |= blocked_pair(pi.x, pi.y, qi.x, qi.y, sa[k].x, sa[k].y,
                                        sb[k].x, sb[k].y, sc[k].x, sc[k].y);
            }
        }
    }
    if (live) out[i] = blocked ? 1 : 0;
}

// Launch on `stream`; returns cudaGetLastError() (0 on success).  All
// pointers are device pointers to contiguous float32 [n, 2] / [e, 2] arrays
// and a uint8 [n] output.
extern "C" int segvis_launch(const void *p, const void *q, const void *ea,
                             const void *eb, const void *ec, void *out,
                             int n, int e, void *stream) {
    if (n > 0) {
        const int blocks = (n + SEG_THREADS - 1) / SEG_THREADS;
        segvis_kernel<<<blocks, SEG_THREADS, 0, (cudaStream_t)stream>>>(
            (const float2 *)p, (const float2 *)q, (const float2 *)ea,
            (const float2 *)eb, (const float2 *)ec, (uint8_t *)out, n, e);
    }
    return (int)cudaGetLastError();
}
