// Segment visibility over per-segment gathered edge tiles (DESIGN.md §10)
// for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/segvis.py:_segvis_tiles_kernel
// (called by segvis.py:segvis_tiles).  Segment i carries its own S edge
// slots, six [N, S] float32 planes ax..cy gathered by the edge-grid walk
// (repro_torch/core/edgegrid.py gather_edge_tiles).  out[i] = 1 where
// segment p[i]->q[i] is blocked by at least one of its slots, else 0.
// Unused slots hold the degenerate sentinel edge (a == b == c), which never
// blocks.  Twin: repro_torch/kernels/ref.py segvis_tiles_ref, which it must
// equal bit for bit; the predicate body is blocked_pairs.cuh, shared with
// segvis.cu.
//
// Bound on the H100: bytes.  Every slot is read once (24 bytes over the six
// planes) for ~50 float32 operations, about 2 operations per byte, far
// below the card's 67e12 / 3.35e12 = 20 operations per byte.  At N = 8192,
// S = 192 that is 37.9 MB, 0.0113 ms at 3.35 TB/s.  Fusing the walk and the
// ELL gather into this kernel (reading 4-byte ids instead of 24-byte slots)
// is the redesign that moves that bound; this first kernel takes the
// materialised tiles as the TPU kernel did.
// Design: one warp per segment.  The lanes stride the segment's S
// contiguous slots, so each row of each plane is read with coalesced
// 128-byte warp loads; each lane ORs its slots' verdicts and the warp
// reduces with __any_sync after every 32-slot step, stopping at the first
// step in which any lane blocks (OR is monotone, so the bits do not
// change).  The ragged N and S edges are masked, so nothing is padded.

#include <cuda_runtime.h>
#include <stdint.h>

#include "blocked_pairs.cuh"

#define TILE_WARPS 8
#define TILE_THREADS (TILE_WARPS * 32)

__global__ void __launch_bounds__(TILE_THREADS)
segvis_tiles_kernel(const float2 *__restrict__ p, const float2 *__restrict__ q,
                    const float *__restrict__ ax, const float *__restrict__ ay,
                    const float *__restrict__ bx, const float *__restrict__ by,
                    const float *__restrict__ cx, const float *__restrict__ cy,
                    uint8_t *__restrict__ out, int n, int s) {
    const int lane = threadIdx.x & 31;
    const int i = blockIdx.x * TILE_WARPS + (threadIdx.x >> 5);
    if (i >= n) return;                 // uniform across the warp
    const float2 pi = p[i];
    const float2 qi = q[i];
    const SegTerms seg = seg_terms(pi.x, pi.y, qi.x, qi.y);
    const size_t row = (size_t)i * (size_t)s;
    bool blocked = false;
    for (int base = 0; base < s; base += 32) {
        const int k = base + lane;
        if (k < s) {
            const size_t o = row + k;
            blocked = blocked_pair(seg, ax[o], ay[o], bx[o], by[o], cx[o],
                                   cy[o]);
        }
        if (__any_sync(0xffffffffu, blocked)) {
            blocked = true;
            break;
        }
    }
    if (lane == 0) out[i] = blocked ? 1 : 0;
}

// Launch on `stream`; returns cudaGetLastError() (0 on success).  All
// pointers are device pointers: p, q contiguous float32 [n, 2]; ax..cy
// contiguous float32 [n, s]; out uint8 [n].
extern "C" int segvis_tiles_launch(const void *p, const void *q,
                                   const void *ax, const void *ay,
                                   const void *bx, const void *by,
                                   const void *cx, const void *cy, void *out,
                                   int n, int s, void *stream) {
    if (n > 0) {
        const int blocks = (n + TILE_WARPS - 1) / TILE_WARPS;
        segvis_tiles_kernel<<<blocks, TILE_THREADS, 0, (cudaStream_t)stream>>>(
            (const float2 *)p, (const float2 *)q, (const float *)ax,
            (const float *)ay, (const float *)bx, (const float *)by,
            (const float *)cx, (const float *)cy, (uint8_t *)out, n, s);
    }
    return (int)cudaGetLastError();
}
