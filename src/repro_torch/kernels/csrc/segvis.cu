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
// Rounding: every product, difference and sum is written with
// __fmul_rn/__fsub_rn/__fadd_rn, which nvcc never contracts into an fma
// whatever the flags, so each step rounds exactly as the twin's separate
// torch ops do.  The band SIGN_BAND * FLT_EPSILON = 2^-20 is a power of two,
// so tau is exact too.

#include <cuda_runtime.h>
#include <stdint.h>

#define SEG_THREADS 256
#define EDGE_TILE 256

// SIGN_BAND (8) * FLT_EPSILON (2^-23) = 2^-20
#define BAND 9.5367431640625e-07f

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }

// (pos, neg) of t1 - t2 with the relative zero band of ref.filtered_signs.
__device__ __forceinline__ void filtered_signs(float t1, float t2,
                                               bool &pos, bool &neg) {
    const float d = sub(t1, t2);
    const float tau = mul(BAND, add(fabsf(t1), fabsf(t2)));
    pos = d > tau;
    neg = d < -tau;
}

// ref.blocked_pairs for one (segment, edge) pair, in the twin's order of
// operations.
__device__ __forceinline__ bool blocked_pair(float px, float py, float qx,
                                             float qy, float ax, float ay,
                                             float bx, float by, float cx,
                                             float cy) {
    bool pos1, neg1, pos2, neg2, pos3, neg3, pos4, neg4, pos5, neg5;
    filtered_signs(mul(sub(bx, ax), sub(py, ay)), mul(sub(by, ay), sub(px, ax)),
                   pos1, neg1);
    filtered_signs(mul(sub(bx, ax), sub(qy, ay)), mul(sub(by, ay), sub(qx, ax)),
                   pos2, neg2);
    filtered_signs(mul(sub(qx, px), sub(ay, py)), mul(sub(qy, py), sub(ax, px)),
                   pos3, neg3);
    filtered_signs(mul(sub(qx, px), sub(by, py)), mul(sub(qy, py), sub(bx, px)),
                   pos4, neg4);
    filtered_signs(mul(sub(qx, px), sub(cy, py)), mul(sub(qy, py), sub(cx, px)),
                   pos5, neg5);
    const bool straddle12 = (pos1 && neg2) || (neg1 && pos2);
    const bool straddle34 = (pos3 && neg4) || (neg3 && pos4);
    const bool proper = straddle12 && straddle34;
    const bool zero1 = !pos1 && !neg1;
    const bool zero2 = !pos2 && !neg2;
    const bool touch_pen = ((zero1 && pos2) || (zero2 && pos1)) && straddle34;
    const float dx = sub(qx, px);
    const float dy = sub(qy, py);
    const float tb = add(mul(sub(bx, px), dx), mul(sub(by, py), dy));
    const float l2 = add(mul(dx, dx), mul(dy, dy));
    const float tau = mul(BAND, l2);
    const bool on_seg = (!pos4 && !neg4) && (tb > tau) && (tb < sub(l2, tau));
    const bool vert_pen = on_seg && ((pos3 && neg5) || (neg3 && pos5));
    return proper || touch_pen || vert_pen;
}

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
