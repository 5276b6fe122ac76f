// The DESIGN.md §5 per-(segment, edge) blocking predicate, shared by the
// dense (segvis.cu) and the gathered-tile (segvis_tiles.cu) visibility
// kernels: one definition, as the twins share repro_torch/kernels/ref.py
// blocked_pairs.
//
// Rounding: every product, difference and sum is written with
// __fmul_rn/__fsub_rn/__fadd_rn, which nvcc never contracts into an fma
// whatever the flags, so each step rounds exactly as the twin's separate
// torch ops do.  The band SIGN_BAND * FLT_EPSILON = 2^-20 is a power of two,
// so tau is exact too.  Cost: ~84 float32 operations per pair (five banded
// cross signs at 14 each plus the 14-op projection test).

#pragma once

#include <cuda_runtime.h>

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
