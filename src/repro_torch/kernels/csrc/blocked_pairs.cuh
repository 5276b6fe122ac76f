// The DESIGN.md §5 per-(segment, edge) blocking predicate, shared by the
// dense (segvis.cu) and the gathered-tile (segvis_tiles.cu) visibility
// kernels: one definition, as the twins share repro_torch/kernels/ref.py
// blocked_pairs.
//
// Rounding: every product, difference and sum is written with
// __fmul_rn/__fsub_rn/__fadd_rn, which nvcc never contracts into an fma
// whatever the flags, so each step rounds exactly as the twin's separate
// torch ops do.  The band SIGN_BAND * FLT_EPSILON = 2^-20 is a power of two,
// so tau is exact too.
//
// Hoisting: a value the twin computes again for every pair is computed here
// once, from the same operands by the same rounded operation, so it has the
// same bits.  Terms of the segment alone (dx, dy, l2, tau, l2 - tau) live in
// SegTerms, computed once per segment; the edge's own differences bx - ax,
// by - ay are computed once per edge by the caller (segvis.cu stages them
// in shared memory).  The vertex rule reads its fifth sign and the
// projection tb only when the fourth sign is zero (b on the segment's
// line), so they are computed only there.  What is left per pair is 34
// float32 operations (6 differences to the endpoints, 8 cross products, 4
// banded signs at 3 operations and 2 compares each), and 14 more on the
// line; the twin spends 84 on every pair.
//
// One exact rewrite: the twin's third sign uses ay - py and ax - px; this
// file uses -(py - ay) and -(px - ax), the differences the first sign
// already holds.  Round-to-nearest is symmetric, fl(-x) = -fl(x), so
// fl(a - b) = -fl(b - a) and fl(u * -v) = -fl(u * v) for every finite or
// infinite operand; the two forms can differ only in the sign of a zero.
// A zero's sign reaches nothing the predicate reads: fabsf drops it, a
// difference t1 - t2 with one zero operand is the other operand up to
// sign (a nonzero value is unchanged), and the compares d > tau,
// d < -tau with tau >= 0 are false for +0 and -0 alike.

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

// The terms of segment p -> q that every pair shares.
struct SegTerms {
    float px, py, qx, qy;
    float dx, dy;       // q - p
    float tau;          // BAND * l2, l2 = dx^2 + dy^2
    float hi;           // l2 - tau
};

__device__ __forceinline__ SegTerms seg_terms(float px, float py, float qx,
                                              float qy) {
    SegTerms s;
    s.px = px;
    s.py = py;
    s.qx = qx;
    s.qy = qy;
    s.dx = sub(qx, px);
    s.dy = sub(qy, py);
    const float l2 = add(mul(s.dx, s.dx), mul(s.dy, s.dy));
    s.tau = mul(BAND, l2);
    s.hi = sub(l2, s.tau);
    return s;
}

// ref.blocked_pairs for one (segment, edge) pair in the twin's order of
// operations; bax = bx - ax and bay = by - ay come precomputed.
__device__ __forceinline__ bool blocked_pair_terms(const SegTerms &s,
                                                   float ax, float ay,
                                                   float bx, float by,
                                                   float cx, float cy,
                                                   float bax, float bay) {
    const float pxa = sub(s.px, ax), pya = sub(s.py, ay);
    const float qxa = sub(s.qx, ax), qya = sub(s.qy, ay);
    const float bpx = sub(bx, s.px), bpy = sub(by, s.py);
    bool pos1, neg1, pos2, neg2, pos3, neg3, pos4, neg4;
    filtered_signs(mul(bax, pya), mul(bay, pxa), pos1, neg1);
    filtered_signs(mul(bax, qya), mul(bay, qxa), pos2, neg2);
    // twin: (qx - px) * (ay - py), (qy - py) * (ax - px); see the note above
    filtered_signs(-mul(s.dx, pya), -mul(s.dy, pxa), pos3, neg3);
    filtered_signs(mul(s.dx, bpy), mul(s.dy, bpx), pos4, neg4);
    const bool straddle12 = (pos1 && neg2) || (neg1 && pos2);
    const bool straddle34 = (pos3 && neg4) || (neg3 && pos4);
    const bool proper = straddle12 && straddle34;
    const bool zero1 = !pos1 && !neg1;
    const bool zero2 = !pos2 && !neg2;
    const bool touch_pen = ((zero1 && pos2) || (zero2 && pos1)) && straddle34;
    // the vertex rule needs b on the segment's line (zero sign 4), which
    // only exact contacts give: the fifth sign and tb are computed there
    // only, and the twin's values of both are read nowhere else
    bool vert_pen = false;
    if (!pos4 && !neg4) {
        bool pos5, neg5;
        filtered_signs(mul(s.dx, sub(cy, s.py)), mul(s.dy, sub(cx, s.px)),
                       pos5, neg5);
        const float tb = add(mul(bpx, s.dx), mul(bpy, s.dy));
        vert_pen = (tb > s.tau) && (tb < s.hi)
            && ((pos3 && neg5) || (neg3 && pos5));
    }
    return proper || touch_pen || vert_pen;
}

// The same predicate with nothing precomputed (segvis_tiles.cu: every slot
// is its own edge).
__device__ __forceinline__ bool blocked_pair(const SegTerms &s, float ax,
                                             float ay, float bx, float by,
                                             float cx, float cy) {
    return blocked_pair_terms(s, ax, ay, bx, by, cx, cy, sub(bx, ax),
                              sub(by, ay));
}
