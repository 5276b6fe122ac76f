// Hub-label row join (paper Eq. 3, dense form) for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/label_join.py:_join_kernel
// (called by label_join.py:label_join_rowmin).  For every row b and s-label i:
//
//   out[b, i] = vd_s[b, i] + min_{j : hub_t[b, j] == hub_s[b, i]} vd_t[b, j]
//
// with +inf when no t-label shares the hub.  Hubs are int32 (pad 2^30),
// distances float32 (+inf = invisible via or padded slot).  Twin:
// repro_torch/kernels/ref.py label_join_rowmin_ref.  A min and one add are
// exact in IEEE arithmetic, so the result equals the twin bit for bit.
//
// Bound on the H100: operations.  The dense join does L^2 (compare, select,
// min) steps per row against 16 L bytes of input and 4 L of output, so at
// the main path's widths (L = 128..512) it is far above the memory line.
// Design: one block per row; the block stages the t side of its row in
// shared memory in tiles of JOIN_TILE labels (8 bytes each), every thread
// owns one s-label at a time and scans the tile for equal hubs.  All
// threads read the same shared word at once (a broadcast, no bank
// conflicts).  The rows are hub-sorted (core/grid.py pack_region), which a
// merge or binary-search form could use to cut the L^2 term; that is a
// later redesign.

#include <cuda_runtime.h>
#include <math.h>

#define JOIN_THREADS 256
#define JOIN_TILE 1024

__global__ void __launch_bounds__(JOIN_THREADS)
label_join_rowmin_kernel(const int *__restrict__ hub_s,
                         const float *__restrict__ vd_s,
                         const int *__restrict__ hub_t,
                         const float *__restrict__ vd_t,
                         float *__restrict__ out, int L) {
    __shared__ int sh[JOIN_TILE];
    __shared__ float sv[JOIN_TILE];
    const size_t row = (size_t)blockIdx.x * (size_t)L;

    // every thread runs the same number of i-steps, so the barriers below
    // are reached uniformly; threads past the row's end only help stage
    for (int i0 = 0; i0 < L; i0 += blockDim.x) {
        const int i = i0 + threadIdx.x;
        const bool live = i < L;
        const int h = live ? hub_s[row + i] : 0;
        float m = INFINITY;
        for (int j0 = 0; j0 < L; j0 += JOIN_TILE) {
            const int tile = min(JOIN_TILE, L - j0);
            __syncthreads();
            for (int k = threadIdx.x; k < tile; k += blockDim.x) {
                sh[k] = hub_t[row + j0 + k];
                sv[k] = vd_t[row + j0 + k];
            }
            __syncthreads();
            if (live) {
                for (int k = 0; k < tile; ++k) {
                    if (sh[k] == h) m = fminf(m, sv[k]);
                }
            }
        }
        if (live) out[row + i] = __fadd_rn(vd_s[row + i], m);
    }
}

// Launch on `stream`; returns cudaGetLastError() (0 on success).  All
// pointers are device pointers to contiguous [B, L] arrays.
extern "C" int label_join_rowmin_launch(const void *hub_s, const void *vd_s,
                                        const void *hub_t, const void *vd_t,
                                        void *out, int B, int L,
                                        void *stream) {
    if (B > 0 && L > 0) {
        label_join_rowmin_kernel<<<B, JOIN_THREADS, 0, (cudaStream_t)stream>>>(
            (const int *)hub_s, (const float *)vd_s, (const int *)hub_t,
            (const float *)vd_t, (float *)out, L);
    }
    return (int)cudaGetLastError();
}
