// Hub-label row join (paper Eq. 3, sorted form) for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/label_join.py:_join_kernel
// (called by label_join.py:label_join_rowmin).  For every row b and s-label i:
//
//   out[b, i] = vd_s[b, i] + min_{j : hub_t[b, j] == hub_s[b, i]} vd_t[b, j]
//
// with +inf when no t-label shares the hub.  Hubs are int32 (pad 2^30),
// distances float32, bfloat16 or float16, one type for both sides (+inf =
// invisible via or padded slot); the output is float32.  Twin:
// repro_torch/kernels/ref.py label_join_rowmin_ref (the dense L x L mask).
//
// Narrow distances: the kernel is a template on the load type T and widens
// each value to float32 where it is read (staging in shared memory for
// vd_t, the final add for vd_s), as the TPU kernel's wrapper and the twin
// widen before they sum.  bf16 -> f32 and f16 -> f32 are exact, so from the
// staging on everything is the float32 join, with the same bits as the twin.
//
// Precondition (every caller in the port meets it: core/packed.py
// _mask_labels makes each distance a sum of norms and label distances, or
// +inf): no distance is NaN or -0.  Then min is exact and independent of
// the order in which it is taken, and fminf agrees with the twin's amin, so
// the kernel equals the twin bit for bit on every row, sorted or not.
//
// Bound on the H100: bytes.  The rows the main path gives it are sorted by
// hub (core/grid.py lexsorts each region's labels by (hub, via);
// core/packed.py pads each slab row with HUB_PAD at its tail and
// _gather_bucketed copies one slab row per query), so the t-labels that
// match one hub form one contiguous run.  The sorted join reads each of the
// 4 input planes once and writes one: 20 B L bytes (16 B L with 2-byte
// distances), 0.00078 ms at B = 256, L = 512; the dense join's 3 L^2
// operations per row are gone.
//
// Design: one block per row.  The t row is taken in chunks of up to `tile`
// labels (the launcher sets tile = min(L, JOIN_MAX_TILE), dynamic shared
// memory of 12 bytes a label, above 48 KB after cudaFuncSetAttribute); rows
// up to JOIN_MAX_TILE wide are one chunk.  For each chunk the block
//   1. stages hubs and distances in shared memory;
//   2. checks that the chunk's hubs are nondecreasing (__syncthreads_or);
//   3. if so, folds each run of equal hubs to its minimum at the run's
//      first slot: a segmented doubling min, ceil(log2(longest run)) steps
//      of one barrier each (a padded tail of hundreds of HUB_PAD slots
//      costs 9 steps, not hundreds of serial reads), and then each s-label
//      finds its hub's first slot by binary search (lower bound, log2 tile
//      probes) and reads the run's minimum;
//   4. if not, every s-label scans the whole chunk for equal hubs (the
//      dense form of the join, inside this kernel).
// A row's chunks combine with fminf, carried in `out` between chunks, so a
// chunk may be sorted or not independently of the others: each chunk's
// minimum is exact either way.  The last chunk adds vd_s with __fadd_rn.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>

#define JOIN_THREADS 256
// 16384 labels * 12 bytes = 192 KB of the 227 KB a block may use
#define JOIN_MAX_TILE 16384

// the wrapper's dtype codes (kernels/label_join.py _DTYPE_CODES)
#define JOIN_F32 0
#define JOIN_BF16 1
#define JOIN_F16 2

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
    return __bfloat162float(x);
}
__device__ __forceinline__ float widen(__half x) { return __half2float(x); }

template <typename T>
__global__ void __launch_bounds__(JOIN_THREADS)
label_join_rowmin_kernel(const int *__restrict__ hub_s,
                         const T *__restrict__ vd_s,
                         const int *__restrict__ hub_t,
                         const T *__restrict__ vd_t,
                         float *__restrict__ out, int L, int tile) {
    extern __shared__ int smem[];
    int *sh = smem;                                 // [tile] hubs
    float *buf0 = (float *)(smem + tile);           // [tile] distances
    float *buf1 = buf0 + tile;                      // [tile] doubling scratch
    const size_t row = (size_t)blockIdx.x * (size_t)L;

    for (int j0 = 0; j0 < L; j0 += tile) {
        const int n = min(tile, L - j0);
        const bool last = j0 + n == L;
        __syncthreads();                // the previous chunk's readers are done
        bool unsorted = false;
        for (int k = threadIdx.x; k < n; k += blockDim.x) {
            sh[k] = hub_t[row + j0 + k];
            buf0[k] = widen(vd_t[row + j0 + k]);
        }
        __syncthreads();
        for (int k = threadIdx.x; k + 1 < n; k += blockDim.x)
            unsorted |= sh[k] > sh[k + 1];
        const float *runmin = buf0;
        if (!__syncthreads_or(unsorted)) {
            // after the step of width d, cur[k] = min over [k, k + 2d) of
            // k's run: sorted hubs make sh[k + d] == sh[k] mean that every
            // slot between lies in the run too
            float *cur = buf0, *nxt = buf1;
            for (int d = 1; d < n; d <<= 1) {
                bool more = false;
                for (int k = threadIdx.x; k < n; k += blockDim.x) {
                    float v = cur[k];
                    if (k + d < n && sh[k + d] == sh[k]) {
                        v = fminf(v, cur[k + d]);
                        more |= k + 2 * d < n && sh[k + 2 * d] == sh[k];
                    }
                    nxt[k] = v;
                }
                float *t = cur;
                cur = nxt;
                nxt = t;
                if (!__syncthreads_or(more)) break;
            }
            runmin = cur;
            for (int i = threadIdx.x; i < L; i += blockDim.x) {
                const int h = hub_s[row + i];
                float m = j0 == 0 ? INFINITY : out[row + i];
                int lo = 0, hi = n;
                while (lo < hi) {
                    const int mid = (lo + hi) >> 1;
                    if (sh[mid] < h) lo = mid + 1;
                    else hi = mid;
                }
                if (lo < n && sh[lo] == h) m = fminf(m, runmin[lo]);
                out[row + i] = last ? __fadd_rn(widen(vd_s[row + i]), m) : m;
            }
        } else {
            for (int i = threadIdx.x; i < L; i += blockDim.x) {
                const int h = hub_s[row + i];
                float m = j0 == 0 ? INFINITY : out[row + i];
                for (int k = 0; k < n; ++k)
                    if (sh[k] == h) m = fminf(m, runmin[k]);
                out[row + i] = last ? __fadd_rn(widen(vd_s[row + i]), m) : m;
            }
        }
    }
}

template <typename T>
static int launch(const void *hub_s, const void *vd_s, const void *hub_t,
                  const void *vd_t, void *out, int B, int L,
                  cudaStream_t stream) {
    const int tile = L < JOIN_MAX_TILE ? L : JOIN_MAX_TILE;
    const size_t smem = (size_t)tile * 12;
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            label_join_rowmin_kernel<T>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    label_join_rowmin_kernel<T><<<B, JOIN_THREADS, smem, stream>>>(
        (const int *)hub_s, (const T *)vd_s, (const int *)hub_t,
        (const T *)vd_t, (float *)out, L, tile);
    return 0;
}

// Launch on `stream`; returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for an unknown dtype code.  All pointers are device
// pointers to contiguous [B, L] arrays; vd_s and vd_t are of the type that
// `dtype` names (JOIN_F32, JOIN_BF16 or JOIN_F16), out is float32.
extern "C" int label_join_rowmin_launch(const void *hub_s, const void *vd_s,
                                        const void *hub_t, const void *vd_t,
                                        void *out, int B, int L, int dtype,
                                        void *stream) {
    if (B > 0 && L > 0) {
        const cudaStream_t st = (cudaStream_t)stream;
        int err;
        switch (dtype) {
        case JOIN_F32:
            err = launch<float>(hub_s, vd_s, hub_t, vd_t, out, B, L, st);
            break;
        case JOIN_BF16:
            err = launch<__nv_bfloat16>(hub_s, vd_s, hub_t, vd_t, out, B, L,
                                        st);
            break;
        case JOIN_F16:
            err = launch<__half>(hub_s, vd_s, hub_t, vd_t, out, B, L, st);
            break;
        default:
            return (int)cudaErrorInvalidValue;
        }
        if (err) return err;
    }
    return (int)cudaGetLastError();
}
