// Bidirectional minimax relaxation sweep of the watershed image-foresting
// transform, one ray per thread, in place.
//
// Replaces the TPU kernels watershed_sweep_z (_ws_sweep_z_kernel) and
// watershed_sweep_y (_ws_sweep_y_kernel) of
// invesalius3_tpu/ops/pallas_kernels.py, and the four HBM transposes that
// fed the X sweep through the Y kernel (invesalius3_tpu/ops/watershed.py
// _sweep_x_pallas).  It computes what two _sweep_axis passes compute
// (forward, then backward, each reading the values the forward pass wrote):
//
//   cand = INF                                         if parent == INF
//        = max(parent >> 15, f) * 2^15 + min((parent & 0x7FFF) + 1, 0x7FFF)
//   where cand < rank: rank = cand, lab = parent's lab
//
// Layout: rank int32, lab int16 or int32, f int32, all C-contiguous
// (Z, Y, X).  AXIS is the sweep axis.  Along axes 0 and 1 neighbouring
// threads own neighbouring x, so every step's loads and stores coalesce.
// Along axis 2 (native X sweep) each thread walks its own contiguous row:
// neighbouring threads are X elements apart and the loads are strided;
// staging x-runs through shared memory is left to a later change.
//
// What bounds it on an H100: device-memory bytes.  Each sweep reads rank,
// f and (where no update happens) lab once per pass and writes rank and
// lab where they improve: at 512^3 with int32 labels about 2 x 1.6 GB per
// sweep, ~1 ms at 3.35 TB/s, and a round is three sweeps.  The carry along
// the ray is the only dependency; the next element's loads do not depend
// on it, so they are issued one step ahead.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int32_t kInf = 0x7FFFFFFF;
constexpr int32_t kDistBits = 15;
constexpr int32_t kDistMax = (1 << kDistBits) - 1;

__device__ __forceinline__ int32_t relax(int32_t parent, int32_t f) {
    if (parent == kInf) return kInf;
    const int32_t cost = max(parent >> kDistBits, f);
    const int32_t dist = min((parent & kDistMax) + 1, kDistMax);
    return cost * (1 << kDistBits) + dist;
}

template <int AXIS, typename L>
__global__ void ws_sweep_kernel(int32_t* __restrict__ rank,
                                L* __restrict__ lab,
                                const int32_t* __restrict__ f,
                                int Z, int Y, int X) {
    const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    int64_t base, stride;
    int n;
    if (AXIS == 0) {          // rays over (y, x), walk z
        if (t >= (int64_t)Y * X) return;
        base = t;
        stride = (int64_t)Y * X;
        n = Z;
    } else if (AXIS == 1) {   // rays over (z, x), walk y
        if (t >= (int64_t)Z * X) return;
        const int64_t z = t / X, x = t % X;
        base = z * Y * X + x;
        stride = X;
        n = Y;
    } else {                  // rays over (z, y), walk x
        if (t >= (int64_t)Z * Y) return;
        base = t * X;
        stride = 1;
        n = X;
    }
    if (n < 2) return;

    // forward: element i relaxes from i - 1
    int64_t p = base;
    int32_t pr = rank[p];
    L pl = lab[p];
    int32_t nr = rank[p + stride], nf = f[p + stride];
    for (int i = 1; i < n; ++i) {
        p += stride;
        const int32_t cur = nr, fi = nf;
        if (i + 1 < n) { nr = rank[p + stride]; nf = f[p + stride]; }
        const int32_t cand = relax(pr, fi);
        if (cand < cur) {
            rank[p] = cand;
            lab[p] = pl;
            pr = cand;
        } else {
            pr = cur;
            pl = lab[p];
        }
    }
    // backward: element i relaxes from i + 1 (p is at the last element)
    nr = rank[p - stride];
    nf = f[p - stride];
    for (int i = n - 2; i >= 0; --i) {
        p -= stride;
        const int32_t cur = nr, fi = nf;
        if (i > 0) { nr = rank[p - stride]; nf = f[p - stride]; }
        const int32_t cand = relax(pr, fi);
        if (cand < cur) {
            rank[p] = cand;
            lab[p] = pl;
            pr = cand;
        } else {
            pr = cur;
            pl = lab[p];
        }
    }
}

template <typename L>
int launch(int axis, int32_t* rank, L* lab, const int32_t* f,
           int Z, int Y, int X, cudaStream_t stream) {
    constexpr int kThreads = 128;
    const int64_t rays = axis == 0 ? (int64_t)Y * X
                       : axis == 1 ? (int64_t)Z * X : (int64_t)Z * Y;
    const unsigned blocks = (unsigned)((rays + kThreads - 1) / kThreads);
    if (blocks == 0) return 0;
    if (axis == 0)
        ws_sweep_kernel<0, L><<<blocks, kThreads, 0, stream>>>(rank, lab, f, Z, Y, X);
    else if (axis == 1)
        ws_sweep_kernel<1, L><<<blocks, kThreads, 0, stream>>>(rank, lab, f, Z, Y, X);
    else
        ws_sweep_kernel<2, L><<<blocks, kThreads, 0, stream>>>(rank, lab, f, Z, Y, X);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 on success), or -1 for an
// argument the kernel does not take.
int ws_sweep(void* rank, void* lab, const void* f, int Z, int Y, int X,
             int axis, int lab_bytes, void* stream) {
    if (axis < 0 || axis > 2 || Z < 0 || Y < 0 || X < 0) return -1;
    cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
    if (lab_bytes == 2)
        return launch<int16_t>(axis, (int32_t*)rank, (int16_t*)lab,
                               (const int32_t*)f, Z, Y, X, s);
    if (lab_bytes == 4)
        return launch<int32_t>(axis, (int32_t*)rank, (int32_t*)lab,
                               (const int32_t*)f, Z, Y, X, s);
    return -1;
}

}  // extern "C"
