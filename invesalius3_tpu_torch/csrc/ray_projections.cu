// Slab ray projections of the 2D slice viewer: LMIP and MIDA, one ray per
// thread.
//
// Replaces the TPU kernels lmip_axis0 (_lmip_kernel) and mida_axis0
// (_mida_kernel) of invesalius3_tpu/ops/pallas_kernels.py.  Each thread owns
// one output pixel and walks its ray with the carry in registers; it stops
// where the TPU kernel's per-pixel "stopped" flag would freeze the carry
// (after that step neither kernel changes its output), so the break is
// exact.
//
//   LMIP: running max; once a value in [tmin, tmax] has been seen, the
//         first strict decrease ends the ray (projections.lmip_scan).
//   MIDA: fpi = (v - img_min) / rng; dl = max(fpi - fmax, 0); bt = 1 - dl;
//         alpha = clip((v - min_v) / (max_v - min_v), 0, 1);
//         colour = bt * colour_p + ((1 - bt * alpha_p) * fpi) * alpha;
//         alpha_p = bt * alpha_p + (1 - bt * alpha_p) * alpha;
//         stop once alpha_p >= 1; out = rng * colour_p + img_min
//         (projections.mida_scan).  img_min and the slab's max come from a
//         device buffer the wrapper fills (torch.aminmax over the slab).
//
// Exactness against the plain PyTorch versions: this file is built with
// -fmad=false, so every product and sum rounds on its own as PyTorch's
// separate elementwise kernels do, and division stays IEEE (no fast math).
// max and clip are written as comparisons that let NaN through, like
// jnp.maximum / torch.maximum / torch.clamp (fmaxf and fminf would drop
// it): a constant slab (rng = 0) or a zero-width window gives NaN.
//
// Layout: the input is any 3-D strided view (a narrowed slab, any
// projection axis) of int16, uint8 or float32, converted to float in
// registers.  A ray is n elements ray_stride apart; the output plane is
// (rows, cols) with input strides row_stride / col_stride, written
// contiguous.  When the projection axis is 0 or 1 the columns are the
// volume's x, so neighbouring threads read neighbouring addresses and every
// step's loads coalesce; along axis 2 they are a row apart (strided).
//
// What bounds it on an H100: device-memory bytes.  At 512^3 int16 a full
// ray walk reads 256 MiB (~0.08 ms at 3.35 TB/s); rays that stop early read
// less.  Measured through the wrapper (the output cast and, for MIDA, the
// slab's aminmax included), 512^3 int16, full depth: LMIP 0.18 ms on axes
// 0 and 1 and 0.48 ms on axis 2; MIDA 0.50, 0.51 and 0.61 ms (NVIDIA H100
// 80GB HBM3, 700 W).  The carry is the only dependency along a ray and the
// addresses do not depend on it, so each thread loads kBatch elements ahead
// before it consumes them, keeping several loads in flight per thread.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBatch = 8;

template <typename T>
__device__ __forceinline__ float to_float(T v) { return static_cast<float>(v); }

// jnp.maximum: NaN if either is NaN
__device__ __forceinline__ float max_nan(float a, float b) {
    return (a > b || a != a) ? a : b;
}

template <typename T>
__global__ void lmip_kernel(const T* __restrict__ vol, T* __restrict__ out,
                            int64_t n, int64_t ray_stride, int64_t rows,
                            int64_t cols, int64_t row_stride,
                            int64_t col_stride, float tmin, float tmax) {
    const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= rows * cols) return;
    const T* p = vol + (t / cols) * row_stride + (t % cols) * col_stride;

    float m = to_float(p[0]);
    bool start = (m >= tmin) && (m <= tmax);
    bool running = true;
    for (int64_t i0 = 1; running && i0 < n; i0 += kBatch) {
        float v[kBatch];
#pragma unroll
        for (int k = 0; k < kBatch; ++k)
            v[k] = (i0 + k < n) ? to_float(p[(i0 + k) * ray_stride]) : 0.0f;
#pragma unroll
        for (int k = 0; k < kBatch; ++k) {
            if (!running || i0 + k >= n) break;
            if (start && v[k] < m) {          // the first strict decrease
                running = false;
                break;
            }
            if (v[k] > m) m = v[k];
            if (v[k] >= tmin && v[k] <= tmax) start = true;
        }
    }
    out[t] = static_cast<T>(m);  // m is one of the ray's values: exact
}

template <typename T>
__global__ void mida_kernel(const T* __restrict__ vol, float* __restrict__ out,
                            int64_t n, int64_t ray_stride, int64_t rows,
                            int64_t cols, int64_t row_stride,
                            int64_t col_stride,
                            const float* __restrict__ minmax, float wl,
                            float ww) {
    const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= rows * cols) return;
    const T* p = vol + (t / cols) * row_stride + (t % cols) * col_stride;

    const float img_min = minmax[0];
    const float rng = minmax[1] - img_min;
    const float half = ww / 2.0f;
    const float min_v = wl - half;
    const float max_v = wl + half;
    const float span = max_v - min_v;

    float fmax = 0.0f, alpha_p = 0.0f, colour_p = 0.0f;
    bool running = true;
    for (int64_t i0 = 0; running && i0 < n; i0 += kBatch) {
        float v[kBatch];
#pragma unroll
        for (int k = 0; k < kBatch; ++k)
            v[k] = (i0 + k < n) ? to_float(p[(i0 + k) * ray_stride]) : 0.0f;
#pragma unroll
        for (int k = 0; k < kBatch; ++k) {
            if (!running || i0 + k >= n) break;
            const float vl = v[k];
            const float fpi = (vl - img_min) / rng;
            const float d = fpi - fmax;
            const float dl = d < 0.0f ? 0.0f : d;     // NaN passes
            const float bt = 1.0f - dl;
            float alpha = (vl - min_v) / span;
            alpha = alpha < 0.0f ? 0.0f : alpha;      // NaN passes
            alpha = alpha > 1.0f ? 1.0f : alpha;
            const float keep = 1.0f - bt * alpha_p;
            colour_p = bt * colour_p + (keep * fpi) * alpha;
            alpha_p = bt * alpha_p + keep * alpha;
            fmax = max_nan(fmax, fpi);
            if (alpha_p >= 1.0f) running = false;     // this step committed
        }
    }
    out[t] = rng * colour_p + img_min;
}

template <typename T>
int launch_lmip(const void* vol, void* out, int64_t n, int64_t ray_stride,
                int64_t rows, int64_t cols, int64_t row_stride,
                int64_t col_stride, float tmin, float tmax, cudaStream_t s) {
    const unsigned blocks = (unsigned)((rows * cols + kThreads - 1) / kThreads);
    lmip_kernel<T><<<blocks, kThreads, 0, s>>>(
        (const T*)vol, (T*)out, n, ray_stride, rows, cols, row_stride,
        col_stride, tmin, tmax);
    return (int)cudaGetLastError();
}

template <typename T>
int launch_mida(const void* vol, float* out, int64_t n, int64_t ray_stride,
                int64_t rows, int64_t cols, int64_t row_stride,
                int64_t col_stride, const float* minmax, float wl, float ww,
                cudaStream_t s) {
    const unsigned blocks = (unsigned)((rows * cols + kThreads - 1) / kThreads);
    mida_kernel<T><<<blocks, kThreads, 0, s>>>(
        (const T*)vol, out, n, ray_stride, rows, cols, row_stride, col_stride,
        minmax, wl, ww);
    return (int)cudaGetLastError();
}

bool bad_shape(int64_t n, int64_t rows, int64_t cols) {
    return n < 1 || rows < 1 || cols < 1 || (rows * cols + kThreads - 1) / kThreads > 0x7FFFFFFF;
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 int16, 2 uint8.  Both return cudaGetLastError() after
// the launch (0 on success), or -1 for an argument the kernels do not take.
// They launch on `stream` and do not synchronise.

int lmip_rays(const void* vol, void* out, int dtype, int64_t n,
              int64_t ray_stride, int64_t rows, int64_t cols,
              int64_t row_stride, int64_t col_stride, float tmin, float tmax,
              void* stream) {
    if (bad_shape(n, rows, cols)) return -1;
    cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
    switch (dtype) {
        case 0: return launch_lmip<float>(vol, out, n, ray_stride, rows, cols,
                                          row_stride, col_stride, tmin, tmax, s);
        case 1: return launch_lmip<int16_t>(vol, out, n, ray_stride, rows, cols,
                                            row_stride, col_stride, tmin, tmax, s);
        case 2: return launch_lmip<uint8_t>(vol, out, n, ray_stride, rows, cols,
                                            row_stride, col_stride, tmin, tmax, s);
        default: return -1;
    }
}

int mida_rays(const void* vol, void* out, int dtype, int64_t n,
              int64_t ray_stride, int64_t rows, int64_t cols,
              int64_t row_stride, int64_t col_stride, const void* minmax,
              float wl, float ww, void* stream) {
    if (bad_shape(n, rows, cols)) return -1;
    cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
    const float* mm = (const float*)minmax;
    float* o = (float*)out;
    switch (dtype) {
        case 0: return launch_mida<float>(vol, o, n, ray_stride, rows, cols,
                                          row_stride, col_stride, mm, wl, ww, s);
        case 1: return launch_mida<int16_t>(vol, o, n, ray_stride, rows, cols,
                                            row_stride, col_stride, mm, wl, ww, s);
        case 2: return launch_mida<uint8_t>(vol, o, n, ray_stride, rows, cols,
                                            row_stride, col_stride, mm, wl, ww, s);
        default: return -1;
    }
}

}  // extern "C"
