// The transition between two convolutions of FastSurferCNN's competitive
// dense block (models/fastsurfer.py), in one pass over an NCHW tensor:
//
//   r   = ((float(y) - mean[c]) * mul[c]) + bias[c]    with a norm; else float(y)
//   m   = maximum(r, skip)                             with a maxout partner; else r
//   out = m                                            float32, when asked
//   act = where(m >= 0, m, slope * m)                  with a PReLU; else m,
//         cast to the next convolution's type (bfloat16 or float32), when asked
//
// with mul[c] = rsqrt(running_var[c] + eps) * weight[c], made by the caller
// with BatchNorm.forward's own expression.  The result is bit for bit that
// of the eager modules (BatchNorm, torch.maximum, PReLU, Tensor.to): each
// step rounds once in float32 (__fsub_rn / __fmul_rn / __fadd_rn, and the
// library is built with -fmad=false, so no product and sum is contracted
// into a fused multiply-add); the PReLU compares m >= 0, so -0.0 keeps its
// sign; the maximum propagates NaN and then takes fmaxf, as torch's CUDA
// maximum does; the cast is __float2bfloat16_rn, c10::BFloat16's on sm_80+.
//
// It replaces no TPU kernel: the JAX package leaves these layers to XLA,
// which fuses them.  It was added because the eager modules made about nine
// float32 passes and launches of each transition (the norm's broadcast sub,
// mul and add, the maximum, PReLU's compare, multiply and where, the cast),
// 66% of the parcellation's device time on an H100.
//
// What bounds it on an H100.  It is a stream: at a middle transition it
// reads the bf16 convolution output (2 B an element) and the float32
// partner (4 B), and writes the float32 maximum (4 B) and the bf16 input of
// the next convolution (2 B): 12 B an element, 0.40 GB at 8 x 64 x 256^2,
// 0.120 ms at 3.35 TB/s.  The per-channel terms and the slope are a few
// hundred bytes, read through the L1 cache.
//
// Design.  A thread takes 8 consecutive elements at a time: 16-byte loads
// and stores (8 bf16, or two of 4 float32).  H * W is a multiple of 8 at
// every level of a 256^2 network (down to 16^2), so the 8 share one channel,
// taken once from the flat index; other shapes or unaligned pointers take
// the same kernel one element at a time.  A grid-stride loop over a grid of
// 8 blocks of 256 threads an SM (the SM's 2048 threads) keeps about 96 KB of
// loads in flight on each SM.  It launches on the caller's stream and
// allocates nothing.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int BLOCKS_PER_SM = 2048 / THREADS;
constexpr int MAX_DEVICES = 64;

enum Flags { NORM = 1, MAXOUT = 2, OUT = 4, ACT = 8, PRELU = 16 };

__device__ __forceinline__ void load(const float* p, float (&v)[1]) { v[0] = p[0]; }
__device__ __forceinline__ void load(const __nv_bfloat16* p, float (&v)[1]) {
    v[0] = __bfloat162float(p[0]);
}
__device__ __forceinline__ void store(float* p, const float (&v)[1]) { p[0] = v[0]; }
__device__ __forceinline__ void store(__nv_bfloat16* p, const float (&v)[1]) {
    p[0] = __float2bfloat16_rn(v[0]);
}

__device__ __forceinline__ void load(const float* p, float (&v)[8]) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load(const __nv_bfloat16* p, float (&v)[8]) {
    const uint4 q = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // a bf16 is the top half of its float32
        v[2 * i] = __uint_as_float(w[i] << 16);
        v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
}
__device__ __forceinline__ void store(float* p, const float (&v)[8]) {
    reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store(__nv_bfloat16* p, const float (&v)[8]) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
        w[i] = uint32_t(__bfloat16_as_ushort(__float2bfloat16_rn(v[2 * i]))) |
               (uint32_t(__bfloat16_as_ushort(__float2bfloat16_rn(v[2 * i + 1]))) << 16);
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

// torch.maximum's CUDA kernel: a NaN of either side, else fmaxf
__device__ __forceinline__ float torch_maximum(float a, float b) {
    if (a != a) return a;
    if (b != b) return b;
    return fmaxf(a, b);
}

// y, skip, out, act: n elements (N, C, H, W) contiguous, taken V at a time
// ("groups"); hw_groups = H * W / V, so a group lies in one channel.
template <typename TIn, typename TAct, int V>
__global__ void __launch_bounds__(THREADS)
cdb_epilogue_kernel(const TIn* __restrict__ y, const float* __restrict__ mean,
                    const float* __restrict__ mul, const float* __restrict__ bias,
                    const float* __restrict__ skip, const float* __restrict__ slope_p,
                    float* __restrict__ out, TAct* __restrict__ act, int64_t groups,
                    int64_t hw_groups, int C, int flags) {
    const float slope = (flags & PRELU) ? __ldg(slope_p) : 0.0f;
    const int64_t stride = int64_t(gridDim.x) * THREADS;
    for (int64_t g = int64_t(blockIdx.x) * THREADS + threadIdx.x; g < groups; g += stride) {
        const int64_t i = g * V;
        float v[V];
        load(y + i, v);
        if (flags & NORM) {
            const int c = int((g / hw_groups) % C);
            const float mu = __ldg(mean + c), k = __ldg(mul + c), b = __ldg(bias + c);
#pragma unroll
            for (int j = 0; j < V; ++j) v[j] = __fadd_rn(__fmul_rn(__fsub_rn(v[j], mu), k), b);
        }
        if (flags & MAXOUT) {
            float s[V];
            load(skip + i, s);
#pragma unroll
            for (int j = 0; j < V; ++j) v[j] = torch_maximum(v[j], s[j]);
        }
        if (flags & OUT) store(out + i, v);
        if (flags & ACT) {
            if (flags & PRELU) {
#pragma unroll
                for (int j = 0; j < V; ++j) v[j] = v[j] >= 0.0f ? v[j] : __fmul_rn(slope, v[j]);
            }
            store(act + i, v);
        }
    }
}

int sm_count() {
    static int sms[MAX_DEVICES];
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= MAX_DEVICES) return -1;
    if (sms[dev] == 0 &&
        cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
        return -1;
    return sms[dev];
}

template <typename TIn, typename TAct, int V>
int launch(const void* y, const float* mean, const float* mul, const float* bias,
           const float* skip, const float* slope, float* out, void* act, int64_t n, int64_t hw,
           int C, int flags, cudaStream_t s) {
    const int sms = sm_count();
    if (sms <= 0) return -1;
    const int64_t groups = n / V;
    const int64_t want = (groups + THREADS - 1) / THREADS;
    const int grid = int(want < int64_t(sms) * BLOCKS_PER_SM ? want : int64_t(sms) * BLOCKS_PER_SM);
    cdb_epilogue_kernel<TIn, TAct, V><<<grid, THREADS, 0, s>>>(
        static_cast<const TIn*>(y), mean, mul, bias, skip, slope, out, static_cast<TAct*>(act),
        groups, hw / V, C, flags);
    return int(cudaGetLastError());
}

template <int V>
int dispatch(int y_bf16, int act_bf16, const void* y, const float* mean, const float* mul,
             const float* bias, const float* skip, const float* slope, float* out, void* act,
             int64_t n, int64_t hw, int C, int flags, cudaStream_t s) {
    if (y_bf16 && act_bf16)
        return launch<__nv_bfloat16, __nv_bfloat16, V>(y, mean, mul, bias, skip, slope, out, act,
                                                       n, hw, C, flags, s);
    if (y_bf16)
        return launch<__nv_bfloat16, float, V>(y, mean, mul, bias, skip, slope, out, act, n, hw,
                                               C, flags, s);
    if (act_bf16)
        return launch<float, __nv_bfloat16, V>(y, mean, mul, bias, skip, slope, out, act, n, hw,
                                               C, flags, s);
    return launch<float, float, V>(y, mean, mul, bias, skip, slope, out, act, n, hw, C, flags, s);
}

bool aligned(const void* p) { return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

extern "C" {

// One transition on `stream` (see the top of this file).  y is float32
// (y_bf16 0) or bfloat16 (1), n elements of (N, C, H, W), hw = H * W; mean,
// mul and bias are C float32 each (NORM); skip is n float32 (MAXOUT); slope
// one float32 (PRELU); out n float32 (OUT); act n elements of float32
// (act_bf16 0) or bfloat16 (1) (ACT).  Pointers a flag does not ask for may
// be null.  Returns cudaGetLastError() after the launch (0 on success), or
// -1 for an argument the kernel does not take.
int cdb_epilogue(const void* y, int y_bf16, const void* mean, const void* mul,
                 const void* bias, const void* skip, const void* slope, void* out, void* act,
                 int act_bf16, int64_t n, int64_t hw, int C, int flags, void* stream) {
    const bool norm = flags & NORM, maxout = flags & MAXOUT, write = flags & OUT,
               activate = flags & ACT, prelu = flags & PRELU;
    if (y == nullptr || n <= 0 || hw <= 0 || C <= 0 || n % (hw * C) != 0 ||
        flags & ~(NORM | MAXOUT | OUT | ACT | PRELU) || !(write || activate) ||
        (prelu && !activate) || (norm && (!mean || !mul || !bias)) || (maxout && !skip) ||
        (prelu && !slope) || (write && !out) || (activate && !act))
        return -1;
    const float *m = norm ? static_cast<const float*>(mean) : nullptr,
                *k = norm ? static_cast<const float*>(mul) : nullptr,
                *b = norm ? static_cast<const float*>(bias) : nullptr,
                *sk = maxout ? static_cast<const float*>(skip) : nullptr,
                *sl = prelu ? static_cast<const float*>(slope) : nullptr;
    float* o = write ? static_cast<float*>(out) : nullptr;
    void* a = activate ? act : nullptr;
    cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
    // 8 at a time where a group of 8 lies in one channel and every array
    // it moves is 16-byte aligned
    if (hw % 8 == 0 && aligned(y) && aligned(sk) && aligned(o) && aligned(a))
        return dispatch<8>(y_bf16, act_bf16, y, m, k, b, sk, sl, o, a, n, hw, C, flags, s);
    return dispatch<1>(y_bf16, act_bf16, y, m, k, b, sk, sl, o, a, n, hw, C, flags, s);
}

}  // extern "C"
