// The weight gradient of a 3D convolution with one input or one output
// channel (stride 1, zero padding k / 2, k 1 or 5, at most 8 channels on
// the other side), summed in float32 and rounded once to the gradient's
// type.
//
// It replaces no TPU kernel: the JAX package leaves this gradient to XLA.
// It was added because cuDNN's wgrad2d_grouped_direct_kernel, which cuDNN
// picks (TF32 off) for the U-Net's 1^3 head (8 -> 1 channels, float32),
// took 108-110 ms of a 257-ms training step at 8 patches of 96^3 on an
// H100 (42%); the first convolution (1 -> 8, 5^3, bf16) is the other
// single-channel convolution, 7.8 ms on cuDNN.
//
// What it computes.  With `a` the side of C <= 8 channels and `b` the
// single channel, both (N, ., D, H, W) contiguous,
//
//   out[c, kd, kh, kw] = sum_{n, d, h, w} a[n, c, d, h, w]
//                        * b[n, 0, d + kd - p, h + kh - p, w + kw - p]
//
// (b is 0 outside the volume).  For one input channel, a is dy and b is x,
// and dW[c, 0] = out[c].  For one output channel, a is x and b is dy, and
// dW[0, c, t] = out[c, k^3 - 1 - t]: the same sum with the taps mirrored.
//
// What bounds it on an H100.  In the training step at 8 patches of 96^3:
// - the first convolution (1 -> 8, 5^3, bf16) must read x (14.2 MB) and dy
//   (113.2 MB) once, 38 us at 3.35 TB/s, and do 7.08 G multiply-adds, 0.21
//   ms at the card's float32 peak at its 1980-MHz clock (132 SMs x 128
//   lanes: 33.4 T a second; a loop of FMAs alone reached 30.7 T, 0.23 ms),
//   the bound this design runs against;
// - the head (8 -> 1, 1^3, float32) must read 254.8 MB: 76 us.
// float32 inputs rule out bf16 tensor-core products for the head, and one
// design serves both.
//
// Design.  A thread group ("unit") of one (kd, kh) pair per tile row, a
// persistent grid walking tiles of TD x TH x TW voxels of one sample (block
// b takes tiles b, b + gridDim.x, ...):
// - The tile's C channels of a (converted to float32, a voxel's channels
//   side by side, rows padded so that neighbouring rows fall on other banks)
//   and b with its k - 1 halo (a warp a row) are staged in shared memory
//   from registers; the next tile's loads are issued before this tile is
//   summed, so they arrive while it is.
// - A thread owns one row of the tile and one (kd, kh): it walks the row in
//   chunks of k voxels keeping the k taps of b in registers (one new load a
//   voxel) and C x k float32 sums, so a voxel costs two 16-byte loads of a,
//   one load of b and C x k fused multiply-adds.
// - After the last tile the threads of a unit add their sums (shuffles,
//   then shared memory in a fixed order) and the block writes its C x k^3
//   partial sums to a float32 scratch row.  conv_wgrad_sum adds the rows
//   in a fixed order (a warp an output) and rounds once.  No atomics: a
//   card gives the same bits on every call.
//
// Measured (chip_smoke.py [19]; NVIDIA H100 80GB HBM3, 700 W): the first
// convolution 0.67 ms (31% of the float32 peak, where cuDNN took 7.8 ms),
// the head 0.124 ms (61% of its byte bound, where cuDNN's direct kernel
// took 110 ms).  The first convolution is held back by staging (bf16
// inputs, and b's halo read about 4.9 times): float32 inputs of the same
// shape take 0.59 ms, and the multiply-adds alone (shared-memory loads of
// the inner loop removed) 0.70.  Two units a thread, wider tiles, two
// blocks an SM and fully unrolled rows were all slower.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

template <int K> struct TileShape;
template <> struct TileShape<5> { static constexpr int TD = 2, TH = 8, TW = 50; };
template <> struct TileShape<1> { static constexpr int TD = 16, TH = 8, TW = 8; };

constexpr int CP = 8;  // the kernel's channels: fewer are zero

template <int K>
struct Geo {
    static constexpr int TD = TileShape<K>::TD, TH = TileShape<K>::TH, TW = TileShape<K>::TW;
    static constexpr int R = TD * TH;         // rows of a tile: one thread of each unit a row
    static constexpr int U = K * K;           // units, one (kd, kh) each
    static constexpr int THREADS = U * R;
    static constexpr int HD = TD + K - 1, HH = TH + K - 1, HW = TW + K - 1;  // b with its halo
    static constexpr int RW = HW | 1;         // an odd row pitch: a warp's rows on other banks
    static constexpr int PLANE = HH * RW;
    static constexpr int B_WORDS = HD * PLANE;
    // a's row pitch in floats: rows 16 bytes apart mod 128, so the 8 rows
    // of one load phase hit other banks, and every voxel stays aligned for
    // its 16-byte loads
    static constexpr int APITCH = TW * CP + 4;
    static constexpr int A_WORDS = R * APITCH;
    static constexpr int A_VOX = R * TW;
    static constexpr int A_ROUNDS = (A_VOX + THREADS - 1) / THREADS;
    // b's halo rows go to the block's whole warps: a warp takes RPW rows at
    // once (rows shorter than a warp) or one row in B_PASSES passes
    static constexpr int WARPS = THREADS / 32;
    static constexpr int B_ROWS = HD * HH;
    static constexpr int RPW = HW < 32 ? 32 / HW : 1;
    static constexpr int B_PASSES = HW < 32 ? 1 : (HW + 31) / 32;
    static constexpr int B_ROUNDS = (B_ROWS + WARPS * RPW - 1) / (WARPS * RPW);
    static constexpr int GROUP = R < 32 ? R : 32;  // a unit's threads inside one warp
    static constexpr int K3 = K * K * K;
    static constexpr int OUT = CP * K3;            // a block's partial sums
    static_assert(32 % GROUP == 0 && R % GROUP == 0, "a unit's rows fill whole lane groups");
    static_assert(TW % K == 0, "a row is walked in chunks of K voxels");
    static_assert(WARPS > 0, "b's rows need a whole warp");
    static_assert((THREADS / GROUP) * CP * K <= A_WORDS, "the unit sums fit in a's tile");
    static_assert((A_WORDS + B_WORDS) * 4 <= 48 * 1024, "static shared memory");
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
    return __float2bfloat16_rn(v);
}

// a voxel's CP floats (aligned to 16 bytes) at p to or from registers
__device__ __forceinline__ void load_vec(const float* p, float (&v)[CP]) {
#pragma unroll
    for (int i = 0; i < CP; i += 4) {
        const float4 q = *reinterpret_cast<const float4*>(p + i);
        v[i] = q.x; v[i + 1] = q.y; v[i + 2] = q.z; v[i + 3] = q.w;
    }
}

__device__ __forceinline__ void store_vec(float* p, const float (&v)[CP]) {
#pragma unroll
    for (int i = 0; i < CP; i += 4)
        *reinterpret_cast<float4*>(p + i) = make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
}

// a: (N, C, D, H, W), b: (N, 1, D, H, W); partial: [gridDim.x][CP][K^3]
template <typename T, int K>
__global__ void __launch_bounds__(Geo<K>::THREADS)
conv_wgrad_kernel(const T* __restrict__ a, const T* __restrict__ b,
                  float* __restrict__ partial, int C, int D, int H, int W, int64_t tiles) {
    using G = Geo<K>;
    constexpr int P = K / 2;
    __shared__ __align__(16) float smem[G::A_WORDS + G::B_WORDS];
    float* a_s = smem;
    float* b_s = smem + G::A_WORDS;

    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int unit = tid / G::R, row = tid % G::R;
    const int dd = row / G::TH, hh = row % G::TH;
    const float* arow = a_s + row * G::APITCH;
    const float* brow = b_s + (dd + unit / K) * G::PLANE + (hh + unit % K) * G::RW;
    // this lane's place in b's rows
    const int sub = G::RPW > 1 ? lane / G::HW : 0, col = G::RPW > 1 ? lane % G::HW : lane;

    const int ntd = (D + G::TD - 1) / G::TD, nth = (H + G::TH - 1) / G::TH,
              ntw = (W + G::TW - 1) / G::TW;
    const int64_t hw = int64_t(H) * W, dhw = hw * D;

    float acc[CP][K];
#pragma unroll
    for (int c = 0; c < CP; ++c)
#pragma unroll
        for (int q = 0; q < K; ++q) acc[c][q] = 0.f;

    // a tile's loads into registers: every load of the next tile is in
    // flight while this one is summed
    float av[G::A_ROUNDS][CP];
    float bv[G::B_ROUNDS][G::B_PASSES];
    auto load = [&](int64_t tile) {
        int64_t t = tile;
        const int tw = int(t % ntw); t /= ntw;
        const int th = int(t % nth); t /= nth;
        const int td = int(t % ntd);
        const int64_t n = t / ntd;
        const int d0 = td * G::TD, h0 = th * G::TH, w0 = tw * G::TW;
#pragma unroll
        for (int i = 0; i < G::A_ROUNDS; ++i) {
            const int v = tid + i * G::THREADS;
            const int r = v / G::TW, w = w0 + v % G::TW;
            const int d = d0 + r / G::TH, h = h0 + r % G::TH;
            const bool in = v < G::A_VOX && d < D && h < H && w < W;
            const T* p = a + n * C * dhw + d * hw + int64_t(h) * W + w;
#pragma unroll
            for (int c = 0; c < CP; ++c)
                av[i][c] = (in && c < C) ? to_float(p[c * dhw]) : 0.f;
        }
#pragma unroll
        for (int i = 0; i < G::B_ROUNDS; ++i) {
            const int rr = (warp + i * G::WARPS) * G::RPW + sub;
            const int d = d0 - P + rr / G::HH, h = h0 - P + rr % G::HH;
            const bool row_in = warp < G::WARPS && sub < G::RPW && rr < G::B_ROWS &&
                                d >= 0 && d < D && h >= 0 && h < H;
            const T* p = b + n * dhw + d * hw + int64_t(h) * W + (w0 - P);
#pragma unroll
            for (int m = 0; m < G::B_PASSES; ++m) {
                const int x = col + 32 * m, w = w0 - P + x;
                bv[i][m] = (row_in && x < G::HW && w >= 0 && w < W) ? to_float(p[x]) : 0.f;
            }
        }
    };

    if (blockIdx.x < tiles) load(blockIdx.x);
    for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        __syncthreads();  // the previous tile's sums are done with shared memory
#pragma unroll
        for (int i = 0; i < G::A_ROUNDS; ++i) {
            const int v = tid + i * G::THREADS;
            if (v < G::A_VOX)
                store_vec(a_s + (v / G::TW) * G::APITCH + (v % G::TW) * CP, av[i]);
        }
#pragma unroll
        for (int i = 0; i < G::B_ROUNDS; ++i) {
            const int rr = (warp + i * G::WARPS) * G::RPW + sub;
#pragma unroll
            for (int m = 0; m < G::B_PASSES; ++m) {
                const int x = col + 32 * m;
                if (warp < G::WARPS && sub < G::RPW && rr < G::B_ROWS && x < G::HW)
                    b_s[(rr / G::HH) * G::PLANE + (rr % G::HH) * G::RW + x] = bv[i][m];
            }
        }
        __syncthreads();
        if (tile + gridDim.x < tiles) load(tile + gridDim.x);

        // b's taps for voxel w sit in slots (w + q) % K, so the walk keeps
        // them in registers through chunks of K voxels, the chunk unrolled
        float bw[K];
#pragma unroll
        for (int q = 0; q < K - 1; ++q) bw[q] = brow[q];
#pragma unroll 1
        for (int w0 = 0; w0 < G::TW; w0 += K) {
#pragma unroll
            for (int s = 0; s < K; ++s) {
                const int w = w0 + s;
                bw[(s + K - 1) % K] = brow[w + K - 1];
                float x[CP];
                load_vec(arow + w * CP, x);
#pragma unroll
                for (int c = 0; c < CP; ++c)
#pragma unroll
                    for (int q = 0; q < K; ++q)
                        acc[c][q] = fmaf(x[c], bw[(s + q) % K], acc[c][q]);
            }
        }
    }

    // a unit's rows: first the lanes of one warp, then its warps in order
    const int lanes = min(32, G::THREADS - (tid & ~31));
    const unsigned mask = lanes == 32 ? 0xffffffffu : (1u << lanes) - 1u;
#pragma unroll
    for (int off = G::GROUP / 2; off > 0; off /= 2)
#pragma unroll
        for (int c = 0; c < CP; ++c)
#pragma unroll
            for (int q = 0; q < K; ++q) acc[c][q] += __shfl_xor_sync(mask, acc[c][q], off);
    __syncthreads();  // the last tile is done with shared memory
    float* red = smem;  // [THREADS / GROUP][CP][K]
    if (tid % G::GROUP == 0) {
#pragma unroll
        for (int c = 0; c < CP; ++c)
#pragma unroll
            for (int q = 0; q < K; ++q) red[((tid / G::GROUP) * CP + c) * K + q] = acc[c][q];
    }
    __syncthreads();
    constexpr int GROUPS = G::R / G::GROUP;  // lane groups of one unit
    for (int o = tid; o < G::OUT; o += G::THREADS) {
        const int c = o / G::K3, tap = o % G::K3, u = tap / K, q = tap % K;
        float s = 0.f;
        for (int g = 0; g < GROUPS; ++g) s += red[((u * GROUPS + g) * CP + c) * K + q];
        partial[int64_t(blockIdx.x) * G::OUT + o] = s;
    }
}

// dw[c * K3 + (mirror ? K3 - 1 - t : t)] = the sum over `rows` partial rows
// of [row][c][t], a warp an output, in a fixed order
template <typename T>
__global__ void conv_wgrad_sum(const float* __restrict__ partial, int rows, int stride,
                               int C, int K3, int mirror, T* __restrict__ dw) {
    const int o = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    if (o >= C * K3) return;  // whole warps leave together
    float s = 0.f;
    for (int r = lane; r < rows; r += 32) s += partial[int64_t(r) * stride + o];
#pragma unroll
    for (int off = 16; off > 0; off /= 2) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) {
        const int c = o / K3, t = o % K3;
        dw[c * K3 + (mirror ? K3 - 1 - t : t)] = from_float<T>(s);
    }
}

template <typename T, int K>
int launch(const void* a, const void* b, float* partial, void* dw, int N, int C, int D, int H,
           int W, int mirror, int grid, cudaStream_t s) {
    using G = Geo<K>;
    if (grid <= 0) {  // the query: resident blocks on the whole card
        int dev = 0, sms = 0, per_sm = 0;
        if (cudaGetDevice(&dev) != cudaSuccess ||
            cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
            cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, conv_wgrad_kernel<T, K>,
                                                          G::THREADS, 0) != cudaSuccess)
            return -1;
        return per_sm > 0 ? per_sm * sms : -1;
    }
    const int64_t tiles = int64_t(N) * ((D + G::TD - 1) / G::TD) *
                          ((H + G::TH - 1) / G::TH) * ((W + G::TW - 1) / G::TW);
    const int rows = int(tiles < grid ? tiles : grid);
    conv_wgrad_kernel<T, K><<<rows, G::THREADS, 0, s>>>(
        static_cast<const T*>(a), static_cast<const T*>(b), partial, C, D, H, W, tiles);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return int(e);
    const int warps = 8, outs = C * G::K3;
    conv_wgrad_sum<T><<<(outs + warps - 1) / warps, warps * 32, 0, s>>>(
        partial, rows, G::OUT, C, G::K3, mirror, static_cast<T*>(dw));
    return int(cudaGetLastError());
}

template <typename T>
int dispatch_k(int K, int C, const void* a, const void* b, float* partial, void* dw, int N,
               int D, int H, int W, int mirror, int grid, cudaStream_t s) {
    if (K == 1) return launch<T, 1>(a, b, partial, dw, N, C, D, H, W, mirror, grid, s);
    return launch<T, 5>(a, b, partial, dw, N, C, D, H, W, mirror, grid, s);
}

int checked(int K, int C, int N, int D, int H, int W, int dtype) {
    return (K == 1 || K == 5) && C >= 1 && C <= 8 && N >= 1 && D >= 1 && H >= 1 &&
           W >= 1 && (dtype == 0 || dtype == 1);
}

}  // namespace

extern "C" {

// Blocks of the (K, dtype) kernel that the current card holds at once: the
// scratch rows a call needs at most.  dtype 0 is float32, 1 bfloat16.
// Returns -1 when the card cannot be asked or the arguments are not taken.
int conv_wgrad_grid(int K, int dtype) {
    if (!checked(K, 1, 1, 1, 1, 1, dtype)) return -1;
    cudaStream_t s = nullptr;
    return dtype == 1
        ? dispatch_k<__nv_bfloat16>(K, 1, nullptr, nullptr, nullptr, nullptr, 1, 1, 1, 1, 0, 0, s)
        : dispatch_k<float>(K, 1, nullptr, nullptr, nullptr, nullptr, 1, 1, 1, 1, 0, 0, s);
}

// dw (C * K^3 elements of dtype) from a (N, C, D, H, W) and b (N, 1, D,
// H, W), with `partial` a float32 scratch of grid * 8 * K^3 (the kernel's
// 8 channels, those past C zero) and grid from conv_wgrad_grid; mirror != 0
// stores each channel's taps mirrored (one output channel).  Two launches
// on `stream`.  Returns cudaGetLastError() after them (0 on success), or
// -1 for an argument the kernel does not take.
int conv_wgrad(const void* a, const void* b, void* partial, void* dw, int N, int C, int D,
               int H, int W, int K, int mirror, int dtype, int grid, void* stream) {
    if (!checked(K, C, N, D, H, W, dtype) || grid <= 0) return -1;
    cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
    float* p = static_cast<float*>(partial);
    return dtype == 1
        ? dispatch_k<__nv_bfloat16>(K, C, a, b, p, dw, N, D, H, W, mirror, grid, s)
        : dispatch_k<float>(K, C, a, b, p, dw, N, D, H, W, mirror, grid, s);
}

}  // extern "C"
