// Slab ray projections of the 2D slice viewer: LMIP and MIDA, and MIDA's
// min/max pass.
//
// Replaces the TPU kernels lmip_axis0 (_lmip_kernel) and mida_axis0
// (_mida_kernel) of invesalius3_tpu/ops/pallas_kernels.py, with the slab's
// min and max that mida_axis0 leaves to XLA.  Each ray is walked by one
// thread with its carry in registers; it stops where the TPU kernel's
// per-pixel "stopped" flag would freeze the carry (after that step neither
// kernel changes its output), so the early stop is exact.
//
//   LMIP: running max; once a value in [tmin, tmax] has been seen, the
//         first strict decrease ends the ray (projections.lmip_scan).
//   MIDA: fpi = (v - img_min) / rng; dl = max(fpi - fmax, 0); bt = 1 - dl;
//         alpha = clip((v - min_v) / (max_v - min_v), 0, 1);
//         colour = bt * colour_p + ((1 - bt * alpha_p) * fpi) * alpha;
//         alpha_p = bt * alpha_p + (1 - bt * alpha_p) * alpha;
//         stop once alpha_p >= 1; out = rng * colour_p + img_min
//         (projections.mida_scan), cast to the slab's dtype in the store.
//
// Exactness against the plain PyTorch versions: this file is built with
// -fmad=false, so every product and sum rounds on its own as PyTorch's
// separate elementwise kernels do, and division stays IEEE (no fast math).
// max and clip are comparisons that let NaN through, like jnp.maximum /
// torch.clamp (fmaxf and fminf would drop it): a constant slab (rng = 0) or
// a zero-width window gives NaN.  An integer output is stored with JAX's
// astype rule (NaN -> 0, saturate, truncate toward zero), so it equals
// cast_like_jax of the float result bit for bit.
//
// Input: any 3-D strided view (a narrowed slab, any projection axis) of
// float32, int16 or uint8.  A ray is n elements ray_stride apart; the output
// plane (rows, cols) has input strides row_stride / col_stride and is
// written contiguous in the input's dtype.
//
// What bounds it on an H100: device-memory bytes.  At 512^3 int16 a full
// walk reads 256 MiB, 0.080 ms at 3.35 TB/s; LMIP's rays stop early and
// need less.  MIDA reads the slab twice (min/max pass, then the walk): at
// full depth the slab is five times the 50 MB L2, so half the bound is its
// ceiling.  The design, per route:
//
// - min/max pass (minmax_kernel): a grid-stride reduction over tiles of
//   16-byte vectors (each block reads whole contiguous tiles; a strided
//   element walk where the slab has no contiguous run), one partial per
//   block, folded by the last block to finish (a counter in the workspace,
//   reset by that block).  Any NaN gives NaN, as jnp.min does.  The last
//   block also fills MIDA's per-value table (below).
// - MIDA's table: for int16 and uint8 slabs fpi and alpha depend only on the
//   value, so the last block computes them once per value in [min, max]
//   with the walk's own operations, and each walking block copies them into
//   shared memory: the walk then does one 8-byte shared load per element
//   instead of two divisions and a clip.  When max - min + 1 exceeds
//   kTableCap the same kernels compute per element.
// - columns route (neighbouring rays adjacent or strided: axes 0 and 1):
//   one ray a thread, walked straight from device memory with 4 (LMIP) or
//   8 (MIDA) steps of loads in flight; a warp's lanes read neighbouring
//   columns, so each step's loads coalesce.  LMIP's rays stop early, and
//   every load past the stop is wasted; MIDA has more arithmetic a step
//   to hide.
// - rows route (the rays are contiguous rows, ray_stride 1: axis 2, where
//   a thread walking its row from device memory touches a new line every
//   step): a warp owns 32 rays and copies them in chunks of 128 bytes a ray
//   with 16-byte cp.async into a two-stage ring in shared memory (rows
//   padded to 144 bytes, so the 32 lanes' 16-byte reads hit every bank
//   once); each lane walks its ray from shared memory.  A ray is copied from
//   its 16-byte aligned frame and the walker skips the elements around it,
//   so any base, row and column stride takes the same path.  The warp
//   stops fetching once all its rays have stopped.
//
// Measured (time_rays.py; NVIDIA H100 80GB HBM3, 700 W; PERF.md has the
// tables), 512^3 int16, full depth, the frame's window: LMIP 0.19 / 0.19 /
// 0.14 ms on axes 0 / 1 / 2 (one thread a ray walking axis 2 straight from
// device memory took 0.48); MIDA 0.31 / 0.31 / 0.29 ms, of which the
// min/max pass is 0.09 (torch.aminmax 0.10).  Staging axes 0 and 1 through
// the same shared-memory ring (a step of 128 adjacent bytes a ring row),
// 2 or 4 rays a thread with vector loads, and deeper load batches were all
// slower there; without the table MIDA took 0.47-0.55 ms.

#include <cmath>
#include <cstdint>
#include <mutex>
#include <utility>
#include <vector>

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;            // warps a block of either route (one table)
constexpr int kThreads = kWarps * 32;
constexpr int kLmipBatch = 4;        // columns route: LMIP steps of loads in flight
constexpr int kMidaBatch = 8;        // columns route: MIDA steps of loads in flight
constexpr int kVecs = 8;             // rows route: a ring row's 16-byte vectors
constexpr int kPitch = kVecs + 1;    // rows route: a ring row, padded, in vectors
constexpr int kStageBytes = 32 * kPitch * 16;
constexpr int kRingBytes = kWarps * 2 * kStageBytes;
constexpr int kTableCap = 4096;      // MIDA table entries (int16; uint8: 256)
constexpr int kMinmaxThreads = 256;  // min/max pass: threads a block
constexpr int kMinmaxUnroll = 2;     // min/max pass: 16-byte loads in flight
constexpr int kMaxBlocks = 1024;     // min/max pass: most blocks

// workspace: counter | min, max, table flag | per-block partials | table
constexpr size_t kMinMaxOff = 16;
constexpr size_t kPartialOff = 32;
constexpr size_t kTableOff = kPartialOff + 8 * kMaxBlocks;
constexpr size_t kWorkspaceBytes = kTableOff + 8 * kTableCap;

template <typename T, int R>
struct alignas(sizeof(T) * R) Pack {
    T v[R];
};

template <typename T>
__host__ __device__ constexpr bool is_int() { return sizeof(T) < 4; }   // int16_t, uint8_t

template <typename T>
__host__ __device__ constexpr int table_cap() { return is_int<T>() ? (sizeof(T) == 1 ? 256 : kTableCap) : 0; }

// jnp.maximum: NaN if either is NaN
__device__ __forceinline__ float max_nan(float a, float b) {
    return (a > b || a != a) ? a : b;
}

// the float result as the output dtype, with jnp.astype's rule
template <typename T>
__device__ __forceinline__ T store_cast(float x) {
    if (!is_int<T>()) return static_cast<T>(x);
    const float lo = sizeof(T) == 1 ? 0.0f : -32768.0f;
    const float hi = sizeof(T) == 1 ? 255.0f : 32767.0f;
    if (x != x) return T(0);
    if (x >= hi) return static_cast<T>(hi);
    if (x <= lo) return static_cast<T>(lo);
    return static_cast<T>(x);   // truncates toward zero
}

struct Geometry {   // a plane of rays over a strided 3-D view (elements)
    int64_t n, ray_stride, rows, cols, row_stride, col_stride;
};

struct Flat {       // a view as d0 x d1 runs of len elements s2 apart
    int64_t d0, d1, len, s0, s1, s2;
};

struct Lmip {
    float m;
    bool start, running;
    __device__ void init(float v, float tmin, float tmax, bool live) {
        m = v;
        start = v >= tmin && v <= tmax;
        running = live;
    }
    // (stepping the first element again changes nothing)
    __device__ __forceinline__ void step(float v, float tmin, float tmax) {
        if (!running) return;
        if (start && v < m) {   // the first strict decrease
            running = false;
            return;
        }
        if (v > m) m = v;
        if (v >= tmin && v <= tmax) start = true;
    }
};

struct MidaParams {
    float img_min, rng, min_v, span;
    __device__ MidaParams(const float* mm, float wl, float ww) {
        img_min = mm[0];
        rng = mm[1] - img_min;
        const float half = ww / 2.0f;
        min_v = wl - half;
        const float max_v = wl + half;
        span = max_v - min_v;
    }
    __device__ __forceinline__ float2 value(float v) const {   // fpi, alpha
        const float fpi = (v - img_min) / rng;
        float a = (v - min_v) / span;
        a = a < 0.0f ? 0.0f : a;                  // NaN passes
        a = a > 1.0f ? 1.0f : a;
        return make_float2(fpi, a);
    }
};

struct Mida {
    float fmax = 0.0f, alpha_p = 0.0f, colour_p = 0.0f;
    bool running = true;
    __device__ __forceinline__ void step(float2 fa) {
        if (!running) return;
        const float fpi = fa.x, alpha = fa.y;
        const float d = fpi - fmax;
        const float dl = d < 0.0f ? 0.0f : d;     // NaN passes
        const float bt = 1.0f - dl;
        const float keep = 1.0f - bt * alpha_p;
        colour_p = bt * colour_p + (keep * fpi) * alpha;
        alpha_p = bt * alpha_p + keep * alpha;
        fmax = max_nan(fmax, fpi);
        if (alpha_p >= 1.0f) running = false;     // this step committed
    }
};

// fpi and alpha of a value: the table's row, or computed
template <typename T, bool TABLE>
struct Lookup {
    MidaParams p;
    const float2* table;
    int imin;
    __device__ __forceinline__ float2 operator()(T v) const {
        if (TABLE) return table[(int)v - imin];
        return p.value(static_cast<float>(v));
    }
};

__device__ __forceinline__ const float* ws_minmax(const char* ws) {
    return reinterpret_cast<const float*>(ws + kMinMaxOff);
}
__device__ __forceinline__ int ws_use_table(const char* ws) {
    return reinterpret_cast<const int*>(ws + kMinMaxOff)[2];
}

// The block copies the table from the workspace into shared memory (every
// thread of the block must call it).
__device__ void load_table(float2* table, const char* ws) {
    const float* mm = ws_minmax(ws);
    const int range = (int)(mm[1] - mm[0]) + 1;
    const float2* src = reinterpret_cast<const float2*>(ws + kTableOff);
    for (int i = threadIdx.x; i < range; i += blockDim.x) table[i] = src[i];
    __syncthreads();
}

// ---------------------------------------------------------------------------
// min/max pass
// ---------------------------------------------------------------------------

__device__ __forceinline__ void fold(float v, float& mn, float& mx, bool& nan) {
    nan |= v != v;
    mn = fminf(mn, v);
    mx = fmaxf(mx, v);
}

template <typename T>
__global__ void __launch_bounds__(kMinmaxThreads)
minmax_kernel(const T* __restrict__ vol, Flat f, char* __restrict__ ws, int table,
              float wl, float ww) {
    constexpr int E = 16 / sizeof(T);
    float mn = INFINITY, mx = -INFINITY;
    bool nan = false;
    const int64_t runs = f.d0 * f.d1;
    const uint32_t stride = gridDim.x * kMinmaxThreads;
    if (f.s2 == 1) {
        // the 16-byte vectors of each run's aligned frame (W a run; the
        // host keeps runs * W below 2^32)
        const uint32_t W = (uint32_t)((f.len + 2 * E - 2) / E);
        const uint32_t items = (uint32_t)(runs * W);
        // a block reads whole tiles of kMinmaxUnroll * kMinmaxThreads
        // consecutive vectors, a thread one vector a row of the tile
        constexpr uint32_t kTile = kMinmaxUnroll * kMinmaxThreads;
        for (uint32_t k0 = blockIdx.x * kTile + threadIdx.x; k0 < items;
             k0 += gridDim.x * kTile) {
            Pack<T, E> pk[kMinmaxUnroll];
            int64_t e0[kMinmaxUnroll];
#pragma unroll
            for (int u = 0; u < kMinmaxUnroll; ++u) {
                const uint32_t k = k0 + u * kMinmaxThreads;
                e0[u] = f.len;   // nothing to fold
                if (k >= items) continue;
                const uint32_t run = runs == 1 ? 0u : k / W;
                const uint32_t w = k - run * W;
                const int64_t off = f.d0 == 1 ? (int64_t)run * f.s1
                                              : (int64_t)(run / f.d1) * f.s0
                                                + (int64_t)(run % f.d1) * f.s1;
                const uintptr_t a = reinterpret_cast<uintptr_t>(vol + off);
                const uintptr_t a0 = a & ~uintptr_t(15);
                e0[u] = (int64_t)w * E - (int64_t)((a - a0) / sizeof(T));
                if (e0[u] < f.len)
                    pk[u] = *reinterpret_cast<const Pack<T, E>*>(a0 + 16 * (uintptr_t)w);
            }
#pragma unroll
            for (int u = 0; u < kMinmaxUnroll; ++u) {
                if (e0[u] >= f.len) continue;
                if (e0[u] >= 0 && e0[u] + E <= f.len) {
#pragma unroll
                    for (int j = 0; j < E; ++j) fold((float)pk[u].v[j], mn, mx, nan);
                } else {
#pragma unroll
                    for (int j = 0; j < E; ++j)
                        if (e0[u] + j >= 0 && e0[u] + j < f.len)
                            fold((float)pk[u].v[j], mn, mx, nan);
                }
            }
        }
    } else {
        const int64_t items = runs * f.len;
        for (int64_t k = blockIdx.x * kMinmaxThreads + threadIdx.x; k < items; k += stride) {
            const int64_t run = k / f.len, i = k - run * f.len;
            const int64_t off = (run / f.d1) * f.s0 + (run % f.d1) * f.s1 + i * f.s2;
            fold((float)vol[off], mn, mx, nan);
        }
    }

    // the block's partial
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
        mn = fminf(mn, __shfl_xor_sync(0xffffffffu, mn, o));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    }
    nan = __any_sync(0xffffffffu, nan);
    __shared__ float smn[kMinmaxThreads / 32], smx[kMinmaxThreads / 32];
    __shared__ int snan[kMinmaxThreads / 32];
    __shared__ bool last;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (lane == 0) {
        smn[warp] = mn;
        smx[warp] = mx;
        snan[warp] = nan;
    }
    __syncthreads();
    float2* partial = reinterpret_cast<float2*>(ws + kPartialOff);
    unsigned* counter = reinterpret_cast<unsigned*>(ws);
    if (threadIdx.x == 0) {
        for (int w = 1; w < kMinmaxThreads / 32; ++w) {
            mn = fminf(mn, smn[w]);
            mx = fmaxf(mx, smx[w]);
            nan |= snan[w] != 0;
        }
        partial[blockIdx.x] = nan ? make_float2(NAN, NAN) : make_float2(mn, mx);
        __threadfence();
        last = atomicAdd(counter, 1u) == gridDim.x - 1;
    }
    __syncthreads();
    if (!last) return;

    // the last block folds every partial
    __threadfence();
    mn = INFINITY;
    mx = -INFINITY;
    nan = false;
    for (unsigned b = threadIdx.x; b < gridDim.x; b += kMinmaxThreads) {
        const float2 p = __ldcg(&partial[b]);
        nan |= p.x != p.x;
        mn = fminf(mn, p.x);
        mx = fmaxf(mx, p.y);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
        mn = fminf(mn, __shfl_xor_sync(0xffffffffu, mn, o));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    }
    nan = __any_sync(0xffffffffu, nan);
    __syncthreads();
    if (lane == 0) {
        smn[warp] = mn;
        smx[warp] = mx;
        snan[warp] = nan;
    }
    __syncthreads();
    __shared__ float fin[2];
    __shared__ int use;
    if (threadIdx.x == 0) {
        for (int w = 1; w < kMinmaxThreads / 32; ++w) {
            mn = fminf(mn, smn[w]);
            mx = fmaxf(mx, smx[w]);
            nan |= snan[w] != 0;
        }
        if (nan) mn = mx = NAN;
        float* mm = reinterpret_cast<float*>(ws + kMinMaxOff);
        mm[0] = fin[0] = mn;
        mm[1] = fin[1] = mx;
        use = table && is_int<T>() && (int)(mx - mn) + 1 <= table_cap<T>();
        reinterpret_cast<int*>(mm)[2] = use;
        *counter = 0u;   // ready for the next call
    }
    __syncthreads();
    if (use) {
        const float m[2] = {fin[0], fin[1]};
        const MidaParams p(m, wl, ww);
        float2* tab = reinterpret_cast<float2*>(ws + kTableOff);
        const int range = (int)(fin[1] - fin[0]) + 1;
        for (int i = threadIdx.x; i < range; i += kMinmaxThreads)
            tab[i] = p.value(fin[0] + (float)i);   // int16 / uint8: exact
    }
}

// ---------------------------------------------------------------------------
// the walks: a two-stage ring of chunks in shared memory per warp
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
    const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" :: "r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int PENDING>   // wait until at most PENDING groups are in flight
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(PENDING) : "memory");
}

__device__ __forceinline__ int64_t warp_id() {
    return (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
}

// The ring: copy chunk c + 1 while chunk c is walked; stop once no lane's
// ray is running.  W::copy(stage, c) issues chunk c's cp.async copies;
// walk_chunk(stage, c) walks it and returns whether the lane still runs.
template <class W, class Walk>
__device__ void run_ring(const W& w, char* ring, int chunks, Walk&& walk_chunk) {
    if (chunks > 0) w.copy(ring, 0);
    cp_async_commit();
    for (int c = 0; c < chunks; ++c) {
        if (c + 1 < chunks) w.copy(ring + ((c + 1) & 1) * kStageBytes, c + 1);
        cp_async_commit();
        cp_async_wait<1>();
        __syncwarp();            // every lane's copies of chunk c
        const bool running = walk_chunk(ring + (c & 1) * kStageBytes, c);
        __syncwarp();            // the stage is free for chunk c + 2
        if (!__any_sync(0xffffffffu, running)) break;
    }
    cp_async_wait<0>();
}

// Rows route: a warp's 32 rays (ray_stride 1), one a lane.  A ring row is
// 128 bytes of one ray, copied from the ray's 16-byte aligned frame, whose
// first element lies o elements in; the frame's vectors and bases are in
// shared memory for the copying lanes.
template <typename T>
struct RowWarp {
    static constexpr int E = 16 / sizeof(T);
    const T* base;   // the lane's first element
    int o, nv;       // its offset in the frame, vectors the frame covers
    bool live;
    int chunks;      // chunks of the warp's longest frame
    const char** sbase;
    int* snv;
    __device__ void init(const T* vol, const Geometry& g, const char** sb, int* sn) {
        const int lane = threadIdx.x & 31;
        const int64_t ray = warp_id() * 32 + lane;
        sbase = sb;
        snv = sn;
        live = ray < g.rows * g.cols;
        base = vol;
        if (live) {
            const int64_t row = ray / g.cols;
            base = vol + row * g.row_stride + (ray - row * g.cols) * g.col_stride;
        }
        const uintptr_t a = reinterpret_cast<uintptr_t>(base);
        o = (int)((a & 15) / sizeof(T));
        nv = live ? (int)((o + g.n + E - 1) / E) : 0;
        sbase[lane] = reinterpret_cast<const char*>(a & ~uintptr_t(15));
        snv[lane] = nv;
        const unsigned most = __reduce_max_sync(0xffffffffu, (unsigned)nv);
        chunks = (int)((most + kVecs - 1) / kVecs);
        __syncwarp();
    }
    // chunk c: 8 lanes a ray, so one warp instruction copies four rays'
    // 128-byte lines
    __device__ void copy(char* stage, int c) const {
        const int lane = threadIdx.x & 31;
        const int q = lane % kVecs;
        const int v = c * kVecs + q;
#pragma unroll
        for (int j = lane / kVecs; j < 32; j += 32 / kVecs)
            if (v < snv[j]) cp_async16(stage + (j * kPitch + q) * 16, sbase[j] + 16 * (int64_t)v);
    }
    // step(value) on each of the lane's elements in chunk c, in order
    template <class Step>
    __device__ __forceinline__ void walk(const char* stage, int c, int64_t n, Step&& step) const {
        const int lane = threadIdx.x & 31;
#pragma unroll
        for (int q = 0; q < kVecs; ++q) {
            const int v = c * kVecs + q;
            if (v >= nv) return;
            const Pack<T, E> pk =
                *reinterpret_cast<const Pack<T, E>*>(stage + (lane * kPitch + q) * 16);
            const int64_t e0 = (int64_t)v * E - o;
            if (e0 >= 0 && e0 + E <= n) {
#pragma unroll
                for (int k = 0; k < E; ++k) step(pk.v[k]);
            } else {
#pragma unroll
                for (int k = 0; k < E; ++k)
                    if (e0 + k >= 0 && e0 + k < n) step(pk.v[k]);
            }
        }
    }
};

// Columns route: one ray a thread (any strides), walked straight from
// device memory with BATCH steps of loads in flight.  step(v) returns
// whether the ray still runs.
template <typename T>
__device__ __forceinline__ bool column_ray(const T* vol, const Geometry& g, const T*& p,
                                           int64_t& t) {
    t = (int64_t)blockIdx.x * kThreads + threadIdx.x;
    if (t >= g.rows * g.cols) return false;
    const int64_t row = t / g.cols;
    p = vol + row * g.row_stride + (t - row * g.cols) * g.col_stride;
    return true;
}

template <int BATCH, typename T, class Step>
__device__ __forceinline__ void walk_column(const T* p, const Geometry& g, int64_t i0,
                                            Step&& step) {
    for (; i0 < g.n; i0 += BATCH) {
        T v[BATCH];
#pragma unroll
        for (int k = 0; k < BATCH; ++k)
            v[k] = i0 + k < g.n ? p[(i0 + k) * g.ray_stride] : T(0);
#pragma unroll
        for (int k = 0; k < BATCH; ++k)
            if (i0 + k >= g.n || !step(v[k])) return;
    }
}

__device__ __forceinline__ char* warp_ring(char* smem) {
    return smem + (threadIdx.x >> 5) * 2 * kStageBytes;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
lmip_rows_kernel(const T* __restrict__ vol, T* __restrict__ out, Geometry g,
                 float tmin, float tmax) {
    extern __shared__ __align__(16) char ring_smem[];
    __shared__ const char* sbase[kWarps][32];
    __shared__ int snv[kWarps][32];
    const int warp = threadIdx.x >> 5;
    RowWarp<T> w;
    w.init(vol, g, sbase[warp], snv[warp]);
    Lmip s;
    s.init(w.live ? (float)w.base[0] : 0.0f, tmin, tmax, w.live);
    run_ring(w, warp_ring(ring_smem), w.chunks, [&](const char* st, int c) {
        if (s.running) w.walk(st, c, g.n, [&](T v) { s.step((float)v, tmin, tmax); });
        return s.running;
    });
    if (w.live) out[warp_id() * 32 + (threadIdx.x & 31)] = static_cast<T>(s.m);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
lmip_columns_kernel(const T* __restrict__ vol, T* __restrict__ out, Geometry g,
                    float tmin, float tmax) {
    const T* p;
    int64_t t;
    if (!column_ray(vol, g, p, t)) return;
    Lmip s;
    s.init((float)p[0], tmin, tmax, true);
    walk_column<kLmipBatch>(p, g, 1, [&](T v) {
        s.step((float)v, tmin, tmax);
        return s.running;
    });
    out[t] = static_cast<T>(s.m);   // one of the ray's values: exact
}

template <typename T, bool TABLE>
__device__ void mida_rows(const T* vol, T* out, const Geometry& g, char* smem,
                          const char* (*sbase)[32], int (*snv)[32],
                          const Lookup<T, TABLE>& look) {
    const int warp = threadIdx.x >> 5;
    RowWarp<T> w;
    w.init(vol, g, sbase[warp], snv[warp]);
    Mida s;
    s.running = w.live;
    run_ring(w, warp_ring(smem), w.chunks, [&](const char* st, int c) {
        if (s.running) w.walk(st, c, g.n, [&](T v) { s.step(look(v)); });
        return s.running;
    });
    if (w.live)
        out[warp_id() * 32 + (threadIdx.x & 31)] =
            store_cast<T>(look.p.rng * s.colour_p + look.p.img_min);
}

template <typename T, bool TABLE>
__device__ void mida_columns(const T* vol, T* out, const Geometry& g,
                             const Lookup<T, TABLE>& look) {
    const T* p;
    int64_t t;
    if (!column_ray(vol, g, p, t)) return;
    Mida s;
    walk_column<kMidaBatch>(p, g, 0, [&](T v) {
        s.step(look(v));
        return s.running;
    });
    out[t] = store_cast<T>(look.p.rng * s.colour_p + look.p.img_min);
}

// MIDA, either route: the table (when the min/max pass filled it) into
// shared memory (behind the rows route's rings), then the walk.
template <typename T, bool ROWS>
__global__ void __launch_bounds__(kThreads)
mida_kernel(const T* __restrict__ vol, T* __restrict__ out, Geometry g,
            const char* __restrict__ ws, float wl, float ww) {
    extern __shared__ __align__(16) char ring_smem[];
    __shared__ const char* sbase[ROWS ? kWarps : 1][32];   // rows route only
    __shared__ int snv[ROWS ? kWarps : 1][32];
    float2* table = reinterpret_cast<float2*>(ring_smem + (ROWS ? kRingBytes : 0));
    const float* mm = ws_minmax(ws);
    const MidaParams p(mm, wl, ww);
    auto walk = [&](const auto& look) {
        if constexpr (ROWS) mida_rows(vol, out, g, ring_smem, sbase, snv, look);
        else mida_columns(vol, out, g, look);
    };
    if (table_cap<T>() > 0 && ws_use_table(ws)) {
        load_table(table, ws);
        walk(Lookup<T, true>{p, table, (int)mm[0]});
    } else {
        walk(Lookup<T, false>{p, nullptr, 0});
    }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

// Allow a kernel more than 48 KB of dynamic shared memory (once a kernel
// and device).
int allow_smem(const void* kernel, size_t bytes) {
    if (bytes <= 48 * 1024) return 0;
    static std::mutex mu;
    static std::vector<std::pair<const void*, int>> done;
    int dev = 0;
    cudaGetDevice(&dev);
    std::lock_guard<std::mutex> lock(mu);
    for (const auto& d : done)
        if (d.first == kernel && d.second == dev) return 0;
    const int err = (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err == 0) done.emplace_back(kernel, dev);
    return err;
}

// Blocks of kThreads threads for a route (0 columns: a ray a thread; 1
// rows: 32 rays a warp, needs ray_stride 1); 0 for a geometry the route
// does not take.
unsigned walk_blocks(const Geometry& g, int route) {
    if (route == 1 && (g.ray_stride != 1 || g.n > 0x7FFFFF00)) return 0;
    const int64_t b = (g.rows * g.cols + kThreads - 1) / kThreads;
    return b > 0 && b <= 0x7FFFFFFF && (route == 0 || route == 1) ? (unsigned)b : 0u;
}

template <typename T>
int launch_minmax(const void* vol, const Flat& f, char* ws, int table, float wl,
                  float ww, cudaStream_t s) {
    constexpr int E = 16 / sizeof(T);
    int64_t items;
    if (f.s2 == 1) {
        items = f.d0 * f.d1 * ((f.len + 2 * E - 2) / E);
        // the grid-stride index is 32-bit
        if (items > 0xFFFFFFFFLL - (int64_t)kMinmaxUnroll * kMinmaxThreads * kMaxBlocks)
            return -1;
    } else {
        items = f.d0 * f.d1 * f.len;
    }
    const int64_t per_block = kMinmaxUnroll * kMinmaxThreads;
    const int64_t want = (items + per_block - 1) / per_block;
    const unsigned blocks = (unsigned)(want < 1 ? 1 : want > kMaxBlocks ? kMaxBlocks : want);
    minmax_kernel<T><<<blocks, kMinmaxThreads, 0, s>>>((const T*)vol, f, ws, table, wl, ww);
    return (int)cudaGetLastError();
}

template <typename T>
int launch_lmip(const void* vol, void* out, int route, const Geometry& g, float tmin,
                float tmax, cudaStream_t s) {
    const unsigned blocks = walk_blocks(g, route);
    if (blocks == 0) return -1;
    auto kernel = route == 0 ? lmip_columns_kernel<T> : lmip_rows_kernel<T>;
    const size_t smem = route == 0 ? 0 : kRingBytes;
    const int err = allow_smem((const void*)kernel, smem);
    if (err) return err;
    kernel<<<blocks, kThreads, smem, s>>>((const T*)vol, (T*)out, g, tmin, tmax);
    return (int)cudaGetLastError();
}

template <typename T>
int launch_mida(const void* vol, void* out, int route, const Geometry& g, const Flat& f,
                char* ws, float wl, float ww, cudaStream_t s) {
    const unsigned blocks = walk_blocks(g, route);
    if (blocks == 0) return -1;
    const int err = launch_minmax<T>(vol, f, ws, 1, wl, ww, s);
    if (err) return err;
    const size_t smem = (route == 0 ? 0 : kRingBytes) + sizeof(float2) * table_cap<T>();
    auto kernel = route == 0 ? mida_kernel<T, false> : mida_kernel<T, true>;
    const int e = allow_smem((const void*)kernel, smem);
    if (e) return e;
    kernel<<<blocks, kThreads, smem, s>>>((const T*)vol, (T*)out, g, ws, wl, ww);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 int16, 2 uint8.  route: 0 columns (any strides), 1
// rows (needs ray_stride 1).  Every function returns
// cudaGetLastError() after its launches (0 on success), or -1 for an
// argument the kernels do not take; it launches on `stream` and does not
// synchronise.

int ray_workspace_bytes(void) { return (int)kWorkspaceBytes; }

// The slab's min and max as float32 into the workspace (ws + 16), NaN for
// both if any element is NaN.
int slab_minmax(const void* vol, int dtype, int64_t d0, int64_t d1, int64_t len,
                int64_t s0, int64_t s1, int64_t s2, void* ws, void* stream) {
    if (d0 < 1 || d1 < 1 || len < 1) return -1;
    const Flat f = {d0, d1, len, s0, s1, s2};
    cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
    char* w = (char*)ws;
    switch (dtype) {
        case 0: return launch_minmax<float>(vol, f, w, 0, 0.0f, 0.0f, s);
        case 1: return launch_minmax<int16_t>(vol, f, w, 0, 0.0f, 0.0f, s);
        case 2: return launch_minmax<uint8_t>(vol, f, w, 0, 0.0f, 0.0f, s);
        default: return -1;
    }
}

int lmip_rays(const void* vol, void* out, int dtype, int route, int64_t n,
              int64_t ray_stride, int64_t rows, int64_t cols, int64_t row_stride,
              int64_t col_stride, float tmin, float tmax, void* stream) {
    const Geometry g = {n, ray_stride, rows, cols, row_stride, col_stride};
    if (n < 1 || rows < 1 || cols < 1) return -1;
    cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
    switch (dtype) {
        case 0: return launch_lmip<float>(vol, out, route, g, tmin, tmax, s);
        case 1: return launch_lmip<int16_t>(vol, out, route, g, tmin, tmax, s);
        case 2: return launch_lmip<uint8_t>(vol, out, route, g, tmin, tmax, s);
        default: return -1;
    }
}

// MIDA: the min/max pass (which fills the table) into `ws`, then the walk.
// (d0, d1, len, s0, s1, s2) describe the same slab for the min/max pass.
int mida_rays(const void* vol, void* out, int dtype, int route, int64_t n,
              int64_t ray_stride, int64_t rows, int64_t cols, int64_t row_stride,
              int64_t col_stride, int64_t d0, int64_t d1, int64_t len, int64_t s0,
              int64_t s1, int64_t s2, void* ws, float wl, float ww, void* stream) {
    const Geometry g = {n, ray_stride, rows, cols, row_stride, col_stride};
    if (n < 1 || rows < 1 || cols < 1 || d0 < 1 || d1 < 1 || len < 1) return -1;
    const Flat f = {d0, d1, len, s0, s1, s2};
    cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
    char* w = (char*)ws;
    switch (dtype) {
        case 0: return launch_mida<float>(vol, out, route, g, f, w, wl, ww, s);
        case 1: return launch_mida<int16_t>(vol, out, route, g, f, w, wl, ww, s);
        case 2: return launch_mida<uint8_t>(vol, out, route, g, f, w, wl, ww, s);
        default: return -1;
    }
}

}  // extern "C"
