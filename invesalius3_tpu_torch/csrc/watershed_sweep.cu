// Bidirectional minimax relaxation sweep of the watershed image-foresting
// transform, in place.
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
// (Z, Y, X).
//
// What bounds it on an H100: device-memory bytes.  A sweep must read rank,
// lab and f once (12 bytes a voxel with int32 labels, 10 with int16) and
// write rank and lab where they improve: at 512^3 that is 1.34-1.61 GB
// read, 0.40-0.48 ms at 3.35 TB/s, plus the writes (up to 0.8 ms in all).
// The carry along a ray is the only dependency, so one thread owns one ray
// and many rays must be in flight to hide the latency.
//
// ws_stream_kernel (the Z and Y sweeps): one thread per ray walks device
// memory with kBatch steps of rank, f and lab loads in flight.
// Neighbouring threads own neighbouring x, so every load and store
// coalesces, but the backward pass reads every element a second time.
//
// ws_tiled_kernel (the X sweep, whose rays are rows: a thread walking its
// row straight from device memory touches a different line every step):
// - A block of kRays threads owns kRays rows and walks them in chunks of
//   kS steps.  A chunk of rank, f and lab for the block's rows is one tile
//   in shared memory, copied in with 4-byte cp.async along the rows (a
//   warp copies one 128-byte line of one row at a time).  The tile's rows
//   are padded to kS + 1 words, so the 32 walkers on one step hit 32 banks.
// - The tiles form a ring of two stages: while chunk c is walked, chunk
//   c + 1 is being copied.  The forward pass stores a chunk back only when
//   its stage is refilled, so the last two chunks stay resident and the
//   backward pass walks them before it reloads the earlier ones (a ray of
//   up to 2 * kS steps crosses device memory once each way).
// - A 32-bit mask per row and chunk marks the steps that changed; only
//   those are stored, and a chunk in which nothing changed is not stored
//   at all (most chunks of a late refine round).
// - int16 labels are copied as pairs (4 bytes) when x is even and the
//   labels are 4-byte aligned; otherwise they are staged through registers.
//
// Measured (chip_smoke.py; NVIDIA H100 80GB HBM3, 700 W; PERF.md has the
// tables): at 512^3 with nearly every element changing, the X sweep takes
// 1.5-1.8 ms, 41-45% of its bound (it was 42 ms with one thread walking
// each row straight from device memory); the streaming Z and Y sweeps
// 1.8-1.9 ms, 34-43%.  In the 512^3 flow, where late rounds change few
// elements, each axis spends 28-31 ms over 48 launches, 35-37% of its
// bound: what is left is the second read of the backward pass (both
// kernels) and, for the X tiles, the copy's instructions and barriers.  A
// deeper ring (a whole 512-step ray resident leaves room for 32 rays an
// SM), wider blocks and tiles for the Z and Y sweeps were all slower in
// the flow.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int32_t kInf = 0x7FFFFFFF;
constexpr int32_t kDistBits = 15;
constexpr int32_t kDistMax = (1 << kDistBits) - 1;
constexpr int kBatch = 8;   // steps of loads in flight, streaming kernel
constexpr int kS = 32;      // steps per chunk (one dirty bit each)
constexpr int kRays = 32;   // rows per block of the X sweep: one warp

__device__ __forceinline__ int32_t relax(int32_t parent, int32_t f) {
    if (parent == kInf) return kInf;
    const int32_t cost = max(parent >> kDistBits, f);
    const int32_t dist = min((parent & kDistMax) + 1, kDistMax);
    return cost * (1 << kDistBits) + dist;
}

__host__ __device__ constexpr size_t align16(size_t b) { return (b + 15) & ~size_t(15); }

// One ring stage: rank and f tiles, the lab tile, one dirty mask per row.
// Rows are padded to kS + 1 words (int16 labels: kS + 2 halves, 17 words),
// so the walkers of a warp on one step hit 32 banks.
template <typename L>
struct Stage {
    static constexpr int P = kS + 1;
    static constexpr int PL = sizeof(L) == 2 ? kS + 2 : kS + 1;
    static constexpr size_t kF = align16(sizeof(int32_t) * kRays * P);
    static constexpr size_t kLab = 2 * kF;
    static constexpr size_t kDirty = kLab + align16(sizeof(L) * kRays * PL);
    static constexpr size_t kBytes = kDirty + align16(sizeof(uint32_t) * kRays);
    int32_t* rank;
    int32_t* f;
    L* lab;
    uint32_t* dirty;
    __device__ explicit Stage(char* p)
        : rank((int32_t*)p), f((int32_t*)(p + kF)), lab((L*)(p + kLab)),
          dirty((uint32_t*)(p + kDirty)) {}
    // element (row r, step j of the chunk)
    __device__ static int at(int r, int j) { return r * P + j; }
    __device__ static int lat(int r, int j) { return r * PL + j; }
};

// The block's rows: row r, step i lies at base + r * X + i.
struct Rows {
    int64_t base;
    int X, nr;
};

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
    const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" :: "r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int PENDING>   // wait until at most PENDING groups are in flight
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(PENDING) : "memory");
}

// Copy chunk c of the block's rows into a stage (cp.async; the caller
// commits the group): thread t copies step t of every row, so a warp
// copies one row's 128-byte line at a time.  With `pairs` int16 labels go
// as 4-byte pairs (thread t: steps 2 (t % 16), + 1 of every other row).
// Clears the stage's dirty masks.
template <typename L>
__device__ void load_chunk(Stage<L> st, const Rows& g, int c, const int32_t* rank,
                           const L* lab, const int32_t* f, bool pairs) {
    const int t = threadIdx.x;
    const int len = min(kS, g.X - c * kS);
    const int64_t q0 = g.base + (int64_t)c * kS;
    st.dirty[t] = 0;
    if (t < len) {
        for (int r = 0; r < g.nr; ++r) {
            const int64_t q = q0 + (int64_t)r * g.X + t;
            cp_async4(&st.rank[st.at(r, t)], rank + q);
            cp_async4(&st.f[st.at(r, t)], f + q);
            if (sizeof(L) == 4) cp_async4(&st.lab[st.lat(r, t)], lab + q);
            else if (!pairs) st.lab[st.lat(r, t)] = lab[q];
        }
    }
    if (sizeof(L) == 2 && pairs) {
        const int j = 2 * (t % (kS / 2));
        if (j < len) {   // x is even, so len is too
            for (int r = t / (kS / 2); r < g.nr; r += 2)
                cp_async4(&st.lab[st.lat(r, j)], lab + q0 + (int64_t)r * g.X + j);
        }
    }
}

// Store the changed elements of chunk c from a stage.
template <typename L>
__device__ void store_chunk(Stage<L> st, const Rows& g, int c, int32_t* rank, L* lab) {
    const int t = threadIdx.x;
    const int len = min(kS, g.X - c * kS);
    if (t >= len) return;
    const int64_t q0 = g.base + (int64_t)c * kS + t;
    for (int r = 0; r < g.nr; ++r) {
        if (!((st.dirty[r] >> t) & 1u)) continue;
        const int64_t q = q0 + (int64_t)r * g.X;
        rank[q] = st.rank[st.at(r, t)];
        lab[q] = st.lab[st.lat(r, t)];
    }
}

// One relaxation step of row r at step j of a stage; the step's values
// (cur, fi, lv) were read one step ahead.
template <typename L>
__device__ __forceinline__ void step(Stage<L> st, int r, int j, int32_t cur,
                                     int32_t fi, L lv, int32_t& pr, L& pl,
                                     uint32_t& d) {
    const int32_t cand = relax(pr, fi);
    if (cand < cur) {
        st.rank[st.at(r, j)] = cand;
        st.lab[st.lat(r, j)] = pl;
        d |= 1u << j;
        pr = cand;
    } else {
        pr = cur;
        pl = lv;
    }
}

// Walk steps j = from, from + dir, ... (to inclusive) of row r in a stage;
// returns the row's dirty mask for the chunk.
template <typename L>
__device__ uint32_t walk(Stage<L> st, int r, int from, int to, int dir,
                         int32_t& pr, L& pl) {
    uint32_t d = st.dirty[r];
    if ((to - from) * dir < 0) return d;
    int j = from;
    int32_t cur = st.rank[st.at(r, j)], fi = st.f[st.at(r, j)];
    L lv = st.lab[st.lat(r, j)];
    for (; j != to; j += dir) {
        const int k = j + dir;
        const int32_t ncur = st.rank[st.at(r, k)], nfi = st.f[st.at(r, k)];
        const L nlv = st.lab[st.lat(r, k)];
        step<L>(st, r, j, cur, fi, lv, pr, pl, d);
        cur = ncur; fi = nfi; lv = nlv;
    }
    step<L>(st, r, j, cur, fi, lv, pr, pl, d);
    st.dirty[r] = d;
    return d;
}

// The X sweep: one block of kRays threads a group of kRays rows.
template <typename L>
__global__ void __launch_bounds__(kRays)
ws_tiled_kernel(int32_t* __restrict__ rank, L* __restrict__ lab,
                const int32_t* __restrict__ f, int64_t rows, int X, int pairs) {
    __shared__ __align__(16) char smem[2 * Stage<L>::kBytes];
    const int64_t row0 = (int64_t)blockIdx.x * kRays;
    const Rows g = {row0 * X, X, (int)min((int64_t)kRays, rows - row0)};
    const int C = (X + kS - 1) / kS;
    const int r = threadIdx.x;
    const bool walker = r < g.nr;
    auto stage = [&](int c) { return Stage<L>(smem + (c & 1) * Stage<L>::kBytes); };

    int32_t pr = 0;
    L pl = 0;
    // forward: the stage of chunk c - 1 is stored and refilled with chunk
    // c + 1, then chunk c is walked while chunk c + 1 is being copied
    load_chunk<L>(stage(0), g, 0, rank, lab, f, pairs);
    cp_async_commit();
    uint32_t d = 0;   // this thread's row's dirty mask of the chunk just walked
    for (int c = 0; c < C; ++c) {
        cp_async_wait<0>();
        const bool changed = __syncthreads_or(d != 0);   // in chunk c - 1
        if (c + 1 < C) {
            if (c >= 1 && changed) {        // evict chunk c - 1
                store_chunk<L>(stage(c - 1), g, c - 1, rank, lab);
                __syncthreads();
            }
            load_chunk<L>(stage(c + 1), g, c + 1, rank, lab, f, pairs);
        }
        cp_async_commit();
        if (walker) {
            const Stage<L> st = stage(c);
            const int len = min(kS, X - c * kS);
            int from = 0;
            if (c == 0) {
                pr = st.rank[st.at(r, 0)];
                pl = st.lab[st.lat(r, 0)];
                from = 1;
            }
            d = walk<L>(st, r, from, len - 1, 1, pr, pl);
        }
    }
    // backward from the forward pass's last element; chunks C - 2 and C - 1
    // are still resident, the earlier ones are reloaded two chunks ahead
    for (int c = C - 1; c >= 0; --c) {
        if (c < C - 2) {
            cp_async_wait<1>();
            __syncthreads();
        }
        d = 0;
        if (walker) {
            const int len = min(kS, X - c * kS);
            d = walk<L>(stage(c), r, c == C - 1 ? len - 2 : len - 1, 0, -1, pr, pl);
        }
        // chunk c is final: store what changed in it (forward or backward)
        if (__syncthreads_or(d != 0)) {
            store_chunk<L>(stage(c), g, c, rank, lab);
            __syncthreads();
        }
        if (c >= 2) load_chunk<L>(stage(c), g, c - 2, rank, lab, f, pairs);
        cp_async_commit();
    }
    cp_async_wait<0>();
}

// The Z (AXIS 0) and Y (AXIS 1) sweeps: one thread per ray, walking device
// memory with kBatch steps of loads in flight (forward, then backward over
// the forward pass's results).
template <int AXIS, typename L>
__global__ void ws_stream_kernel(int32_t* __restrict__ rank, L* __restrict__ lab,
                                 const int32_t* __restrict__ f,
                                 int Z, int Y, int X) {
    static_assert(AXIS == 0 || AXIS == 1, "the X sweep takes ws_tiled_kernel");
    const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    int64_t base, stride;
    int n;
    if (AXIS == 0) {
        if (t >= (int64_t)Y * X) return;
        base = t; stride = (int64_t)Y * X; n = Z;
    } else {
        if (t >= (int64_t)Z * X) return;
        base = (t / X) * Y * X + t % X; stride = X; n = Y;
    }
    int32_t pr = rank[base];
    L pl = lab[base];
    for (int i0 = 1; i0 < n; i0 += kBatch) {
        int32_t cr[kBatch], cf[kBatch];
        L cl[kBatch];
#pragma unroll
        for (int k = 0; k < kBatch; ++k) {
            if (i0 + k < n) {
                const int64_t q = base + (i0 + k) * stride;
                cr[k] = rank[q]; cf[k] = f[q]; cl[k] = lab[q];
            }
        }
#pragma unroll
        for (int k = 0; k < kBatch; ++k) {
            if (i0 + k < n) {
                const int32_t cand = relax(pr, cf[k]);
                if (cand < cr[k]) {
                    const int64_t q = base + (i0 + k) * stride;
                    rank[q] = cand; lab[q] = pl; pr = cand;
                } else {
                    pr = cr[k]; pl = cl[k];
                }
            }
        }
    }
    for (int i0 = n - 2; i0 >= 0; i0 -= kBatch) {
        int32_t cr[kBatch], cf[kBatch];
        L cl[kBatch];
#pragma unroll
        for (int k = 0; k < kBatch; ++k) {
            if (i0 - k >= 0) {
                const int64_t q = base + (i0 - k) * stride;
                cr[k] = rank[q]; cf[k] = f[q]; cl[k] = lab[q];
            }
        }
#pragma unroll
        for (int k = 0; k < kBatch; ++k) {
            if (i0 - k >= 0) {
                const int32_t cand = relax(pr, cf[k]);
                if (cand < cr[k]) {
                    const int64_t q = base + (i0 - k) * stride;
                    rank[q] = cand; lab[q] = pl; pr = cand;
                } else {
                    pr = cr[k]; pl = cl[k];
                }
            }
        }
    }
}

template <typename L>
int launch(int axis, int32_t* rank, L* lab, const int32_t* f, int Z, int Y,
           int X, cudaStream_t s) {
    const int n = axis == 0 ? Z : axis == 1 ? Y : X;
    if (n < 2 || (int64_t)Z * Y * X == 0) return 0;   // nothing to relax
    if (axis == 2) {
        const int64_t blocks = ((int64_t)Z * Y + kRays - 1) / kRays;
        if (blocks > 0x7FFFFFFF) return -1;
        const bool pairs = sizeof(L) == 2 && X % 2 == 0
                           && reinterpret_cast<uintptr_t>(lab) % 4 == 0;
        ws_tiled_kernel<L><<<(unsigned)blocks, kRays, 0, s>>>(rank, lab, f, (int64_t)Z * Y,
                                                             X, pairs);
    } else {
        constexpr int kThreads = 128;
        const int64_t rays = axis == 0 ? (int64_t)Y * X : (int64_t)Z * X;
        const unsigned blocks = (unsigned)((rays + kThreads - 1) / kThreads);
        if (axis == 0)
            ws_stream_kernel<0, L><<<blocks, kThreads, 0, s>>>(rank, lab, f, Z, Y, X);
        else
            ws_stream_kernel<1, L><<<blocks, kThreads, 0, s>>>(rank, lab, f, Z, Y, X);
    }
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// One sweep along `axis`: the streaming kernel for axes 0 and 1, the tiled
// kernel for axis 2.  Returns cudaGetLastError() after the launch (0 on
// success; also 0, with nothing launched, when the axis is shorter than 2
// or the volume empty), or -1 for an argument the kernels do not take.
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
