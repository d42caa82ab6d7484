// Binary-STL record packing on the host, one streaming pass per thread.
//
// The port's copy of the record packer of invesalius3_tpu/native/meshpack.cpp
// (stl_pack_mt and the loop behind it; the arithmetic is unchanged, so the
// records are byte-identical).  Strided numpy field writes miss a fresh
// cache line per 12-byte store; a row-at-a-time loop streams reads and
// writes at memcpy speed.  Built by g++ through _build.py.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

int stl_pack_range(const float* verts, int64_t nv, const int32_t* faces,
                   int64_t i0, int64_t i1, uint8_t* out) {
    for (int64_t i = i0; i < i1; ++i) {
        const int32_t a = faces[3 * i], b = faces[3 * i + 1], c = faces[3 * i + 2];
        if (a < 0 || b < 0 || c < 0 || a >= nv || b >= nv || c >= nv) return 1;
        const float* pa = verts + 3 * a;
        const float* pb = verts + 3 * b;
        const float* pc = verts + 3 * c;
        const float ux = pb[0] - pa[0], uy = pb[1] - pa[1], uz = pb[2] - pa[2];
        const float wx = pc[0] - pa[0], wy = pc[1] - pa[1], wz = pc[2] - pa[2];
        float n0 = uy * wz - uz * wy;
        float n1 = uz * wx - ux * wz;
        float n2 = ux * wy - uy * wx;
        const float mag = std::sqrt(n0 * n0 + n1 * n1 + n2 * n2);
        if (mag > 1e-30f) { n0 /= mag; n1 /= mag; n2 /= mag; }
        uint8_t* rec = out + 50 * i;
        float nrm[3] = {n0, n1, n2};
        std::memcpy(rec, nrm, 12);
        std::memcpy(rec + 12, pa, 12);
        std::memcpy(rec + 24, pb, 12);
        std::memcpy(rec + 36, pc, 12);
        rec[48] = 0; rec[49] = 0;
    }
    return 0;
}

}  // namespace

extern "C" {

// verts: (nv, 3) float32, faces: (nf, 3) int32 -> out: (nf, 50) bytes
// (normal f32x3, 3 corners f32x3, 2-byte attribute = 0), the binary STL
// record layout.  Records are independent fixed-size rows, so the face
// range splits over n_threads.  Returns 1 for a face index out of range.
int stl_pack_mt(const float* verts, int64_t nv, const int32_t* faces,
                int64_t nf, uint8_t* out, int n_threads) {
    if (n_threads <= 1 || nf < 65536)
        return stl_pack_range(verts, nv, faces, 0, nf, out);
    std::vector<std::thread> ts;
    std::vector<int> rcs(n_threads, 0);
    const int64_t chunk = (nf + n_threads - 1) / n_threads;
    for (int t = 0; t < n_threads; ++t) {
        const int64_t i0 = t * chunk;
        const int64_t i1 = std::min(nf, i0 + chunk);
        if (i0 >= i1) break;
        ts.emplace_back([=, &rcs] {
            rcs[t] = stl_pack_range(verts, nv, faces, i0, i1, out);
        });
    }
    for (auto& th : ts) th.join();
    for (int rc : rcs) if (rc) return rc;
    return 0;
}

}  // extern "C"
