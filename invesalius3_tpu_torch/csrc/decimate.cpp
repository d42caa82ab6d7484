// Quadric-error-metric mesh decimation (Garland-Heckbert edge collapse).
//
// The port's copy of invesalius3_tpu/native/decimate.cpp (decimate_qem;
// the code is unchanged, so the same arrays decimate to the same arrays).
// It replaces the reference's vtkQuadricDecimation stage (reference
// surface_process.py:350-372): dynamic-topology mesh simplification is
// sequential and irregular, so it stays on the host in C++.  Built by g++
// through _build.py.
//
// C ABI (ctypes): decimate_qem(verts, n_verts, faces, n_faces,
//                              target_faces, out_verts, out_faces,
//                              &out_n_verts, &out_n_faces)
// Buffers are caller-allocated at input size; outputs are compacted.

#include <cstdint>
#include <cstring>
#include <cmath>
#include <queue>
#include <vector>
#include <unordered_set>
#include <algorithm>

namespace {

struct Quadric {
    // symmetric 4x4: [a2 ab ac ad bb bc bd cc cd dd]
    double q[10] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0};
    void add_plane(double a, double b, double c, double d) {
        q[0] += a * a; q[1] += a * b; q[2] += a * c; q[3] += a * d;
        q[4] += b * b; q[5] += b * c; q[6] += b * d;
        q[7] += c * c; q[8] += c * d; q[9] += d * d;
    }
    Quadric operator+(const Quadric& o) const {
        Quadric r;
        for (int i = 0; i < 10; i++) r.q[i] = q[i] + o.q[i];
        return r;
    }
    double eval(double x, double y, double z) const {
        return q[0] * x * x + 2 * q[1] * x * y + 2 * q[2] * x * z + 2 * q[3] * x
             + q[4] * y * y + 2 * q[5] * y * z + 2 * q[6] * y
             + q[7] * z * z + 2 * q[8] * z + q[9];
    }
    // solve for the minimizing point; returns false if singular
    bool optimal(double& x, double& y, double& z) const {
        double m[9] = {q[0], q[1], q[2], q[1], q[4], q[5], q[2], q[5], q[7]};
        double b[3] = {-q[3], -q[6], -q[8]};
        double det = m[0] * (m[4] * m[8] - m[5] * m[7])
                   - m[1] * (m[3] * m[8] - m[5] * m[6])
                   + m[2] * (m[3] * m[7] - m[4] * m[6]);
        if (std::fabs(det) < 1e-10) return false;
        double inv = 1.0 / det;
        x = inv * (b[0] * (m[4] * m[8] - m[5] * m[7])
                 - m[1] * (b[1] * m[8] - m[5] * b[2])
                 + m[2] * (b[1] * m[7] - m[4] * b[2]));
        y = inv * (m[0] * (b[1] * m[8] - m[5] * b[2])
                 - b[0] * (m[3] * m[8] - m[5] * m[6])
                 + m[2] * (m[3] * b[2] - b[1] * m[6]));
        z = inv * (m[0] * (m[4] * b[2] - b[1] * m[7])
                 - m[1] * (m[3] * b[2] - b[1] * m[6])
                 + b[0] * (m[3] * m[7] - m[4] * m[6]));
        return std::isfinite(x) && std::isfinite(y) && std::isfinite(z);
    }
};

struct Collapse {
    double cost;
    int u, v;            // collapse u -> v's union position
    double x, y, z;
    uint64_t stamp_u, stamp_v;  // version stamps for lazy invalidation
    bool operator<(const Collapse& o) const { return cost > o.cost; }  // min-heap
};

inline uint64_t ekey(int a, int b) {
    if (a > b) std::swap(a, b);
    return (static_cast<uint64_t>(a) << 32) | static_cast<uint32_t>(b);
}

}  // namespace

extern "C" int decimate_qem(
    const float* verts_in, int64_t n_verts,
    const int32_t* faces_in, int64_t n_faces,
    int64_t target_faces,
    float* verts_out, int32_t* faces_out,
    int64_t* out_n_verts, int64_t* out_n_faces) {

    std::vector<double> vx(n_verts), vy(n_verts), vz(n_verts);
    for (int64_t i = 0; i < n_verts; i++) {
        vx[i] = verts_in[3 * i];
        vy[i] = verts_in[3 * i + 1];
        vz[i] = verts_in[3 * i + 2];
    }
    std::vector<int> f0(n_faces), f1(n_faces), f2(n_faces);
    std::vector<bool> face_alive(n_faces, true);
    std::vector<std::vector<int>> vfaces(n_verts);
    for (int64_t i = 0; i < n_faces; i++) {
        f0[i] = faces_in[3 * i];
        f1[i] = faces_in[3 * i + 1];
        f2[i] = faces_in[3 * i + 2];
        vfaces[f0[i]].push_back((int)i);
        vfaces[f1[i]].push_back((int)i);
        vfaces[f2[i]].push_back((int)i);
    }

    // per-vertex quadrics from incident face planes
    std::vector<Quadric> Q(n_verts);
    for (int64_t i = 0; i < n_faces; i++) {
        int a = f0[i], b = f1[i], c = f2[i];
        double ux = vx[b] - vx[a], uy = vy[b] - vy[a], uz = vz[b] - vz[a];
        double wx_ = vx[c] - vx[a], wy_ = vy[c] - vy[a], wz_ = vz[c] - vz[a];
        double nx = uy * wz_ - uz * wy_;
        double ny = uz * wx_ - ux * wz_;
        double nz = ux * wy_ - uy * wx_;
        double len = std::sqrt(nx * nx + ny * ny + nz * nz);
        if (len < 1e-12) continue;
        nx /= len; ny /= len; nz /= len;
        double d = -(nx * vx[a] + ny * vy[a] + nz * vz[a]);
        Q[a].add_plane(nx, ny, nz, d);
        Q[b].add_plane(nx, ny, nz, d);
        Q[c].add_plane(nx, ny, nz, d);
    }

    std::vector<uint64_t> stamp(n_verts, 0);
    std::vector<bool> vert_alive(n_verts, true);
    std::priority_queue<Collapse> heap;

    auto push_edge = [&](int u, int v) {
        if (u == v) return;
        Quadric s = Q[u] + Q[v];
        double x, y, z;
        if (!s.optimal(x, y, z)) {
            // fallback: best of endpoints / midpoint
            double mx = 0.5 * (vx[u] + vx[v]);
            double my = 0.5 * (vy[u] + vy[v]);
            double mz = 0.5 * (vz[u] + vz[v]);
            double cu = s.eval(vx[u], vy[u], vz[u]);
            double cv = s.eval(vx[v], vy[v], vz[v]);
            double cm = s.eval(mx, my, mz);
            if (cu <= cv && cu <= cm) { x = vx[u]; y = vy[u]; z = vz[u]; }
            else if (cv <= cm) { x = vx[v]; y = vy[v]; z = vz[v]; }
            else { x = mx; y = my; z = mz; }
        }
        heap.push({s.eval(x, y, z), u, v, x, y, z, stamp[u], stamp[v]});
    };

    // unique edges
    {
        std::unordered_set<uint64_t> seen;
        seen.reserve(n_faces * 3);
        for (int64_t i = 0; i < n_faces; i++) {
            int e[3][2] = {{f0[i], f1[i]}, {f1[i], f2[i]}, {f0[i], f2[i]}};
            for (auto& pr : e) {
                uint64_t k = ekey(pr[0], pr[1]);
                if (seen.insert(k).second) push_edge(pr[0], pr[1]);
            }
        }
    }

    int64_t alive_faces = n_faces;
    std::vector<int> tmp_faces;
    while (alive_faces > target_faces && !heap.empty()) {
        Collapse c = heap.top();
        heap.pop();
        int u = c.u, v = c.v;
        if (!vert_alive[u] || !vert_alive[v]) continue;
        if (c.stamp_u != stamp[u] || c.stamp_v != stamp[v]) continue;  // stale

        // link condition: u and v must share exactly two neighbors (the
        // opposite vertices of the two faces on edge uv), otherwise the
        // collapse pinches the surface into non-manifold fins
        {
            std::unordered_set<int> nu;
            for (int fi : vfaces[u]) {
                if (!face_alive[fi]) continue;
                nu.insert(f0[fi]); nu.insert(f1[fi]); nu.insert(f2[fi]);
            }
            nu.erase(u);
            int common = 0;
            std::unordered_set<int> seen_nb;
            for (int fi : vfaces[v]) {
                if (!face_alive[fi]) continue;
                int vs[3] = {f0[fi], f1[fi], f2[fi]};
                for (int w : vs) {
                    if (w == v || !seen_nb.insert(w).second) continue;
                    if (nu.count(w)) common++;
                }
            }
            if (common != 2) continue;
        }

        // normal-flip rejection: simulate the collapse; if any surviving
        // incident face's normal reverses, skip (prevents folds that
        // inflate surface area)
        bool flips = false;
        for (int pass = 0; pass < 2 && !flips; pass++) {
            const std::vector<int>& fcs = vfaces[pass == 0 ? u : v];
            for (int fi : fcs) {
                if (!face_alive[fi]) continue;
                int a = f0[fi], b = f1[fi], cc2 = f2[fi];
                // faces containing BOTH u and v degenerate away: ignore
                bool has_u = (a == u || b == u || cc2 == u);
                bool has_v = (a == v || b == v || cc2 == v);
                if (has_u && has_v) continue;
                double pax = vx[a], pay = vy[a], paz = vz[a];
                double pbx = vx[b], pby = vy[b], pbz = vz[b];
                double pcx = vx[cc2], pcy = vy[cc2], pcz = vz[cc2];
                auto norm = [](double ax, double ay, double az,
                               double bx, double by, double bz,
                               double cx2, double cy2, double cz2,
                               double& nx, double& ny, double& nz) {
                    double ux = bx - ax, uy = by - ay, uz = bz - az;
                    double wx2 = cx2 - ax, wy2 = cy2 - ay, wz2 = cz2 - az;
                    nx = uy * wz2 - uz * wy2;
                    ny = uz * wx2 - ux * wz2;
                    nz = ux * wy2 - uy * wx2;
                };
                double n0x, n0y, n0z;
                norm(pax, pay, paz, pbx, pby, pbz, pcx, pcy, pcz, n0x, n0y, n0z);
                // after: u and v both land at (c.x, c.y, c.z)
                if (a == u || a == v) { pax = c.x; pay = c.y; paz = c.z; }
                if (b == u || b == v) { pbx = c.x; pby = c.y; pbz = c.z; }
                if (cc2 == u || cc2 == v) { pcx = c.x; pcy = c.y; pcz = c.z; }
                double n1x, n1y, n1z;
                norm(pax, pay, paz, pbx, pby, pbz, pcx, pcy, pcz, n1x, n1y, n1z);
                if (n0x * n1x + n0y * n1y + n0z * n1z < 0) { flips = true; break; }
            }
        }
        if (flips) continue;

        // move v to the optimal position, retire u
        vx[v] = c.x; vy[v] = c.y; vz[v] = c.z;
        Q[v] = Q[u] + Q[v];
        vert_alive[u] = false;
        stamp[v]++;

        // rewire u's faces to v; kill degenerate faces
        tmp_faces.clear();
        for (int fi : vfaces[u]) {
            if (!face_alive[fi]) continue;
            if (f0[fi] == u) f0[fi] = v;
            if (f1[fi] == u) f1[fi] = v;
            if (f2[fi] == u) f2[fi] = v;
            if (f0[fi] == f1[fi] || f1[fi] == f2[fi] || f0[fi] == f2[fi]) {
                face_alive[fi] = false;
                alive_faces--;
            } else {
                tmp_faces.push_back(fi);
            }
        }
        for (int fi : tmp_faces) vfaces[v].push_back(fi);
        vfaces[u].clear();

        // re-push edges around v
        std::unordered_set<int> nbrs;
        for (int fi : vfaces[v]) {
            if (!face_alive[fi]) continue;
            nbrs.insert(f0[fi]); nbrs.insert(f1[fi]); nbrs.insert(f2[fi]);
        }
        nbrs.erase(v);
        for (int w : nbrs)
            if (vert_alive[w]) push_edge(v, w);
    }

    // compact output
    std::vector<int32_t> remap(n_verts, -1);
    int64_t nv = 0;
    for (int64_t i = 0; i < n_verts; i++) {
        if (vert_alive[i]) {
            remap[i] = (int32_t)nv;
            verts_out[3 * nv] = (float)vx[i];
            verts_out[3 * nv + 1] = (float)vy[i];
            verts_out[3 * nv + 2] = (float)vz[i];
            nv++;
        }
    }
    int64_t nf = 0;
    for (int64_t i = 0; i < n_faces; i++) {
        if (!face_alive[i]) continue;
        int32_t a = remap[f0[i]], b = remap[f1[i]], cc = remap[f2[i]];
        if (a < 0 || b < 0 || cc < 0) continue;
        faces_out[3 * nf] = a;
        faces_out[3 * nf + 1] = b;
        faces_out[3 * nf + 2] = cc;
        nf++;
    }
    *out_n_verts = nv;
    *out_n_faces = nf;
    return 0;
}
