// Isosurface extraction for TSDF volumes (host-side, C++17).
//
// The port's own copy of native/marching.cpp, line for line in its code:
// built with the same g++ flags (ops/build.py, HOST_FLAGS), the same volume
// gives the same mesh bit for bit in both packages. It replaces the
// reference's CUDA marching-cubes extension (reference:
// tools/marching_cubes/marching_cubes.cu) and the single-mesh scikit-image
// fork used for eval meshes (tools/tsdf.py:196-202). The hint loop raycasts
// the TSDF directly, so surface extraction runs once per scan, for mesh
// export and evaluation: host code, not a device kernel.
//
// Algorithm: marching tetrahedra over the dense grid (each cell split into
// six tetrahedra around the main diagonal, consistent across cells), with
// vertices placed by linear interpolation on edges and deduplicated by a
// global edge key — yielding a single-walled, shared-vertex mesh (the
// property the reference's custom skimage fork provides). Cells touching
// unobserved voxels (weight <= wthresh) are skipped, mirroring the CUDA
// path's active-voxel restriction.
//
// C ABI (ctypes): two-call protocol — extract once to get counts with
// null output pointers, then again with allocated buffers; or use the
// malloc-returning variant with mt_free.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace {

struct MeshBuffers {
    std::vector<float> verts;   // xyz triples
    std::vector<int32_t> faces; // index triples
};

// corner offsets of a unit cell
static const int CORNER[8][3] = {
    {0, 0, 0}, {1, 0, 0}, {1, 1, 0}, {0, 1, 0},
    {0, 0, 1}, {1, 0, 1}, {1, 1, 1}, {0, 1, 1},
};

// six tetrahedra spanning the cube around the 0-6 diagonal (consistent
// decomposition: every face diagonal is shared identically by neighbors)
static const int TETS[6][4] = {
    {0, 5, 1, 6}, {0, 1, 2, 6}, {0, 2, 3, 6},
    {0, 3, 7, 6}, {0, 7, 4, 6}, {0, 4, 5, 6},
};

struct Extractor {
    const float* vol;
    const float* wts;
    float wthresh;
    int nx, ny, nz;
    float iso;
    MeshBuffers out;
    std::unordered_map<uint64_t, int32_t> edge_cache;

    inline int64_t gid(int x, int y, int z) const {
        return (int64_t)(x) * ny * nz + (int64_t)(y) * nz + z;
    }
    inline float val(int64_t g) const { return vol[g]; }
    inline bool observed(int64_t g) const {
        return wts == nullptr || wts[g] > wthresh;
    }

    int32_t edge_vertex(int64_t ga, int64_t gb, float va, float vb) {
        if (gb < ga) { std::swap(ga, gb); std::swap(va, vb); }
        uint64_t key = ((uint64_t)ga << 32) | (uint64_t)gb;
        auto it = edge_cache.find(key);
        if (it != edge_cache.end()) return it->second;

        // linear interpolation of the zero crossing along the edge
        float denom = va - vb;
        float t = (denom == 0.0f) ? 0.5f : (va - iso) / denom;
        if (t < 0.f) t = 0.f;
        if (t > 1.f) t = 1.f;

        // decode grid coords from global ids
        int ax = (int)(ga / ((int64_t)ny * nz));
        int ay = (int)((ga / nz) % ny);
        int az = (int)(ga % nz);
        int bx = (int)(gb / ((int64_t)ny * nz));
        int by = (int)((gb / nz) % ny);
        int bz = (int)(gb % nz);

        int32_t idx = (int32_t)(out.verts.size() / 3);
        out.verts.push_back(ax + t * (bx - ax));
        out.verts.push_back(ay + t * (by - ay));
        out.verts.push_back(az + t * (bz - az));
        edge_cache.emplace(key, idx);
        return idx;
    }

    void emit_tri(int32_t a, int32_t b, int32_t c) {
        if (a == b || b == c || a == c) return; // degenerate
        out.faces.push_back(a);
        out.faces.push_back(b);
        out.faces.push_back(c);
    }

    // process one tetrahedron given global corner ids
    void do_tet(const int64_t g[4]) {
        float v[4];
        bool inside[4];
        int code = 0;
        for (int i = 0; i < 4; ++i) {
            v[i] = val(g[i]);
            inside[i] = v[i] < iso;
            if (inside[i]) code |= 1 << i;
        }
        if (code == 0 || code == 15) return;

        // collect crossing edges of the tet (the 6 edges)
        static const int TE[6][2] = {{0,1},{0,2},{0,3},{1,2},{1,3},{2,3}};
        int32_t ev[6];
        int n = 0;
        int which[6];
        for (int e = 0; e < 6; ++e) {
            int a = TE[e][0], b = TE[e][1];
            if (inside[a] != inside[b]) {
                ev[n] = edge_vertex(g[a], g[b], v[a], v[b]);
                which[n] = e;
                ++n;
            }
        }
        if (n == 3) {
            // single corner isolated: one triangle; orient by which corner
            // is inside (normal toward positive side)
            int lone = -1;
            int cnt = (inside[0] ? 1 : 0) + (inside[1] ? 1 : 0) +
                      (inside[2] ? 1 : 0) + (inside[3] ? 1 : 0);
            bool lone_inside = (cnt == 1);
            for (int i = 0; i < 4; ++i)
                if (inside[i] == lone_inside) lone = i;
            (void)lone;
            emit_tri(ev[0], ev[1], ev[2]);
        } else if (n == 4) {
            // quad case: order the four edge vertices into a strip. The
            // four crossing edges share two inside and two outside corners;
            // ordering ev pairs that share a tet corner adjacently gives a
            // valid fan.
            // find pairing: edges sharing a corner are adjacent in the quad
            auto shares = [&](int e1, int e2) {
                int a1 = TE[which[e1]][0], b1 = TE[which[e1]][1];
                int a2 = TE[which[e2]][0], b2 = TE[which[e2]][1];
                return a1 == a2 || a1 == b2 || b1 == a2 || b1 == b2;
            };
            // ev[0] is adjacent to exactly two of the others
            int adj[2], opp = -1, k = 0;
            for (int i = 1; i < 4; ++i) {
                if (shares(0, i) && k < 2) adj[k++] = i;
                else opp = i;
            }
            emit_tri(ev[0], ev[adj[0]], ev[opp]);
            emit_tri(ev[0], ev[opp], ev[adj[1]]);
        }
    }

    void run() {
        for (int x = 0; x < nx - 1; ++x)
            for (int y = 0; y < ny - 1; ++y)
                for (int z = 0; z < nz - 1; ++z) {
                    int64_t g[8];
                    bool all_obs = true;
                    bool any_lo = false, any_hi = false;
                    for (int c = 0; c < 8; ++c) {
                        g[c] = gid(x + CORNER[c][0], y + CORNER[c][1],
                                   z + CORNER[c][2]);
                        if (!observed(g[c])) { all_obs = false; break; }
                        float v = val(g[c]);
                        if (v < iso) any_lo = true; else any_hi = true;
                    }
                    if (!all_obs || !any_lo || !any_hi) continue;
                    for (int t = 0; t < 6; ++t) {
                        int64_t tg[4] = {g[TETS[t][0]], g[TETS[t][1]],
                                         g[TETS[t][2]], g[TETS[t][3]]};
                        do_tet(tg);
                    }
                }
    }
};

} // namespace

extern "C" {

// Extract the isosurface. Returns 0 on success. Outputs are malloc'd;
// caller frees with mt_free. weights may be null (no observedness mask).
int marching_tetrahedra(
    const float* volume, const float* weights, float weight_threshold,
    int nx, int ny, int nz, float isolevel,
    float** out_verts, int64_t* out_num_verts,
    int32_t** out_faces, int64_t* out_num_faces) {
    Extractor ex;
    ex.vol = volume;
    ex.wts = weights;
    ex.wthresh = weight_threshold;
    ex.nx = nx; ex.ny = ny; ex.nz = nz;
    ex.iso = isolevel;
    ex.run();

    *out_num_verts = (int64_t)(ex.out.verts.size() / 3);
    *out_num_faces = (int64_t)(ex.out.faces.size() / 3);
    *out_verts = (float*)std::malloc(ex.out.verts.size() * sizeof(float));
    *out_faces = (int32_t*)std::malloc(ex.out.faces.size() * sizeof(int32_t));
    if ((*out_verts == nullptr && !ex.out.verts.empty()) ||
        (*out_faces == nullptr && !ex.out.faces.empty()))
        return 1;
    std::memcpy(*out_verts, ex.out.verts.data(),
                ex.out.verts.size() * sizeof(float));
    std::memcpy(*out_faces, ex.out.faces.data(),
                ex.out.faces.size() * sizeof(int32_t));
    return 0;
}

void mt_free(void* p) { std::free(p); }

} // extern "C"
