// Native host-side kernels for the scenenet_tpu_torch data pipeline: the port's own
// copy of the JAX package's scenenet_tpu/native/voxel_native.cpp.
//
// The reference delegates its host hot loops to third-party native code
// (pyntcloud/pandas C internals for voxel binning, Open3D's C++ DBSCAN,
// laspy for LAS decoding — SURVEY.md §2.9). Here the equivalents are
// first-class, dependency-free C++ exposed over a C ABI (ctypes):
//
//   snt_voxelize : grid-spec fit (pyntcloud semantics) + per-point bin
//                  indices + fused hist/reg grids in a single pass
//   snt_dbscan   : grid-hashed DBSCAN (Open3D-compatible label contract)
//   snt_read_las : LAS 1.1-1.4 point decode (xyz + classification)
//
// Built with batch_loader.cpp at first use by scenenet_tpu_torch/native/__init__.py
// (g++ -O3 -shared -fPIC -pthread) into build/native/.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <queue>
#include <unordered_map>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Voxelization
// ---------------------------------------------------------------------------

// Fit the pyntcloud-style grid spec: regular bounding box expansion, then
// (optionally) per-axis size margins. Returns bin counts via shape_out.
static void fit_spec(const double* xyz, int64_t n,
                     const int64_t* vxg, const double* vox, int use_vox,
                     double* mins_out, double* maxs_out, int64_t* shape_out) {
    double mins[3], maxs[3];
    for (int a = 0; a < 3; ++a) { mins[a] = xyz[a]; maxs[a] = xyz[a]; }
    for (int64_t i = 1; i < n; ++i) {
        for (int a = 0; a < 3; ++a) {
            double v = xyz[i * 3 + a];
            if (v < mins[a]) mins[a] = v;
            if (v > maxs[a]) maxs[a] = v;
        }
    }
    double range[3], max_range = 0.0;
    for (int a = 0; a < 3; ++a) {
        range[a] = maxs[a] - mins[a];
        max_range = std::max(max_range, range[a]);
    }
    for (int a = 0; a < 3; ++a) {  // regular bounding box
        double margin = max_range - range[a];
        mins[a] -= margin / 2;
        maxs[a] += margin / 2;
    }
    if (use_vox) {
        for (int a = 0; a < 3; ++a) {
            double size = vox[a];
            double margin = (std::floor(range[a] / size) + 1.0) * size - range[a];
            mins[a] -= margin / 2;
            maxs[a] += margin / 2;
            shape_out[a] = (int64_t)((maxs[a] - mins[a]) / size);
        }
    } else {
        for (int a = 0; a < 3; ++a) shape_out[a] = vxg[a];
    }
    for (int a = 0; a < 3; ++a) { mins_out[a] = mins[a]; maxs_out[a] = maxs[a]; }
}

// searchsorted-left over linspace edges (replicates numpy linspace rounding
// by materializing the edges exactly as the host oracle does)
static inline int64_t bin_of(double v, const std::vector<double>& edges) {
    auto it = std::lower_bound(edges.begin(), edges.end(), v);
    int64_t j = (int64_t)(it - edges.begin()) - 1;
    int64_t n = (int64_t)edges.size() - 2;
    return std::min(std::max(j, (int64_t)0), n);
}

// Fused hist+reg voxelization. Outputs (z,x,y)-ordered dense grids.
//   hist_out: n_z*n_x*n_y doubles (raw counts; normalize on the caller)
//   reg_out:  n_z*n_x*n_y doubles (tower fraction)
//   idx_out:  n int64 flat (z,x,y) bin per point (for the device path)
// Returns 0 on success.
int snt_voxelize(const double* xyz, const double* labels, int64_t n,
                 const int64_t* vxg_size, const double* vox_size, int use_vox,
                 const double* keep_labels, int64_t n_keep,
                 double* mins_out, double* maxs_out, int64_t* shape_out,
                 double* hist_out, double* reg_out, int64_t* idx_out) {
    if (n <= 0) return 1;
    fit_spec(xyz, n, vxg_size, vox_size, use_vox, mins_out, maxs_out, shape_out);
    int64_t nx = shape_out[0], ny = shape_out[1], nz = shape_out[2];

    std::vector<double> edges[3];
    for (int a = 0; a < 3; ++a) {
        int64_t bins = shape_out[a];
        edges[a].resize(bins + 1);
        // numpy linspace: start + i*step with endpoint pinned
        double start = mins_out[a], stop = maxs_out[a];
        double step = (stop - start) / (double)bins;
        for (int64_t i = 0; i <= bins; ++i) edges[a][i] = start + step * (double)i;
        edges[a][bins] = stop;
    }

    int64_t size = nx * ny * nz;
    std::memset(hist_out, 0, sizeof(double) * size);
    std::memset(reg_out, 0, sizeof(double) * size);

    for (int64_t i = 0; i < n; ++i) {
        int64_t bx = bin_of(xyz[i * 3 + 0], edges[0]);
        int64_t by = bin_of(xyz[i * 3 + 1], edges[1]);
        int64_t bz = bin_of(xyz[i * 3 + 2], edges[2]);
        int64_t flat = (bz * nx + bx) * ny + by;
        if (idx_out) idx_out[i] = flat;
        hist_out[flat] += 1.0;
        if (labels) {
            double lab = labels[i];
            for (int64_t k = 0; k < n_keep; ++k) {
                if (lab == keep_labels[k]) { reg_out[flat] += 1.0; break; }
            }
        }
    }
    for (int64_t v = 0; v < size; ++v) {
        if (hist_out[v] > 0.0) reg_out[v] /= hist_out[v];
    }
    return 0;
}

// Fit-only entry point: lets the caller size hist/reg buffers from the
// SAME float path snt_voxelize will use (a host-side reimplementation
// could disagree by one truncated bin and under-allocate — heap overflow).
int snt_fit_spec(const double* xyz, int64_t n,
                 const int64_t* vxg_size, const double* vox_size, int use_vox,
                 double* mins_out, double* maxs_out, int64_t* shape_out) {
    if (n <= 0) return 1;
    fit_spec(xyz, n, vxg_size, vox_size, use_vox, mins_out, maxs_out, shape_out);
    return 0;
}

// ---------------------------------------------------------------------------
// DBSCAN (grid-hashed; labels: -1 noise, clusters from 0)
// ---------------------------------------------------------------------------

struct CellKey {
    int64_t x, y, z;
    bool operator==(const CellKey& o) const { return x == o.x && y == o.y && z == o.z; }
};
struct CellHash {
    size_t operator()(const CellKey& k) const {
        return (size_t)(k.x * 73856093LL ^ k.y * 19349663LL ^ k.z * 83492791LL);
    }
};

int snt_dbscan(const double* xyz, int64_t n, double eps, int64_t min_points,
               int64_t* labels_out) {
    if (n <= 0) return 0;
    const double eps2 = eps * eps;
    std::unordered_map<CellKey, std::vector<int64_t>, CellHash> cells;
    cells.reserve((size_t)n);
    auto cell_of = [&](int64_t i) {
        return CellKey{(int64_t)std::floor(xyz[i * 3 + 0] / eps),
                       (int64_t)std::floor(xyz[i * 3 + 1] / eps),
                       (int64_t)std::floor(xyz[i * 3 + 2] / eps)};
    };
    for (int64_t i = 0; i < n; ++i) cells[cell_of(i)].push_back(i);

    std::vector<int64_t> nbr;
    auto neighbors = [&](int64_t i, std::vector<int64_t>& out) {
        out.clear();
        CellKey c = cell_of(i);
        for (int64_t dx = -1; dx <= 1; ++dx)
            for (int64_t dy = -1; dy <= 1; ++dy)
                for (int64_t dz = -1; dz <= 1; ++dz) {
                    auto it = cells.find(CellKey{c.x + dx, c.y + dy, c.z + dz});
                    if (it == cells.end()) continue;
                    for (int64_t j : it->second) {
                        double ddx = xyz[i * 3] - xyz[j * 3];
                        double ddy = xyz[i * 3 + 1] - xyz[j * 3 + 1];
                        double ddz = xyz[i * 3 + 2] - xyz[j * 3 + 2];
                        if (ddx * ddx + ddy * ddy + ddz * ddz <= eps2) out.push_back(j);
                    }
                }
    };

    const int64_t UNVISITED = -2;
    for (int64_t i = 0; i < n; ++i) labels_out[i] = UNVISITED;
    int64_t cluster = 0;
    std::queue<int64_t> queue;
    std::vector<int64_t> nbr2;
    for (int64_t i = 0; i < n; ++i) {
        if (labels_out[i] != UNVISITED) continue;
        neighbors(i, nbr);
        if ((int64_t)nbr.size() < min_points) { labels_out[i] = -1; continue; }
        labels_out[i] = cluster;
        for (int64_t j : nbr) queue.push(j);
        while (!queue.empty()) {
            int64_t j = queue.front(); queue.pop();
            if (labels_out[j] == -1) labels_out[j] = cluster;  // border
            if (labels_out[j] != UNVISITED) continue;
            labels_out[j] = cluster;
            neighbors(j, nbr2);
            if ((int64_t)nbr2.size() >= min_points)
                for (int64_t k : nbr2) queue.push(k);
        }
        ++cluster;
    }
    return (int)cluster;
}

// ---------------------------------------------------------------------------
// LAS reader (uncompressed 1.1-1.4, point formats 0-10)
// ---------------------------------------------------------------------------

// Pass 1 (xyz==nullptr): returns point count. Pass 2: fills xyz + classes.
int64_t snt_read_las(const char* path, double* xyz, uint8_t* classes) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return -1;
    uint8_t header[375];
    if (std::fread(header, 1, 375, f) < 227) { std::fclose(f); return -2; }
    if (std::memcmp(header, "LASF", 4) != 0) { std::fclose(f); return -3; }
    uint8_t ver_minor = header[25];
    uint32_t offset; std::memcpy(&offset, header + 96, 4);
    uint8_t fmt_raw = header[104];
    if (fmt_raw & 0xC0) { std::fclose(f); return -4; }  // LAZ
    uint8_t fmt = fmt_raw & 0x3F;
    uint16_t reclen; std::memcpy(&reclen, header + 105, 2);
    uint32_t n32; std::memcpy(&n32, header + 107, 4);
    int64_t n = n32;
    double scale[3], off[3];
    std::memcpy(scale, header + 131, 24);
    std::memcpy(off, header + 155, 24);
    if (ver_minor >= 4) {
        uint64_t n64; std::memcpy(&n64, header + 247, 8);
        if (n64) n = (int64_t)n64;
    }
    if (!xyz) { std::fclose(f); return n; }

    int cls_off = fmt >= 6 ? 16 : 15;
    std::fseek(f, (long)offset, SEEK_SET);
    std::vector<uint8_t> rec(reclen);
    for (int64_t i = 0; i < n; ++i) {
        if (std::fread(rec.data(), 1, reclen, f) != reclen) { std::fclose(f); return -5; }
        int32_t xi, yi, zi;
        std::memcpy(&xi, rec.data(), 4);
        std::memcpy(&yi, rec.data() + 4, 4);
        std::memcpy(&zi, rec.data() + 8, 4);
        xyz[i * 3 + 0] = xi * scale[0] + off[0];
        xyz[i * 3 + 1] = yi * scale[1] + off[1];
        xyz[i * 3 + 2] = zi * scale[2] + off[2];
        uint8_t c = rec[cls_off];
        classes[i] = fmt < 6 ? (uint8_t)(c & 0x1F) : c;
    }
    std::fclose(f);
    return n;
}

}  // extern "C"
