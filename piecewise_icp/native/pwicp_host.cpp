// pwicp_host — native host runtime for the Piecewise-ICP framework.
//
// The device handles every O(N) dense computation (NN queries, normals, patch
// statistics, ICP normal equations).  This library provides the host-side
// components that are inherently sequential or pointer-chasing and that the
// reference implements natively in C++ (via PCL/codelibrary):
//
//   * exact k-nearest-neighbour graph over a uniform grid
//     (reference: cl::KDTree, codelibrary/util/tree/kd_tree.h)
//   * grid-sample seed counting
//     (reference: GridSample, codelibrary/geometry/point_cloud/grid_sample.h)
//   * supervoxel segmentation by seeded metric label propagation — a
//     from-scratch parallel formulation covering the same role as the
//     reference's sequential energy-fusion segmenter
//     (supervoxel_segmentation.h:66-248), sharing only the VCCS metric
//     formula (include/Segmentation.h:362-375) and GridSample seed count
//
// Exposed as a C ABI consumed through ctypes (the same binding style as the
// reference's python/main.py DLL interface).
//
// Build: g++ -O3 -shared -fPIC -std=c++17 pwicp_host.cpp -o libpwicp_host.so

#ifdef _OPENMP
#include <omp.h>
#endif

#include <algorithm>
#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Vec3 {
    double x, y, z;
};

inline double sqdist(const Vec3& a, const Vec3& b) {
    const double dx = a.x - b.x, dy = a.y - b.y, dz = a.z - b.z;
    return dx * dx + dy * dy + dz * dz;
}

// ---------------------------------------------------------------------------
// Uniform grid for exact kNN.
// ---------------------------------------------------------------------------
class UniformGrid {
  public:
    UniformGrid(const float* pts, int n, double cell) : n_(n), cell_(cell) {
        pts_.resize(n);
        double mn[3] = {DBL_MAX, DBL_MAX, DBL_MAX};
        double mx[3] = {-DBL_MAX, -DBL_MAX, -DBL_MAX};
        for (int i = 0; i < n; ++i) {
            pts_[i] = {pts[3 * i], pts[3 * i + 1], pts[3 * i + 2]};
            const double c[3] = {pts_[i].x, pts_[i].y, pts_[i].z};
            for (int d = 0; d < 3; ++d) {
                mn[d] = std::min(mn[d], c[d]);
                mx[d] = std::max(mx[d], c[d]);
            }
        }
        for (int d = 0; d < 3; ++d) {
            origin_[d] = mn[d];
            dims_[d] = std::max<int64_t>(
                1, static_cast<int64_t>((mx[d] - mn[d]) / cell_) + 1);
        }
        // CSR bucketing: counting sort of point ids by cell id.
        const int64_t n_cells = dims_[0] * dims_[1] * dims_[2];
        cell_of_.resize(n);
        start_.assign(n_cells + 1, 0);
        for (int i = 0; i < n; ++i) {
            cell_of_[i] = cell_id(pts_[i]);
            ++start_[cell_of_[i] + 1];
        }
        for (int64_t c = 0; c < n_cells; ++c) start_[c + 1] += start_[c];
        order_.resize(n);
        std::vector<int64_t> cursor(start_.begin(), start_.end() - 1);
        for (int i = 0; i < n; ++i) order_[cursor[cell_of_[i]]++] = i;
    }

    int64_t cell_id(const Vec3& p) const {
        int64_t ix = clampi((p.x - origin_[0]) / cell_, dims_[0]);
        int64_t iy = clampi((p.y - origin_[1]) / cell_, dims_[1]);
        int64_t iz = clampi((p.z - origin_[2]) / cell_, dims_[2]);
        return (ix * dims_[1] + iy) * dims_[2] + iz;
    }

    // Exact kNN of query point index q (self included, like the reference's
    // KD-tree search).  Results sorted ascending by distance.
    void knn(int q, int k, int* out_idx) const {
        const Vec3& p = pts_[q];
        const int64_t ix = clampi((p.x - origin_[0]) / cell_, dims_[0]);
        const int64_t iy = clampi((p.y - origin_[1]) / cell_, dims_[1]);
        const int64_t iz = clampi((p.z - origin_[2]) / cell_, dims_[2]);

        // max-heap of (dist2, idx), size <= k
        std::vector<std::pair<double, int>> heap;
        heap.reserve(k + 1);
        auto push = [&](double d2, int idx) {
            if ((int)heap.size() < k) {
                heap.emplace_back(d2, idx);
                std::push_heap(heap.begin(), heap.end());
            } else if (d2 < heap.front().first) {
                std::pop_heap(heap.begin(), heap.end());
                heap.back() = {d2, idx};
                std::push_heap(heap.begin(), heap.end());
            }
        };

        const int64_t max_ring = std::max({dims_[0], dims_[1], dims_[2]});
        for (int64_t ring = 0; ring <= max_ring; ++ring) {
            // Shell lower bound: any point in a ring-r shell is at least
            // (r-1)*cell away from the query.
            if ((int)heap.size() == k) {
                const double bound = (ring > 0 ? (ring - 1) * cell_ : 0.0);
                if (bound * bound > heap.front().first) break;
            }
            bool any_cell = false;
            const int64_t x0 = ix - ring, x1 = ix + ring;
            const int64_t y0 = iy - ring, y1 = iy + ring;
            const int64_t z0 = iz - ring, z1 = iz + ring;
            for (int64_t cx = x0; cx <= x1; ++cx) {
                if (cx < 0 || cx >= dims_[0]) continue;
                for (int64_t cy = y0; cy <= y1; ++cy) {
                    if (cy < 0 || cy >= dims_[1]) continue;
                    for (int64_t cz = z0; cz <= z1; ++cz) {
                        if (cz < 0 || cz >= dims_[2]) continue;
                        // only the shell surface of the ring cube
                        const bool on_shell =
                            (cx == x0 || cx == x1 || cy == y0 || cy == y1 ||
                             cz == z0 || cz == z1);
                        if (!on_shell) continue;
                        any_cell = true;
                        const int64_t c = (cx * dims_[1] + cy) * dims_[2] + cz;
                        for (int64_t s = start_[c]; s < start_[c + 1]; ++s) {
                            const int j = order_[s];
                            push(sqdist(p, pts_[j]), j);
                        }
                    }
                }
            }
            if (!any_cell && ring > max_ring) break;
        }
        std::sort_heap(heap.begin(), heap.end());
        const int found = (int)heap.size();
        for (int i = 0; i < k; ++i)
            out_idx[i] = (i < found) ? heap[i].second : -1;
    }

    const std::vector<Vec3>& points() const { return pts_; }

  private:
    static int64_t clampi(double v, int64_t hi) {
        int64_t i = static_cast<int64_t>(v);
        if (i < 0) i = 0;
        if (i >= hi) i = hi - 1;
        return i;
    }

    int n_;
    double cell_;
    double origin_[3];
    int64_t dims_[3];
    std::vector<Vec3> pts_;
    std::vector<int64_t> cell_of_;
    std::vector<int64_t> start_;
    std::vector<int> order_;
};

// Pick a grid cell size giving ~4 points per cell on average.
double auto_cell_size(const float* pts, int n) {
    double mn[3] = {DBL_MAX, DBL_MAX, DBL_MAX};
    double mx[3] = {-DBL_MAX, -DBL_MAX, -DBL_MAX};
    for (int i = 0; i < n; ++i) {
        for (int d = 0; d < 3; ++d) {
            const double v = pts[3 * i + d];
            mn[d] = std::min(mn[d], v);
            mx[d] = std::max(mx[d], v);
        }
    }
    double vol = 1.0;
    for (int d = 0; d < 3; ++d) vol *= std::max(mx[d] - mn[d], 1e-9);
    return std::cbrt(vol * 4.0 / std::max(n, 1));
}

// VCCS metric (include/Segmentation.h:362-375):
//   d = 1 - |n1 . n2| + ||p1 - p2|| / resolution * 0.4
struct VCCSMetric {
    const Vec3* pts;
    const float* normals;
    double inv_res_04;
    double operator()(int a, int b) const {
        const double dot = normals[3 * a] * normals[3 * b] +
                           normals[3 * a + 1] * normals[3 * b + 1] +
                           normals[3 * a + 2] * normals[3 * b + 2];
        return 1.0 - std::fabs(dot) +
               std::sqrt(sqdist(pts[a], pts[b])) * inv_res_04;
    }
};

}  // namespace

namespace {

// Closed-form smallest eigenvector of a 3x3 covariance (the same
// trigonometric solve as the device kernel in ops/eigh3.py and the
// reference's pca_estimate_normals.h:77-107).
void smallest_eigvec(double a00, double a01, double a02, double a11,
                     double a12, double a22, float* out) {
    const double q = (a00 + a11 + a22) / 3.0;
    const double b00 = a00 - q, b11 = a11 - q, b22 = a22 - q;
    const double p2 = b00 * b00 + b11 * b11 + b22 * b22 +
                      2.0 * (a01 * a01 + a02 * a02 + a12 * a12);
    if (p2 <= 0.0) {
        out[0] = 0.f; out[1] = 0.f; out[2] = 1.f;
        return;
    }
    const double p = std::sqrt(p2 / 6.0);
    const double det_b = b00 * (b11 * b22 - a12 * a12) -
                         a01 * (a01 * b22 - a12 * a02) +
                         a02 * (a01 * a12 - b11 * a02);
    double r = det_b / (2.0 * p * p * p);
    r = std::max(-1.0, std::min(1.0, r));
    const double phi = std::acos(r) / 3.0;
    const double eig = q + 2.0 * p * std::cos(phi + 2.0 * M_PI / 3.0);

    // rows of (A - eig I); pick the largest cross product of two rows
    const double r0[3] = {a00 - eig, a01, a02};
    const double r1[3] = {a01, a11 - eig, a12};
    const double r2[3] = {a02, a12, a22 - eig};
    auto cross = [](const double* u, const double* v, double* w) {
        w[0] = u[1] * v[2] - u[2] * v[1];
        w[1] = u[2] * v[0] - u[0] * v[2];
        w[2] = u[0] * v[1] - u[1] * v[0];
    };
    double c01[3], c02[3], c12[3];
    cross(r0, r1, c01);
    cross(r0, r2, c02);
    cross(r1, r2, c12);
    auto n2 = [](const double* v) {
        return v[0] * v[0] + v[1] * v[1] + v[2] * v[2];
    };
    const double* best = c01;
    double bn = n2(c01);
    if (n2(c02) > bn) { best = c02; bn = n2(c02); }
    if (n2(c12) > bn) { best = c12; bn = n2(c12); }
    if (bn <= 1e-40) {
        out[0] = 0.f; out[1] = 0.f; out[2] = 1.f;
        return;
    }
    const double inv = 1.0 / std::sqrt(bn);
    out[0] = (float)(best[0] * inv);
    out[1] = (float)(best[1] * inv);
    out[2] = (float)(best[2] * inv);
}

}  // namespace

extern "C" {

// Per-point PCA normals from a kNN graph (neighbors [n, k], -1 padded).
// Host equivalent of PCAEstimateNormal (Segmentation.cpp:42-44): smallest
// eigenvector of the neighbourhood covariance.  Returns 0 on success.
int pwicp_pca_normals(const float* points, const int32_t* neighbors, int n,
                      int k, float* out_normals) {
    if (n <= 0 || k <= 0) return 1;
#pragma omp parallel for schedule(static, 1024)
    for (int i = 0; i < n; ++i) {
        double sx = 0, sy = 0, sz = 0;
        int m = 0;
        const int32_t* nb = neighbors + (int64_t)i * k;
        for (int j = 0; j < k; ++j) {
            const int v = nb[j];
            if (v < 0) continue;
            sx += points[3 * v];
            sy += points[3 * v + 1];
            sz += points[3 * v + 2];
            ++m;
        }
        if (m == 0) {
            out_normals[3 * i] = 0.f;
            out_normals[3 * i + 1] = 0.f;
            out_normals[3 * i + 2] = 1.f;
            continue;
        }
        const double mx = sx / m, my = sy / m, mz = sz / m;
        double a00 = 0, a01 = 0, a02 = 0, a11 = 0, a12 = 0, a22 = 0;
        for (int j = 0; j < k; ++j) {
            const int v = nb[j];
            if (v < 0) continue;
            const double x = points[3 * v] - mx;
            const double y = points[3 * v + 1] - my;
            const double z = points[3 * v + 2] - mz;
            a00 += x * x; a01 += x * y; a02 += x * z;
            a11 += y * y; a12 += y * z; a22 += z * z;
        }
        const double t = 1.0 / m;
        smallest_eigvec(a00 * t, a01 * t, a02 * t, a11 * t, a12 * t,
                        a22 * t, out_normals + 3 * i);
    }
    return 0;
}

// Exact kNN graph (self included, ascending by distance).  Cell size < 0
// selects an automatic density-based value.  Returns 0 on success.
int pwicp_knn_graph(const float* points, int n, int k, double cell_size,
                    int32_t* out_idx) {
    if (n <= 0 || k <= 0) return 1;
    const double cell = cell_size > 0 ? cell_size : auto_cell_size(points, n);
    UniformGrid grid(points, n, cell);
#pragma omp parallel for schedule(dynamic, 256)
    for (int i = 0; i < n; ++i) grid.knn(i, k, out_idx + (int64_t)i * k);
    return 0;
}

// Number of occupied voxels at the given resolution — the expected
// supervoxel count K (GridSample semantics, grid_sample.h:49-75: grid sizes
// int(len/res)+1 over the bounding box, coordinates clamped).
int pwicp_grid_sample_count(const float* points, int n, double resolution) {
    if (n <= 0 || resolution <= 0) return 0;
    double mn[3] = {DBL_MAX, DBL_MAX, DBL_MAX};
    double mx[3] = {-DBL_MAX, -DBL_MAX, -DBL_MAX};
    for (int i = 0; i < n; ++i) {
        for (int d = 0; d < 3; ++d) {
            const double v = points[3 * i + d];
            mn[d] = std::min(mn[d], v);
            mx[d] = std::max(mx[d], v);
        }
    }
    int64_t dims[3];
    for (int d = 0; d < 3; ++d)
        dims[d] = static_cast<int64_t>((mx[d] - mn[d]) / resolution) + 1;
    std::vector<int64_t> cells(n);
    for (int i = 0; i < n; ++i) {
        int64_t id[3];
        for (int d = 0; d < 3; ++d) {
            int64_t c = static_cast<int64_t>(
                (points[3 * i + d] - mn[d]) / resolution);
            id[d] = std::min(std::max<int64_t>(c, 0), dims[d] - 1);
        }
        cells[i] = (id[0] * dims[1] + id[1]) * dims[2] + id[2];
    }
    std::sort(cells.begin(), cells.end());
    return (int)(std::unique(cells.begin(), cells.end()) - cells.begin());
}

// Mean distance to the k nearest non-self neighbours of every point — the
// statistic of PCL StatisticalOutlierRemoval (CommonFunc.cpp:442-452).
// Exact grid kNN, OpenMP over points; the caller applies the global
// mean + mult * std threshold.
int pwicp_sor_mean_dist(const float* points, int n, int k, double cell_size,
                        float* out_mean) {
    if (n <= 0 || k <= 0) return 1;
    const double cell = cell_size > 0 ? cell_size : auto_cell_size(points, n);
    UniformGrid grid(points, n, cell);
#pragma omp parallel for schedule(dynamic, 256)
    for (int i = 0; i < n; ++i) {
        const int kk = std::min(k + 1, n);
        std::vector<int> idx(kk, -1);
        grid.knn(i, kk, idx.data());
        double s = 0.0;
        int cnt = 0;
        bool self_skipped = false;
        for (int j = 0; j < kk && cnt < k; ++j) {
            const int v = idx[j];
            if (v < 0) continue;
            if (v == i && !self_skipped) { self_skipped = true; continue; }
            const double dx = points[3 * i] - points[3 * v];
            const double dy = points[3 * i + 1] - points[3 * v + 1];
            const double dz = points[3 * i + 2] - points[3 * v + 2];
            s += std::sqrt(dx * dx + dy * dy + dz * dz);
            ++cnt;
        }
        out_mean[i] = cnt > 0 ? (float)(s / cnt) : 0.0f;
    }
    return 0;
}

// ---------------------------------------------------------------------------
// Parallel supervoxel segmentation by seeded metric label propagation.
//
// A from-scratch alternative to the greedy energy-fusion segmenter above
// (which follows the reference's sequential algorithm; SURVEY.md §7 "hard
// part #1" asks for a parallel formulation).  Design:
//
//   1. SEEDS — one per occupied voxel at `resolution`: the point nearest
//      the voxel centre (deterministic; the reference picks a random point
//      per voxel).  Seed count K therefore matches GridSample's K.
//   2. PROPAGATION — multi-source region growing over the kNN graph in
//      synchronous rounds: every point adopts the label of the
//      neighbouring region whose SEED is closest under the VCCS metric
//      (1 - |n_i . n_s| + 0.4 * ||p_i - p_s|| / resolution).  Rounds are
//      embarrassingly parallel (each reads the previous round's labels,
//      double-buffered), deterministic, and converge in O(supervoxel
//      diameter) rounds since a point's best-seed distance only decreases.
//   3. Orphans (points whose graph component contains no seed) join their
//      Euclidean-nearest labelled kNN neighbour after convergence.
//
// This is a constrained-k-means/SLIC-style assignment in metric space, not
// an energy fusion: regions are metric-Voronoi cells around seeds grown
// along the graph.  Boundary refinement is inherent (every round IS a
// refinement sweep), so no separate queue pass is needed.
// ---------------------------------------------------------------------------

int pwicp_supervoxel_propagate_o(const float* points, const float* normals,
                                 const int32_t* neighbors, int n, int k,
                                 double resolution, const double* origin,
                                 int32_t* out_labels) {
    if (n <= 0 || k <= 0 || resolution <= 0) return -1;
    std::vector<Vec3> pts(n);
    for (int i = 0; i < n; ++i)
        pts[i] = {points[3 * i], points[3 * i + 1], points[3 * i + 2]};
    VCCSMetric metric{pts.data(), normals, 0.4 / resolution};
    auto nb = [&](int i, int j) { return neighbors[(int64_t)i * k + j]; };

    // --- seeds: per occupied voxel, the point nearest the voxel centre.
    //     `origin` (optional, must be <= cloud min) anchors the lattice so
    //     campaign epochs share one world-frame voxelisation (see
    //     models/segmentation_device.propagate_seeds) ---
    double mn[3] = {DBL_MAX, DBL_MAX, DBL_MAX};
    double mx[3] = {-DBL_MAX, -DBL_MAX, -DBL_MAX};
    for (int i = 0; i < n; ++i)
        for (int d = 0; d < 3; ++d) {
            const double v = points[3 * i + d];
            mn[d] = std::min(mn[d], v);
            mx[d] = std::max(mx[d], v);
        }
    if (origin)
        for (int d = 0; d < 3; ++d) mn[d] = origin[d];
    int64_t dims[3];
    for (int d = 0; d < 3; ++d)
        dims[d] = static_cast<int64_t>((mx[d] - mn[d]) / resolution) + 1;
    struct Cand { int64_t cell; double d2c; int idx; };
    std::vector<Cand> cands(n);
    for (int i = 0; i < n; ++i) {
        int64_t id[3];
        double d2c = 0.0;
        for (int d = 0; d < 3; ++d) {
            int64_t c = static_cast<int64_t>(
                (points[3 * i + d] - mn[d]) / resolution);
            id[d] = std::min(std::max<int64_t>(c, 0), dims[d] - 1);
            const double ctr = mn[d] + (id[d] + 0.5) * resolution;
            const double dd = points[3 * i + d] - ctr;
            d2c += dd * dd;
        }
        cands[i] = {(id[0] * dims[1] + id[1]) * dims[2] + id[2], d2c, i};
    }
    std::sort(cands.begin(), cands.end(), [](const Cand& a, const Cand& b) {
        if (a.cell != b.cell) return a.cell < b.cell;
        if (a.d2c != b.d2c) return a.d2c < b.d2c;
        return a.idx < b.idx;
    });
    std::vector<int> seeds;
    for (int i = 0; i < n; ++i)
        if (i == 0 || cands[i].cell != cands[i - 1].cell)
            seeds.push_back(cands[i].idx);
    const int n_seeds = (int)seeds.size();

    // --- synchronous label propagation, double-buffered ---
    std::vector<int32_t> lab(n, -1), lab_next(n, -1);
    std::vector<double> dist(n, DBL_MAX), dist_next(n, DBL_MAX);
    for (int s = 0; s < n_seeds; ++s) {
        lab[seeds[s]] = s;
        dist[seeds[s]] = 0.0;   // a seed stays its own region's anchor
    }
    for (int round = 0; round < 256; ++round) {
        int changed = 0;
#pragma omp parallel for schedule(static) reduction(+:changed)
        for (int i = 0; i < n; ++i) {
            int32_t best_l = lab[i];
            double best_d = dist[i];
            for (int j = 0; j < k; ++j) {
                const int v = nb(i, j);
                if (v < 0 || v == i) continue;
                const int32_t lv = lab[v];
                if (lv < 0 || lv == best_l) continue;
                const double d = metric(i, seeds[lv]);
                if (d < best_d || (d == best_d && lv < best_l)) {
                    best_d = d;
                    best_l = lv;
                }
            }
            lab_next[i] = best_l;
            dist_next[i] = best_d;
            changed += (best_l != lab[i]);
        }
        lab.swap(lab_next);
        dist.swap(dist_next);
        if (changed == 0) break;
    }

    // --- orphans: adopt the Euclidean-nearest labelled neighbour ---
    for (bool any = true; any;) {
        any = false;
        int adopted = 0;
#pragma omp parallel for schedule(static) reduction(+:adopted)
        for (int i = 0; i < n; ++i) {
            lab_next[i] = lab[i];
            if (lab[i] >= 0) continue;
            double best = DBL_MAX;
            int32_t bl = -1;
            for (int j = 0; j < k; ++j) {
                const int v = nb(i, j);
                if (v < 0 || lab[v] < 0) continue;
                const double d = sqdist(pts[i], pts[v]);
                if (d < best) { best = d; bl = lab[v]; }
            }
            if (bl >= 0) { lab_next[i] = bl; ++adopted; }
        }
        lab.swap(lab_next);
        if (adopted > 0) any = true;
        else break;
    }
    for (int i = 0; i < n; ++i)           // isolated points: own label
        if (lab[i] < 0) lab[i] = -1;

    // --- compact labels in first-occurrence order ---
    std::vector<int32_t> remap(n_seeds + 1, -1);
    int next = 0;
    for (int i = 0; i < n; ++i) {
        if (lab[i] < 0) { out_labels[i] = next++; continue; }
        if (remap[lab[i]] < 0) remap[lab[i]] = next++;
        out_labels[i] = remap[lab[i]];
    }
    return next;
}

int pwicp_supervoxel_propagate(const float* points, const float* normals,
                               const int32_t* neighbors, int n, int k,
                               double resolution, int32_t* out_labels) {
    return pwicp_supervoxel_propagate_o(points, normals, neighbors, n, k,
                                        resolution, nullptr, out_labels);
}

// ---------------------------------------------------------------------------
// LZF codec — the stream format used by PCL's binary_compressed PCD payload
// (pcl::lzfCompress / lzfDecompress; loadPCDFile handles this mode).
// Independent implementation from the stream format:
//   ctrl < 32             -> literal run of ctrl+1 bytes
//   ctrl >= 32            -> back-reference; len' = ctrl >> 5 (7 => +extra
//                            byte), distance = ((ctrl & 31) << 8) + next + 1,
//                            copies len' + 2 bytes (overlap allowed).
// ---------------------------------------------------------------------------

int pwicp_lzf_decompress(const unsigned char* in, int in_len,
                         unsigned char* out, int out_len) {
    int ip = 0, op = 0;
    while (ip < in_len) {
        const unsigned ctrl = in[ip++];
        if (ctrl < 32) {                         // literal run
            const int len = (int)ctrl + 1;
            if (ip + len > in_len || op + len > out_len) return -1;
            std::memcpy(out + op, in + ip, len);
            ip += len;
            op += len;
        } else {                                 // back reference
            int len = (int)(ctrl >> 5);
            if (len == 7) {
                if (ip >= in_len) return -1;
                len += in[ip++];
            }
            len += 2;
            if (ip >= in_len) return -1;
            int ref = op - (((int)(ctrl & 0x1f)) << 8) - (int)in[ip++] - 1;
            if (ref < 0 || op + len > out_len) return -1;
            for (int i = 0; i < len; ++i) out[op + i] = out[ref + i];
            op += len;
        }
    }
    return op;
}

int pwicp_lzf_compress(const unsigned char* in, int in_len,
                       unsigned char* out, int out_cap) {
    constexpr int kHashBits = 14;
    constexpr int kHashSize = 1 << kHashBits;
    constexpr int kMaxDist = 8192;               // (31 << 8) + 255 + 1
    constexpr int kMaxMatch = 264;               // 7 + 255 + 2
    std::vector<int> table(kHashSize, -1);
    auto hash3 = [&](int i) {
        const unsigned v = ((unsigned)in[i] << 16) | ((unsigned)in[i + 1] << 8)
                           | (unsigned)in[i + 2];
        return (int)((v * 2654435761u) >> (32 - kHashBits));
    };
    int ip = 0, op = 0, lit_start = 0;
    auto flush_literals = [&](int end) -> bool {
        int s = lit_start;
        while (s < end) {
            const int run = std::min(32, end - s);
            if (op + 1 + run > out_cap) return false;
            out[op++] = (unsigned char)(run - 1);
            std::memcpy(out + op, in + s, run);
            op += run;
            s += run;
        }
        return true;
    };
    while (ip + 2 < in_len) {
        const int h = hash3(ip);
        const int cand = table[h];
        table[h] = ip;
        if (cand >= 0 && ip - cand <= kMaxDist
            && in[cand] == in[ip] && in[cand + 1] == in[ip + 1]
            && in[cand + 2] == in[ip + 2]) {
            int len = 3;
            const int max_len = std::min(kMaxMatch, in_len - ip);
            while (len < max_len && in[cand + len] == in[ip + len]) ++len;
            if (!flush_literals(ip)) return -1;
            const int dist = ip - cand - 1;       // stored distance - 1
            const int lenp = len - 2;
            if (lenp < 7) {
                if (op + 2 > out_cap) return -1;
                out[op++] = (unsigned char)((lenp << 5) | (dist >> 8));
            } else {
                if (op + 3 > out_cap) return -1;
                out[op++] = (unsigned char)((7 << 5) | (dist >> 8));
                out[op++] = (unsigned char)(lenp - 7);
            }
            out[op++] = (unsigned char)(dist & 0xff);
            // index a couple of positions inside the match for better chains
            for (int j = 1; j < len && ip + j + 2 < in_len; j += (len > 16 ? 4 : 1))
                table[hash3(ip + j)] = ip + j;
            ip += len;
            lit_start = ip;
        } else {
            ++ip;
        }
    }
    if (!flush_literals(in_len)) return -1;
    return op;
}

}  // extern "C"
