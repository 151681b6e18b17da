// Host-side kernels of the palette extraction, built with g++ and called through ctypes.
//
// The port's own copy of palettenerf_tpu/native/palette_native.cpp (the same functions,
// the same arithmetic and summation order):
//  - weighted RGB histogram  (reference: palette/src/bindings.cpp:40-91, CPU C++)
//  - point-to-triangle distance batch (reference: GteDistPointTriangle.pyx, Cython)
//
// Plain C ABI. palettenerf_torch/native/__init__.py builds it at first use into
// palettenerf_torch/build/ with
//   g++ -O3 -march=native -fopenmp -shared -fPIC palette_native.cpp -o <lib>
// or, where that fails, without -march=native -fopenmp; a failed build raises there.
// The NumPy versions in palettenerf_torch/extraction/ are the plain versions of both.

#include <cstdint>
#include <cstring>
#include <cmath>
#include <algorithm>

extern "C" {

// Weighted RGB histogram over a uniform 2^bpc-per-channel grid.
// colors: [n*3] floats in [0,1]; weights: [n]; out_weights: [2^(3*bpc)] doubles.
// Bin packing: (r << 2bpc) | (g << bpc) | b, channels clamped to [0, 0.999].
void rgb_histogram(const float* colors, const float* weights, int64_t n,
                   int bpc, double* out_weights) {
    const int side = 1 << bpc;
    const int64_t num_bins = (int64_t)side * side * side;
    std::memset(out_weights, 0, num_bins * sizeof(double));
    for (int64_t i = 0; i < n; ++i) {
        uint32_t idx = 0;
        for (int c = 0; c < 3; ++c) {
            float v = colors[i * 3 + c];
            v = std::max(0.0f, std::min(0.999f, v));
            idx = (idx << bpc) + (uint32_t)(v * (float)side);
        }
        out_weights[idx] += (double)weights[i];
    }
}

// Bin centers for the histogram above: out [2^(3*bpc) * 3] floats.
void rgb_histogram_centers(int bpc, float* out_centers) {
    const int side = 1 << bpc;
    const int64_t num_bins = (int64_t)side * side * side;
    for (int64_t ibin = 0; ibin < num_bins; ++ibin) {
        uint32_t code = (uint32_t)ibin;
        for (int c = 2; c >= 0; --c) {
            out_centers[ibin * 3 + c] = ((float)(code & (side - 1)) + 0.5f) / (float)side;
            code >>= bpc;
        }
    }
}

namespace {

// Closest point on one triangle (Eberly-style region decomposition).
inline double closest_on_triangle(const double* p, const double* a,
                                  const double* b, const double* c,
                                  double* out_closest) {
    double e0[3], e1[3], d[3];
    for (int k = 0; k < 3; ++k) {
        e0[k] = b[k] - a[k];
        e1[k] = c[k] - a[k];
        d[k] = a[k] - p[k];
    }
    auto dot = [](const double* x, const double* y) {
        return x[0] * y[0] + x[1] * y[1] + x[2] * y[2];
    };
    const double aa = dot(e0, e0), ab = dot(e0, e1), bb = dot(e1, e1);
    const double ad = dot(e0, d), bd = dot(e1, d);
    const double det = std::max(aa * bb - ab * ab, 1e-30);
    double s = (ab * bd - bb * ad) / det;
    double t = (ab * ad - aa * bd) / det;

    double best = 1e300;
    double cand[3];
    auto consider = [&](double ss, double tt) {
        double q[3], diff[3];
        for (int k = 0; k < 3; ++k) {
            q[k] = a[k] + ss * e0[k] + tt * e1[k];
            diff[k] = q[k] - p[k];
        }
        double dist2 = dot(diff, diff);
        if (dist2 < best) {
            best = dist2;
            cand[0] = q[0]; cand[1] = q[1]; cand[2] = q[2];
        }
    };

    if (s >= 0 && t >= 0 && s + t <= 1) {
        consider(s, t);
    } else {
        // clamp onto the three edges
        double s_ab = std::min(1.0, std::max(0.0, -ad / std::max(aa, 1e-30)));
        consider(s_ab, 0.0);
        double t_ac = std::min(1.0, std::max(0.0, -bd / std::max(bb, 1e-30)));
        consider(0.0, t_ac);
        // edge b->c parameterized by u: point = b + u*(c-b) => s=1-u, t=u
        double e2[3], bp[3];
        for (int k = 0; k < 3; ++k) { e2[k] = c[k] - b[k]; bp[k] = p[k] - b[k]; }
        double u = std::min(1.0, std::max(0.0, dot(bp, e2) / std::max(dot(e2, e2), 1e-30)));
        consider(1.0 - u, u);
    }
    out_closest[0] = cand[0]; out_closest[1] = cand[1]; out_closest[2] = cand[2];
    return std::sqrt(best);
}

}  // namespace

// For each point, min distance + closest point over all triangles.
// points: [np*3]; tris: [nt*9]; out_dist: [np]; out_closest: [np*3].
void point_triangle_min_dist(const double* points, int64_t np_,
                             const double* tris, int64_t nt,
                             double* out_dist, double* out_closest) {
    #pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < np_; ++i) {
        double best = 1e300;
        double bestc[3] = {0, 0, 0};
        for (int64_t j = 0; j < nt; ++j) {
            double cl[3];
            double dd = closest_on_triangle(points + i * 3, tris + j * 9,
                                            tris + j * 9 + 3, tris + j * 9 + 6, cl);
            if (dd < best) {
                best = dd;
                bestc[0] = cl[0]; bestc[1] = cl[1]; bestc[2] = cl[2];
            }
        }
        out_dist[i] = best;
        out_closest[i * 3 + 0] = bestc[0];
        out_closest[i * 3 + 1] = bestc[1];
        out_closest[i * 3 + 2] = bestc[2];
    }
}

}  // extern "C"
