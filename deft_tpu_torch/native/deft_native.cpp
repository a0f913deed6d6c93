// Native host runtime of the PyTorch port, copied from
// deft_tpu/native/deft_native.cpp.
//
// The per-frame association cascade is host-side by design (only Hungarian
// assignment and track bookkeeping stay off-device); under a 100-track load
// the Python/numpy versions of these kernels become the pipeline bottleneck
// and, worse, hold the GIL that the fetch threads need.  This module provides
// GIL-free (ctypes releases the GIL for the call) C++ implementations of:
//
//   * lapjv_limit  -- Jonker-Volgenant shortest-augmenting-path assignment
//                     with lap.lapjv's extend_cost/cost_limit semantics
//                     (replaces the scipy padded solve; the reference used
//                     the pip `lap` C++ package, matching.py:48)
//   * iou_matrix   -- pairwise IoU with the cython_bbox +1-pixel convention
//   * warp_affine_u8 -- bilinear inverse-warp of a uint8 BGR image (the cv2
//                     warpAffine call in preprocessing)
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -o libdeft_native.so deft_native.cpp
// (driven by deft_tpu_torch/native/__init__.py into build/native/ under the
// repository root, at first use).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Assignment: shortest augmenting path with potentials (JV).  Solves the
// rectangular problem with cost limit by padding to (n+m) x (n+m):
// real block | diag(limit/2); diag(limit/2) | 0  (lap.lapjv's extension).
// Returns the number of real matches; row_to_col[i] = matched column or -1.
// ---------------------------------------------------------------------------
int lapjv_limit(int n, int m, const double* cost, double limit,
                int* row_to_col, int* col_to_row) {
    const int size = n + m;
    const double BIG = 1e9;
    const double INF = std::numeric_limits<double>::infinity();
    const double half = limit / 2.0;

    auto C = [&](int i, int j) -> double {
        if (i < n && j < m) {
            double c = cost[i * m + j];
            return c < BIG ? c : BIG;
        }
        if (i < n) return (j - m == i) ? half : BIG;
        if (j < m) return (i - n == j) ? half : BIG;
        return 0.0;
    };

    // Hungarian with potentials (Jonker-Volgenant style shortest augmenting
    // paths); 1-indexed working arrays, p[j] = row matched to column j.
    std::vector<double> u(size + 1, 0.0), v(size + 1, 0.0);
    std::vector<int> p(size + 1, 0), way(size + 1, 0);
    std::vector<double> minv(size + 1);
    std::vector<char> used(size + 1);

    for (int i = 1; i <= size; ++i) {
        p[0] = i;
        int j0 = 0;
        std::fill(minv.begin(), minv.end(), INF);
        std::fill(used.begin(), used.end(), 0);
        do {
            used[j0] = 1;
            const int i0 = p[j0];
            int j1 = -1;
            double delta = INF;
            for (int j = 1; j <= size; ++j) {
                if (used[j]) continue;
                const double cur = C(i0 - 1, j - 1) - u[i0] - v[j];
                if (cur < minv[j]) { minv[j] = cur; way[j] = j0; }
                if (minv[j] < delta) { delta = minv[j]; j1 = j; }
            }
            for (int j = 0; j <= size; ++j) {
                if (used[j]) { u[p[j]] += delta; v[j] -= delta; }
                else minv[j] -= delta;
            }
            j0 = j1;
        } while (p[j0] != 0);
        do {
            const int j1 = way[j0];
            p[j0] = p[j1];
            j0 = j1;
        } while (j0);
    }

    std::vector<int> match_row(size, -1);
    for (int j = 1; j <= size; ++j)
        if (p[j] > 0) match_row[p[j] - 1] = j - 1;

    int count = 0;
    for (int i = 0; i < n; ++i) {
        int j = match_row[i];
        row_to_col[i] = (j >= 0 && j < m) ? j : -1;
        if (row_to_col[i] >= 0) ++count;
    }
    for (int j = 0; j < m; ++j) col_to_row[j] = -1;
    for (int i = 0; i < n; ++i)
        if (row_to_col[i] >= 0) col_to_row[row_to_col[i]] = i;
    return count;
}

// ---------------------------------------------------------------------------
// Pairwise IoU (tlbr boxes, +1-pixel areas like cython_bbox)
// ---------------------------------------------------------------------------
void iou_matrix(const double* a, int n, const double* b, int m, double* out) {
    for (int i = 0; i < n; ++i) {
        const double ax1 = a[i * 4], ay1 = a[i * 4 + 1];
        const double ax2 = a[i * 4 + 2], ay2 = a[i * 4 + 3];
        const double area_a = (ax2 - ax1 + 1.0) * (ay2 - ay1 + 1.0);
        for (int j = 0; j < m; ++j) {
            const double bx1 = b[j * 4], by1 = b[j * 4 + 1];
            const double bx2 = b[j * 4 + 2], by2 = b[j * 4 + 3];
            const double iw = std::min(ax2, bx2) - std::max(ax1, bx1) + 1.0;
            double v = 0.0;
            if (iw > 0) {
                const double ih =
                    std::min(ay2, by2) - std::max(ay1, by1) + 1.0;
                if (ih > 0) {
                    const double area_b =
                        (bx2 - bx1 + 1.0) * (by2 - by1 + 1.0);
                    const double inter = iw * ih;
                    v = inter / (area_a + area_b - inter);
                }
            }
            out[i * m + j] = v;
        }
    }
}

// ---------------------------------------------------------------------------
// Bilinear inverse affine warp, uint8 C-channel image (cv2.warpAffine
// WARP_INVERSE off: M maps src -> dst, so we invert it here once).
// ---------------------------------------------------------------------------
void warp_affine_u8(const uint8_t* src, int sh, int sw, int ch,
                    const double* M, uint8_t* dst, int dh, int dw) {
    // invert [a b c; d e f]
    const double a = M[0], b = M[1], c = M[2];
    const double d = M[3], e = M[4], f = M[5];
    const double det = a * e - b * d;
    const double ia = e / det, ib = -b / det;
    const double id = -d / det, ie = a / det;
    const double ic = -(ia * c + ib * f);
    const double if_ = -(id * c + ie * f);

    for (int y = 0; y < dh; ++y) {
        for (int x = 0; x < dw; ++x) {
            const double sx = ia * x + ib * y + ic;
            const double sy = id * x + ie * y + if_;
            uint8_t* out = dst + (y * dw + x) * ch;
            const int x0 = (int)std::floor(sx);
            const int y0 = (int)std::floor(sy);
            if (x0 < -1 || y0 < -1 || x0 >= sw || y0 >= sh) {
                std::memset(out, 0, ch);
                continue;
            }
            const double fx = sx - x0, fy = sy - y0;
            const double w00 = (1 - fx) * (1 - fy), w01 = fx * (1 - fy);
            const double w10 = (1 - fx) * fy, w11 = fx * fy;
            for (int k = 0; k < ch; ++k) {
                double acc = 0.0;
                if (y0 >= 0 && x0 >= 0)
                    acc += w00 * src[(y0 * sw + x0) * ch + k];
                if (y0 >= 0 && x0 + 1 < sw)
                    acc += w01 * src[(y0 * sw + x0 + 1) * ch + k];
                if (y0 + 1 < sh && x0 >= 0)
                    acc += w10 * src[((y0 + 1) * sw + x0) * ch + k];
                if (y0 + 1 < sh && x0 + 1 < sw)
                    acc += w11 * src[((y0 + 1) * sw + x0 + 1) * ch + k];
                out[k] = (uint8_t)std::min(255.0, std::max(0.0, acc + 0.5));
            }
        }
    }
}

}  // extern "C"
