// Native preprocessing kernels for nngp_tpu.
//
// Host-side equivalents of the reference's C++ dependency layer
// (SURVEY.md §2b N1/N2: GpGp::order_maxmin / find_ordered_nn and the R
// greedy coloring loop, Scripts/Coloring.R:2-20).  These run once per
// problem on the host; the O(n^2) exact farthest-point ordering and the
// sequential greedy coloring are the only preprocessing steps whose Python
// implementations are noticeably slow at ~10^5 sites, so they get native
// fast paths here (loaded via ctypes, with NumPy fallbacks).
//
// Built on first use by nngp_tpu/utils/native.py:
//   g++ -O3 -fPIC -shared -std=c++17 [-fopenmp] -o libnngp_native.so nngp_native.cpp
// with -fopenmp only when the toolchain compiles and links an OpenMP probe.

#include <cstdint>
#include <cmath>
#include <limits>
#include <vector>

#if defined(_OPENMP)
#include <omp.h>
#endif

extern "C" {

// Exact farthest-point (maxmin) ordering.
// locs: n x d row-major. out_perm: n int64 slots.
// First point = closest to the centroid; then argmax of min-distance.
void maxmin_order(const double* locs, int64_t n, int64_t d, int64_t* out_perm) {
    if (n == 0) return;
    std::vector<double> centroid(d, 0.0);
    for (int64_t i = 0; i < n; ++i)
        for (int64_t k = 0; k < d; ++k) centroid[k] += locs[i * d + k];
    for (int64_t k = 0; k < d; ++k) centroid[k] /= (double)n;

    int64_t first = 0;
    double best = std::numeric_limits<double>::infinity();
    for (int64_t i = 0; i < n; ++i) {
        double s = 0.0;
        for (int64_t k = 0; k < d; ++k) {
            double t = locs[i * d + k] - centroid[k];
            s += t * t;
        }
        if (s < best) { best = s; first = i; }
    }
    std::vector<double> mind(n);
    out_perm[0] = first;
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n; ++i) {
        double s = 0.0;
        for (int64_t k = 0; k < d; ++k) {
            double t = locs[i * d + k] - locs[first * d + k];
            s += t * t;
        }
        mind[i] = s;
    }
    mind[first] = -std::numeric_limits<double>::infinity();

    for (int64_t step = 1; step < n; ++step) {
        // argmax of mind
        int64_t nxt = 0;
        double mx = -std::numeric_limits<double>::infinity();
#if defined(_OPENMP)
#pragma omp parallel
        {
            int64_t loc_i = 0;
            double loc_m = -std::numeric_limits<double>::infinity();
#pragma omp for nowait schedule(static)
            for (int64_t i = 0; i < n; ++i)
                if (mind[i] > loc_m) { loc_m = mind[i]; loc_i = i; }
#pragma omp critical
            {
                if (loc_m > mx || (loc_m == mx && loc_i < nxt)) { mx = loc_m; nxt = loc_i; }
            }
        }
#else
        for (int64_t i = 0; i < n; ++i)
            if (mind[i] > mx) { mx = mind[i]; nxt = i; }
#endif
        out_perm[step] = nxt;
        const double* pn = locs + nxt * d;
#pragma omp parallel for schedule(static)
        for (int64_t i = 0; i < n; ++i) {
            double s = 0.0;
            for (int64_t k = 0; k < d; ++k) {
                double t = locs[i * d + k] - pn[k];
                s += t * t;
            }
            if (s < mind[i]) mind[i] = s;
        }
        mind[nxt] = -std::numeric_limits<double>::infinity();
    }
}

// Sequential first-fit greedy coloring over a CSR adjacency.
// indptr: n+1, indices: nnz, out_colors: n int32 slots. Returns #colors.
int32_t greedy_coloring(const int64_t* indptr, const int32_t* indices,
                        int64_t n, int32_t* out_colors) {
    std::vector<int32_t> mark;  // mark[c] == i  <=>  color c used by a nbr of i
    int32_t n_colors = 0;
    mark.assign(256, -1);
    for (int64_t i = 0; i < n; ++i) {
        for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p) {
            int32_t j = indices[p];
            if (j < i) {
                int32_t c = out_colors[j];
                if (c >= (int32_t)mark.size()) mark.resize(c + 64, -1);
                mark[c] = (int32_t)i;
            }
        }
        int32_t c = 0;
        while (c < (int32_t)mark.size() && mark[c] == (int32_t)i) ++c;
        out_colors[i] = c;
        if (c + 1 > n_colors) n_colors = c + 1;
    }
    return n_colors;
}

}  // extern "C"
