// Host events->voxel builder of the h5 eval path (the port's copy of
// v2v_tpu/native/voxel_builder.cpp, in place of the reference's compiled
// `event-voxel-builder` package, data/testh5.py:6).
//
// Implements the h5 test-path voxelization semantics
// (data/testh5.py:60-90): polarities {0,1} -> {-1,+1}, timestamps to
// integer microseconds relative to the first event, then either
//   discrete:  bin = floor(t_us / ((t_last + 0.001) / B))
//   bilinear:  w_b = max(0, 1 - |t_norm - b|), t_norm in [0, B-1]
// accumulated into a (B, H, W) float64 grid.
//
// A tight loop in place of np.add.at; per-bin accumulation is race-free,
// so the bilinear path parallelizes over bins with plain threads.
// Discrete bins sum +-1 in event order, as np.add.at does: the same bits.
// Bilinear weights come from t_us * scale where numpy computes
// t_us / (dt + 1e-4) * (B - 1): equal to within 1e-9.
//
// Build: v2v_tpu_torch/data/native.py (g++ -O3 -shared -fPIC -std=c++17
// -pthread, no -march=native or -ffast-math), at first use.

#include <cstdint>
#include <cmath>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// Discrete binning. out must be zeroed (B*H*W doubles).
void build_voxel_discrete(const double* ts, const int32_t* xs,
                          const int32_t* ys, const uint8_t* ps,
                          int64_t n, int num_bins, int h, int w,
                          double* out) {
    if (n <= 0) return;
    const double t0 = ts[0];
    const double t_last = std::floor((ts[n - 1] - t0) * 1e6);
    const double t_per_bin = (t_last + 0.001) / num_bins;
    const int64_t hw = (int64_t)h * w;
    for (int64_t i = 0; i < n; ++i) {
        const double t_us = std::floor((ts[i] - t0) * 1e6);
        int b = (int)(t_us / t_per_bin);
        if (b < 0) b = 0;
        if (b >= num_bins) b = num_bins - 1;
        const double pol = ps[i] ? 1.0 : -1.0;
        out[b * hw + (int64_t)ys[i] * w + xs[i]] += pol;
    }
}

// Temporal-bilinear binning; parallel over bins (each bin's plane is
// written by exactly one thread).
void build_voxel_bilinear(const double* ts, const int32_t* xs,
                          const int32_t* ys, const uint8_t* ps,
                          int64_t n, int num_bins, int h, int w,
                          double* out) {
    if (n <= 0) return;
    const double t0 = ts[0];
    const double dt = std::floor((ts[n - 1] - t0) * 1e6);
    const double scale = (num_bins - 1) / (dt + 0.0001);
    const int64_t hw = (int64_t)h * w;

    auto do_bin = [&](int b) {
        double* plane = out + (int64_t)b * hw;
        for (int64_t i = 0; i < n; ++i) {
            const double t_norm =
                std::floor((ts[i] - t0) * 1e6) * scale;
            const double wgt = 1.0 - std::fabs(t_norm - b);
            if (wgt <= 0.0) continue;
            const double pol = ps[i] ? 1.0 : -1.0;
            plane[(int64_t)ys[i] * w + xs[i]] += wgt * pol;
        }
    };

    if (num_bins >= 4 && n > 100000) {
        std::vector<std::thread> threads;
        threads.reserve(num_bins);
        for (int b = 0; b < num_bins; ++b)
            threads.emplace_back(do_bin, b);
        for (auto& t : threads) t.join();
    } else {
        for (int b = 0; b < num_bins; ++b) do_bin(b);
    }
}

// Polarity-split event-count image (for hot-pixel maps etc.).
void build_event_image(const int32_t* xs, const int32_t* ys,
                       const float* weights, int64_t n, int h, int w,
                       double* out) {
    for (int64_t i = 0; i < n; ++i) {
        if (xs[i] < 0 || xs[i] >= w || ys[i] < 0 || ys[i] >= h) continue;
        out[(int64_t)ys[i] * w + xs[i]] += weights[i];
    }
}

}  // extern "C"
