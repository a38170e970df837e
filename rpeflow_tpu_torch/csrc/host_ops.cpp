// Native host-side event scatters of the port's data pipeline.
//
// The port's own copy of the two entries of csrc/host_ops.cpp that the JAX
// package calls (event_scatter_add, event_scatter_trilinear), with the same
// arithmetic in the same order, so that the two libraries give the same
// bits from the same build flags. They replace the np.add.at loops of the
// voxelizers (rpeflow_tpu_torch/data/event_voxel.py : _accumulate,
// rpeflow_tpu_torch/data/dsec.py : events_to_voxel_trilinear), whose numpy
// bodies stay beside them as the plain versions.
//
// Built with g++ at first use by rpeflow_tpu_torch/data/native.py into
// build/torch_host/<key>/ and loaded with ctypes. Plain C interface, no
// dependencies.

#include <cstdint>

extern "C" {

// voxel grid [num_bins, height, width]; one triangle-weighted scatter pass.
// Entries with ti outside [0, num_bins) are skipped (the numpy version's
// valid mask). An entry of a valid bin whose pixel lies outside the grid is
// not written either, and is counted: the return value is that count, and
// the caller raises on it (the numpy version's IndexError). Nothing is ever
// written outside vox.
int64_t event_scatter_add(float* vox, int64_t n_events, const int32_t* xs, const int32_t* ys,
                          const int32_t* tis, const float* weights, int32_t num_bins,
                          int32_t height, int32_t width) {
  const int64_t hw = static_cast<int64_t>(height) * width;
  int64_t outside = 0;
  for (int64_t i = 0; i < n_events; ++i) {
    const int32_t t = tis[i], x = xs[i], y = ys[i];
    if (t < 0 || t >= num_bins) continue;
    if (x < 0 || x >= width || y < 0 || y >= height) {
      ++outside;
      continue;
    }
    const int64_t idx = t * hw + static_cast<int64_t>(y) * width + x;
    vox[idx] += weights[i];
  }
  return outside;
}

// Signed trilinear (x, y, t) scatter of the DSEC voxelizer: each event
// spreads over its 8 surrounding cells with the value the caller passes
// (2p - 1); cells outside the grid are skipped.
void event_scatter_trilinear(float* vox, int64_t n_events, const float* xs, const float* ys,
                             const float* ts, const float* values, int32_t num_bins,
                             int32_t height, int32_t width) {
  const int64_t hw = static_cast<int64_t>(height) * width;
  for (int64_t i = 0; i < n_events; ++i) {
    const float x = xs[i], y = ys[i], t = ts[i];
    const int32_t x0 = static_cast<int32_t>(x);
    const int32_t y0 = static_cast<int32_t>(y);
    const int32_t t0 = static_cast<int32_t>(t);
    const float v = values[i];
    for (int32_t dt = 0; dt < 2; ++dt) {
      const int32_t tl = t0 + dt;
      if (tl < 0 || tl >= num_bins) continue;
      const float wt = 1.0f - (tl > t ? tl - t : t - tl);
      if (wt <= 0.0f) continue;
      for (int32_t dy = 0; dy < 2; ++dy) {
        const int32_t yl = y0 + dy;
        if (yl < 0 || yl >= height) continue;
        const float wy = 1.0f - (yl > y ? yl - y : y - yl);
        for (int32_t dx = 0; dx < 2; ++dx) {
          const int32_t xl = x0 + dx;
          if (xl < 0 || xl >= width) continue;
          const float wx = 1.0f - (xl > x ? xl - x : x - xl);
          vox[tl * hw + static_cast<int64_t>(yl) * width + xl] += v * wx * wy * wt;
        }
      }
    }
  }
}

}  // extern "C"
