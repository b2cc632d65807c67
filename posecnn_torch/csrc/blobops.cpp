// Carried copy of native/blobops.cpp (the JAX package's data-path loops),
// built by posecnn_torch/data/native.py with g++ into posecnn_torch/_build/.
// The functions and their C interface are the original's, line for line,
// so the port's library and the JAX package's give the same arrays.
//
// Native host-side data-path kernels for posecnn_tpu.
//
// The reference keeps its training-data generation native (the
// lib/synthesize C++/OpenGL renderer feeding the data layer,
// synthesize.cpp render path; vertex-target assembly in the data
// layer). TPU hosts have no GL, so the rasterization core here is a
// z-buffered point splatter — the inner loop of
// data/synthetic.SyntheticSceneGenerator — plus the per-pixel
// vertex-target writer (ref semantics:
// lib/gt_synthesize_layer/minibatch.py:517-577). Exposed as a plain C
// ABI consumed via ctypes (no pybind11 in this image).
//
// Build: g++ -O3 -march=native -shared -fPIC blobops.cpp -o libblobops.so

#include <cmath>
#include <cstdint>
#include <cstring>
#include <algorithm>

extern "C" {

// Z-buffered splat of transformed, projected model points.
//   u, v      : (n) integer pixel coords of each point
//   z         : (n) camera depth of each point
//   n         : number of points
//   cls       : class id written to the label map
//   radius    : splat radius r → (2r+1)² square per point
//   color     : (3) per-class base color; shaded by depth
//   t_far     : far plane used for the depth shading ramp
//   depth_buf : (h*w) float32 z-buffer, init +inf by caller
//   label_buf : (h*w) int32
//   image_buf : (h*w*3) float32
void splat_points(
    const int32_t* u, const int32_t* v, const float* z, int64_t n,
    int32_t cls, int32_t radius, const float* color, float t_far,
    int32_t h, int32_t w,
    float* depth_buf, int32_t* label_buf, float* image_buf) {
  for (int64_t i = 0; i < n; ++i) {
    const float zi = z[i];
    if (zi <= 1e-3f) continue;
    float shade = 1.6f - zi / t_far;
    shade = std::min(std::max(shade, 0.4f), 1.3f);
    for (int dv = -radius; dv <= radius; ++dv) {
      const int32_t py = v[i] + dv;
      if (py < 0 || py >= h) continue;
      for (int du = -radius; du <= radius; ++du) {
        const int32_t px = u[i] + du;
        if (px < 0 || px >= w) continue;
        const int64_t idx = (int64_t)py * w + px;
        if (zi < depth_buf[idx]) {
          depth_buf[idx] = zi;
          label_buf[idx] = cls;
          image_buf[idx * 3 + 0] = color[0] * shade;
          image_buf[idx * 3 + 1] = color[1] * shade;
          image_buf[idx * 3 + 2] = color[2] * shade;
        }
      }
    }
  }
}

// Per-point-color two-pass visibility splat: each point carries its
// own pre-shaded RGB (procedural texture × Lambertian shade computed
// by the caller). This is what makes the synthetic appearance
// rotation-dependent — the data-level requirement for the pose branch
// to learn rotation (see data/procedural.py).
//
// Pass 1 min-splats depth; pass 2 writes color/label only for points
// within `eps` of the visible surface (zi <= depth+eps), preferring
// the nearest such point per pixel. The eps gate removes back-surface
// poke-through: with single-pass z-buffering, a far-surface point
// landing in a splat gap wins the pixel, speckling the render with a
// rotation-unstable pattern that drowns the texture signal.
//   rgb : (n*3) per-point colors, already shaded
//   eps : visibility tolerance in meters (e.g. 0.01)
void splat_points_rgb(
    const int32_t* u, const int32_t* v, const float* z, const float* rgb,
    int64_t n, int32_t cls, int32_t radius, float eps,
    int32_t h, int32_t w,
    float* depth_buf, int32_t* label_buf, float* image_buf) {
  for (int64_t i = 0; i < n; ++i) {
    const float zi = z[i];
    if (zi <= 1e-3f) continue;
    for (int dv = -radius; dv <= radius; ++dv) {
      const int32_t py = v[i] + dv;
      if (py < 0 || py >= h) continue;
      for (int du = -radius; du <= radius; ++du) {
        const int32_t px = u[i] + du;
        if (px < 0 || px >= w) continue;
        const int64_t idx = (int64_t)py * w + px;
        if (zi < depth_buf[idx]) depth_buf[idx] = zi;
      }
    }
  }
  // pass 2: among points inside the visible band, the NEAREST one per
  // pixel wins (deterministic and rotation-stable, unlike last-writer)
  float* color_z = new float[(int64_t)h * w];
  for (int64_t i = 0; i < (int64_t)h * w; ++i) color_z[i] = 1e30f;
  for (int64_t i = 0; i < n; ++i) {
    const float zi = z[i];
    if (zi <= 1e-3f) continue;
    const float r0 = rgb[i * 3 + 0];
    const float r1 = rgb[i * 3 + 1];
    const float r2 = rgb[i * 3 + 2];
    for (int dv = -radius; dv <= radius; ++dv) {
      const int32_t py = v[i] + dv;
      if (py < 0 || py >= h) continue;
      for (int du = -radius; du <= radius; ++du) {
        const int32_t px = u[i] + du;
        if (px < 0 || px >= w) continue;
        const int64_t idx = (int64_t)py * w + px;
        if (zi <= depth_buf[idx] + eps && zi < color_z[idx]) {
          color_z[idx] = zi;
          label_buf[idx] = cls;
          image_buf[idx * 3 + 0] = r0;
          image_buf[idx * 3 + 1] = r1;
          image_buf[idx * 3 + 2] = r2;
        }
      }
    }
  }
  delete[] color_z;
}

// Vertex-target writer (ref: _generate_vertex_targets
// minibatch.py:550-575): for each pixel with label c > 0, write the
// unit direction to that class's center + log depth into channels
// [3c, 3c+2] and the weight into the weight map.
//   label        : (h*w) int32
//   centers      : (num_classes*2) per-class center (x, y); NaN = absent
//   log_z        : (num_classes) per-class log depth
//   weight_inside: VERTEX_W_INSIDE
//   targets      : (h*w*3*num_classes) float32, zeroed by caller
//   weights      : (h*w*3*num_classes) float32, zeroed by caller
void vertex_targets(
    const int32_t* label, const float* centers, const float* log_z,
    float weight_inside, int32_t h, int32_t w, int32_t num_classes,
    float* targets, float* weights) {
  const int64_t cstride = 3 * (int64_t)num_classes;
  for (int32_t y = 0; y < h; ++y) {
    for (int32_t x = 0; x < w; ++x) {
      const int64_t p = (int64_t)y * w + x;
      const int32_t c = label[p];
      if (c <= 0 || c >= num_classes) continue;
      const float cx = centers[c * 2 + 0];
      const float cy = centers[c * 2 + 1];
      if (std::isnan(cx)) continue;
      const float dx = cx - (float)x;
      const float dy = cy - (float)y;
      const float norm = std::sqrt(dx * dx + dy * dy) + 1e-10f;
      float* t = targets + p * cstride + 3 * c;
      float* wgt = weights + p * cstride + 3 * c;
      t[0] = dx / norm;
      t[1] = dy / norm;
      t[2] = log_z[c];
      wgt[0] = weight_inside;
      wgt[1] = weight_inside;
      wgt[2] = weight_inside;
    }
  }
}

}  // extern "C"
