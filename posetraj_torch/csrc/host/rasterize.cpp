// Native trajectory rasterizer for the host data path.
//
// The reference rasterizes control frames per sample with cv2 inside the
// DataLoader workers (utils/dataset.py:741-766). The loader's worker
// threads run it without the interpreter lock, so this is a dependency-free
// C++ implementation of the same drawing recipe (thick line segments + filled
// endpoint circles on black), exposed over a C ABI for ctypes
// (posetraj_torch/ops/host_rasterize.py).
//
// Geometry follows cv2 semantics: a width-w line covers pixels within
// distance w/2 of the segment; circles are filled disks of radius r centered
// on the endpoint. Colors are written RGB. The BGR-swap fidelity quirk (Q5,
// reference dataset.py:754-766: cvtColor INSIDE the per-trajectory loop) is
// reproduced exactly via color algebra when `bgr_swap_quirk` is set: a pixel
// last written by trajectory k undergoes (num_traj - k) whole-image channel
// swaps, so its final line color is (0,0,255) when that count is even and
// (255,0,0) when odd; the green endpoint circles are swap-invariant.
//
// Built at first use by posetraj_torch/ops/host_rasterize.py:
//   g++ -O3 -fPIC -shared -std=c++17 -o librasterize.so rasterize.cpp

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>

namespace {

inline void set_px(uint8_t* img, int h, int w, int y, int x,
                   uint8_t r, uint8_t g, uint8_t b) {
  if (x < 0 || y < 0 || x >= w || y >= h) return;
  uint8_t* p = img + (static_cast<int64_t>(y) * w + x) * 3;
  p[0] = r; p[1] = g; p[2] = b;
}

// Fill every pixel within `radius` of segment (x0,y0)-(x1,y1).
void draw_thick_segment(uint8_t* img, int h, int w,
                        float x0, float y0, float x1, float y1,
                        float radius, uint8_t r, uint8_t g, uint8_t b) {
  const float minx = std::min(x0, x1) - radius - 1.f;
  const float maxx = std::max(x0, x1) + radius + 1.f;
  const float miny = std::min(y0, y1) - radius - 1.f;
  const float maxy = std::max(y0, y1) + radius + 1.f;
  const int ix0 = std::max(0, static_cast<int>(std::floor(minx)));
  const int ix1 = std::min(w - 1, static_cast<int>(std::ceil(maxx)));
  const int iy0 = std::max(0, static_cast<int>(std::floor(miny)));
  const int iy1 = std::min(h - 1, static_cast<int>(std::ceil(maxy)));
  const float dx = x1 - x0, dy = y1 - y0;
  const float len_sq = std::max(dx * dx + dy * dy, 1e-12f);
  const float r_sq = radius * radius;
  for (int y = iy0; y <= iy1; ++y) {
    for (int x = ix0; x <= ix1; ++x) {
      float t = ((x - x0) * dx + (y - y0) * dy) / len_sq;
      t = std::clamp(t, 0.f, 1.f);
      const float cx = x0 + t * dx, cy = y0 + t * dy;
      const float d_sq = (x - cx) * (x - cx) + (y - cy) * (y - cy);
      if (d_sq <= r_sq) set_px(img, h, w, y, x, r, g, b);
    }
  }
}

void draw_filled_circle(uint8_t* img, int h, int w, float cx, float cy,
                        float radius, uint8_t r, uint8_t g, uint8_t b) {
  const int ix0 = std::max(0, static_cast<int>(std::floor(cx - radius)));
  const int ix1 = std::min(w - 1, static_cast<int>(std::ceil(cx + radius)));
  const int iy0 = std::max(0, static_cast<int>(std::floor(cy - radius)));
  const int iy1 = std::min(h - 1, static_cast<int>(std::ceil(cy + radius)));
  const float r_sq = radius * radius;
  for (int y = iy0; y <= iy1; ++y)
    for (int x = ix0; x <= ix1; ++x)
      if ((x - cx) * (x - cx) + (y - cy) * (y - cy) <= r_sq)
        set_px(img, h, w, y, x, r, g, b);
}

}  // namespace

extern "C" {

// trajectories: (num_traj, num_frames, 2) float32 [x, y] pixel coords.
// out: (num_frames, h, w, 3) uint8, zero-initialized by the caller or here.
// Frame t draws segment t->t+1 for every trajectory (red, width line_width)
// plus a green filled endpoint circle; the final frame stays black
// (dataset.py:754-766, run_inference_vipseg_json_repro.py:438-449).
// bgr_swap_quirk != 0 reproduces Q5's per-trajectory color alternation (see
// header comment); 0 gives the clean recipe (all lines red).
void rasterize_trajectory_video(const float* trajectories, int num_traj,
                                int num_frames, int h, int w,
                                float line_width, float circle_radius,
                                int bgr_swap_quirk, uint8_t* out) {
  std::memset(out, 0, static_cast<size_t>(num_frames) * h * w * 3);
  const float line_r = line_width / 2.f;
  for (int t = 0; t < num_frames - 1; ++t) {
    uint8_t* frame = out + static_cast<int64_t>(t) * h * w * 3;
    for (int k = 0; k < num_traj; ++k) {
      const float* p0 = trajectories + (static_cast<int64_t>(k) * num_frames + t) * 2;
      const float* p1 = p0 + 2;
      // Q5 algebra: (num_traj - k) swaps remain after trajectory k draws.
      const bool swapped = !bgr_swap_quirk || ((num_traj - k) % 2 == 1);
      draw_thick_segment(frame, h, w, p0[0], p0[1], p1[0], p1[1], line_r,
                         swapped ? 255 : 0, 0, swapped ? 0 : 255);
      draw_filled_circle(frame, h, w, p1[0], p1[1], circle_radius, 0, 255, 0);
    }
  }
}

// Wireframe 3D-bbox control maps: corners (num_frames, 8, 2) float32,
// 12 box edges per frame, last frame black (data/blender_contract.py).
void rasterize_bbox_video(const float* corners, int num_frames, int h, int w,
                          float line_width, uint8_t* out) {
  static const int kEdges[12][2] = {
      {0, 1}, {1, 2}, {2, 3}, {3, 0},
      {4, 5}, {5, 6}, {6, 7}, {7, 4},
      {0, 4}, {1, 5}, {2, 6}, {3, 7}};
  std::memset(out, 0, static_cast<size_t>(num_frames) * h * w * 3);
  const float line_r = line_width / 2.f;
  for (int t = 0; t < num_frames - 1; ++t) {
    uint8_t* frame = out + static_cast<int64_t>(t) * h * w * 3;
    const float* c = corners + static_cast<int64_t>(t) * 8 * 2;
    for (const auto& e : kEdges) {
      draw_thick_segment(frame, h, w, c[e[0] * 2], c[e[0] * 2 + 1],
                         c[e[1] * 2], c[e[1] * 2 + 1], line_r, 255, 255, 0);
    }
  }
}

}  // extern "C"
