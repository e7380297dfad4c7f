// Host-side native runtime for fast_limo_tpu.
//
// The reference's "runtime" is C++ end to end (ROS callbacks, PCL filters,
// std::partial_sort deskew prep — Modules/Localizer.cpp:262-321,733-805).
// Here the accelerator owns the compute path; this library owns the host
// data path:
//
//  * KITTI velodyne .bin parsing with azimuth-derived per-point times
//  * the preprocessing filter chain + time sort (produces the padded arrays
//    the jitted pipeline consumes)
//  * a lock-free SPSC ring buffer for sensor ingestion threads
//
// Exposed as a plain C ABI for ctypes (no pybind11 in this image).

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <algorithm>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// KITTI velodyne .bin → x,y,z,intensity + azimuth-based relative time
// ---------------------------------------------------------------------------

// Returns number of points read (≤ max_points), fills xyz (n*3), intensity
// (n), t_rel (n; seconds in [0, sweep_period) derived from azimuth — the
// standard KITTI convention: the HDL-64 spins clockwise starting at the rear).
int64_t flh_parse_kitti_bin(const char* path, float* xyz, float* intensity,
                            float* t_rel, int64_t max_points,
                            double sweep_period) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  std::vector<float> buf(4096 * 4);
  int64_t n = 0;
  while (n < max_points) {
    size_t got = fread(buf.data(), sizeof(float) * 4, 4096, f);
    if (got == 0) break;
    for (size_t i = 0; i < got && n < max_points; i++, n++) {
      xyz[n * 3 + 0] = buf[i * 4 + 0];
      xyz[n * 3 + 1] = buf[i * 4 + 1];
      xyz[n * 3 + 2] = buf[i * 4 + 2];
      intensity[n] = buf[i * 4 + 3];
    }
    if (got < 4096) break;
  }
  fclose(f);
  // azimuth → relative time, KITTI/SuMa convention: sweep starts at the
  // rear (-x) and the firing azimuth increases counterclockwise, i.e.
  // t = (atan2(y,x) + π) / 2π · period.
  for (int64_t i = 0; i < n; i++) {
    float x = xyz[i * 3 + 0], y = xyz[i * 3 + 1];
    double az = std::atan2((double)y, (double)x);     // [-π, π], 0 = +x
    double from_start = az + M_PI;                    // 0 at rear, grows CCW
    if (from_start < 0) from_start += 2.0 * M_PI;
    if (from_start >= 2.0 * M_PI) from_start -= 2.0 * M_PI;
    t_rel[i] = (float)(from_start / (2.0 * M_PI) * sweep_period);
  }
  return n;
}

// ---------------------------------------------------------------------------
// preprocessing chain: crop/min-dist/rate/FoV masks + time sort + pad
// (counterpart of Localizer.cpp:262-302 + deskew sort 785-805)
// ---------------------------------------------------------------------------

int64_t flh_preprocess(
    const float* xyz, const float* t_rel, int64_t n_in,
    // filters
    int crop_active, const float* crop_min, const float* crop_max,
    int dist_active, float min_dist,
    int rate_active, int rate_value,
    int fov_active, float fov_angle,
    // outputs, padded to n_out capacity
    float* out_xyz, float* out_t, uint8_t* out_valid, int64_t n_out) {
  struct Rec { float t; int32_t idx; };
  std::vector<Rec> keep;
  keep.reserve((size_t)n_in);
  const float min_d2 = min_dist * min_dist;
  for (int64_t i = 0; i < n_in; i++) {
    const float x = xyz[i * 3], y = xyz[i * 3 + 1], z = xyz[i * 3 + 2];
    if (!std::isfinite(x) || !std::isfinite(y) || !std::isfinite(z)) continue;
    if (crop_active &&
        x >= crop_min[0] && x <= crop_max[0] &&
        y >= crop_min[1] && y <= crop_max[1] &&
        z >= crop_min[2] && z <= crop_max[2])
      continue;                                        // negative crop box
    if (dist_active && (x * x + y * y + z * z) <= min_d2) continue;
    if (rate_active && (i % rate_value) != 0) continue;
    if (fov_active && std::fabs(std::atan2(y, x)) >= fov_angle) continue;
    keep.push_back({t_rel[i], (int32_t)i});
  }
  std::stable_sort(keep.begin(), keep.end(),
                   [](const Rec& a, const Rec& b) { return a.t < b.t; });
  int64_t n_kept = (int64_t)keep.size();   // reported pre-truncation
  int64_t n = std::min<int64_t>(n_kept, n_out);
  for (int64_t j = 0; j < n; j++) {
    const int32_t i = keep[j].idx;
    out_xyz[j * 3 + 0] = xyz[i * 3 + 0];
    out_xyz[j * 3 + 1] = xyz[i * 3 + 1];
    out_xyz[j * 3 + 2] = xyz[i * 3 + 2];
    out_t[j] = keep[j].t;
    out_valid[j] = 1;
  }
  for (int64_t j = n; j < n_out; j++) {
    out_xyz[j * 3] = out_xyz[j * 3 + 1] = out_xyz[j * 3 + 2] = 0.f;
    out_t[j] = 0.f;
    out_valid[j] = 0;
  }
  return n_kept;
}

// ---------------------------------------------------------------------------
// lock-free SPSC byte ring (sensor ingestion thread → dispatch thread)
// ---------------------------------------------------------------------------

struct FlhRing {
  uint8_t* data;
  uint64_t capacity;   // power of two
  uint64_t item_size;
  std::atomic<uint64_t> head;  // producer writes
  std::atomic<uint64_t> tail;  // consumer reads
};

void* flh_ring_create(uint64_t n_items, uint64_t item_size) {
  // round up to power of two
  uint64_t cap = 1;
  while (cap < n_items) cap <<= 1;
  FlhRing* r = new FlhRing();
  r->data = new uint8_t[cap * item_size];
  r->capacity = cap;
  r->item_size = item_size;
  r->head.store(0);
  r->tail.store(0);
  return r;
}

void flh_ring_destroy(void* ring) {
  FlhRing* r = (FlhRing*)ring;
  delete[] r->data;
  delete r;
}

int flh_ring_push(void* ring, const void* item) {
  FlhRing* r = (FlhRing*)ring;
  uint64_t head = r->head.load(std::memory_order_relaxed);
  uint64_t tail = r->tail.load(std::memory_order_acquire);
  if (head - tail >= r->capacity) return 0;  // full
  std::memcpy(r->data + (head & (r->capacity - 1)) * r->item_size, item,
              r->item_size);
  r->head.store(head + 1, std::memory_order_release);
  return 1;
}

int flh_ring_pop(void* ring, void* item) {
  FlhRing* r = (FlhRing*)ring;
  uint64_t tail = r->tail.load(std::memory_order_relaxed);
  uint64_t head = r->head.load(std::memory_order_acquire);
  if (tail == head) return 0;  // empty
  std::memcpy(item, r->data + (tail & (r->capacity - 1)) * r->item_size,
              r->item_size);
  r->tail.store(tail + 1, std::memory_order_release);
  return 1;
}

// ---------------------------------------------------------------------------
// one-pass int16 scan packing for the transfer-minimal dispatch path
// (Localizer._pack_scan with tpu.quantize_transfer > 0): quantize xyz by
// `quant` metres/LSB, pick t_scale = max|t_raw|/32767, quantize t_raw by it.
// Replaces a 4-op NumPy chain with a single pass.
// out is (n_cap, 4) int16 rows [x, y, z, t], zero-padded past n.
// Rounding matches np.rint (round-half-to-even = default FP environment).
// ---------------------------------------------------------------------------

int64_t flh_pack_scan_i16(const float* xyz, const float* t_raw, int64_t n,
                          float quant, int16_t* out, int64_t n_cap,
                          float* t_scale_out) {
  if (n > n_cap) n = n_cap;
  float tmax = 0.f;
  for (int64_t i = 0; i < n; i++) {
    const float a = std::fabs(t_raw[i]);
    if (a > tmax) tmax = a;
  }
  // All quantization products are computed in DOUBLE: an f64 multiply is
  // IEEE-identical between any compiler and NumPy, so the NumPy fallback
  // (io/native.py pack_scan_i16_numpy) is bit-identical to this path —
  // f32 products can land exactly on .5 ties whose resolution depends on
  // how the compiler schedules the multiply (observed 1-LSB divergence).
  const float ts = (float)(std::max((double)tmax, 1e-12) / 32767.0);
  const double inv_q = 1.0 / (double)quant;
  const double inv_ts = 1.0 / (double)ts;
  for (int64_t i = 0; i < n; i++) {
    for (int c = 0; c < 3; c++) {
      double v = std::nearbyint((double)xyz[i * 3 + c] * inv_q);
      v = std::min(32767.0, std::max(-32767.0, v));
      out[i * 4 + c] = (int16_t)v;
    }
    double tv = std::nearbyint((double)t_raw[i] * inv_ts);
    tv = std::min(32767.0, std::max(-32767.0, tv));
    out[i * 4 + 3] = (int16_t)tv;
  }
  std::memset(out + n * 4, 0, sizeof(int16_t) * 4 * (size_t)(n_cap - n));
  *t_scale_out = ts;
  return n;
}

uint64_t flh_ring_size(void* ring) {
  FlhRing* r = (FlhRing*)ring;
  return r->head.load(std::memory_order_acquire) -
         r->tail.load(std::memory_order_acquire);
}

}  // extern "C"
