// Native differential oracle for the preprocess chain: a plain-loop C++
// transcription of the reference semantics (ordering → ground marking →
// multi/single BEV, plus the float BEV and top-part extraction), built as a
// shared library and byte-diffed against both the Python oracle
// (tests/ref_impl.py) and the pctpu JAX ops (tests/test_native_oracle.py).
//
// Why a THIRD implementation: tests/ref_impl.py must *emulate* the C++
// mixed f32/f64 arithmetic with numpy scalar casts; this file gets the same
// semantics natively (float locals, double promotions exactly where the
// reference promotes).  Byte agreement between the two independent
// transcriptions and the vectorized device ops is the strongest parity
// evidence available without PCL on this machine.
//
// Reference semantics transcribed (never copied):
//   getOrderedCloud           /root/reference/BatchMultiBevGen.cpp:94-117
//   markGroundPoints          /root/reference/BatchMultiBevGen.cpp:119-252
//   computeAndSaveMultiBev    /root/reference/BatchMultiBevGen.cpp:261-292
//   computeAndSaveSingleBev   /root/reference/BatchMultiBevGen.cpp:331-356
//   saveAsMat (float BEV)     /root/reference/BatchCloudManip.cpp:201-239
//   extractTopAndFlatten      /root/reference/BatchTopPartRegistration.cpp:90-147
//
// Build (see tests/native_oracle.py — on-demand, like native_io):
//   g++ -O2 -std=c++14 -ffp-contract=off -shared -fPIC -o libpctpu_ref_oracle.so ref_oracle.cpp
// -ffp-contract=off matters: GCC's default contraction could fuse
// dx*dx + dy*dy into an FMA whose infinite-precision intermediate diverges
// from the reference's plain f32 multiply-add by an ulp.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

namespace {

// C round() via the floor(v+0.5)/ceil(v-0.5) form used by the established
// Python oracle (tests/ref_impl.py::c_round) — identical to round() for
// every exactly-representable double these chains produce.
inline long c_round(double v) {
  return v >= 0.0 ? (long)std::floor(v + 0.5) : (long)std::ceil(v - 0.5);
}

// round((coord + MAX_RANGE)/interval + 0.5) with the reference's mixed
// precision: the inner expression is f32, the +0.5 promotes to double
// (ref_impl._bev_cell).
inline long bev_cell(float coord, float max_range, float interval) {
  float t = (coord + max_range) / interval;
  return c_round((double)t + 0.5);
}

struct Pt {
  float x = 0.0f, y = 0.0f, z = 0.0f, intensity = 0.0f;
  std::int32_t label = 0;  // empty cells: all-zero point, label 0 (= ground)
};

constexpr int kSectRows = 75;
constexpr int kSectCols = 50;
constexpr int kBevSize = 224;
constexpr int kBevLayers = 24;
constexpr float kBevRange = 112.0f;

// `float normalized = coord + 75.0` stores the double sum into a float
// before the double /2.0 floor (BatchMultiBevGen.h:78-81).
inline void belonging(const Pt& p, int* sr, int* sc) {
  float nx = (float)((double)p.x + 75.0);
  float ny = (float)((double)p.y + 50.0);
  int sx = (int)std::floor((double)nx / 2.0);
  int sy = (int)std::floor((double)ny / 2.0);
  *sr = std::min(std::max(sx, 0), kSectRows - 1);
  *sc = std::min(std::max(sy, 0), kSectCols - 1);
}

}  // namespace

extern "C" {

// One cloud through the flagship chain.  Inputs are the raw (unordered)
// per-point arrays; outputs are the dense grid's labels and both BEVs.
//   xyz        (n_points, 3) f32
//   intensity  (n_points,)   f32
//   row, col   (n_points,)   i32  (out-of-range rows/cols are skipped)
//   label_in   (n_points,)   i32  (the selector convention: -2 unsegmented)
// Outputs (caller-allocated):
//   labels_out    (n_scan*horizon,) i32
//   multi_out     (24*224*224,)     u8, layer-major
//   single_out    (224*224,)        u8
//   ordered_xyz   (n_scan*horizon, 3) f32 — the ordered cloud, for callers
//                 that want to diff the scatter itself (may be null)
// Returns 0.
int pctpu_ref_preprocess(const float* xyz, const float* intensity,
                         const std::int32_t* row, const std::int32_t* col,
                         const std::int32_t* label_in, std::int64_t n_points,
                         std::int32_t n_scan, std::int32_t horizon,
                         std::int32_t ground_upper, float height_res,
                         std::int32_t* labels_out, std::uint8_t* multi_out,
                         std::uint8_t* single_out, float* ordered_xyz) {
  const std::int64_t grid = (std::int64_t)n_scan * horizon;
  std::vector<Pt> g(grid);

  // --- getOrderedCloud: last-wins scatter, empty slots all-zero ------------
  for (std::int64_t i = 0; i < n_points; ++i) {
    std::int32_t r = row[i], c = col[i];
    if (r < 0 || r >= n_scan || c < 0 || c >= horizon) continue;
    Pt& dst = g[(std::int64_t)r * horizon + c];
    dst.x = xyz[3 * i];
    dst.y = xyz[3 * i + 1];
    dst.z = xyz[3 * i + 2];
    dst.intensity = intensity[i];
    dst.label = label_in[i];
  }

  // --- markGroundPoints -----------------------------------------------------
  std::vector<std::int8_t> gm(grid, 0);
  std::vector<float> heights((std::size_t)kSectRows * kSectCols, 0.0f);
  std::vector<float> counts((std::size_t)kSectRows * kSectCols, 0.01f);

  // the Python oracle indexes a list, where a negative index wraps from
  // the end (reachable when ground_upper >= n_scan pushes the sweep to
  // r == 0, or via the (c-2) fallback at c < 2) — mirror that wrap
  // everywhere instead of under-reading the heap
  auto wrap = [grid](std::int64_t idx) {
    return idx < 0 ? idx + grid : idx;
  };
  for (std::int32_t c = 0; c < horizon; ++c) {
    for (std::int32_t r = n_scan - 1; r > n_scan - ground_upper - 1; --r) {
      std::int64_t lower = (std::int64_t)r * horizon + c;
      std::int64_t upper = wrap((std::int64_t)(r - 1) * horizon + c);
      if (g[upper].intensity == -1.0f) {
        std::int64_t tmp_col = (c + 2) % horizon;
        upper = wrap((std::int64_t)(r - 1) * horizon + tmp_col);
      }
      if (g[upper].intensity == -1.0f) {
        // C++ % truncates toward zero (ref_impl uses fmod for the same)
        std::int64_t tmp_col = (std::int64_t)(c - 2) % horizon;
        upper = wrap((std::int64_t)(r - 1) * horizon + tmp_col);
      }
      if (g[upper].intensity == -1.0f && r >= 2) {
        upper = (std::int64_t)(r - 2) * horizon + c;
      }
      if (g[lower].intensity == -1.0f || g[upper].intensity == -1.0f) {
        gm[lower] = -1;
        continue;
      }
      float dx = g[upper].x - g[lower].x;
      float dy = g[upper].y - g[lower].y;
      float dz = g[upper].z - g[lower].z;
      float ss = dx * dx + dy * dy;  // plain f32 (-ffp-contract=off)
      // the C++ stores the double atan2 result into a `float angle`
      // before the <= 10 compare (BatchMultiBevGen.cpp:126,173)
      float angle =
          (float)(std::atan2((double)dz, std::sqrt((double)ss)) * 180.0 / M_PI);
      if (std::fabs((double)angle) <= 10.0) {
        gm[lower] = 1;
        gm[wrap((std::int64_t)(r - 1) * horizon + c)] = 1;
      }
    }
  }

  for (std::int32_t r = 0; r < n_scan; ++r) {
    for (std::int32_t c = 0; c < horizon; ++c) {
      std::int64_t idx = (std::int64_t)r * horizon + c;
      if (gm[idx] != 1) continue;
      int sr, sc;
      belonging(g[idx], &sr, &sc);
      heights[(std::size_t)sr * kSectCols + sc] += g[idx].z;  // f32, point order
      counts[(std::size_t)sr * kSectCols + sc] += 1.0f;
    }
  }
  std::vector<float> avg((std::size_t)kSectRows * kSectCols);
  for (std::size_t s = 0; s < avg.size(); ++s) avg[s] = heights[s] / counts[s];

  static const int kNbr[4][2] = {{-1, 0}, {0, 1}, {0, -1}, {1, 0}};
  for (std::int32_t r = 0; r < n_scan; ++r) {
    for (std::int32_t c = 0; c < horizon; ++c) {
      std::int64_t idx = (std::int64_t)r * horizon + c;
      int sr, sc;
      belonging(g[idx], &sr, &sc);
      for (auto& d : kNbr) {
        int nr = sr + d[0], nc = sc + d[1];
        if (nr < 0 || nr >= kSectRows || nc < 0 || nc >= kSectCols) continue;
        // f32 difference promoted to f64, compared to the double margin
        if ((double)(g[idx].z - avg[(std::size_t)nr * kSectCols + nc]) > 0.30) {
          gm[idx] = 0;
          break;
        }
      }
      if (gm[idx] == 1) g[idx].label = 0;
    }
  }

  // --- BEV rasters ----------------------------------------------------------
  std::fill(multi_out, multi_out + (std::size_t)kBevLayers * kBevSize * kBevSize,
            (std::uint8_t)0);
  std::fill(single_out, single_out + (std::size_t)kBevSize * kBevSize,
            (std::uint8_t)0);
  for (const Pt& p : g) {
    long x = bev_cell(p.x, kBevRange, 1.0f);
    long y = bev_cell(p.y, kBevRange, 1.0f);
    // multi: all-f32 chain z/HEIGHT_RES + 2.0f, round(double(float))
    float lt = p.z / height_res + 2.0f;
    long layer = c_round((double)lt);
    if (!(x < 0 || x >= kBevSize || y < 0 || y >= kBevSize || layer < 0 ||
          layer >= kBevLayers || p.label == 0)) {
      std::uint8_t& cell =
          multi_out[((std::size_t)layer * kBevSize + x) * kBevSize + y];
      if (cell == 0) cell = 255;
    }
    // single: z+2 rounds to f32, then *4.0 in double and int() truncation
    int height = (int)((double)(p.z + 2.0f) * 4.0);
    height = std::min(std::max(0, height), 255);
    if (x < 0 || x >= kBevSize || y < 0 || y >= kBevSize || p.label == 0)
      continue;
    std::uint8_t& cell = single_out[(std::size_t)x * kBevSize + y];
    if (cell < height) cell = (std::uint8_t)height;
  }

  for (std::int64_t i = 0; i < grid; ++i) labels_out[i] = g[i].label;
  if (ordered_xyz) {
    for (std::int64_t i = 0; i < grid; ++i) {
      ordered_xyz[3 * i] = g[i].x;
      ordered_xyz[3 * i + 1] = g[i].y;
      ordered_xyz[3 * i + 2] = g[i].z;
    }
  }
  return 0;
}

// saveAsMat float BEV (201×201 CV_32F, max-of z+2.0 per cell).
int pctpu_ref_float_bev(const float* xyz, const std::int32_t* label,
                        std::int64_t n, std::int32_t filter_ground,
                        float* out /* 201*201 */) {
  constexpr int kSize = 201;
  constexpr float kRange = 100.0f;
  std::fill(out, out + (std::size_t)kSize * kSize, 0.0f);
  for (std::int64_t i = 0; i < n; ++i) {
    long x = bev_cell(xyz[3 * i], kRange, 1.0f);
    long y = bev_cell(xyz[3 * i + 1], kRange, 1.0f);
    if (x < 0 || x >= kSize || y < 0 || y >= kSize) continue;
    if (filter_ground && label[i] == 0) continue;
    double v = (double)xyz[3 * i + 2] + 2.0;
    std::int64_t idx = (std::int64_t)x * kSize + y;
    if (v > (double)out[idx]) out[idx] = (float)v;
  }
  return 0;
}

// extractTopAndFlatten: 10×10 grid over ±100 m, skip ground, cells with
// ≥20 points keep the top round(20%) by z (stable descending), flatten z=0.
// Returns the number of output points written (≤ cap), or -1 on overflow.
std::int64_t pctpu_ref_top_flatten(const float* xyz, const std::int32_t* label,
                                   std::int64_t n, float* out_xyz,
                                   std::int64_t cap) {
  constexpr int kG = 10;
  constexpr float kRad = 100.0f;
  constexpr float kRes = 20.0f;  // 2*100/10
  constexpr std::int64_t kMinPts = 20;
  std::vector<std::vector<std::int64_t>> cells((std::size_t)kG * kG);
  for (std::int64_t i = 0; i < n; ++i) {
    if (label[i] == 0) continue;
    float tx = (xyz[3 * i] + kRad) / kRes;
    float ty = (xyz[3 * i + 1] + kRad) / kRes;
    long gx = c_round((double)tx);
    long gy = c_round((double)ty);
    if (gx < 0 || gx >= kG || gy < 0 || gy >= kG) continue;
    cells[(std::size_t)gx * kG + gy].push_back(i);
  }
  std::int64_t w = 0;
  for (auto& cell : cells) {
    std::int64_t cn = (std::int64_t)cell.size();
    if (cn < kMinPts) continue;
    float frac = 0.2f * (float)cn;
    std::int64_t needed = c_round((double)frac);
    // stable: ties keep original point order, like the Python sorted(key=-z)
    std::stable_sort(cell.begin(), cell.end(),
                     [xyz](std::int64_t a, std::int64_t b) {
                       return xyz[3 * a + 2] > xyz[3 * b + 2];
                     });
    for (std::int64_t k = 0; k < needed && k < cn; ++k) {
      if (w >= cap) return -1;
      out_xyz[3 * w] = xyz[3 * cell[k]];
      out_xyz[3 * w + 1] = xyz[3 * cell[k] + 1];
      out_xyz[3 * w + 2] = 0.0f;
      ++w;
    }
  }
  return w;
}

}  // extern "C"
