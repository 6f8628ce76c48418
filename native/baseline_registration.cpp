// Single-core CPU baseline for the two-stage registration pipeline:
// top-part extraction + voxel + 2-D normals + coarse point-to-plane ICP (two
// yaw guesses) + fine point-to-point ICP, written per-point/loop style like
// the reference (PCL-free re-implementation of the same algorithm; semantics
// /root/reference/BatchTopPartRegistration.cpp:90-541, SURVEY.md §2.4.7-8).
// Used by bench.py to self-measure the reference-equivalent single-core
// pairs/sec, since the reference publishes no numbers and PCL is unavailable
// in this image (BASELINE.md "Baseline protocol").  Nearest-neighbour
// searches use a uniform grid (at ~0.2-1 µs/query comparable to — usually
// faster than — PCL's kd-tree at these sizes, so the baseline is not
// handicapped by the substitution).
//
// The synthetic scene matches bench.py::measure_registration: 40 building
// clusters (150 pts, σ=2.5 m) + 45k ground points, second cloud = yaw 17° +
// (1.5, −2, 0); per pair the source is perturbed so no two pairs are
// identical.  ICP parameters are the reference's exactly (coarse: maxCorr
// 10 m, 10 iters, two guesses {θ, θ+180°}; fine: maxCorr 1 m, ε 1e-6,
// fitness ε 0.01, 100 iters).
//
// Build: g++ -O2 -o baseline_registration baseline_registration.cpp
// Run:   ./baseline_registration <n_pairs>  → one JSON line on stdout.

#include <algorithm>
#include <chrono>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <limits>
#include <random>
#include <unordered_map>
#include <vector>

namespace {

struct P3 {
  float x = 0, y = 0, z = 0;
};

struct Mat4 {
  double m[4][4];
  static Mat4 identity() {
    Mat4 r{};
    for (int i = 0; i < 4; ++i)
      for (int j = 0; j < 4; ++j) r.m[i][j] = (i == j) ? 1.0 : 0.0;
    return r;
  }
  Mat4 operator*(const Mat4& o) const {
    Mat4 r{};
    for (int i = 0; i < 4; ++i)
      for (int j = 0; j < 4; ++j) {
        double s = 0;
        for (int k = 0; k < 4; ++k) s += m[i][k] * o.m[k][j];
        r.m[i][j] = s;
      }
    return r;
  }
  P3 apply(const P3& p) const {
    return {
        float(m[0][0] * p.x + m[0][1] * p.y + m[0][2] * p.z + m[0][3]),
        float(m[1][0] * p.x + m[1][1] * p.y + m[1][2] * p.z + m[1][3]),
        float(m[2][0] * p.x + m[2][1] * p.y + m[2][2] * p.z + m[2][3])};
  }
};

Mat4 yawRotation(double theta) {
  Mat4 r = Mat4::identity();
  r.m[0][0] = std::cos(theta);
  r.m[0][1] = -std::sin(theta);
  r.m[1][0] = std::sin(theta);
  r.m[1][1] = std::cos(theta);
  return r;
}

// --- top-part extraction (BatchTopPartRegistration.cpp:90-147) -------------
// 10×10 grid over ±100 m, round-based indexing; skip ground (label==0);
// cells with ≥20 points keep the top round(20%) by z descending; flatten z=0.
std::vector<P3> extractTopAndFlatten(const std::vector<P3>& pts,
                                     const std::vector<int>& label) {
  constexpr int kG = 10;
  constexpr float kRad = 100.0f, kRes = 20.0f;
  std::vector<std::vector<std::pair<float, std::pair<float, float>>>> cells(
      kG * kG);
  for (std::size_t i = 0; i < pts.size(); ++i) {
    if (label[i] == 0) continue;
    int gx = int(std::round((pts[i].x + kRad) / kRes));
    int gy = int(std::round((pts[i].y + kRad) / kRes));
    if (gx < 0 || gx >= kG || gy < 0 || gy >= kG) continue;
    cells[gx * kG + gy].push_back({pts[i].z, {pts[i].x, pts[i].y}});
  }
  std::vector<P3> out;
  for (auto& c : cells) {
    if (c.size() < 20) continue;
    std::stable_sort(c.begin(), c.end(),
                     [](const auto& a, const auto& b) { return a.first > b.first; });
    int k = int(std::round(0.2f * float(c.size())));
    for (int i = 0; i < k; ++i)
      out.push_back({c[i].second.first, c[i].second.second, 0.0f});
  }
  return out;
}

// --- voxel-grid centroid downsample (pcl::VoxelGrid, leaf 0.2) -------------
std::vector<P3> voxelDownsample(const std::vector<P3>& pts, float leaf) {
  const float inv = 1.0f / leaf;
  std::unordered_map<std::uint64_t, std::pair<P3, int>> acc;
  acc.reserve(pts.size());
  for (const P3& p : pts) {
    std::int64_t i = std::int64_t(std::floor(p.x * inv)) + (1 << 20);
    std::int64_t j = std::int64_t(std::floor(p.y * inv)) + (1 << 20);
    std::int64_t k = std::int64_t(std::floor(p.z * inv)) + (1 << 20);
    std::uint64_t key = (std::uint64_t(i) << 42) | (std::uint64_t(j) << 21) |
                        std::uint64_t(k);
    auto& slot = acc[key];
    slot.first.x += p.x;
    slot.first.y += p.y;
    slot.first.z += p.z;
    slot.second += 1;
  }
  std::vector<std::pair<std::uint64_t, P3>> items;
  items.reserve(acc.size());
  for (auto& kv : acc)
    items.push_back({kv.first,
                     {kv.second.first.x / kv.second.second,
                      kv.second.first.y / kv.second.second,
                      kv.second.first.z / kv.second.second}});
  std::sort(items.begin(), items.end(),
            [](const auto& a, const auto& b) { return a.first < b.first; });
  std::vector<P3> out;
  out.reserve(items.size());
  for (auto& it : items) out.push_back(it.second);
  return out;
}

// --- uniform-grid NN (kd-tree stand-in) ------------------------------------
struct Grid2D {
  float cell;
  float minx, miny;
  int nx, ny;
  std::vector<std::vector<int>> bins;
  const std::vector<P3>* pts;

  void build(const std::vector<P3>& p, float cell_size) {
    pts = &p;
    cell = cell_size;
    minx = miny = std::numeric_limits<float>::max();
    float maxx = -minx, maxy = -miny;
    for (const P3& q : p) {
      minx = std::min(minx, q.x);
      miny = std::min(miny, q.y);
      maxx = std::max(maxx, q.x);
      maxy = std::max(maxy, q.y);
    }
    if (p.empty()) minx = miny = maxx = maxy = 0;
    nx = std::max(1, int((maxx - minx) / cell) + 1);
    ny = std::max(1, int((maxy - miny) / cell) + 1);
    bins.assign(std::size_t(nx) * ny, {});
    for (int i = 0; i < int(p.size()); ++i)
      bins[binOf(p[i].x, p[i].y)].push_back(i);
  }
  std::size_t binOf(float x, float y) const {
    int bx = std::min(std::max(int((x - minx) / cell), 0), nx - 1);
    int by = std::min(std::max(int((y - miny) / cell), 0), ny - 1);
    return std::size_t(bx) * ny + by;
  }
  // 1-NN within max_d (squared dist in 3-D); returns index or -1
  int nn(const P3& q, float max_d, float* d2_out) const {
    int bx = int(std::floor((q.x - minx) / cell));
    int by = int(std::floor((q.y - miny) / cell));
    int r = int(std::ceil(max_d / cell));
    float best = max_d * max_d;
    int best_i = -1;
    for (int dx = -r; dx <= r; ++dx) {
      int cx = bx + dx;
      if (cx < 0 || cx >= nx) continue;
      for (int dy = -r; dy <= r; ++dy) {
        int cy = by + dy;
        if (cy < 0 || cy >= ny) continue;
        for (int i : bins[std::size_t(cx) * ny + cy]) {
          const P3& t = (*pts)[i];
          float ddx = t.x - q.x, ddy = t.y - q.y, ddz = t.z - q.z;
          float d2 = ddx * ddx + ddy * ddy + ddz * ddz;
          if (d2 < best || (d2 == best && best_i >= 0 && i < best_i)) {
            best = d2;
            best_i = i;
          }
        }
      }
    }
    *d2_out = best;
    return best_i;
  }
  // unbounded 1-NN: expanding ring search (fitness pass, getFitnessScore
  // default max_range)
  int nnUnbounded(const P3& q, float* d2_out) const {
    for (float md = cell; ; md *= 4.0f) {
      int i = nn(q, md, d2_out);
      if (i >= 0) return i;
      if (md > 4.0f * cell * std::max(nx, ny)) return -1;
    }
  }
  // radius search: collect indices within r (2-D distance — flat clouds)
  void radius(const P3& q, float rad, std::vector<int>* out) const {
    out->clear();
    int bx = int(std::floor((q.x - minx) / cell));
    int by = int(std::floor((q.y - miny) / cell));
    int r = int(std::ceil(rad / cell));
    float r2 = rad * rad;
    for (int dx = -r; dx <= r; ++dx) {
      int cx = bx + dx;
      if (cx < 0 || cx >= nx) continue;
      for (int dy = -r; dy <= r; ++dy) {
        int cy = by + dy;
        if (cy < 0 || cy >= ny) continue;
        for (int i : bins[std::size_t(cx) * ny + cy]) {
          const P3& t = (*pts)[i];
          float ddx = t.x - q.x, ddy = t.y - q.y;
          if (ddx * ddx + ddy * ddy <= r2) out->push_back(i);
        }
      }
    }
  }
};

// --- 2-D normal estimation (Normal2dEstimation.cpp:106-318) ----------------
// Normal = minor eigenvector of the 2×2 scatter of the radius-2 neighborhood,
// flipped toward the origin viewpoint; <2 neighbors → undefined.
void computeNormals2d(const std::vector<P3>& pts, const Grid2D& grid,
                      std::vector<P3>* normals, std::vector<char>* ok) {
  normals->assign(pts.size(), {0, 0, 0});
  ok->assign(pts.size(), 0);
  std::vector<int> nbr;
  for (std::size_t i = 0; i < pts.size(); ++i) {
    grid.radius(pts[i], 2.0f, &nbr);
    if (nbr.size() < 2) continue;
    double mx = 0, my = 0;
    for (int j : nbr) {
      mx += pts[j].x;
      my += pts[j].y;
    }
    mx /= double(nbr.size());
    my /= double(nbr.size());
    double sxx = 0, sxy = 0, syy = 0;
    for (int j : nbr) {
      double dx = pts[j].x - mx, dy = pts[j].y - my;
      sxx += dx * dx;
      sxy += dx * dy;
      syy += dy * dy;
    }
    // minor eigenvector of [[sxx, sxy], [sxy, syy]]
    double tr = sxx + syy, det = sxx * syy - sxy * sxy;
    double lam_min = tr / 2 - std::sqrt(std::max(tr * tr / 4 - det, 0.0));
    double nx_, ny_;
    if (std::fabs(sxy) > 1e-12) {
      nx_ = lam_min - syy;
      ny_ = sxy;
    } else if (sxx <= syy) {
      nx_ = 1;
      ny_ = 0;
    } else {
      nx_ = 0;
      ny_ = 1;
    }
    double n = std::sqrt(nx_ * nx_ + ny_ * ny_);
    if (n < 1e-12) continue;
    nx_ /= n;
    ny_ /= n;
    // flip toward viewpoint (origin): n · (vp − p) ≥ 0
    if (nx_ * (0 - pts[i].x) + ny_ * (0 - pts[i].y) < 0) {
      nx_ = -nx_;
      ny_ = -ny_;
    }
    (*normals)[i] = {float(nx_), float(ny_), 0.0f};
    (*ok)[i] = 1;
  }
}

// --- transformation estimation --------------------------------------------
// Point-to-plane LLS (TransformationEstimationPointToPlaneLLS): solve the
// linearized 6×6 system, plug the angles into exact Rz(γ)Ry(β)Rx(α).
Mat4 estimatePointToPlane(const std::vector<P3>& src, const std::vector<P3>& tgt,
                          const std::vector<P3>& nrm) {
  double ata[6][6] = {}, atb[6] = {};
  for (std::size_t i = 0; i < src.size(); ++i) {
    const P3 &s = src[i], &t = tgt[i], &n = nrm[i];
    double a[6] = {double(s.y) * n.z - double(s.z) * n.y,
                   double(s.z) * n.x - double(s.x) * n.z,
                   double(s.x) * n.y - double(s.y) * n.x,
                   n.x, n.y, n.z};
    double b = n.x * (t.x - s.x) + n.y * (t.y - s.y) + n.z * (t.z - s.z);
    for (int r = 0; r < 6; ++r) {
      for (int c = 0; c < 6; ++c) ata[r][c] += a[r] * a[c];
      atb[r] += a[r] * b;
    }
  }
  for (int r = 0; r < 6; ++r) ata[r][r] += 1e-12;
  // Gaussian elimination with partial pivoting
  double x[6];
  {
    double A[6][7];
    for (int r = 0; r < 6; ++r) {
      for (int c = 0; c < 6; ++c) A[r][c] = ata[r][c];
      A[r][6] = atb[r];
    }
    for (int col = 0; col < 6; ++col) {
      int piv = col;
      for (int r = col + 1; r < 6; ++r)
        if (std::fabs(A[r][col]) > std::fabs(A[piv][col])) piv = r;
      for (int c = 0; c < 7; ++c) std::swap(A[col][c], A[piv][c]);
      double d = A[col][col];
      if (std::fabs(d) < 1e-30) d = 1e-30;
      for (int r = 0; r < 6; ++r) {
        if (r == col) continue;
        double f = A[r][col] / d;
        for (int c = col; c < 7; ++c) A[r][c] -= f * A[col][c];
      }
    }
    for (int r = 0; r < 6; ++r) x[r] = A[r][6] / A[r][r];
  }
  double ca = std::cos(x[0]), sa = std::sin(x[0]);
  double cb = std::cos(x[1]), sb = std::sin(x[1]);
  double cg = std::cos(x[2]), sg = std::sin(x[2]);
  Mat4 m = Mat4::identity();
  m.m[0][0] = cg * cb;
  m.m[0][1] = -sg * ca + cg * sb * sa;
  m.m[0][2] = sg * sa + cg * sb * ca;
  m.m[0][3] = x[3];
  m.m[1][0] = sg * cb;
  m.m[1][1] = cg * ca + sg * sb * sa;
  m.m[1][2] = -cg * sa + sg * sb * ca;
  m.m[1][3] = x[4];
  m.m[2][0] = -sb;
  m.m[2][1] = cb * sa;
  m.m[2][2] = cb * ca;
  m.m[2][3] = x[5];
  return m;
}

// Point-to-point rigid estimation (TransformationEstimationSVD semantics)
// via Horn's quaternion method: the dominant eigenvector of the 4×4
// correlation matrix (Jacobi sweeps) is the optimal rotation.
Mat4 estimateSvd(const std::vector<P3>& src, const std::vector<P3>& tgt) {
  std::size_t n = src.size();
  double msx = 0, msy = 0, msz = 0, mtx = 0, mty = 0, mtz = 0;
  for (std::size_t i = 0; i < n; ++i) {
    msx += src[i].x; msy += src[i].y; msz += src[i].z;
    mtx += tgt[i].x; mty += tgt[i].y; mtz += tgt[i].z;
  }
  msx /= n; msy /= n; msz /= n;
  mtx /= n; mty /= n; mtz /= n;
  double h[3][3] = {};
  for (std::size_t i = 0; i < n; ++i) {
    double sx = src[i].x - msx, sy = src[i].y - msy, sz = src[i].z - msz;
    double tx = tgt[i].x - mtx, ty = tgt[i].y - mty, tz = tgt[i].z - mtz;
    h[0][0] += sx * tx; h[0][1] += sx * ty; h[0][2] += sx * tz;
    h[1][0] += sy * tx; h[1][1] += sy * ty; h[1][2] += sy * tz;
    h[2][0] += sz * tx; h[2][1] += sz * ty; h[2][2] += sz * tz;
  }
  double N[4][4] = {
      {h[0][0] + h[1][1] + h[2][2], h[1][2] - h[2][1], h[2][0] - h[0][2],
       h[0][1] - h[1][0]},
      {h[1][2] - h[2][1], h[0][0] - h[1][1] - h[2][2], h[0][1] + h[1][0],
       h[2][0] + h[0][2]},
      {h[2][0] - h[0][2], h[0][1] + h[1][0], h[1][1] - h[0][0] - h[2][2],
       h[1][2] + h[2][1]},
      {h[0][1] - h[1][0], h[2][0] + h[0][2], h[1][2] + h[2][1],
       h[2][2] - h[0][0] - h[1][1]}};
  // Jacobi eigendecomposition of the symmetric 4×4
  double V[4][4] = {{1, 0, 0, 0}, {0, 1, 0, 0}, {0, 0, 1, 0}, {0, 0, 0, 1}};
  for (int sweep = 0; sweep < 32; ++sweep) {
    double off = 0;
    for (int p = 0; p < 4; ++p)
      for (int q = p + 1; q < 4; ++q) off += N[p][q] * N[p][q];
    if (off < 1e-22) break;
    for (int p = 0; p < 4; ++p)
      for (int q = p + 1; q < 4; ++q) {
        if (std::fabs(N[p][q]) < 1e-30) continue;
        double theta = (N[q][q] - N[p][p]) / (2 * N[p][q]);
        double t = (theta >= 0 ? 1.0 : -1.0) /
                   (std::fabs(theta) + std::sqrt(theta * theta + 1));
        double c = 1.0 / std::sqrt(t * t + 1), s = t * c;
        for (int k = 0; k < 4; ++k) {
          double npk = N[p][k], nqk = N[q][k];
          N[p][k] = c * npk - s * nqk;
          N[q][k] = s * npk + c * nqk;
        }
        for (int k = 0; k < 4; ++k) {
          double nkp = N[k][p], nkq = N[k][q];
          N[k][p] = c * nkp - s * nkq;
          N[k][q] = s * nkp + c * nkq;
          double vkp = V[k][p], vkq = V[k][q];
          V[k][p] = c * vkp - s * vkq;
          V[k][q] = s * vkp + c * vkq;
        }
      }
  }
  int best = 0;
  for (int i = 1; i < 4; ++i)
    if (N[i][i] > N[best][best]) best = i;
  double w = V[0][best], qx = V[1][best], qy = V[2][best], qz = V[3][best];
  double nn = std::sqrt(w * w + qx * qx + qy * qy + qz * qz);
  w /= nn; qx /= nn; qy /= nn; qz /= nn;
  Mat4 m = Mat4::identity();
  m.m[0][0] = 1 - 2 * (qy * qy + qz * qz);
  m.m[0][1] = 2 * (qx * qy - w * qz);
  m.m[0][2] = 2 * (qx * qz + w * qy);
  m.m[1][0] = 2 * (qx * qy + w * qz);
  m.m[1][1] = 1 - 2 * (qx * qx + qz * qz);
  m.m[1][2] = 2 * (qy * qz - w * qx);
  m.m[2][0] = 2 * (qx * qz - w * qy);
  m.m[2][1] = 2 * (qy * qz + w * qx);
  m.m[2][2] = 1 - 2 * (qx * qx + qy * qy);
  m.m[0][3] = mtx - (m.m[0][0] * msx + m.m[0][1] * msy + m.m[0][2] * msz);
  m.m[1][3] = mty - (m.m[1][0] * msx + m.m[1][1] * msy + m.m[1][2] * msz);
  m.m[2][3] = mtz - (m.m[2][0] * msx + m.m[2][1] * msy + m.m[2][2] * msz);
  return m;
}

// --- ICP loop (PCL DefaultConvergenceCriteria semantics, ops/icp.py) -------
struct IcpParams {
  float max_corr;
  int max_iters;
  double eps_t;          // transformation_epsilon
  double eps_fitness;    // euclidean_fitness_epsilon (relative MSE)
  bool point_to_plane;
};

struct IcpOut {
  bool converged = false;
  double fitness = 0;
  Mat4 transform = Mat4::identity();
};

IcpOut runIcp(const std::vector<P3>& src, const std::vector<P3>& tgt,
              const Grid2D& grid, const Mat4& guess, const IcpParams& prm,
              const std::vector<P3>* tgt_normals = nullptr,
              const std::vector<char>* normal_ok = nullptr) {
  IcpOut out;
  out.transform = guess;
  std::vector<P3> work(src.size());
  for (std::size_t i = 0; i < src.size(); ++i) work[i] = guess.apply(src[i]);

  double prev_mse = std::numeric_limits<double>::max();
  bool done = false;
  int it = 0;
  const int min_one = std::max(prm.max_iters, 1);
  std::vector<P3> cs, ct, cn;
  while (!done && it < min_one) {
    cs.clear();
    ct.clear();
    cn.clear();
    double mse_sum = 0;
    for (const P3& q : work) {
      float d2;
      int j = grid.nn(q, prm.max_corr, &d2);
      if (j < 0) continue;
      if (normal_ok && !(*normal_ok)[j]) continue;
      cs.push_back(q);
      ct.push_back(tgt[j]);
      if (tgt_normals) cn.push_back((*tgt_normals)[j]);
      mse_sum += d2;
    }
    bool enough = cs.size() >= 3;
    Mat4 inc = Mat4::identity();
    if (enough)
      inc = prm.point_to_plane ? estimatePointToPlane(cs, ct, cn)
                               : estimateSvd(cs, ct);
    out.transform = inc * out.transform;
    for (P3& p : work) p = inc.apply(p);
    ++it;

    double cos_angle =
        0.5 * (inc.m[0][0] + inc.m[1][1] + inc.m[2][2] - 1.0);
    double trans_sqr = inc.m[0][3] * inc.m[0][3] + inc.m[1][3] * inc.m[1][3] +
                       inc.m[2][3] * inc.m[2][3];
    bool delta_small = cos_angle >= 1.0 - prm.eps_t && trans_sqr <= prm.eps_t;
    double mse = cs.empty() ? 0.0 : mse_sum / double(cs.size());
    bool mse_ok = std::fabs(mse - prev_mse) < 1e-12 ||
                  std::fabs(mse - prev_mse) / std::max(prev_mse, 1e-30) <
                      prm.eps_fitness;
    bool converged_now = delta_small || mse_ok;
    bool hit_max = it >= prm.max_iters;
    prev_mse = mse;
    if (!enough) {
      done = true;
      out.converged = false;
    } else if (converged_now || hit_max) {
      done = true;
      out.converged = true;
    }
  }
  // fitness: mean squared unbounded-NN distance of all transformed sources
  double fsum = 0;
  for (const P3& q : work) {
    float d2;
    if (grid.nnUnbounded(q, &d2) >= 0) fsum += d2;
  }
  out.fitness = work.empty() ? std::numeric_limits<double>::max()
                             : fsum / double(work.size());
  return out;
}

// --- synthetic bench scene (bench.py::measure_registration) ----------------
void synthScene(std::vector<P3>* pts, std::vector<int>* label) {
  std::mt19937_64 rng(0);
  std::uniform_real_distribution<float> u01(0.f, 1.f);
  std::normal_distribution<float> nrm(0.f, 2.5f);
  for (int c = 0; c < 40; ++c) {
    float cx = -60 + 120 * u01(rng), cy = -60 + 120 * u01(rng);
    for (int i = 0; i < 150; ++i) {
      pts->push_back({cx + nrm(rng), cy + nrm(rng), 9.0f * u01(rng)});
      label->push_back(-2);
    }
  }
  for (int i = 0; i < 45000; ++i) {
    pts->push_back({-70 + 140 * u01(rng), -70 + 140 * u01(rng),
                    -2.0f + 0.1f * u01(rng)});
    label->push_back(0);
  }
}

}  // namespace

int main(int argc, char** argv) {
  int n_pairs = argc > 1 ? std::atoi(argv[1]) : 5;

  std::vector<P3> base;
  std::vector<int> label;
  synthScene(&base, &label);
  const double theta = 17.0 * M_PI / 180.0;
  Mat4 rel = yawRotation(theta);
  rel.m[0][3] = 1.5;
  rel.m[1][3] = -2.0;
  std::vector<P3> tgt_pts(base.size());
  for (std::size_t i = 0; i < base.size(); ++i) tgt_pts[i] = rel.apply(base[i]);

  const IcpParams kCoarse{10.0f, 10, 0.0, -std::numeric_limits<double>::infinity(),
                          true};
  const IcpParams kFine{1.0f, 100, 1e-6, 0.01, false};

  double coarse_ms = 0, fine_ms = 0, last_fitness = 0;
  Mat4 last_fine = Mat4::identity();
  int successes = 0;
  auto t_all0 = std::chrono::steady_clock::now();
  for (int pair = 0; pair < n_pairs; ++pair) {
    // perturb the source so no two pairs are identical
    std::vector<P3> src_pts = base;
    float off = float(pair + 1) * 1e-4f;
    for (P3& p : src_pts) p.x += off;

    auto t0 = std::chrono::steady_clock::now();
    // stage 1 (reference [TIME] "1st Stage"): flatten + voxel + normals +
    // two coarse ICPs (BatchTopPartRegistration.cpp:396-473)
    std::vector<P3> sf = voxelDownsample(extractTopAndFlatten(src_pts, label), 0.2f);
    std::vector<P3> tf = voxelDownsample(extractTopAndFlatten(tgt_pts, label), 0.2f);
    Grid2D flat_grid;
    flat_grid.build(tf, 2.0f);
    std::vector<P3> tnrm;
    std::vector<char> tok;
    computeNormals2d(tf, flat_grid, &tnrm, &tok);
    Grid2D corr_grid;
    corr_grid.build(tf, 10.0f);
    IcpOut best{};
    best.fitness = std::numeric_limits<double>::max();
    for (int g = 0; g < 2; ++g) {
      Mat4 guess = yawRotation(theta + g * M_PI);
      IcpOut r = runIcp(sf, tf, corr_grid, guess, kCoarse, &tnrm, &tok);
      if (g == 0 ? r.fitness < best.fitness : r.fitness <= best.fitness)
        best = r;  // tie → 2nd guess, like the C++ ternary (:464)
    }
    auto t1 = std::chrono::steady_clock::now();
    // stage 2 ("2nd Stage"): full-cloud voxel + fine ICP (:480-506)
    std::vector<P3> sv = voxelDownsample(src_pts, 0.2f);
    std::vector<P3> tv = voxelDownsample(tgt_pts, 0.2f);
    Grid2D fine_grid;
    fine_grid.build(tv, 1.0f);
    IcpOut fine = runIcp(sv, tv, fine_grid, best.transform, kFine);
    auto t2 = std::chrono::steady_clock::now();
    coarse_ms += std::chrono::duration<double, std::milli>(t1 - t0).count();
    fine_ms += std::chrono::duration<double, std::milli>(t2 - t1).count();
    last_fitness = fine.fitness;
    last_fine = fine.transform;
    if (fine.fitness <= 1.5) ++successes;
  }
  auto t_all1 = std::chrono::steady_clock::now();
  double total_ms =
      std::chrono::duration<double, std::milli>(t_all1 - t_all0).count();
  // accuracy vs the scene's KNOWN transform (yaw 17 deg, t = (1.5, -2)) —
  // the timing comparison is only fair if the baseline also solves the
  // problem correctly; bench.py asserts these stay inside the north-star
  // window (<0.5 deg yaw)
  double yaw_deg =
      std::atan2(last_fine.m[1][0], last_fine.m[0][0]) * 180.0 / M_PI;
  std::printf(
      "{\"ms_per_pair\": %.3f, \"coarse_ms\": %.3f, \"fine_ms\": %.3f, "
      "\"n_pairs\": %d, \"successes\": %d, \"last_fine_fitness\": %.6f, "
      "\"last_fine_yaw_deg\": %.6f, \"last_fine_tx\": %.6f, "
      "\"last_fine_ty\": %.6f}\n",
      total_ms / n_pairs, coarse_ms / n_pairs, fine_ms / n_pairs, n_pairs,
      successes, last_fitness, yaw_deg, last_fine.m[0][3], last_fine.m[1][3]);
  return 0;
}
