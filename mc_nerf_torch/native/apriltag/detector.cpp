// tag36h11 detector — native C++ component of MC-NeRF-TPU.
//
// Role parity: the reference depends on the C libapriltag via the `apriltag`
// pip binding (ref data/data_read.py:7,181-187) to find the calibration
// cube's tag keypoints (center + 4 corners per tag).  This is a from-scratch
// detector for the same tag family layout, tuned for the clean synthetic
// calibration renders this framework consumes; it shares the codeword table
// with the Python renderer (passed in at call time, single source of truth).
//
// Pipeline:
//   1. adaptive tile threshold (libapriltag-style, ref data_read.py:181-187
//      uses libapriltag whose threshold.c tiles the image, takes per-tile
//      min/max over a 3x3 tile neighborhood, and midpoint-thresholds per
//      tile): robust to the illumination gradients / noise / blur of real
//      captures where one global midpoint fails.  Low-contrast tiles are
//      SKIP for segmentation (no edges there) but receive a propagated
//      threshold for value comparisons inside detected quads,
//   2. connected components over dark pixels (iterative flood fill),
//   3. convex hull of each component's border pixels (monotone chain),
//   4. quad corner extraction + least-squares edge refinement (subpixel),
//   5. 4-point homography, 8x8 cell sampling, black-border validation,
//   6. codeword match over 4 rotations (bounded Hamming distance),
//   7. output [id, center, lt, rt, rb, lb] with corners reordered to the
//      tag's canonical frame — the order the reference's loader expects
//      (data_read.py:197-199).
//
// C ABI only; bound from Python with ctypes (no pybind11 in this image).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Pt {
  double x, y;
};

constexpr int kGrid = 8;   // black square is 8x8 cells
constexpr int kData = 6;   // inner 6x6 data cells

// Adaptive threshold tiling (see pipeline step 1 above).  kTile=16 px with
// a 3x3-tile neighborhood gives a 48 px contrast window — small against an
// 800x800 capture's illumination gradient, large against a tag edge.
constexpr int kTile = 16;
// minimum (neighborhood max - min) for a tile to contain usable black/white
// structure; below this the tile is flat (pure background or the uniform
// interior of a large black region) and is skipped for segmentation
constexpr int kMinTileContrast = 24;

// Per-tile threshold map.  `t` is the midpoint threshold, fully propagated
// into low-contrast tiles (BFS from contrast-valid neighbors) so decode /
// subpixel sampling has a threshold everywhere inside a quad; `valid` marks
// tiles with local contrast — only their pixels can seed/join components.
struct ThreshMap {
  int th = 0, tw = 0;
  std::vector<float> t;
  std::vector<uint8_t> valid;

  float tile_thresh(int x, int y) const {
    return t[(size_t)(y / kTile) * tw + (x / kTile)];
  }
  bool tile_valid(int x, int y) const {
    return valid[(size_t)(y / kTile) * tw + (x / kTile)] != 0;
  }
  // bilinear between tile centers: smooth threshold for subpixel work.
  // Degenerate grids (tw==1 or th==1 — images 8..16 px in a dimension pass
  // the h,w >= 8 guard) collapse that axis to the single tile instead of
  // indexing one past it.
  float at(double x, double y) const {
    double u = x / kTile - 0.5, v = y / kTile - 0.5;
    int u0 = tw > 1 ? std::min(std::max((int)u, 0), tw - 2) : 0;
    int v0 = th > 1 ? std::min(std::max((int)v, 0), th - 2) : 0;
    double fu = tw > 1 ? std::min(std::max(u - u0, 0.0), 1.0) : 0.0;
    double fv = th > 1 ? std::min(std::max(v - v0, 0.0), 1.0) : 0.0;
    const size_t du = tw > 1 ? 1 : 0, dv = th > 1 ? (size_t)tw : 0;
    const float* p = &t[(size_t)v0 * tw + u0];
    return (float)((p[0] * (1 - fu) + p[du] * fu) * (1 - fv) +
                   (p[dv] * (1 - fu) + p[dv + du] * fu) * fv);
  }
};

// Build the adaptive map.  Returns false when no tile has contrast (blank
// image -> no tags).
bool build_thresh_map(const uint8_t* gray, int h, int w, ThreshMap* m) {
  const int tw = (w + kTile - 1) / kTile;
  const int th = (h + kTile - 1) / kTile;
  const size_t nt = (size_t)th * tw;
  std::vector<uint8_t> tmin(nt, 255), tmax(nt, 0);
  for (int y = 0; y < h; ++y) {
    const uint8_t* row = gray + (size_t)y * w;
    uint8_t* mnr = &tmin[(size_t)(y / kTile) * tw];
    uint8_t* mxr = &tmax[(size_t)(y / kTile) * tw];
    for (int x = 0; x < w; ++x) {
      uint8_t v = row[x];
      int tx = x / kTile;
      if (v < mnr[tx]) mnr[tx] = v;
      if (v > mxr[tx]) mxr[tx] = v;
    }
  }
  m->th = th;
  m->tw = tw;
  m->t.assign(nt, 0.f);
  m->valid.assign(nt, 0);
  bool any = false;
  for (int ty = 0; ty < th; ++ty) {
    for (int tx = 0; tx < tw; ++tx) {
      int nmin = 255, nmax = 0;
      for (int dy = -1; dy <= 1; ++dy) {
        int yy = ty + dy;
        if (yy < 0 || yy >= th) continue;
        for (int dx = -1; dx <= 1; ++dx) {
          int xx = tx + dx;
          if (xx < 0 || xx >= tw) continue;
          size_t i = (size_t)yy * tw + xx;
          if (tmin[i] < nmin) nmin = tmin[i];
          if (tmax[i] > nmax) nmax = tmax[i];
        }
      }
      size_t i = (size_t)ty * tw + tx;
      if (nmax - nmin >= kMinTileContrast) {
        m->t[i] = 0.5f * (nmin + nmax);
        m->valid[i] = 1;
        any = true;
      }
    }
  }
  if (!any) return false;
  // propagate thresholds into contrast-free tiles (BFS rounds averaging
  // filled 4-neighbors) so at() is defined everywhere
  std::vector<uint8_t> filled(m->valid);
  for (;;) {
    bool progress = false, done = true;
    std::vector<uint8_t> next(filled);
    for (int ty = 0; ty < th; ++ty) {
      for (int tx = 0; tx < tw; ++tx) {
        size_t i = (size_t)ty * tw + tx;
        if (filled[i]) continue;
        done = false;
        float sum = 0.f;
        int n = 0;
        if (tx > 0 && filled[i - 1]) { sum += m->t[i - 1]; ++n; }
        if (tx + 1 < tw && filled[i + 1]) { sum += m->t[i + 1]; ++n; }
        if (ty > 0 && filled[i - tw]) { sum += m->t[i - tw]; ++n; }
        if (ty + 1 < th && filled[i + tw]) { sum += m->t[i + tw]; ++n; }
        if (n) {
          m->t[i] = sum / n;
          next[i] = 1;
          progress = true;
        }
      }
    }
    filled.swap(next);
    if (done || !progress) break;
  }
  // a contrast-free tile whose pixels all sit BELOW its propagated
  // threshold is the uniform interior of a black region, not background:
  // mark it dark-valid so the border ring of a very large tag (black band
  // wider than the 3x3-tile contrast window, tags over ~380 px) stays one
  // connected component instead of splitting into arcs.  Background tiles
  // are at the white level of their local context (their max is ABOVE the
  // propagated midpoint), so uneven lighting cannot fuse them back in.
  for (size_t i = 0; i < nt; ++i) {
    if (!m->valid[i] && filled[i] && tmax[i] < m->t[i]) m->valid[i] = 1;
  }
  return true;
}

// ---------------------------------------------------------------- geometry

double cross(const Pt& o, const Pt& a, const Pt& b) {
  return (a.x - o.x) * (b.y - o.y) - (a.y - o.y) * (b.x - o.x);
}

// Andrew monotone chain; returns hull in counter-clockwise order (math
// convention; clockwise on screen with y pointing down).
std::vector<Pt> convex_hull(std::vector<Pt> pts) {
  size_t n = pts.size();
  if (n < 3) return pts;
  std::sort(pts.begin(), pts.end(), [](const Pt& a, const Pt& b) {
    return a.x < b.x || (a.x == b.x && a.y < b.y);
  });
  std::vector<Pt> hull(2 * n);
  size_t k = 0;
  for (size_t i = 0; i < n; ++i) {
    while (k >= 2 && cross(hull[k - 2], hull[k - 1], pts[i]) <= 0) --k;
    hull[k++] = pts[i];
  }
  size_t lower = k + 1;
  for (size_t i = n - 1; i-- > 0;) {
    while (k >= lower && cross(hull[k - 2], hull[k - 1], pts[i]) <= 0) --k;
    hull[k++] = pts[i];
  }
  hull.resize(k - 1);
  return hull;
}

// Pick 4 extreme corners from a hull: farthest from centroid, farthest from
// that, then extremes on both sides of the diagonal.
void quad_corners(const std::vector<Pt>& hull, Pt q[4]) {
  Pt c{0, 0};
  for (const Pt& p : hull) { c.x += p.x; c.y += p.y; }
  c.x /= hull.size();
  c.y /= hull.size();

  auto far_from = [&](const Pt& a) {
    size_t best = 0; double bd = -1;
    for (size_t i = 0; i < hull.size(); ++i) {
      double dx = hull[i].x - a.x, dy = hull[i].y - a.y, d = dx * dx + dy * dy;
      if (d > bd) { bd = d; best = i; }
    }
    return best;
  };
  size_t i0 = far_from(c);
  size_t i2 = far_from(hull[i0]);
  const Pt &a = hull[i0], &b = hull[i2];
  size_t i1 = i0, i3 = i0;
  double best_pos = 0, best_neg = 0;
  for (size_t i = 0; i < hull.size(); ++i) {
    double s = cross(a, b, hull[i]);
    if (s > best_pos) { best_pos = s; i1 = i; }
    if (s < best_neg) { best_neg = s; i3 = i; }
  }
  Pt raw[4] = {hull[i0], hull[i1], hull[i2], hull[i3]};
  // order clockwise on screen (y down) by angle around the centroid
  double ang[4];
  for (int i = 0; i < 4; ++i) ang[i] = std::atan2(raw[i].y - c.y, raw[i].x - c.x);
  int idx[4] = {0, 1, 2, 3};
  for (int i = 0; i < 4; ++i)
    for (int j = i + 1; j < 4; ++j)
      if (ang[idx[j]] < ang[idx[i]]) { int t = idx[i]; idx[i] = idx[j]; idx[j] = t; }
  for (int i = 0; i < 4; ++i) q[i] = raw[idx[i]];
}

// Least-squares refine each quad edge against nearby hull points, then
// re-intersect adjacent edges -> subpixel corners.
void refine_quad(const std::vector<Pt>& hull, Pt q[4]) {
  double L[4][3];  // line: a*x + b*y = c, (a, b) unit normal
  for (int e = 0; e < 4; ++e) {
    const Pt &a = q[e], &b = q[(e + 1) % 4];
    double ex = b.x - a.x, ey = b.y - a.y;
    double len = std::sqrt(ex * ex + ey * ey);
    if (len < 1e-9) { L[e][0] = 1; L[e][1] = 0; L[e][2] = a.x; continue; }
    double nx = -ey / len, ny = ex / len;
    double c0 = nx * a.x + ny * a.y;
    // gather inlier hull points
    double sx = 0, sy = 0, sxx = 0, sxy = 0, syy = 0; int m = 0;
    for (const Pt& p : hull) {
      double tproj = ((p.x - a.x) * ex + (p.y - a.y) * ey) / (len * len);
      double dist = std::fabs(nx * p.x + ny * p.y - c0);
      if (tproj > 0.1 && tproj < 0.9 && dist < 2.5) {
        sx += p.x; sy += p.y; sxx += p.x * p.x; sxy += p.x * p.y; syy += p.y * p.y;
        ++m;
      }
    }
    if (m >= 2) {
      double mx = sx / m, my = sy / m;
      double cxx = sxx / m - mx * mx, cxy = sxy / m - mx * my, cyy = syy / m - my * my;
      // principal direction of the scatter = edge direction
      double theta = 0.5 * std::atan2(2 * cxy, cxx - cyy);
      double dx = std::cos(theta), dy = std::sin(theta);
      nx = -dy; ny = dx;
      c0 = nx * mx + ny * my;
    }
    // hull points are centers of black pixels: the true black/white edge
    // sits ~0.5 px outside them — push the line outward (away from the quad
    // interior) by half a pixel.
    {
      Pt qc{0.25 * (q[0].x + q[1].x + q[2].x + q[3].x),
            0.25 * (q[0].y + q[1].y + q[2].y + q[3].y)};
      double side = nx * qc.x + ny * qc.y - c0;   // centroid side of the line
      c0 -= (side > 0 ? 0.5 : -0.5);              // move away from centroid
    }
    L[e][0] = nx; L[e][1] = ny; L[e][2] = c0;
  }
  for (int k = 0; k < 4; ++k) {
    // corner k = intersection of edge (k-1) and edge k
    const double* l1 = L[(k + 3) % 4];
    const double* l2 = L[k];
    double det = l1[0] * l2[1] - l1[1] * l2[0];
    if (std::fabs(det) > 1e-9) {
      q[k].x = (l1[2] * l2[1] - l1[1] * l2[2]) / det;
      q[k].y = (l1[0] * l2[2] - l1[2] * l2[0]) / det;
    }
  }
}

double bilinear(const uint8_t* g, int h, int w, double x, double y);

// Subpixel edge refinement against the antialiased grayscale image: for each
// quad edge, walk sample points along the edge, locate the threshold
// crossing along the edge normal by linear interpolation, and refit the
// line through the crossings.  Brings corners from ~1 px (hull-based) to
// ~0.1 px, comparable to libapriltag's refinement.
void refine_subpixel(const uint8_t* gray, int h, int w, const ThreshMap& tm,
                     Pt q[4]) {
  double L[4][3];
  Pt qc{0.25 * (q[0].x + q[1].x + q[2].x + q[3].x),
        0.25 * (q[0].y + q[1].y + q[2].y + q[3].y)};
  for (int e = 0; e < 4; ++e) {
    const Pt &a = q[e], &b = q[(e + 1) % 4];
    double ex = b.x - a.x, ey = b.y - a.y;
    double len = std::sqrt(ex * ex + ey * ey);
    double nx = -ey / len, ny = ex / len;
    // make the normal point outward (away from the quad centroid)
    if (nx * (qc.x - a.x) + ny * (qc.y - a.y) > 0) { nx = -nx; ny = -ny; }

    double sx = 0, sy = 0, sxx = 0, sxy = 0, syy = 0;
    int m = 0;
    const int kSamples = 24;
    for (int s = 0; s < kSamples; ++s) {
      double tt = 0.15 + 0.7 * s / (kSamples - 1);
      double px = a.x + tt * ex, py = a.y + tt * ey;
      // scan from inside (black) to outside (white) for the crossing;
      // each sample compares against the LOCAL adaptive threshold (an
      // illumination gradient along the edge shifts the crossing level)
      double pvx = px - 1.5 * nx, pvy = py - 1.5 * ny;
      double prev_d = bilinear(gray, h, w, pvx, pvy) - tm.at(pvx, pvy);
      bool got = false;
      double cx = 0, cy = 0;
      for (double t = -1.25; t <= 2.01; t += 0.25) {
        double vx = px + t * nx, vy = py + t * ny;
        double d = bilinear(gray, h, w, vx, vy) - tm.at(vx, vy);
        if (prev_d < 0 && d >= 0) {
          double f = -prev_d / (d - prev_d + 1e-12);
          double tc = t - 0.25 + 0.25 * f;
          cx = px + tc * nx; cy = py + tc * ny;
          got = true;
          break;
        }
        prev_d = d;
      }
      if (got && cx >= 1 && cx < w - 1 && cy >= 1 && cy < h - 1) {
        sx += cx; sy += cy; sxx += cx * cx; sxy += cx * cy; syy += cy * cy;
        ++m;
      }
    }
    if (m >= 6) {
      double mx = sx / m, my = sy / m;
      double cxx = sxx / m - mx * mx, cxy = sxy / m - mx * my, cyy = syy / m - my * my;
      double theta = 0.5 * std::atan2(2 * cxy, cxx - cyy);
      double dx = std::cos(theta), dy = std::sin(theta);
      L[e][0] = -dy; L[e][1] = dx; L[e][2] = -dy * mx + dx * my;
    } else {
      L[e][0] = nx; L[e][1] = ny; L[e][2] = nx * a.x + ny * a.y;
    }
  }
  for (int k = 0; k < 4; ++k) {
    const double* l1 = L[(k + 3) % 4];
    const double* l2 = L[k];
    double det = l1[0] * l2[1] - l1[1] * l2[0];
    if (std::fabs(det) > 1e-9) {
      q[k].x = (l1[2] * l2[1] - l1[1] * l2[2]) / det;
      q[k].y = (l1[0] * l2[2] - l1[2] * l2[0]) / det;
    }
  }
}

// 4-point homography: (u, v) in cell coords -> image (x, y).
// Maps (0,0)->q0, (S,0)->q1, (S,S)->q2, (0,S)->q3 with S = kGrid.
struct Homography {
  double h[9];
  Pt apply(double u, double v) const {
    double w = h[6] * u + h[7] * v + h[8];
    return {(h[0] * u + h[1] * v + h[2]) / w, (h[3] * u + h[4] * v + h[5]) / w};
  }
};

bool solve8(double A[8][9]) {  // Gauss-Jordan on [A | b]
  for (int col = 0; col < 8; ++col) {
    int piv = col;
    for (int r = col + 1; r < 8; ++r)
      if (std::fabs(A[r][col]) > std::fabs(A[piv][col])) piv = r;
    if (std::fabs(A[piv][col]) < 1e-12) return false;
    for (int c = 0; c < 9; ++c) { double t = A[col][c]; A[col][c] = A[piv][c]; A[piv][c] = t; }
    double d = A[col][col];
    for (int c = 0; c < 9; ++c) A[col][c] /= d;
    for (int r = 0; r < 8; ++r) {
      if (r == col) continue;
      double f = A[r][col];
      for (int c = 0; c < 9; ++c) A[r][c] -= f * A[col][c];
    }
  }
  return true;
}

bool homography_from_quad(const Pt q[4], Homography* H) {
  const double S = kGrid;
  double src[4][2] = {{0, 0}, {S, 0}, {S, S}, {0, S}};
  double A[8][9];
  std::memset(A, 0, sizeof(A));
  for (int i = 0; i < 4; ++i) {
    double u = src[i][0], v = src[i][1], x = q[i].x, y = q[i].y;
    double* r1 = A[2 * i];
    double* r2 = A[2 * i + 1];
    r1[0] = u; r1[1] = v; r1[2] = 1; r1[6] = -u * x; r1[7] = -v * x; r1[8] = x;
    r2[3] = u; r2[4] = v; r2[5] = 1; r2[6] = -u * y; r2[7] = -v * y; r2[8] = y;
  }
  if (!solve8(A)) return false;
  for (int i = 0; i < 8; ++i) H->h[i] = A[i][8];
  H->h[8] = 1.0;
  return true;
}

double bilinear(const uint8_t* g, int h, int w, double x, double y) {
  x = x < 0 ? 0 : (x > w - 1.001 ? w - 1.001 : x);
  y = y < 0 ? 0 : (y > h - 1.001 ? h - 1.001 : y);
  int x0 = (int)x, y0 = (int)y;
  double fx = x - x0, fy = y - y0;
  double v00 = g[y0 * w + x0], v01 = g[y0 * w + x0 + 1];
  double v10 = g[(y0 + 1) * w + x0], v11 = g[(y0 + 1) * w + x0 + 1];
  return (v00 * (1 - fx) + v01 * fx) * (1 - fy) + (v10 * (1 - fx) + v11 * fx) * fy;
}

int hamming36(uint64_t a, uint64_t b) {
  uint64_t x = (a ^ b) & ((1ULL << 36) - 1);
  int n = 0;
  while (x) { x &= x - 1; ++n; }
  return n;
}

// rotate a 6x6 bit grid 90 deg counter-clockwise, k times
void rot90(const int in[kData][kData], int out[kData][kData]) {
  for (int r = 0; r < kData; ++r)
    for (int c = 0; c < kData; ++c)
      out[kData - 1 - c][r] = in[r][c];
}

}  // namespace

extern "C" {

// Detect tags.  gray: row-major uint8 [h, w].  codes: family codewords.
// out: [max_out, 11] floats — id, cx, cy, then lt, rt, rb, lb corner (x, y)
// pairs in the tag's canonical frame.  Returns the number of detections.
int mcn_detect_tags(const uint8_t* gray, int h, int w,
                    const uint64_t* codes, int n_codes, int max_hamming,
                    float* out, int max_out) {
  if (h < 8 || w < 8) return 0;
  // 1. adaptive tile threshold (see ThreshMap above)
  const int64_t npix = (int64_t)h * w;
  ThreshMap tm;
  if (!build_thresh_map(gray, h, w, &tm)) return 0;  // no contrast, no tags
  // dark = below the LOCAL threshold, in a tile that has contrast (flat
  // tiles are skip: their pixels neither seed nor join components, which
  // stops a dim background from fusing into one image-wide component under
  // uneven lighting; a uniform black tag interior skipped this way only
  // hollows the component — the convex hull is unaffected)
  auto is_dark = [&](int x, int y) {
    return tm.tile_valid(x, y) &&
           gray[(size_t)y * w + x] < tm.tile_thresh(x, y);
  };

  // 2. connected components over dark pixels
  std::vector<int32_t> label(npix, -1);
  std::vector<int64_t> stack;
  int n_det = 0;
  int32_t next_label = 0;

  for (int64_t seed = 0; seed < npix; ++seed) {
    if (label[seed] >= 0 || !is_dark((int)(seed % w), (int)(seed / w)))
      continue;
    const int32_t lab = next_label++;
    stack.clear();
    stack.push_back(seed);
    label[seed] = lab;
    std::vector<Pt> border;
    int64_t area = 0;
    int min_x = w, max_x = 0, min_y = h, max_y = 0;
    while (!stack.empty()) {
      int64_t p = stack.back();
      stack.pop_back();
      ++area;
      int y = (int)(p / w), x = (int)(p % w);
      if (x < min_x) min_x = x;
      if (x > max_x) max_x = x;
      if (y < min_y) min_y = y;
      if (y > max_y) max_y = y;
      bool is_border = (x == 0 || x == w - 1 || y == 0 || y == h - 1);
      const int dx[4] = {1, -1, 0, 0}, dy[4] = {0, 0, 1, -1};
      for (int k = 0; k < 4; ++k) {
        int nx = x + dx[k], ny = y + dy[k];
        if (nx < 0 || nx >= w || ny < 0 || ny >= h) continue;
        int64_t q = (int64_t)ny * w + nx;
        if (!is_dark(nx, ny)) { is_border = true; continue; }
        if (label[q] < 0) { label[q] = lab; stack.push_back(q); }
      }
      if (is_border) border.push_back({(double)x, (double)y});
    }
    // 3. geometric filters
    int bw = max_x - min_x + 1, bh = max_y - min_y + 1;
    if (area < 32 || bw < 8 || bh < 8) continue;
    if (border.size() < 8) continue;

    std::vector<Pt> hull = convex_hull(border);
    if (hull.size() < 4) continue;
    Pt q[4];
    quad_corners(hull, q);
    refine_quad(hull, q);
    refine_subpixel(gray, h, w, tm, q);

    // 4. decode
    Homography H;
    if (!homography_from_quad(q, &H)) continue;
    int bits[kData][kData];
    int border_black = 0, border_total = 0;
    bool sample_ok = true;
    for (int r = 0; r < kGrid && sample_ok; ++r) {
      for (int c = 0; c < kGrid; ++c) {
        Pt p = H.apply(c + 0.5, r + 0.5);
        if (p.x < -2 || p.x > w + 1 || p.y < -2 || p.y > h + 1) { sample_ok = false; break; }
        double v = bilinear(gray, h, w, p.x, p.y);
        bool white = v >= tm.at(p.x, p.y);
        if (r == 0 || r == kGrid - 1 || c == 0 || c == kGrid - 1) {
          ++border_total;
          if (!white) ++border_black;
        } else {
          bits[r - 1][c - 1] = white ? 1 : 0;
        }
      }
    }
    if (!sample_ok) continue;
    if (border_black < border_total - 2) continue;  // border ring must be black

    int cur[kData][kData], nxt[kData][kData];
    std::memcpy(cur, bits, sizeof(bits));
    int found_id = -1, found_rot = 0;
    for (int k = 0; k < 4 && found_id < 0; ++k) {
      uint64_t word = 0;
      for (int r = 0; r < kData; ++r)
        for (int c = 0; c < kData; ++c)
          word = (word << 1) | (uint64_t)cur[r][c];
      for (int id = 0; id < n_codes; ++id) {
        if (hamming36(word, codes[id]) <= max_hamming) { found_id = id; found_rot = k; break; }
      }
      rot90(cur, nxt);
      std::memcpy(cur, nxt, sizeof(cur));
    }
    if (found_id < 0) continue;

    if (n_det >= max_out) return n_det;
    Pt center = H.apply(kGrid / 2.0, kGrid / 2.0);
    float* o = out + (int64_t)n_det * 11;
    // +0.5: internally pixel (i, j)'s sample sits at integer coords; the
    // framework's projection convention puts pixel centers at (i+0.5, j+0.5)
    // (cameras/rays.py pixel_grid), so detections shift accordingly.
    o[0] = (float)found_id;
    o[1] = (float)(center.x + 0.5);
    o[2] = (float)(center.y + 0.5);
    // canonical lt corner = q[rot] (see Python twin's derivation)
    for (int i = 0; i < 4; ++i) {
      const Pt& p = q[(found_rot + i) % 4];
      o[3 + 2 * i] = (float)(p.x + 0.5);
      o[4 + 2 * i] = (float)(p.y + 0.5);
    }
    ++n_det;
  }
  return n_det;
}

}  // extern "C"
