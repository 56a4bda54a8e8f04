// atlas_contours.cc — Suzuki–Abe border following for binary tissue masks.
//
// Native replacement for the reference's cv2.findContours(RETR_CCOMP,
// CHAIN_APPROX_NONE) call (geometry engine, SURVEY.md §7 item 3): emits every
// border pixel of outer contours and holes with parent links, matching
// OpenCV's output bit-for-bit (validated against cv2 in tests/test_native.py).
//
// Algorithm: S. Suzuki, K. Abe, "Topological Structural Analysis of Digitized
// Binary Images by Border Following", CVGIP 30(1), 1985 — the same algorithm
// OpenCV implements. 8-connectivity; borders numbered sequentially (NBD);
// parent borders resolved through LNBD per the paper's decision table, then
// flattened to the two-level CCOMP hierarchy (outer → -1, hole → its outer).

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// counterclockwise (y-down) chain code: E, NE, N, NW, W, SW, S, SE — the same
// table OpenCV uses, so traversal direction and point order match exactly.
static const int kDx[8] = {1, 1, 0, -1, -1, -1, 0, 1};
static const int kDy[8] = {0, -1, -1, -1, 0, 1, 1, 1};

struct Border {
  int parent_border;  // border number of parent (1 = frame)
  bool is_hole;
  std::vector<int64_t> points;  // x,y interleaved
};

struct Tracer {
  int W, H;
  std::vector<int32_t> f;  // (H) x (W), no explicit frame (bounds-checked)

  int32_t at(int y, int x) const {
    if (x < 0 || x >= W || y < 0 || y >= H) return 0;
    return f[(size_t)y * W + x];
  }
  int32_t& ref(int y, int x) { return f[(size_t)y * W + x]; }

  void follow(int sy, int sx, bool is_hole, int nbd, Border* out) {
    // Initial scan: rotate clockwise from the start direction (west for outer
    // borders, east for holes) until a nonzero neighbor is found.
    int s_start = is_hole ? 0 : 4;
    int s = s_start;
    int i1 = -1;
    do {
      s = (s - 1) & 7;
      if (at(sy + kDy[s], sx + kDx[s]) != 0) {
        i1 = s;
        break;
      }
    } while (s != s_start);
    if (i1 < 0) {  // isolated pixel
      ref(sy, sx) = -nbd;
      out->points.push_back(sx);
      out->points.push_back(sy);
      return;
    }
    const int p0y = sy, p0x = sx;
    const int p1y = sy + kDy[i1], p1x = sx + kDx[i1];
    int i3y = sy, i3x = sx;

    while (true) {
      // Counterclockwise search from s+1 (unmasked index tracks whether the
      // east neighbor — index 8 — was examined and found zero).
      int s_end = s;
      int s_unmasked = s_end;
      for (int k = 1; k <= 8; ++k) {
        int d = (s_end + k) & 7;
        if (at(i3y + kDy[d], i3x + kDx[d]) != 0) {
          s_unmasked = s_end + k;
          break;
        }
      }
      s = s_unmasked & 7;
      bool east_examined_zero = s_unmasked > 8;

      int32_t& cur = ref(i3y, i3x);
      if (east_examined_zero)
        cur = -nbd;
      else if (cur == 1)
        cur = nbd;
      out->points.push_back(i3x);
      out->points.push_back(i3y);

      int i4y = i3y + kDy[s], i4x = i3x + kDx[s];
      if (i4y == p0y && i4x == p0x && i3y == p1y && i3x == p1x) return;
      i3y = i4y;
      i3x = i4x;
      s = (s + 4) & 7;  // direction back toward the previous pixel
    }
  }
};

}  // namespace

extern "C" {

// mask: H*W uint8 (0 / nonzero). Outputs are allocated by the caller through
// the two-pass protocol: first call with points=nullptr to get counts, then
// with buffers sized accordingly.
//
// Returns the number of contours (>= 0), -2 when a caller buffer/limit is
// too small (retry with larger capacity), or -3 on internal/allocation
// failure.
//   n_points[i]    — number of points of contour i
//   parents[i]     — index of parent contour (-1 for outer)
//   is_hole[i]     — 1 when contour is a hole border
//   points         — interleaved x,y for all contours concatenated (int64)
int atlas_find_contours(const uint8_t* mask, int h, int w, int max_contours,
                        int64_t* n_points, int64_t* parents, uint8_t* is_hole,
                        int64_t* points, int64_t points_capacity) try {
  if (h <= 0 || w <= 0) return 0;
  Tracer tr;
  tr.W = w;
  tr.H = h;
  tr.f.resize((size_t)h * w);
  for (size_t i = 0; i < tr.f.size(); ++i) tr.f[i] = mask[i] ? 1 : 0;

  std::vector<Border> borders;     // borders[n] has border number n+2
  std::vector<int> border_parent;  // parent border number per border number
  border_parent.resize(2, 1);      // numbers 0,1 unused/frame
  std::vector<uint8_t> border_is_hole(2, 1);  // frame counts as a hole border

  int nbd = 1;  // frame
  for (int y = 0; y < h; ++y) {
    int lnbd = 1;
    for (int x = 0; x < w; ++x) {
      int32_t fp = tr.at(y, x);
      if (fp == 0) continue;
      bool outer_start = (fp == 1) && (tr.at(y, x - 1) == 0);
      bool hole_start = (fp >= 1) && (tr.at(y, x + 1) == 0);
      if (outer_start || hole_start) {
        bool is_hole_border = !outer_start && hole_start;
        ++nbd;
        int lnbd_for_parent = lnbd;
        if (is_hole_border && fp > 1) lnbd_for_parent = fp;

        // Parent from the paper's table 1. Marks always name existing
        // borders, so lnbd_known is belt-and-braces — but BOTH vector
        // lookups must share the guard (an unguarded operator[] is UB the
        // surrounding try/catch cannot catch).
        int parent_number;
        bool lnbd_known = lnbd_for_parent < (int)border_is_hole.size();
        bool lnbd_is_hole = lnbd_known && border_is_hole[lnbd_for_parent];
        int lnbd_parent = lnbd_known ? border_parent[lnbd_for_parent] : 1;
        if (is_hole_border)
          parent_number = lnbd_is_hole ? lnbd_parent : lnbd_for_parent;
        else
          parent_number = lnbd_is_hole ? lnbd_for_parent : lnbd_parent;

        Border b;
        b.parent_border = parent_number;
        b.is_hole = is_hole_border;
        tr.follow(y, x, is_hole_border, nbd, &b);
        borders.push_back(std::move(b));
        border_parent.push_back(parent_number);
        border_is_hole.push_back(is_hole_border ? 1 : 0);
      }
      // LNBD update (paper step 4)
      int32_t fp_now = tr.at(y, x);
      if (fp_now != 1 && fp_now != 0) lnbd = fp_now < 0 ? -fp_now : fp_now;
    }
  }

  int n = (int)borders.size();
  if (n > max_contours) return -2;  // caller buffer too small
  if (n_points == nullptr) return n;

  // CCOMP flattening: EVERY outer border is top-level (-1) regardless of
  // nesting depth; a hole links to its enclosing outer border (its Suzuki
  // parent, which the decision table guarantees is an outer border).
  int64_t total = 0;
  for (int i = 0; i < n; ++i) {
    n_points[i] = (int64_t)(borders[i].points.size() / 2);
    is_hole[i] = borders[i].is_hole ? 1 : 0;
    int pb = borders[i].parent_border;  // border number
    parents[i] = (borders[i].is_hole && pb >= 2) ? (int64_t)(pb - 2) : -1;
    total += n_points[i];
  }
  if (points != nullptr) {
    if (total * 2 > points_capacity) return -2;
    int64_t off = 0;
    for (int i = 0; i < n; ++i) {
      std::memcpy(points + off, borders[i].points.data(),
                  borders[i].points.size() * sizeof(int64_t));
      off += (int64_t)borders[i].points.size();
    }
  }
  return n;
} catch (...) {
  return -3;  // allocation or internal failure; never terminate the process
}

// Batched cv2.pointPolygonTest(measureDist=False) over M probe points
// against one closed integer polygon. out[m] = +1 inside, 0 on boundary,
// -1 outside — bit-identical to OpenCV's integer branch (the Python
// fallback in ops/polygon.py is the parity oracle). This is the extraction
// grid's containment probe (reference: atlas_patch/utils/contours.py:22-38,
// services/extraction.py:83-128); the numpy version dominates the extract
// stage at small candidate counts purely on array overhead.
int atlas_points_polygon_test(const int64_t* poly, int64_t n, const int64_t* pts,
                              int64_t m, int8_t* out) {
  if (n <= 0 || m < 0) return -1;
  for (int64_t k = 0; k < m; ++k) {
    const int64_t px = pts[2 * k], py = pts[2 * k + 1];
    int64_t crossings = 0;
    bool on_edge = false;
    // Directed edges v0->v with v0 = previous vertex (closed polygon).
    int64_t v0x = poly[2 * (n - 1)], v0y = poly[2 * (n - 1) + 1];
    for (int64_t i = 0; i < n; ++i) {
      const int64_t vx = poly[2 * i], vy = poly[2 * i + 1];
      // Boundary checks apply even to skipped edges: probe on a vertex, or
      // on a horizontal edge at its own y.
      if (py == vy &&
          (px == vx || (py == v0y && ((v0x <= px && px <= vx) || (vx <= px && px <= v0x))))) {
        on_edge = true;
        break;
      }
      const bool skip = (v0y <= py && vy <= py) || (v0y > py && vy > py) ||
                        (v0x < px && vx < px);
      if (!skip) {
        const int64_t dist = (py - v0y) * (vx - v0x) - (px - v0x) * (vy - v0y);
        if (dist == 0) {
          on_edge = true;
          break;
        }
        const int64_t dist_signed = (vy < v0y) ? -dist : dist;
        if (dist_signed > 0) ++crossings;
      }
      v0x = vx;
      v0y = vy;
    }
    out[k] = on_edge ? 0 : ((crossings & 1) ? 1 : -1);
  }
  return 0;
}

}  // extern "C"
