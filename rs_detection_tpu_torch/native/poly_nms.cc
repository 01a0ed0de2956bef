// Polygon NMS core of the tile merge (a copy of
// rs_detection_tpu/native/poly_nms.cc): the whole greedy NMS, hbb
// prefilter + exact convex polygon IoU (Sutherland-Hodgman clip +
// shoelace), is one C call over packed float64 arrays, bound with ctypes.
// rs_detection_tpu_torch/native/__init__.py builds it with g++ at first use.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <numeric>
#include <vector>

namespace {

struct Pt {
  double x, y;
};

// Sutherland–Hodgman: clip subject polygon by one directed edge (a->b),
// keeping the left side (CCW clip polygon).
static int clip_edge(const Pt* in, int n_in, Pt a, Pt b, Pt* out) {
  int n_out = 0;
  const double ex = b.x - a.x, ey = b.y - a.y;
  for (int i = 0; i < n_in; ++i) {
    const Pt cur = in[i];
    const Pt nxt = in[(i + 1) % n_in];
    const double side_cur = ex * (cur.y - a.y) - ey * (cur.x - a.x);
    const double side_nxt = ex * (nxt.y - a.y) - ey * (nxt.x - a.x);
    const bool cur_in = side_cur >= 0.0;
    const bool nxt_in = side_nxt >= 0.0;
    if (cur_in) {
      out[n_out++] = cur;
      if (!nxt_in) {
        double denom = side_cur - side_nxt;
        double t = (std::fabs(denom) < 1e-12) ? 0.0 : side_cur / denom;
        out[n_out++] = {cur.x + t * (nxt.x - cur.x),
                        cur.y + t * (nxt.y - cur.y)};
      }
    } else if (nxt_in) {
      double denom = side_cur - side_nxt;
      double t = (std::fabs(denom) < 1e-12) ? 0.0 : side_cur / denom;
      out[n_out++] = {cur.x + t * (nxt.x - cur.x),
                      cur.y + t * (nxt.y - cur.y)};
    }
  }
  return n_out;
}

static double ring_area(const Pt* p, int n) {
  double s = 0.0;
  for (int i = 0; i < n; ++i) {
    const Pt& u = p[i];
    const Pt& v = p[(i + 1) % n];
    s += u.x * v.y - v.x * u.y;
  }
  return 0.5 * std::fabs(s);
}

// Exact intersection area of two (possibly CW) quads.
static double quad_inter_area(const double* q1, const double* q2) {
  Pt subj[16], buf[16], clip[4];
  for (int i = 0; i < 4; ++i) subj[i] = {q1[2 * i], q1[2 * i + 1]};
  // force CCW orientation of the clip quad
  double s = 0.0;
  for (int i = 0; i < 4; ++i) {
    const double ax = q2[2 * i], ay = q2[2 * i + 1];
    const double bx = q2[(2 * i + 2) % 8], by = q2[(2 * i + 3) % 8];
    s += ax * by - bx * ay;
  }
  if (s >= 0) {
    for (int i = 0; i < 4; ++i) clip[i] = {q2[2 * i], q2[2 * i + 1]};
  } else {
    for (int i = 0; i < 4; ++i)
      clip[i] = {q2[2 * (3 - i)], q2[2 * (3 - i) + 1]};
  }
  int n = 4;
  Pt* cur = subj;
  Pt* nxt = buf;
  for (int e = 0; e < 4 && n >= 3; ++e) {
    n = clip_edge(cur, n, clip[e], clip[(e + 1) % 4], nxt);
    std::swap(cur, nxt);
  }
  if (n < 3) return 0.0;
  return ring_area(cur, n);
}

}  // namespace

extern "C" {

// dets: [n, 9] row-major (8 poly coords + score).
// keep_out: caller-allocated [n] int64; returns number kept
// (score-descending order), greedy poly NMS with hbb prefilter —
// the semantics of ops/nms_poly.py:poly_nms_numpy.
int64_t poly_nms(const double* dets, int64_t n, double thresh,
                 int64_t* keep_out) {
  if (n <= 0) return 0;
  std::vector<double> x1(n), y1(n), x2(n), y2(n), areas_h(n), area_p(n);
  for (int64_t i = 0; i < n; ++i) {
    const double* p = dets + i * 9;
    double xmin = p[0], xmax = p[0], ymin = p[1], ymax = p[1];
    for (int k = 1; k < 4; ++k) {
      xmin = std::min(xmin, p[2 * k]);
      xmax = std::max(xmax, p[2 * k]);
      ymin = std::min(ymin, p[2 * k + 1]);
      ymax = std::max(ymax, p[2 * k + 1]);
    }
    x1[i] = xmin; y1[i] = ymin; x2[i] = xmax; y2[i] = ymax;
    areas_h[i] = (xmax - xmin + 1.0) * (ymax - ymin + 1.0);
    Pt q[4];
    for (int k = 0; k < 4; ++k) q[k] = {p[2 * k], p[2 * k + 1]};
    area_p[i] = ring_area(q, 4);
  }
  std::vector<int64_t> order(n);
  std::iota(order.begin(), order.end(), 0);
  std::stable_sort(order.begin(), order.end(),
                   [&](int64_t a, int64_t b) {
                     return dets[a * 9 + 8] > dets[b * 9 + 8];
                   });
  std::vector<char> removed(n, 0);
  int64_t n_keep = 0;
  for (int64_t oi = 0; oi < n; ++oi) {
    const int64_t i = order[oi];
    if (removed[i]) continue;
    keep_out[n_keep++] = i;
    for (int64_t oj = oi + 1; oj < n; ++oj) {
      const int64_t j = order[oj];
      if (removed[j]) continue;
      // hbb prefilter (VOC +1 convention, as the reference)
      const double xx1 = std::max(x1[i], x1[j]);
      const double yy1 = std::max(y1[i], y1[j]);
      const double xx2 = std::min(x2[i], x2[j]);
      const double yy2 = std::min(y2[i], y2[j]);
      const double w = std::max(0.0, xx2 - xx1 + 1.0);
      const double h = std::max(0.0, yy2 - yy1 + 1.0);
      const double hiou = w * h / (areas_h[i] + areas_h[j] - w * h);
      if (hiou <= 0.0) continue;
      const double inter = quad_inter_area(dets + i * 9, dets + j * 9);
      const double uni = area_p[i] + area_p[j] - inter;
      if (uni > 0 && inter / uni > thresh) removed[j] = 1;
    }
  }
  return n_keep;
}

// Pairwise exact IoU of one query quad vs m candidates.
void poly_iou_batch(const double* query, const double* cands, int64_t m,
                    double* out) {
  Pt q[4];
  for (int k = 0; k < 4; ++k) q[k] = {query[2 * k], query[2 * k + 1]};
  const double aq = ring_area(q, 4);
  for (int64_t i = 0; i < m; ++i) {
    const double* c = cands + i * 8;
    Pt cp[4];
    for (int k = 0; k < 4; ++k) cp[k] = {c[2 * k], c[2 * k + 1]};
    const double ac = ring_area(cp, 4);
    const double inter = quad_inter_area(query, c);
    const double uni = aq + ac - inter;
    out[i] = uni > 0 ? inter / uni : 0.0;
  }
}

}  // extern "C"
