// Native host-side geometry + graph kernels for the LiDAR engine.
//
// Plays the role of the reference's external C++ hull submodules
// (ref: CMakeLists.txt:24-25,66-67 — Convex-Hull and
// Concave-Hull targets, called from polygon_simplification.cpp:56-62,129-130)
// plus a host union-find used by tests and the streaming runtime's
// large-cluster path. Everything is exposed through a C ABI and loaded from
// Python via ctypes (ops/hull_native.py).
//
// Contents:
//   convex_hull       — Andrew monotone chain, CCW, strictly convex.
//   chi_concave_hull  — chi-shape (Duckham et al. 2008): Delaunay
//                       triangulation (Bowyer-Watson) + iterative
//                       longest-boundary-edge peeling under the regularity
//                       constraint; threshold l_min + chi*(l_max-l_min).
//   union_find_cc     — connected components over an edge list.
//   radius_cc         — exact Euclidean radius-graph connected components
//                       via voxel hashing (27-cell neighborhood), the host
//                       oracle for clustering (ref behavior:
//                       src/clustering.cpp:47-125).

#include <algorithm>
#include <array>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <queue>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

struct P2 {
  double x, y;
};

inline double cross(const P2& o, const P2& a, const P2& b) {
  return (a.x - o.x) * (b.y - o.y) - (a.y - o.y) * (b.x - o.x);
}

// ---------------------------------------------------------------------------
// Convex hull: Andrew monotone chain, CCW, strictly convex vertices only.
// ---------------------------------------------------------------------------
std::vector<int32_t> convex_hull_impl(const float* pts, int32_t n) {
  std::vector<int32_t> order(n);
  for (int32_t i = 0; i < n; ++i) order[i] = i;
  std::sort(order.begin(), order.end(), [&](int32_t a, int32_t b) {
    if (pts[2 * a] != pts[2 * b]) return pts[2 * a] < pts[2 * b];
    return pts[2 * a + 1] < pts[2 * b + 1];
  });
  auto at = [&](int32_t i) {
    return P2{static_cast<double>(pts[2 * i]),
              static_cast<double>(pts[2 * i + 1])};
  };
  std::vector<int32_t> h(2 * n);
  int32_t k = 0;
  // lower hull
  for (int32_t ii = 0; ii < n; ++ii) {
    int32_t i = order[ii];
    while (k >= 2 && cross(at(h[k - 2]), at(h[k - 1]), at(i)) <= 0) --k;
    h[k++] = i;
  }
  // upper hull
  for (int32_t ii = n - 2, lower = k + 1; ii >= 0; --ii) {
    int32_t i = order[ii];
    while (k >= lower && cross(at(h[k - 2]), at(h[k - 1]), at(i)) <= 0) --k;
    h[k++] = i;
  }
  h.resize(k > 1 ? k - 1 : k);  // drop duplicated first point
  return h;
}

// ---------------------------------------------------------------------------
// Chan's O(n log h) convex hull (ref behavior: the reference routes
// >1000-point clusters to Chan's algorithm in its Convex-Hull submodule,
// polygon_simplification.cpp:53-63). Classic rounds with m = 2^(2^t):
// partition into ceil(n/m) groups, monotone-chain each mini-hull, then
// Jarvis-march across the mini-hulls' tangent candidates, aborting the
// round when the march exceeds m steps. Identical output to
// convex_hull_impl (CCW, strictly convex) — property-tested in
// tests/test_native.py.
// ---------------------------------------------------------------------------

// Comparator for the Jarvis march from hull point p (CCW, strict):
// returns true when candidate b beats candidate a (b is strictly right of
// p->a, or collinear and farther).
inline bool wrap_better(const P2& p, const P2& a, const P2& b) {
  double c = cross(p, a, b);
  if (c < 0) return true;
  if (c > 0) return false;
  double da = (a.x - p.x) * (a.x - p.x) + (a.y - p.y) * (a.y - p.y);
  double db = (b.x - p.x) * (b.x - p.x) + (b.y - p.y) * (b.y - p.y);
  return db > da;
}

// Tangent from external point p to the CCW strictly-convex polygon
// poly[0..k): the vertex t such that every vertex is left of (or behind on)
// the ray p->t under wrap_better's ordering. Linear scan over the
// mini-hull vertices: the march then costs O(h * sum |mini-hull|), still
// output-sensitive through the m-doubling rounds (binary-search tangents
// would recover the full O(n log h) bound, but the live path's clusters
// are <= a few thousand points and exact tie handling dominates the risk).
inline int32_t tangent_index(const P2& p, const std::vector<P2>& poly) {
  int32_t k = static_cast<int32_t>(poly.size());
  int32_t best = 0;
  for (int32_t i = 1; i < k; ++i) {
    if (wrap_better(p, poly[best], poly[i])) best = i;
  }
  return best;
}

std::vector<int32_t> chan_hull_impl(const float* pts, int32_t n) {
  auto at = [&](int32_t i) {
    return P2{static_cast<double>(pts[2 * i]),
              static_cast<double>(pts[2 * i + 1])};
  };
  // start vertex: lexicographic (x, y) minimum — on every convex hull and
  // the first vertex monotone chain visits
  int32_t start = 0;
  for (int32_t i = 1; i < n; ++i) {
    P2 a = at(i), b = at(start);
    if (a.x < b.x || (a.x == b.x && a.y < b.y)) start = i;
  }

  for (int64_t m = 16; ; m = std::min<int64_t>(
           static_cast<int64_t>(n), m * m)) {
    // group mini-hulls of <= m points each
    int32_t n_groups = static_cast<int32_t>((n + m - 1) / m);
    std::vector<std::vector<int32_t>> gh(n_groups);   // hull indices
    std::vector<std::vector<P2>> gp(n_groups);        // hull coordinates
    std::vector<float> buf;
    for (int32_t g = 0; g < n_groups; ++g) {
      int32_t lo = static_cast<int32_t>(g * m);
      int32_t cnt = std::min<int32_t>(static_cast<int32_t>(m), n - lo);
      buf.assign(pts + 2 * lo, pts + 2 * (lo + cnt));
      gh[g] = convex_hull_impl(buf.data(), cnt);
      for (int32_t& idx : gh[g]) idx += lo;
      gp[g].reserve(gh[g].size());
      for (int32_t idx : gh[g]) gp[g].push_back(at(idx));
    }

    std::vector<int32_t> hull;
    int32_t cur = start;
    bool ok = false;
    for (int64_t step = 0; step < m; ++step) {
      hull.push_back(cur);
      P2 p = at(cur);
      int32_t best = -1;
      for (int32_t g = 0; g < n_groups; ++g) {
        if (gp[g].empty()) continue;
        int32_t t;
        int32_t k = static_cast<int32_t>(gp[g].size());
        // p may be a vertex of its own group's mini-hull: its tangent is
        // simply the next CCW vertex there
        int32_t self = -1;
        for (int32_t i = 0; i < k; ++i) {
          if (gh[g][i] == cur) { self = i; break; }
        }
        if (self >= 0) {
          if (k == 1) continue;
          t = (self + 1) % k;
        } else {
          t = tangent_index(p, gp[g]);
          if (gh[g][t] == cur) continue;
        }
        int32_t cand = gh[g][t];
        if (best < 0 || wrap_better(p, at(best), at(cand))) best = cand;
      }
      if (best < 0 || best == start) { ok = true; break; }
      cur = best;
    }
    if (ok) return hull;
    if (m >= n) return convex_hull_impl(pts, n);  // unreachable safety net
  }
}

// ---------------------------------------------------------------------------
// Delaunay triangulation: Bowyer-Watson with a single ghost vertex at
// infinity (Shewchuk-style) and walk-based point location. Triangles store
// vertex indices and neighbor triangle ids; ghost triangles (one vertex ==
// the ghost id `n`) tile the outside of the hull as a fan around the ghost.
// The ghost-vertex formulation keeps all predicates exact: the circumcircle
// of a ghost triangle (u, v, G) degenerates to the open half-plane left of
// the directed edge u->v plus the open edge itself, so huge circumcircles of
// thin hull triangles never interact with any artificial finite vertex.
// ---------------------------------------------------------------------------
struct Tri {
  int32_t v[3];   // CCW vertices (ghost triangles contain the ghost id)
  int32_t nb[3];  // nb[k] is the neighbor across edge (v[k], v[(k+1)%3])
  bool alive;
};

struct Delaunay {
  std::vector<P2> p;        // n input points
  std::vector<Tri> tris;
  int32_t n;                // number of real points; ghost id == n
  bool ok = false;

  inline bool is_ghost_v(int32_t v) const { return v == n; }
  inline bool is_ghost_t(int32_t t) const {
    const Tri& tr = tris[t];
    return tr.v[0] == n || tr.v[1] == n || tr.v[2] == n;
  }

  inline double orient(int32_t a, int32_t b, int32_t c) const {
    return cross(p[a], p[b], p[c]);
  }

  // exact in-circumcircle: positive if d strictly inside circle through the
  // CCW triangle (a,b,c)
  inline double incircle(int32_t a, int32_t b, int32_t c, int32_t d) const {
    const double adx = p[a].x - p[d].x, ady = p[a].y - p[d].y;
    const double bdx = p[b].x - p[d].x, bdy = p[b].y - p[d].y;
    const double cdx = p[c].x - p[d].x, cdy = p[c].y - p[d].y;
    const double ad = adx * adx + ady * ady;
    const double bd = bdx * bdx + bdy * bdy;
    const double cd = cdx * cdx + cdy * cdy;
    return adx * (bdy * cd - bd * cdy) - ady * (bdx * cd - bd * cdx) +
           ad * (bdx * cdy - bdy * cdx);
  }

  // circumcircle test with ghost handling; d is always a real point
  bool in_circum(int32_t t, int32_t d) const {
    const Tri& tr = tris[t];
    int g = -1;
    for (int k = 0; k < 3; ++k)
      if (is_ghost_v(tr.v[k])) g = k;
    if (g < 0)
      return incircle(tr.v[0], tr.v[1], tr.v[2], d) > 0;
    // ghost (.., u, v, G, ..): real directed edge follows the cycle order
    const int32_t u = tr.v[(g + 1) % 3], v = tr.v[(g + 2) % 3];
    const double o = orient(u, v, d);
    if (o > 0) return true;
    if (o < 0) return false;
    // collinear: inside iff strictly within the open segment (u, v)
    const double dot = (p[d].x - p[u].x) * (p[v].x - p[d].x) +
                       (p[d].y - p[u].y) * (p[v].y - p[d].y);
    return dot > 0;
  }

  void build(const float* pts, int32_t count) {
    n = count;
    p.resize(n);
    double xmin = 1e300, xmax = -1e300, ymin = 1e300, ymax = -1e300;
    for (int32_t i = 0; i < n; ++i) {
      p[i] = {static_cast<double>(pts[2 * i]),
              static_cast<double>(pts[2 * i + 1])};
      xmin = std::min(xmin, p[i].x); xmax = std::max(xmax, p[i].x);
      ymin = std::min(ymin, p[i].y); ymax = std::max(ymax, p[i].y);
    }
    const double w = std::max({xmax - xmin, ymax - ymin, 1e-12});

    // insertion order: Morton-ish spatial sort for walk locality
    // (keys precomputed once — the comparator-lambda version recomputed
    // the 16-step interleave O(n log n) times)
    std::vector<int32_t> order(n);
    {
      auto interleave = [](uint64_t v) {
        v = (v | (v << 8)) & 0x00FF00FF00FF00FFULL;
        v = (v | (v << 4)) & 0x0F0F0F0F0F0F0F0FULL;
        v = (v | (v << 2)) & 0x3333333333333333ULL;
        v = (v | (v << 1)) & 0x5555555555555555ULL;
        return v;
      };
      std::vector<uint64_t> mkey(n);
      for (int32_t i = 0; i < n; ++i) {
        const uint64_t gx =
            static_cast<uint64_t>((p[i].x - xmin) / w * 65535.0);
        const uint64_t gy =
            static_cast<uint64_t>((p[i].y - ymin) / w * 65535.0);
        mkey[i] = interleave(gx) | (interleave(gy) << 1);
      }
      for (int32_t i = 0; i < n; ++i) order[i] = i;
      std::sort(order.begin(), order.end(),
                [&](int32_t a, int32_t b) { return mkey[a] < mkey[b]; });
    }

    // seed: first two distinct points + first point not collinear with them
    int32_t s0 = order[0], s1 = -1, s2 = -1;
    size_t cursor = 1;
    for (; cursor < order.size(); ++cursor) {
      const int32_t c = order[cursor];
      if (p[c].x != p[s0].x || p[c].y != p[s0].y) { s1 = c; ++cursor; break; }
    }
    if (s1 < 0) { ok = false; return; }
    std::vector<char> used(n, 0);
    used[s0] = used[s1] = 1;
    double best = 0.0;
    for (size_t j = cursor; j < order.size(); ++j) {
      const int32_t c = order[j];
      const double o = orient(s0, s1, c);
      if (o != 0.0) { s2 = c; best = o; break; }
    }
    if (s2 < 0) { ok = false; return; }  // all collinear
    used[s2] = 1;
    if (best < 0) std::swap(s0, s1);     // make (s0,s1,s2) CCW
    tris.clear();
    // real triangle 0 + ghost fan 1..3
    tris.push_back({{s0, s1, s2}, {3, 1, 2}, true});     // (s0,s1): ghost 3
    tris.push_back({{s2, s1, n}, {0, 3, 2}, true});      // across (s1,s2)
    tris.push_back({{s0, s2, n}, {0, 1, 3}, true});      // across (s2,s0)
    tris.push_back({{s1, s0, n}, {0, 2, 1}, true});      // across (s0,s1)

    std::vector<int32_t> bad;
    std::vector<char> in_cavity(64, 0);
    std::vector<int32_t> stack;
    // hoisted per-insertion scratch (was a fresh unordered_map + two
    // vectors per point — the dominant constant-factor cost)
    struct BEdge { int32_t a, b, outside; };
    std::vector<BEdge> bound;
    std::vector<int32_t> fresh;
    std::vector<int32_t> es_tri(n + 1, -1);    // edge_start, epoch-tagged
    std::vector<uint32_t> es_epoch(n + 1, 0);
    uint32_t epoch = 0;
    int32_t last = 0;
    for (size_t oi = 0; oi < order.size(); ++oi) {
      const int32_t pi = order[oi];
      if (used[pi]) continue;
      const int32_t t0 = locate(pi, last);
      if (t0 < 0) { ok = false; return; }
      // --- collect cavity: BFS over triangles whose circumcircle holds pi
      bad.clear();
      stack.clear();
      if (tris.size() > in_cavity.size())
        in_cavity.resize(tris.size() * 2, 0);
      stack.push_back(t0);
      in_cavity[t0] = 1;
      bool dup = false;
      while (!stack.empty() && !dup) {
        const int32_t t = stack.back();
        stack.pop_back();
        bad.push_back(t);
        for (int k = 0; k < 3; ++k) {
          const int32_t vk = tris[t].v[k];
          if (!is_ghost_v(vk) && p[vk].x == p[pi].x && p[vk].y == p[pi].y) {
            dup = true;  // duplicate point: skip insertion
            break;
          }
          const int32_t nb = tris[t].nb[k];
          if (nb >= 0 && !in_cavity[nb] && in_circum(nb, pi)) {
            in_cavity[nb] = 1;
            stack.push_back(nb);
          }
        }
      }
      if (dup) {
        for (int32_t t : bad) in_cavity[t] = 0;
        for (int32_t t : stack) in_cavity[t] = 0;
        continue;
      }
      // --- cavity boundary edges, with their outside neighbors
      bound.clear();
      for (int32_t t : bad)
        for (int k = 0; k < 3; ++k) {
          const int32_t nb = tris[t].nb[k];
          if (nb < 0 || !in_cavity[nb])
            bound.push_back({tris[t].v[k], tris[t].v[(k + 1) % 3], nb});
        }
      // --- retriangulate: one new triangle (a, b, pi) per boundary edge;
      //     reuse cavity slots, allocate the rest
      fresh.resize(bound.size());
      for (size_t e = 0; e < bound.size(); ++e)
        fresh[e] = (e < bad.size())
                       ? bad[e]
                       : (tris.push_back({}), (int32_t)tris.size() - 1);
      if (tris.size() > in_cavity.size())
        in_cavity.resize(tris.size() * 2, 0);
      // cavity boundary is a single cycle: each boundary vertex starts
      // exactly one directed edge (the ghost can be such a vertex too)
      ++epoch;
      for (size_t e = 0; e < bound.size(); ++e) {
        es_tri[bound[e].a] = fresh[e];
        es_epoch[bound[e].a] = epoch;
      }
      for (size_t e = 0; e < bound.size(); ++e) {
        Tri& t = tris[fresh[e]];
        t.v[0] = bound[e].a; t.v[1] = bound[e].b; t.v[2] = pi;
        t.alive = true;
        t.nb[0] = bound[e].outside;
        if (bound[e].outside >= 0) {
          Tri& o = tris[bound[e].outside];
          for (int k = 0; k < 3; ++k)
            if (o.v[k] == bound[e].b && o.v[(k + 1) % 3] == bound[e].a)
              o.nb[k] = fresh[e];
        }
        t.nb[1] = (es_epoch[bound[e].b] == epoch) ? es_tri[bound[e].b] : -1;
      }
      for (size_t e = 0; e < bound.size(); ++e) {
        const int32_t nb1 = tris[fresh[e]].nb[1];
        if (nb1 >= 0) tris[nb1].nb[2] = fresh[e];
      }
      for (int32_t t : bad) in_cavity[t] = 0;
      last = fresh.empty() ? last : fresh[0];
      used[pi] = 1;
    }
    // drop ghost triangles
    for (size_t t = 0; t < tris.size(); ++t)
      if (tris[t].alive && is_ghost_t(static_cast<int32_t>(t)))
        tris[t].alive = false;
    ok = true;
  }

  // walk over REAL triangles toward pi; if the walk exits through a hull
  // edge, the adjacent ghost triangle is the cavity seed (pi lies beyond
  // that hull edge's line, hence inside the ghost's circumcircle limit).
  int32_t locate(int32_t pi, int32_t start) const {
    int32_t t = start;
    if (t < 0 || !tris[t].alive || is_ghost_t(t)) {
      t = -1;
      for (size_t i = 0; i < tris.size(); ++i)
        if (tris[i].alive && !is_ghost_t(static_cast<int32_t>(i))) {
          t = static_cast<int32_t>(i);
          break;
        }
      if (t < 0) return -1;
    }
    for (int64_t steps = 0;
         steps < static_cast<int64_t>(tris.size()) * 4 + 16; ++steps) {
      const Tri& tr = tris[t];
      int32_t next = -1;
      for (int k = 0; k < 3; ++k) {
        if (orient(tr.v[k], tr.v[(k + 1) % 3], pi) < 0) {
          next = tr.nb[k];
          break;
        }
      }
      if (next < 0) return t;                 // containing real triangle
      if (is_ghost_t(next)) return next;      // exited hull: ghost seed
      t = next;
    }
    return -1;  // walk failed (should not happen with exact predicates)
  }
};

// ---------------------------------------------------------------------------
// chi-shape peeling over the Delaunay boundary.
// ---------------------------------------------------------------------------
int32_t chi_hull_impl(const float* pts, int32_t n, double chi,
                      int32_t* out, int32_t cap) {
  Delaunay dt;
  dt.build(pts, n);
  if (!dt.ok) return -2;  // degenerate: caller falls back to convex hull

  // Hash-free formulation: the triangulation's stored adjacency IS the
  // edge structure. An edge of alive triangle t is (t, k) with endpoints
  // (v[k], v[(k+1)%3]); it is a BOUNDARY edge iff the neighbor across it
  // is missing/dead (ghost triangles were already marked dead by build).
  auto& tris = dt.tris;
  const int32_t T = static_cast<int32_t>(tris.size());
  std::vector<char> alive(T);
  int32_t alive_cnt = 0;
  for (int32_t t = 0; t < T; ++t) {
    alive[t] = tris[t].alive ? 1 : 0;
    alive_cnt += alive[t];
  }
  if (alive_cnt == 0) return -2;
  auto elen = [&](int32_t a, int32_t b) {
    const double dx = dt.p[a].x - dt.p[b].x, dy = dt.p[a].y - dt.p[b].y;
    return std::sqrt(dx * dx + dy * dy);
  };
  auto is_b = [&](int32_t t, int k) {
    const int32_t nb = tris[t].nb[k];
    return nb < 0 || !alive[nb];
  };

  // chi threshold over every (undirected) triangulation edge
  double l_min = std::numeric_limits<double>::max(), l_max = 0.0;
  for (int32_t t = 0; t < T; ++t) {
    if (!alive[t]) continue;
    for (int k = 0; k < 3; ++k) {
      const int32_t nb = tris[t].nb[k];
      if (nb >= 0 && alive[nb] && nb < t) continue;  // count interior once
      const double l = elen(tris[t].v[k], tris[t].v[(k + 1) % 3]);
      l_min = std::min(l_min, l);
      l_max = std::max(l_max, l);
    }
  }
  const double l_thresh = l_min + chi * (l_max - l_min);

  // peel: longest-first over boundary edges; removing triangle t across
  // boundary edge (a,b) exposes its other two edges (always interior
  // before the peel — if either were boundary, opp would be a boundary
  // vertex and the regularity constraint blocks the peel)
  std::vector<int32_t> bdeg(n, 0);   // boundary-edge incidences per vertex
  using HeapItem = std::tuple<double, int32_t, int32_t>;  // (len, t, k)
  std::priority_queue<HeapItem> heap;
  for (int32_t t = 0; t < T; ++t) {
    if (!alive[t]) continue;
    for (int k = 0; k < 3; ++k)
      if (is_b(t, k)) {
        const int32_t a = tris[t].v[k], b = tris[t].v[(k + 1) % 3];
        ++bdeg[a];
        ++bdeg[b];
        heap.push({elen(a, b), t, k});
      }
  }
  while (!heap.empty()) {
    const auto [l, t, k] = heap.top();
    heap.pop();
    if (!alive[t]) continue;  // stale: owning triangle already peeled
    if (l <= l_thresh) break;
    const int32_t opp = tris[t].v[(k + 2) % 3];
    if (bdeg[opp] > 0) continue;  // regularity constraint
    alive[t] = 0;
    for (int kk : {(k + 1) % 3, (k + 2) % 3}) {
      const int32_t nb = tris[t].nb[kk];
      // nb is alive (see argument above); find the shared edge from its
      // side so the new boundary edge references a live triangle
      for (int k2 = 0; k2 < 3; ++k2)
        if (tris[nb].nb[k2] == t) {
          heap.push({elen(tris[nb].v[k2], tris[nb].v[(k2 + 1) % 3]),
                     nb, k2});
          break;
        }
    }
    bdeg[opp] += 2;
  }

  // walk the boundary cycle via triangle adjacency, starting from the
  // minimum boundary vertex (matches the previous formulation's start)
  int32_t st = -1, sk = -1, smin = std::numeric_limits<int32_t>::max();
  for (int32_t t = 0; t < T; ++t) {
    if (!alive[t]) continue;
    for (int k = 0; k < 3; ++k)
      if (is_b(t, k) && tris[t].v[k] < smin) {
        smin = tris[t].v[k];
        st = t;
        sk = k;
      }
  }
  if (st < 0) return -2;
  std::vector<int32_t> walk;
  int32_t t = st, k = sk;
  while (true) {
    walk.push_back(tris[t].v[k]);
    if (static_cast<int32_t>(walk.size()) > n) break;  // safety
    // rotate around b = v[(k+1)%3] to the next boundary edge out of b
    int kb = (k + 1) % 3;
    while (!is_b(t, kb)) {
      const int32_t nb = tris[t].nb[kb];
      const int32_t b = tris[t].v[kb];
      int found = -1;
      for (int k2 = 0; k2 < 3; ++k2)
        if (tris[nb].v[k2] == b) found = k2;
      t = nb;
      kb = found;
    }
    k = kb;
    if (t == st && k == sk) break;  // cycle closed
  }
  if (static_cast<int32_t>(walk.size()) > n) {
    // safety trip: malformed boundary; emit nothing -> convex fallback
    return -2;
  }
  if (static_cast<int32_t>(walk.size()) > cap) return -1;  // caller: grow
  std::memcpy(out, walk.data(), walk.size() * sizeof(int32_t));
  return static_cast<int32_t>(walk.size());
}

// ---------------------------------------------------------------------------
// Union-find
// ---------------------------------------------------------------------------
struct DSU {
  std::vector<int32_t> parent;
  explicit DSU(int32_t n) : parent(n) {
    for (int32_t i = 0; i < n; ++i) parent[i] = i;
  }
  int32_t find(int32_t x) {
    while (parent[x] != x) {
      parent[x] = parent[parent[x]];  // path halving
      x = parent[x];
    }
    return x;
  }
  void unite(int32_t a, int32_t b) {
    a = find(a); b = find(b);
    if (a == b) return;
    if (a > b) std::swap(a, b);      // min-id root => canonical labels
    parent[b] = a;
  }
};

}  // namespace

extern "C" {

// CCW strictly-convex hull indices. Returns count, or -1 if cap too small.
int32_t convex_hull(const float* pts, int32_t n, int32_t* out, int32_t cap) {
  if (n <= 0) return 0;
  auto h = convex_hull_impl(pts, n);
  if (static_cast<int32_t>(h.size()) > cap) return -1;
  std::memcpy(out, h.data(), h.size() * sizeof(int32_t));
  return static_cast<int32_t>(h.size());
}

// CCW strictly-convex hull indices via Chan's grouped march (the
// reference's >1000-point convex path, polygon_simplification.cpp:53-63).
// Returns count, or -1 if cap too small.
int32_t chan_convex_hull(const float* pts, int32_t n, int32_t* out,
                         int32_t cap) {
  if (n <= 0) return 0;
  auto h = chan_hull_impl(pts, n);
  if (static_cast<int32_t>(h.size()) > cap) return -1;
  std::memcpy(out, h.data(), h.size() * sizeof(int32_t));
  return static_cast<int32_t>(h.size());
}

// Ordered chi-shape outline indices. Returns count; -1 cap too small;
// -2 degenerate input (caller should use convex hull).
int32_t chi_concave_hull(const float* pts, int32_t n, double chi,
                         int32_t* out, int32_t cap) {
  if (n < 3) return -2;
  return chi_hull_impl(pts, n, chi, out, cap);
}

// Batched chi-shape hulls over concatenated clusters, parallelized with an
// internal thread pool (one Python->C call per FRAME instead of one per
// cluster — the per-call ctypes/GIL overhead dominates at ~150 large
// clusters/frame). pts holds packed xy pairs; cluster j occupies point
// offsets [offsets[j], offsets[j+1]). Hull indices (LOCAL to each cluster)
// are written at the same offsets; out_counts[j] = vertex count, or -2 for
// degenerate clusters (collinear/tiny/malformed boundary) — the Python
// wrapper routes those through the same per-cluster fallback chain as
// chi_concave_hull, keeping batch and single paths output-identical.
// Pass clusters largest-first for the best load balance.
void chi_hulls_batch(const float* pts, const int64_t* offsets, int32_t m,
                     double chi, int32_t* out, int32_t* out_counts,
                     int32_t n_threads) {
  std::atomic<int32_t> next(0);
  auto work = [&]() {
    for (;;) {
      const int32_t j = next.fetch_add(1);
      if (j >= m) break;
      const int64_t off = offsets[j];
      const int32_t nj = static_cast<int32_t>(offsets[j + 1] - off);
      int32_t k = -2;
      if (nj >= 3) k = chi_hull_impl(pts + 2 * off, nj, chi, out + off, nj);
      out_counts[j] = k < 0 ? -2 : k;
    }
  };
  const int32_t nt = std::max(
      1, std::min(n_threads, static_cast<int32_t>(
                      std::thread::hardware_concurrency())));
  if (nt <= 1 || m <= 1) {
    work();
    return;
  }
  std::vector<std::thread> pool;
  pool.reserve(nt - 1);
  for (int32_t t = 1; t < nt; ++t) pool.emplace_back(work);
  work();
  for (auto& th : pool) th.join();
}

// Delaunay triangle list (debug/test): returns triangle count, writes up to
// cap triangles as index triples. -2 on degenerate input, -1 if cap small.
int32_t delaunay_triangles(const float* pts, int32_t n, int32_t* out,
                           int32_t cap) {
  Delaunay dt;
  dt.build(pts, n);
  if (!dt.ok) return -2;
  int32_t k = 0;
  for (const auto& t : dt.tris) {
    if (!t.alive) continue;
    if (k >= cap) return -1;
    out[3 * k] = t.v[0];
    out[3 * k + 1] = t.v[1];
    out[3 * k + 2] = t.v[2];
    ++k;
  }
  return k;
}

// Connected components over an int32 edge list. labels[i] = min node id of
// i's component. n_nodes labels written.
void union_find_cc(const int32_t* edges_u, const int32_t* edges_v,
                   int64_t n_edges, int32_t n_nodes, int32_t* labels) {
  DSU dsu(n_nodes);
  for (int64_t e = 0; e < n_edges; ++e) dsu.unite(edges_u[e], edges_v[e]);
  for (int32_t i = 0; i < n_nodes; ++i) labels[i] = dsu.find(i);
}

// Exact Euclidean radius-graph connected components via voxel hashing.
// pts: (n,3) float32. labels out: component id = min point index.
// Returns number of components.
int32_t radius_cc(const float* pts, int32_t n, float radius,
                  int32_t* labels) {
  if (n <= 0) return 0;
  const double r = radius;
  const double r2 = r * r;
  const double inv_h = 1.0 / r;  // cell size == radius, 27-neighborhood
  auto cell_of = [&](int32_t i, int64_t& cx, int64_t& cy, int64_t& cz) {
    cx = static_cast<int64_t>(std::floor(pts[3 * i] * inv_h));
    cy = static_cast<int64_t>(std::floor(pts[3 * i + 1] * inv_h));
    cz = static_cast<int64_t>(std::floor(pts[3 * i + 2] * inv_h));
  };
  auto hkey = [](int64_t cx, int64_t cy, int64_t cz) {
    return (static_cast<uint64_t>(cx) * 73856093ULL) ^
           (static_cast<uint64_t>(cy) * 19349663ULL) ^
           (static_cast<uint64_t>(cz) * 83492791ULL);
  };
  // bucket points by cell
  std::unordered_map<uint64_t, std::vector<int32_t>> cells;
  cells.reserve(n);
  for (int32_t i = 0; i < n; ++i) {
    int64_t cx, cy, cz;
    cell_of(i, cx, cy, cz);
    cells[hkey(cx, cy, cz)].push_back(i);
  }
  DSU dsu(n);
  for (int32_t i = 0; i < n; ++i) {
    int64_t cx, cy, cz;
    cell_of(i, cx, cy, cz);
    for (int dx = -1; dx <= 1; ++dx)
      for (int dy = -1; dy <= 1; ++dy)
        for (int dz = -1; dz <= 1; ++dz) {
          auto it = cells.find(hkey(cx + dx, cy + dy, cz + dz));
          if (it == cells.end()) continue;
          for (int32_t j : it->second) {
            if (j >= i) continue;  // hash collisions are fine: extra checks
            const double ddx = pts[3 * i] - pts[3 * j];
            const double ddy = pts[3 * i + 1] - pts[3 * j + 1];
            const double ddz = pts[3 * i + 2] - pts[3 * j + 2];
            if (ddx * ddx + ddy * ddy + ddz * ddz <= r2) dsu.unite(i, j);
          }
        }
  }
  int32_t n_comp = 0;
  for (int32_t i = 0; i < n; ++i) {
    labels[i] = dsu.find(i);
    if (labels[i] == i) ++n_comp;
  }
  return n_comp;
}

// Faithful serial FEC clustering (ref: src/clustering.cpp:47-125), matching
// the Python oracle bit-for-bit: float64 arithmetic, voxel buckets of size
// == radius, neighbors enumerated in ascending point index order, FIFO BFS,
// duplicate-counting size filter. Used to run 154-frame golden diffs fast.
// Returns the number of valid clusters; labels: 0..L-1, -1 INVALID,
// INT32_MIN UNDEFINED (matches clustering.hpp:53-54 conventions).
int32_t fec_cluster(const float* pts, int32_t n, double r2, double quality,
                    uint32_t min_size, uint32_t max_size, int32_t* labels) {
  const int32_t kUndefined = std::numeric_limits<int32_t>::min();
  for (int32_t i = 0; i < n; ++i) labels[i] = kUndefined;
  if (n <= 0) return 0;
  const double radius = std::sqrt(r2);
  const double inner = (1.0 - quality) * (1.0 - quality) * r2;

  std::vector<double> px(n), py(n), pz(n);
  std::vector<int64_t> cx(n), cy(n), cz(n);
  for (int32_t i = 0; i < n; ++i) {
    px[i] = pts[3 * i]; py[i] = pts[3 * i + 1]; pz[i] = pts[3 * i + 2];
    cx[i] = static_cast<int64_t>(std::floor(px[i] / radius));
    cy[i] = static_cast<int64_t>(std::floor(py[i] / radius));
    cz[i] = static_cast<int64_t>(std::floor(pz[i] / radius));
  }
  struct CellHash {
    size_t operator()(const std::array<int64_t, 3>& c) const {
      return (static_cast<uint64_t>(c[0]) * 73856093ULL) ^
             (static_cast<uint64_t>(c[1]) * 19349663ULL) ^
             (static_cast<uint64_t>(c[2]) * 83492791ULL);
    }
  };
  std::unordered_map<std::array<int64_t, 3>, std::vector<int32_t>, CellHash>
      buckets;
  buckets.reserve(n);
  for (int32_t i = 0; i < n; ++i)
    buckets[{cx[i], cy[i], cz[i]}].push_back(i);  // ascending by construction

  std::vector<char> removed(n, 0);
  std::vector<int32_t> cand, bfs, members;
  cand.reserve(256);
  int32_t label = 0;
  for (int32_t i = 0; i < n; ++i) {
    if (removed[i]) continue;
    bfs.clear();
    bfs.push_back(i);
    members.clear();
    size_t head = 0;
    while (head < bfs.size()) {
      const int32_t j = bfs[head++];
      if (removed[j]) continue;
      // radius query, ascending index order (27 buckets merged + sorted)
      cand.clear();
      for (int64_t dx = -1; dx <= 1; ++dx)
        for (int64_t dy = -1; dy <= 1; ++dy)
          for (int64_t dz = -1; dz <= 1; ++dz) {
            auto it = buckets.find({cx[j] + dx, cy[j] + dy, cz[j] + dz});
            if (it == buckets.end()) continue;
            cand.insert(cand.end(), it->second.begin(), it->second.end());
          }
      std::sort(cand.begin(), cand.end());
      for (const int32_t k : cand) {
        const double ddx = px[k] - px[j], ddy = py[k] - py[j],
                     ddz = pz[k] - pz[j];
        const double d2 = ddx * ddx + ddy * ddy + ddz * ddz;
        if (d2 > r2 || removed[k]) continue;
        labels[k] = label;
        members.push_back(k);
        if (d2 <= inner)
          removed[k] = 1;
        else
          bfs.push_back(k);
      }
    }
    if (members.size() < min_size || members.size() > max_size) {
      for (const int32_t m : members) labels[m] = -1;  // INVALID
    } else {
      ++label;
    }
  }
  return label;
}

}  // extern "C"
