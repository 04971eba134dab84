// The native BVH builder: accel.build_bvh's skip-link tree in C++.
//
// The same candidate-split cost search as the reference's BIH
// constructor (GlomeTrace/Data/Glome/Bih.hs:211-285: midpoint splits on
// x/y/z plus a big/small-object split, surface-area x count costs
// weighted 1.1/1.2, leaves at <= 3 objects), emitted as the flattened
// skip-link node arrays of accel.BvhFlat.  The numpy builder
// (accel.build_bvh(..., native=False)) is its plain version: this one
// does the same double arithmetic in the same order, so the two give
// bit-equal tables, and casts each node box to float32 only at the end.
// Over the ~100k triangles of a big mesh it takes a fraction of a second
// where the recursive numpy build takes seconds of host time.
//
// Build (native/__init__.py does it at first use):
//   g++ -O3 -shared -fPIC -std=c++17 -ffp-contract=off bvh_builder.cpp
// -ffp-contract=off: no a*b+c contraction (GCC contracts by default
// where the target has FMA), which would move the surface-area costs
// and so the splits away from numpy's.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

namespace {

constexpr double kCostSplit = 1.1;
constexpr double kCostBig = 1.2;
constexpr double kBigSaFrac = 0.4;

struct Builder {
  const double* bmin;  // (P, 3)
  const double* bmax;
  int P;
  int leaf_max;
  std::vector<double> mid;  // (P, 3)
  std::vector<double> sa;   // (P,)

  std::vector<float> nodes_bmin, nodes_bmax;
  std::vector<int32_t> leaf_start, leaf_count, skip;
  std::vector<int32_t> order;

  static double bbsa(const double lo[3], const double hi[3]) {
    double dx = std::max(hi[0] - lo[0], 0.0);
    double dy = std::max(hi[1] - lo[1], 0.0);
    double dz = std::max(hi[2] - lo[2], 0.0);
    return 2.0 * (dx * dy + dx * dz + dy * dz);
  }

  void bounds_of(const std::vector<int32_t>& idx, double lo[3], double hi[3]) {
    for (int a = 0; a < 3; ++a) {
      lo[a] = 1e300;
      hi[a] = -1e300;
    }
    for (int32_t i : idx) {
      for (int a = 0; a < 3; ++a) {
        lo[a] = std::min(lo[a], bmin[i * 3 + a]);
        hi[a] = std::max(hi[a], bmax[i * 3 + a]);
      }
    }
  }

  void emit(std::vector<int32_t>& idx) {
    size_t me = leaf_start.size();
    double lo[3], hi[3];
    bounds_of(idx, lo, hi);
    for (int a = 0; a < 3; ++a) {
      nodes_bmin.push_back((float)lo[a]);
      nodes_bmax.push_back((float)hi[a]);
    }
    leaf_start.push_back(-1);
    leaf_count.push_back(0);
    skip.push_back(-1);

    int n = (int)idx.size();
    bool make_leaf = n <= 3;
    std::vector<int32_t> l, r;
    if (!make_leaf) {
      double node_sa = std::max(bbsa(lo, hi), 1e-30);
      double best_cost = node_sa * n;  // keep-a-leaf cost
      int best = -1;                   // 0..2 axis, 3 big/small
      for (int axis = 0; axis < 3; ++axis) {
        double c = (lo[axis] + hi[axis]) * 0.5;
        double llo[3] = {1e300, 1e300, 1e300}, lhi[3] = {-1e300, -1e300, -1e300};
        double rlo[3] = {1e300, 1e300, 1e300}, rhi[3] = {-1e300, -1e300, -1e300};
        int ln = 0, rn = 0;
        for (int32_t i : idx) {
          bool left = mid[i * 3 + axis] < c;
          double* plo = left ? llo : rlo;
          double* phi = left ? lhi : rhi;
          for (int a = 0; a < 3; ++a) {
            plo[a] = std::min(plo[a], bmin[i * 3 + a]);
            phi[a] = std::max(phi[a], bmax[i * 3 + a]);
          }
          (left ? ln : rn)++;
        }
        if (ln == 0 || rn == 0) continue;
        double cost = (bbsa(llo, lhi) * ln + bbsa(rlo, rhi) * rn) * kCostSplit;
        if (cost < best_cost) {
          best_cost = cost;
          best = axis;
        }
      }
      {
        double node_thresh = node_sa * kBigSaFrac;
        double llo[3] = {1e300, 1e300, 1e300}, lhi[3] = {-1e300, -1e300, -1e300};
        double rlo[3] = {1e300, 1e300, 1e300}, rhi[3] = {-1e300, -1e300, -1e300};
        int ln = 0, rn = 0;
        for (int32_t i : idx) {
          bool big = sa[i] > node_thresh;
          double* plo = big ? llo : rlo;
          double* phi = big ? lhi : rhi;
          for (int a = 0; a < 3; ++a) {
            plo[a] = std::min(plo[a], bmin[i * 3 + a]);
            phi[a] = std::max(phi[a], bmax[i * 3 + a]);
          }
          (big ? ln : rn)++;
        }
        if (ln > 0 && rn > 0) {
          double cost = (bbsa(llo, lhi) * ln + bbsa(rlo, rhi) * rn) * kCostBig;
          if (cost < best_cost) {
            best_cost = cost;
            best = 3;
          }
        }
      }
      if (best < 0) {
        make_leaf = true;
      } else if (best < 3) {
        double c = (lo[best] + hi[best]) * 0.5;
        for (int32_t i : idx)
          (mid[i * 3 + best] < c ? l : r).push_back(i);
      } else {
        double node_thresh = node_sa * kBigSaFrac;
        for (int32_t i : idx) (sa[i] > node_thresh ? l : r).push_back(i);
      }
    }

    if (make_leaf) {
      int take = std::min(n, leaf_max);
      leaf_start[me] = (int32_t)order.size();
      leaf_count[me] = take;
      for (int k = 0; k < take; ++k) order.push_back(idx[k]);
      if (n > take) {
        std::vector<int32_t> rest(idx.begin() + take, idx.end());
        emit(rest);
      }
    } else {
      emit(l);
      emit(r);
    }
    skip[me] = (int32_t)leaf_start.size();
  }
};

}  // namespace

extern "C" {

// Returns the number of nodes; fills caller-owned output buffers which
// must be sized >= cap_nodes/cap_order (use 4*P+8 each).
int32_t glome_build_bvh(const double* bmin, const double* bmax, int32_t P,
                        int32_t leaf_max, float* out_bmin, float* out_bmax,
                        int32_t* out_leaf_start, int32_t* out_leaf_count,
                        int32_t* out_skip, int32_t* out_order,
                        int32_t cap_nodes, int32_t cap_order,
                        int32_t* out_n_order) {
  Builder b;
  b.bmin = bmin;
  b.bmax = bmax;
  b.P = P;
  b.leaf_max = leaf_max;
  b.mid.resize((size_t)P * 3);
  b.sa.resize(P);
  for (int i = 0; i < P; ++i) {
    double lo[3], hi[3];
    for (int a = 0; a < 3; ++a) {
      lo[a] = bmin[i * 3 + a];
      hi[a] = bmax[i * 3 + a];
      b.mid[i * 3 + a] = (lo[a] + hi[a]) * 0.5;
    }
    b.sa[i] = Builder::bbsa(lo, hi);
  }
  if (P > 0) {
    std::vector<int32_t> all(P);
    for (int i = 0; i < P; ++i) all[i] = i;
    b.emit(all);
  }
  int32_t M = (int32_t)b.leaf_start.size();
  if (M > cap_nodes || (int32_t)b.order.size() > cap_order) return -1;
  std::copy(b.nodes_bmin.begin(), b.nodes_bmin.end(), out_bmin);
  std::copy(b.nodes_bmax.begin(), b.nodes_bmax.end(), out_bmax);
  std::copy(b.leaf_start.begin(), b.leaf_start.end(), out_leaf_start);
  std::copy(b.leaf_count.begin(), b.leaf_count.end(), out_leaf_count);
  std::copy(b.skip.begin(), b.skip.end(), out_skip);
  std::copy(b.order.begin(), b.order.end(), out_order);
  *out_n_order = (int32_t)b.order.size();
  return M;
}
}
