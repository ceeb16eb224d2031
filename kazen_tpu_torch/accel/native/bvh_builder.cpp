// Native binned-SAH BVH builder (C ABI, loaded via ctypes).
//
// Replaces the reference's Embree3 build step (accel.cpp:25-61) for large
// meshes where the numpy/Python recursive builder dominates scene-compile
// time. Produces exactly the flattened escape-link layout consumed by
// accel/bvh.py and the Pallas packet kernel: DFS node order, skip[i] = index
// after node i's subtree, leaf prims contiguous in prim_faces.
//
// Build: g++ -O2 -shared -fPIC -o libbvh.so bvh_builder.cpp
#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Vec3 {
  float x, y, z;
};

static inline Vec3 vmin(const Vec3 &a, const Vec3 &b) {
  return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
static inline Vec3 vmax(const Vec3 &a, const Vec3 &b) {
  return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}
static inline float area(const Vec3 &mn, const Vec3 &mx) {
  float dx = mx.x - mn.x, dy = mx.y - mn.y, dz = mx.z - mn.z;
  return 2.0f * (dx * dy + dy * dz + dx * dz);
}

struct Builder {
  static constexpr int kBins = 16;
  int leaf_size;
  const Vec3 *fmin;
  const Vec3 *fmax;
  const Vec3 *centroid;
  std::vector<float> bounds_min, bounds_max;
  std::vector<int32_t> skip, prim_offset, prim_count, prim_faces;

  void emit(int32_t *ids, int n) {
    size_t node = skip.size();
    Vec3 mn = fmin[ids[0]], mx = fmax[ids[0]];
    for (int i = 1; i < n; ++i) {
      mn = vmin(mn, fmin[ids[i]]);
      mx = vmax(mx, fmax[ids[i]]);
    }
    bounds_min.insert(bounds_min.end(), {mn.x, mn.y, mn.z});
    bounds_max.insert(bounds_max.end(), {mx.x, mx.y, mx.z});
    skip.push_back(-1);
    if (n <= leaf_size) {
      prim_offset.push_back((int32_t)prim_faces.size());
      prim_count.push_back(n);
      prim_faces.insert(prim_faces.end(), ids, ids + n);
    } else {
      prim_offset.push_back(0);
      prim_count.push_back(0);
      // centroid extent + widest axis
      Vec3 cmin = centroid[ids[0]], cmax = centroid[ids[0]];
      for (int i = 1; i < n; ++i) {
        cmin = vmin(cmin, centroid[ids[i]]);
        cmax = vmax(cmax, centroid[ids[i]]);
      }
      float ext[3] = {cmax.x - cmin.x, cmax.y - cmin.y, cmax.z - cmin.z};
      int axis = 0;
      if (ext[1] > ext[axis]) axis = 1;
      if (ext[2] > ext[axis]) axis = 2;

      int mid = -1;
      if (ext[axis] > 1e-12f) {
        float lo = axis == 0 ? cmin.x : (axis == 1 ? cmin.y : cmin.z);
        float scale = kBins * (1.0f - 1e-6f) / ext[axis];
        // bin bounds + counts
        Vec3 bmn[kBins], bmx[kBins];
        int cnt[kBins] = {0};
        for (int b = 0; b < kBins; ++b) {
          bmn[b] = {1e30f, 1e30f, 1e30f};
          bmx[b] = {-1e30f, -1e30f, -1e30f};
        }
        auto bin_of = [&](int32_t id) {
          const Vec3 &c = centroid[id];
          float v = axis == 0 ? c.x : (axis == 1 ? c.y : c.z);
          int b = (int)((v - lo) * scale);
          return b < 0 ? 0 : (b >= kBins ? kBins - 1 : b);
        };
        for (int i = 0; i < n; ++i) {
          int b = bin_of(ids[i]);
          cnt[b]++;
          bmn[b] = vmin(bmn[b], fmin[ids[i]]);
          bmx[b] = vmax(bmx[b], fmax[ids[i]]);
        }
        // sweep for best SAH split
        float best_cost = 1e30f;
        int best_split = -1;
        for (int split = 1; split < kBins; ++split) {
          int nl = 0, nr = 0;
          Vec3 lmn = {1e30f, 1e30f, 1e30f}, lmx = {-1e30f, -1e30f, -1e30f};
          Vec3 rmn = lmn, rmx = lmx;
          for (int b = 0; b < split; ++b) {
            if (!cnt[b]) continue;
            nl += cnt[b];
            lmn = vmin(lmn, bmn[b]);
            lmx = vmax(lmx, bmx[b]);
          }
          for (int b = split; b < kBins; ++b) {
            if (!cnt[b]) continue;
            nr += cnt[b];
            rmn = vmin(rmn, bmn[b]);
            rmx = vmax(rmx, bmx[b]);
          }
          if (!nl || !nr) continue;
          float cost = nl * area(lmn, lmx) + nr * area(rmn, rmx);
          if (cost < best_cost) {
            best_cost = cost;
            best_split = split;
          }
        }
        if (best_split > 0) {
          int32_t *first = ids;
          int32_t *last = ids + n;
          int32_t *p = std::partition(first, last, [&](int32_t id) {
            return bin_of(id) < best_split;
          });
          mid = (int)(p - ids);
          if (mid == 0 || mid == n) mid = -1;
        }
      }
      if (mid < 0) {
        // degenerate: median split on the axis
        std::nth_element(ids, ids + n / 2, ids + n, [&](int32_t a, int32_t b) {
          const Vec3 &ca = centroid[a], &cb = centroid[b];
          float va = axis == 0 ? ca.x : (axis == 1 ? ca.y : ca.z);
          float vb = axis == 0 ? cb.x : (axis == 1 ? cb.y : cb.z);
          return va < vb;
        });
        mid = n / 2;
      }
      emit(ids, mid);
      emit(ids + mid, n - mid);
    }
    skip[node] = (int32_t)skip.size();
  }
};

}  // namespace

extern "C" {

// Returns the node count; call bvh_read to copy results out, bvh_free after.
// V: (nv, 3) float32, F: (nf, 3) int32.
void *bvh_build(const float *V, int32_t nv, const int32_t *F, int32_t nf,
                int32_t leaf_size, int32_t *n_nodes_out) {
  auto *b = new Builder();
  b->leaf_size = leaf_size;
  std::vector<Vec3> fmin(nf), fmax(nf), cent(nf);
  for (int32_t f = 0; f < nf; ++f) {
    Vec3 p0 = {V[3 * F[3 * f] + 0], V[3 * F[3 * f] + 1], V[3 * F[3 * f] + 2]};
    Vec3 p1 = {V[3 * F[3 * f + 1] + 0], V[3 * F[3 * f + 1] + 1],
               V[3 * F[3 * f + 1] + 2]};
    Vec3 p2 = {V[3 * F[3 * f + 2] + 0], V[3 * F[3 * f + 2] + 1],
               V[3 * F[3 * f + 2] + 2]};
    fmin[f] = vmin(vmin(p0, p1), p2);
    fmax[f] = vmax(vmax(p0, p1), p2);
    cent[f] = {(fmin[f].x + fmax[f].x) * 0.5f, (fmin[f].y + fmax[f].y) * 0.5f,
               (fmin[f].z + fmax[f].z) * 0.5f};
  }
  b->fmin = fmin.data();
  b->fmax = fmax.data();
  b->centroid = cent.data();
  std::vector<int32_t> ids(nf);
  for (int32_t i = 0; i < nf; ++i) ids[i] = i;
  b->emit(ids.data(), nf);
  b->fmin = b->fmax = b->centroid = nullptr;
  *n_nodes_out = (int32_t)b->skip.size();
  return b;
}

void bvh_read(void *handle, float *bounds_min, float *bounds_max,
              int32_t *skip, int32_t *prim_offset, int32_t *prim_count,
              int32_t *prim_faces) {
  auto *b = (Builder *)handle;
  std::memcpy(bounds_min, b->bounds_min.data(),
              b->bounds_min.size() * sizeof(float));
  std::memcpy(bounds_max, b->bounds_max.data(),
              b->bounds_max.size() * sizeof(float));
  std::memcpy(skip, b->skip.data(), b->skip.size() * sizeof(int32_t));
  std::memcpy(prim_offset, b->prim_offset.data(),
              b->prim_offset.size() * sizeof(int32_t));
  std::memcpy(prim_count, b->prim_count.data(),
              b->prim_count.size() * sizeof(int32_t));
  std::memcpy(prim_faces, b->prim_faces.data(),
              b->prim_faces.size() * sizeof(int32_t));
}

void bvh_free(void *handle) { delete (Builder *)handle; }

}  // extern "C"
