// Cluster-BVH ray traversal on Hopper (sm_90a): nearest hit and any hit.
//
// Replaces the Pallas kernels of kazen_tpu/accel/cluster_trace.py:_make_kernel
// (any_hit=False behind `trace`, any_hit=True behind `occluded`). Same output
// contract; the inner design is the card's, not the TPU's.
//
// The walk. One thread per ray, 128 threads a block, ragged edge masked (no
// padding to 1024-ray packets). Each ray walks the node table of its own
// direction octant, 4*(dx>0) + 2*(dy>0) + (dz>0), a near-child-first
// preorder with escape links: nxt = (box hit && !leaf) ? c+1 : skip. No
// stack. The loop is Aila and Laine's "while-while" (Understanding the
// Efficiency of Ray Traversal on GPUs, HPG 2009): each lane walks until it
// holds a leaf to test or is done, then the warp drains the pending leaves.
//
// The drain. `min_idle` chooses between two ways, per drain round:
// * fewer than `min_idle` of the warp's 32 lanes idle (no pending leaf):
//   each pending lane tests its own cluster's <= 128 triangles one by one.
//   On a coherent warp (camera rays) the lanes read the same records and
//   the read-only path broadcasts them;
// * at least `min_idle` lanes idle: the warp serves the pending lanes one
//   by one. For lane L, lane j tests triangles j, j+32, j+64, j+96 of L's
//   cluster against L's ray (broadcast with shuffles), so each warp load
//   covers one contiguous 1.5 KB span and a visit reads its records once.
//   A serial loop costs the warp the longest lane's visit; a divergent
//   bounce warp, where one lane grazes a dense mesh, otherwise keeps 31
//   lanes idle through each of that lane's 128-triangle loops.
// min_idle = 33 never drains cooperatively (one serial loop per lane);
// min_idle = 0 always does. Every value gives the same rows:
// * nearest hit: each lane keeps its best (t, k) with a strict '<' over its
//   increasing k, the warp takes the lexicographic minimum of (t, k), and L
//   accepts it only below its tbest -- exactly what the serial loop's strict
//   '<' over k = 0..count-1 keeps;
// * any hit: the warp takes the first blocker in k order, and row 3 counts
//   the triangles that can block up to and including it, as the serial loop
//   counts them before it breaks.
// Lanes past the end and dead lanes (maxt < 0) stay in the loop as helpers
// until their warp ends: the warp intrinsics need every lane of the mask.
//
// Per triangle, Moller-Trumbore (accel/intersect.py) in f32 from a compact
// (C, 128, 12) record table [p0 | e1 | e2 | blocks]. One `mt_test` serves
// both drains and is written in round-to-nearest steps the compiler may not
// fuse into FMAs, in the plain version's order of operations, so a (ray,
// triangle) pair gives the same t wherever it is tested, here and in the
// plain walk (accel/cluster_trace.py:trace_walk_plain). The nearest hit
// reads the winner's 32 attribute rows once at the end and recomputes its
// (t, u, v) exactly as the reference's _write_nearest_out does; output is
// written column-per-thread into (40, N), coalesced. The any hit stops at
// the first accepted triangle that can block (faces of primary-invisible
// lights never do) and writes row 0 of (8, N).
//
// What bounds it, and what Hopper offers. The ray/hit I/O is 192 bytes a
// ray for the nearest hit; the triangle tests of a pass are few (< 100 a
// ray on average), so the bound is by bytes, yet the kernel runs far above
// it: warps wait on divergent lanes and dependent loads, not on arithmetic
// or device memory. Hence the levers are warp-level primitives and
// coalescing. The tables fit the 50 MB L2 (the 36,876-face stand-in:
// 419 x 128 x 48 B = 2.6 MB of triangle records, 6.9 MB of shade rows).
// Within a visit no record is read twice, so staging a cluster in shared
// memory, or through TMA, buys nothing; tensor cores would break the f32
// contract rows 0-33 are held to bit for bit, which is also why the TPU
// kernel's split-bf16 MXU product is not carried over. Staging an octant's
// node table in shared memory (837 x 64 B = 54 KB for the stand-in) is the
// lever left for the walk itself. Rows 34-36 (any hit: 1-3) count visits,
// node steps and triangle tests per ray, the data for the kernel's
// operation bound and for the SIMT efficiency of its warps.
//
// `nearest_kernel<FETCH>`: FETCH = true is the nearest hit above (behind
// kz_trace_nearest). FETCH = false (kz_trace_nearest_nofetch, a lab
// instance that render() never reaches) runs the same walk and drain but
// skips the winner's attribute read, its recompute and the 40-row write: it
// reads one value (the face id) and writes six rows, which equal the default
// instance's rows 0 (t), 3 (face), 33 (cluster) and 34-36 on every lane. The
// walk's t is the recompute's t: both are mt_test's operations on the same
// f32 inputs. Its time beside the default's prices the end-of-walk fetch
// (lab/kernel_ablate.py, the counterpart of KAZEN_TRACE_ABLATE=nofetch).
#include <cuda_runtime.h>

namespace {

constexpr int K = 128;
constexpr int SH_ROWS = 32;
constexpr int OUT_ROWS = 40;
constexpr int ANY_ROWS = 8;
constexpr int TRI_F = 12;
constexpr int NODE_F = 16;
constexpr int THREADS = 128;
constexpr int WARP = 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned NONE = 0xffffffffu;
constexpr float BIG = 3.0e38f;
constexpr float DET_EPS = 1e-8f;
constexpr int S_FACE = 24;
constexpr int S_LIGHT = 25;

struct Seg {
  float ox, oy, oz, dx, dy, dz, mint, maxt;
};

struct Ray : Seg {
  float ix, iy, iz;  // reciprocal direction for the slab test
};

__device__ __forceinline__ float safe_inv(float c) {
  // the reference's 1 / where(|d| < 1e-20, 1e-20, d)
  return __fdiv_rn(1.0f, fabsf(c) < 1e-20f ? 1e-20f : c);
}

__device__ __forceinline__ Ray load_ray(const float* __restrict__ rays, int n,
                                        int i) {
  Ray r;
  r.ox = rays[0 * (size_t)n + i];
  r.oy = rays[1 * (size_t)n + i];
  r.oz = rays[2 * (size_t)n + i];
  r.dx = rays[3 * (size_t)n + i];
  r.dy = rays[4 * (size_t)n + i];
  r.dz = rays[5 * (size_t)n + i];
  r.mint = rays[6 * (size_t)n + i];
  r.maxt = rays[7 * (size_t)n + i];
  r.ix = safe_inv(r.dx);
  r.iy = safe_inv(r.dy);
  r.iz = safe_inv(r.dz);
  return r;
}

// lane L's segment, broadcast to the warp
__device__ __forceinline__ Seg shfl_seg(const Seg& s, int L) {
  Seg q;
  q.ox = __shfl_sync(FULL, s.ox, L);
  q.oy = __shfl_sync(FULL, s.oy, L);
  q.oz = __shfl_sync(FULL, s.oz, L);
  q.dx = __shfl_sync(FULL, s.dx, L);
  q.dy = __shfl_sync(FULL, s.dy, L);
  q.dz = __shfl_sync(FULL, s.dz, L);
  q.mint = __shfl_sync(FULL, s.mint, L);
  q.maxt = __shfl_sync(FULL, s.maxt, L);
  return q;
}

__device__ __forceinline__ const float* octant_nodes(
    const float* __restrict__ nodes, int n_nodes, const Ray& r) {
  const int oct =
      (r.dx > 0.0f ? 4 : 0) + (r.dy > 0.0f ? 2 : 0) + (r.dz > 0.0f ? 1 : 0);
  return nodes + (size_t)oct * n_nodes * NODE_F;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

// Slab test of node record (a, b) = [bmin3 bmax.x], [bmax.yz skip count]
// with the reference's acceptance: tnear<=tfar && tfar>=mint && tnear<=tmax.
__device__ __forceinline__ bool slab(const float4& a, const float4& b,
                                     const Ray& r, float tmax) {
  const float tx0 = (a.x - r.ox) * r.ix, tx1 = (a.w - r.ox) * r.ix;
  const float ty0 = (a.y - r.oy) * r.iy, ty1 = (b.x - r.oy) * r.iy;
  const float tz0 = (a.z - r.oz) * r.iz, tz1 = (b.y - r.oz) * r.iz;
  const float tnear =
      fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)), fminf(tz0, tz1));
  const float tfar =
      fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)), fmaxf(tz0, tz1));
  return tnear <= tfar && tfar >= r.mint && tnear <= tmax;
}

// a*b - c*d and a.b without FMA contraction (the __f*_rn intrinsics are
// never fused)
__device__ __forceinline__ float cross_rn(float a, float b, float c, float d) {
  return __fsub_rn(__fmul_rn(a, b), __fmul_rn(c, d));
}

__device__ __forceinline__ float dot_rn(float ax, float ay, float az, float bx,
                                        float by, float bz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(ax, bx), __fmul_rn(ay, by)),
                   __fmul_rn(az, bz));
}

// Moller-Trumbore against record [p0 | e1 | e2 | ...] in the operations and
// order of accel/intersect.py:moller_trumbore_edges; true with t set when the
// hit lies inside the triangle and [mint, maxt].
__device__ __forceinline__ bool mt_test(const float4& a, const float4& b,
                                        const float4& c, const Seg& r,
                                        float& t) {
  const float e1x = a.w, e1y = b.x, e1z = b.y;
  const float e2x = b.z, e2y = b.w, e2z = c.x;
  const float pvx = cross_rn(r.dy, e2z, r.dz, e2y);
  const float pvy = cross_rn(r.dz, e2x, r.dx, e2z);
  const float pvz = cross_rn(r.dx, e2y, r.dy, e2x);
  const float det = dot_rn(e1x, e1y, e1z, pvx, pvy, pvz);
  if (!(fabsf(det) > DET_EPS)) return false;
  const float inv_det = __fdiv_rn(1.0f, det);
  const float tvx = __fsub_rn(r.ox, a.x), tvy = __fsub_rn(r.oy, a.y),
              tvz = __fsub_rn(r.oz, a.z);
  const float u = __fmul_rn(dot_rn(tvx, tvy, tvz, pvx, pvy, pvz), inv_det);
  if (!(u >= 0.0f && u <= 1.0f)) return false;
  const float qvx = cross_rn(tvy, e1z, tvz, e1y);
  const float qvy = cross_rn(tvz, e1x, tvx, e1z);
  const float qvz = cross_rn(tvx, e1y, tvy, e1x);
  const float v = __fmul_rn(dot_rn(r.dx, r.dy, r.dz, qvx, qvy, qvz), inv_det);
  if (!(v >= 0.0f && __fadd_rn(u, v) <= 1.0f)) return false;
  t = __fmul_rn(dot_rn(e2x, e2y, e2z, qvx, qvy, qvz), inv_det);
  return t >= r.mint && t <= r.maxt;
}

// One step of the lane's walk at node c: true, with the cluster and its
// triangle count, when the ray enters a leaf's box.
__device__ __forceinline__ bool walk_step(const float* __restrict__ nb,
                                          const Ray& r, float tmax, int& c,
                                          int& steps, int& cid, int& count) {
  const float* node = nb + (size_t)c * NODE_F;
  const float4 a = ld4(node), b = ld4(node + 4);
  ++steps;
  const bool hit = slab(a, b, r, tmax);
  const int cnt = (int)b.w;
  c = (hit && cnt == 0) ? c + 1 : (int)b.z;
  if (!(hit && cnt > 0)) return false;
  cid = (int)__ldg(node + 8);
  count = cnt;
  return true;
}

// The while-while schedule, one node step per lane per iteration so that
// every ballot sits in warp-uniform control flow: a lane that holds no leaf
// and is not done takes a step; while any lane still walks, the warp walks
// on; then the lanes holding a leaf are the pending set of a drain round.
// (A per-lane inner walk loop lets the compiler fold it into the outer loop
// and issue the ballot without reconverging the warp.)
__device__ __forceinline__ unsigned next_round(const float* __restrict__ nb,
                                               int n_nodes, const Ray& r,
                                               float tmax, int& c, int& steps,
                                               int& cid, int& count) {
  bool holding = false;
  for (;;) {
    const bool walking = !holding && c < n_nodes;
    if (__ballot_sync(FULL, walking) == 0u) return __ballot_sync(FULL, holding);
    if (walking) holding = walk_step(nb, r, tmax, c, steps, cid, count);
  }
}

// Whether this drain round runs cooperatively: at least min_idle of the
// warp's lanes hold no pending leaf.
__device__ __forceinline__ bool cooperative(unsigned pending, int min_idle) {
  return WARP - __popc(pending) >= min_idle;
}

// f32 -> u32 with the same order (no NaNs reach it; -0 counts as +0, as '<'
// does)
__device__ __forceinline__ unsigned order_key(float t) {
  const unsigned u = __float_as_uint(t == 0.0f ? 0.0f : t);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ void serial_nearest(const float* __restrict__ tri,
                                               int cid, int count, const Ray& r,
                                               float& tbest, int& cbest,
                                               int& kbest) {
  const float* rec = tri + (size_t)cid * K * TRI_F;
  for (int k = 0; k < count; ++k) {
    const float* p = rec + k * TRI_F;
    float t;
    if (mt_test(ld4(p), ld4(p + 4), ld4(p + 8), r, t) && t < tbest) {
      tbest = t;
      cbest = cid;
      kbest = k;
    }
  }
}

// The warp tests lane L's cluster against L's ray; L keeps the winner.
__device__ __forceinline__ void coop_nearest(const float* __restrict__ tri,
                                             int L, int lane, int cid,
                                             int count, const Ray& r,
                                             float& tbest, int& cbest,
                                             int& kbest) {
  const Seg q = shfl_seg(r, L);
  const int qc = __shfl_sync(FULL, cid, L);
  const int qn = __shfl_sync(FULL, count, L);
  const float* rec = tri + (size_t)qc * K * TRI_F;
  float bt = __int_as_float(0x7f800000);  // +inf
  unsigned bk = NONE;
#pragma unroll
  for (int j = 0; j < K / WARP; ++j) {
    const int k = lane + j * WARP;
    if (k < qn) {
      const float* p = rec + k * TRI_F;
      float t;
      if (mt_test(ld4(p), ld4(p + 4), ld4(p + 8), q, t) && t < bt) {
        bt = t;
        bk = k;
      }
    }
  }
  const unsigned key = order_key(bt);
  const unsigned kmin = __reduce_min_sync(FULL, key);
  const unsigned kwin = __reduce_min_sync(FULL, key == kmin ? bk : NONE);
  const float twin = __shfl_sync(FULL, bt, (int)(kwin & (WARP - 1)));
  if (lane == L && kwin != NONE && twin < tbest) {
    tbest = twin;
    cbest = qc;
    kbest = (int)kwin;
  }
}

// true when a triangle that can block is hit; tests counts those tested
__device__ __forceinline__ bool serial_any(const float* __restrict__ tri,
                                           int cid, int count, const Ray& r,
                                           int& tests) {
  const float* rec = tri + (size_t)cid * K * TRI_F;
  for (int k = 0; k < count; ++k) {
    const float* p = rec + k * TRI_F;
    const float4 cc = ld4(p + 8);
    if (cc.y == 0.0f) continue;  // cannot block
    ++tests;
    float t;
    if (mt_test(ld4(p), ld4(p + 4), cc, r, t)) return true;
  }
  return false;
}

// The warp tests lane L's cluster against L's ray for a blocker; L counts
// the triangles the serial loop would have tested and keeps the answer.
__device__ __forceinline__ void coop_any(const float* __restrict__ tri, int L,
                                         int lane, int cid, int count,
                                         const Ray& r, bool& blocked,
                                         int& tests) {
  const Seg q = shfl_seg(r, L);
  const int qc = __shfl_sync(FULL, cid, L);
  const int qn = __shfl_sync(FULL, count, L);
  const float* rec = tri + (size_t)qc * K * TRI_F;
  // bit j of can[s] / hit[s]: triangle 32 s + j can block / blocks
  unsigned can[K / WARP], hit[K / WARP];
#pragma unroll
  for (int s = 0; s < K / WARP; ++s) {
    const int k = lane + s * WARP;
    bool c = false, h = false;
    if (k < qn) {
      const float* p = rec + k * TRI_F;
      const float4 cc = ld4(p + 8);
      c = cc.y != 0.0f;
      float t;
      h = c && mt_test(ld4(p), ld4(p + 4), cc, q, t);
    }
    can[s] = __ballot_sync(FULL, c);
    hit[s] = __ballot_sync(FULL, h);
  }
  // the first blocker in k order, and the triangles that can block up to it
  bool found = false;
  int n_tested = 0;
#pragma unroll
  for (int s = 0; s < K / WARP; ++s) {
    if (found) continue;
    const unsigned upto = hit[s] ? (hit[s] ^ (hit[s] - 1u)) : FULL;
    n_tested += __popc(can[s] & upto);
    found = hit[s] != 0u;
  }
  if (lane == L) {
    tests += n_tested;
    blocked = found;
  }
}

template <bool FETCH>
__global__ void __launch_bounds__(THREADS)
    nearest_kernel(const float* __restrict__ rays,
                   const float* __restrict__ nodes, int n_nodes,
                   const float* __restrict__ tri,
                   const float* __restrict__ shade, float* __restrict__ out,
                   int n, int min_idle) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & (WARP - 1);
  const bool active = i < n;
  const Ray r = load_ray(rays, n, active ? i : n - 1);
  const float* nb = octant_nodes(nodes, n_nodes, r);

  float tbest = fminf(r.maxt, BIG);
  int cbest = -1, kbest = 0;
  int visits = 0, steps = 0, tests = 0;
  // the root's escape link is the table's end; idle lanes start there
  int c = (active && r.maxt >= 0.0f) ? 0 : n_nodes;
  for (;;) {
    int cid = 0, count = 0;
    const unsigned pending =
        next_round(nb, n_nodes, r, tbest, c, steps, cid, count);
    if (pending == 0u) break;
    const bool mine = (pending >> lane) & 1u;
    if (mine) {
      ++visits;
      tests += count;
    }
    if (cooperative(pending, min_idle)) {
      for (unsigned m = pending; m != 0u; m &= m - 1u) {
        coop_nearest(tri, __ffs(m) - 1, lane, cid, count, r, tbest, cbest,
                     kbest);
      }
    } else if (mine) {
      serial_nearest(tri, cid, count, r, tbest, cbest, kbest);
    }
  }
  if (!active) return;

  if constexpr (!FETCH) {
    // rows 0, 3, 33, 34-36 of the default instance, as (6, n)
    const float* col =
        shade + ((size_t)max(cbest, 0) * SH_ROWS + S_FACE) * K + kbest;
    const float face = cbest >= 0 ? __ldg(col) : -1.0f;
    const bool valid = face >= 0.0f;
    float* o = out + i;
    const size_t st = (size_t)n;
    o[0 * st] = valid ? tbest : BIG;
    o[1 * st] = face;
    o[2 * st] = valid ? (float)cbest : 0.0f;
    o[3 * st] = (float)visits;
    o[4 * st] = (float)steps;
    o[5 * st] = (float)tests;
    return;
  }

  // winner attributes (or the miss sentinel: face = light = -1 and a benign
  // unit triangle in rows 3, 7, 11, 14, 17)
  float s[SH_ROWS];
  if (cbest >= 0) {
    const float* col = shade + (size_t)cbest * SH_ROWS * K + kbest;
#pragma unroll
    for (int q = 0; q < SH_ROWS; ++q) s[q] = __ldg(col + (size_t)q * K);
  } else {
#pragma unroll
    for (int q = 0; q < SH_ROWS; ++q) s[q] = 0.0f;
    s[S_FACE] = -1.0f;
    s[S_LIGHT] = -1.0f;
    s[3] = s[7] = s[11] = s[14] = s[17] = 1.0f;
  }
  // exact (t, u, v) recompute against the winner (_write_nearest_out), in
  // round-to-nearest steps the compiler may not fuse into FMAs: the
  // operations and their order are those of the plain version, so the
  // recompute gives its bits
  const float e1x = s[3] - s[0], e1y = s[4] - s[1], e1z = s[5] - s[2];
  const float e2x = s[6] - s[0], e2y = s[7] - s[1], e2z = s[8] - s[2];
  const float pvx = cross_rn(r.dy, e2z, r.dz, e2y);
  const float pvy = cross_rn(r.dz, e2x, r.dx, e2z);
  const float pvz = cross_rn(r.dx, e2y, r.dy, e2x);
  const float det = dot_rn(e1x, e1y, e1z, pvx, pvy, pvz);
  const float inv_det = __fdiv_rn(1.0f, fabsf(det) > DET_EPS ? det : 1.0f);
  const float tvx = r.ox - s[0], tvy = r.oy - s[1], tvz = r.oz - s[2];
  const float uu = __fmul_rn(dot_rn(tvx, tvy, tvz, pvx, pvy, pvz), inv_det);
  const float qvx = cross_rn(tvy, e1z, tvz, e1y);
  const float qvy = cross_rn(tvz, e1x, tvx, e1z);
  const float qvz = cross_rn(tvx, e1y, tvy, e1x);
  const float vv = __fmul_rn(dot_rn(r.dx, r.dy, r.dz, qvx, qvy, qvz), inv_det);
  const float tt = __fmul_rn(dot_rn(e2x, e2y, e2z, qvx, qvy, qvz), inv_det);
  const bool valid = s[S_FACE] >= 0.0f;

  float* o = out + i;
  const size_t st = (size_t)n;
  o[0 * st] = valid ? tt : BIG;
  o[1 * st] = valid ? uu : 0.0f;
  o[2 * st] = valid ? vv : 0.0f;
  o[3 * st] = s[S_FACE];
#pragma unroll
  for (int q = 0; q < 24; ++q) o[(4 + q) * st] = s[q];
#pragma unroll
  for (int q = 0; q < 5; ++q) o[(28 + q) * st] = s[S_LIGHT + q];
  o[33 * st] = valid ? (float)cbest : 0.0f;
  o[34 * st] = (float)visits;
  o[35 * st] = (float)steps;
  o[36 * st] = (float)tests;
#pragma unroll
  for (int q = 37; q < OUT_ROWS; ++q) o[q * st] = 0.0f;
}

__global__ void __launch_bounds__(THREADS)
    any_hit_kernel(const float* __restrict__ rays,
                   const float* __restrict__ nodes, int n_nodes,
                   const float* __restrict__ tri, float* __restrict__ out,
                   int n, int min_idle) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & (WARP - 1);
  const bool active = i < n;
  const Ray r = load_ray(rays, n, active ? i : n - 1);
  const float* nb = octant_nodes(nodes, n_nodes, r);

  bool blocked = false;
  int visits = 0, steps = 0, tests = 0;
  int c = (active && r.maxt >= 0.0f) ? 0 : n_nodes;
  for (;;) {
    int cid = 0, count = 0;
    const unsigned pending =
        next_round(nb, n_nodes, r, r.maxt, c, steps, cid, count);
    if (pending == 0u) break;
    const bool mine = (pending >> lane) & 1u;
    if (mine) ++visits;
    if (cooperative(pending, min_idle)) {
      for (unsigned m = pending; m != 0u; m &= m - 1u) {
        coop_any(tri, __ffs(m) - 1, lane, cid, count, r, blocked, tests);
      }
    } else if (mine) {
      blocked = serial_any(tri, cid, count, r, tests);
    }
    if (blocked) c = n_nodes;  // done: the first blocker ends the walk
  }
  if (!active) return;
  float* o = out + i;
  const size_t st = (size_t)n;
  o[0] = blocked ? 1.0f : 0.0f;
  o[1 * st] = (float)visits;
  o[2 * st] = (float)steps;
  o[3 * st] = (float)tests;
#pragma unroll
  for (int q = 4; q < ANY_ROWS; ++q) o[q * st] = 0.0f;
}

inline int blocks_for(int n) { return (n + THREADS - 1) / THREADS; }

}  // namespace

extern "C" {

// rays (8, n) [o3 d3 mint maxt]; nodes (8, n_nodes, 16), one table per
// direction octant; tri (C, 128, 12); shade (C, 32, 128); out (40, n).
// min_idle: a drain round runs cooperatively when at least this many of a
// warp's lanes hold no pending leaf (33: never, 0: always).
// Returns cudaGetLastError() after the launch (0 = launched).
int kz_trace_nearest(const float* rays, const float* nodes, int n_nodes,
                     const float* tri, const float* shade, float* out, int n,
                     int min_idle, cudaStream_t stream) {
  if (n <= 0) return 0;
  nearest_kernel<true><<<blocks_for(n), THREADS, 0, stream>>>(
      rays, nodes, n_nodes, tri, shade, out, n, min_idle);
  return (int)cudaGetLastError();
}

// The lab instance without the winner's attribute fetch: out (6, n) holds
// the default's rows 0 (t), 3 (face), 33 (cluster), 34-36 (visits, node
// steps, triangle tests).
int kz_trace_nearest_nofetch(const float* rays, const float* nodes,
                             int n_nodes, const float* tri, const float* shade,
                             float* out, int n, int min_idle,
                             cudaStream_t stream) {
  if (n <= 0) return 0;
  nearest_kernel<false><<<blocks_for(n), THREADS, 0, stream>>>(
      rays, nodes, n_nodes, tri, shade, out, n, min_idle);
  return (int)cudaGetLastError();
}

// out (8, n): row 0 blocked, rows 1-3 visits / node steps / triangle tests.
int kz_trace_any_hit(const float* rays, const float* nodes, int n_nodes,
                     const float* tri, float* out, int n, int min_idle,
                     cudaStream_t stream) {
  if (n <= 0) return 0;
  any_hit_kernel<<<blocks_for(n), THREADS, 0, stream>>>(
      rays, nodes, n_nodes, tri, out, n, min_idle);
  return (int)cudaGetLastError();
}

const char* kz_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
