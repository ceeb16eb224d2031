// Cluster-BVH ray traversal on Hopper (sm_90a): nearest hit and any hit.
//
// Replaces the Pallas kernels of kazen_tpu/accel/cluster_trace.py:_make_kernel
// (any_hit=False behind `trace`, any_hit=True behind `occluded`). Same output
// contract; the inner design is the card's, not the TPU's:
//
// * One thread per ray, 128 threads a block, ragged edge masked (no padding
//   to 1024-ray packets). Each ray walks the node table of its own direction
//   octant, 4*(dx>0) + 2*(dy>0) + (dz>0), a near-child-first preorder with
//   escape links: nxt = (box hit && !leaf) ? c+1 : skip. No stack.
// * A visited cluster's <= 128 triangles are tested one by one in plain f32
//   with the Moller-Trumbore formula of accel/intersect.py, from a compact
//   (C, 128, 12) record table [p0 | e1 | e2 | blocks]. The TPU kernel's
//   split-bf16 MXU product, SMEM/VMEM node variants, windowed bitmask walk
//   and DMA double buffers have no counterpart here.
// * Nearest hit keeps (tbest, cluster, k), improving only on strict '<';
//   the winner's 32 attribute rows are read once at the end and its
//   (t, u, v) recomputed exactly as the reference's _write_nearest_out does.
//   Output is written column-per-thread into (40, N), coalesced.
// * Any hit stops at the first accepted triangle that can block (faces of
//   primary-invisible lights never do) and writes row 0 of (8, N).
//
// What bounds it: ray/hit I/O is 192 bytes a ray for the nearest hit, while
// a ray runs thousands of triangle tests of ~45 flops; the kernel is bound
// by f32 arithmetic and by the latency of divergent, dependent loads in the
// walk, not by device-memory bytes. The node and triangle tables are small
// (a few MB for a 37k-face scene) and stay in L2/L1; rays of a warp that are
// coherent (camera rays, or bounce rays after the wavefront's sort) read the
// same records, which the read-only path broadcasts. Rows 34-36 (any hit:
// 1-3) count visits, node steps and triangle tests per ray, the data for
// the kernel's operation bound.
#include <cuda_runtime.h>

namespace {

constexpr int K = 128;
constexpr int SH_ROWS = 32;
constexpr int OUT_ROWS = 40;
constexpr int ANY_ROWS = 8;
constexpr int TRI_F = 12;
constexpr int NODE_F = 16;
constexpr int THREADS = 128;
constexpr float BIG = 3.0e38f;
constexpr float DET_EPS = 1e-8f;
constexpr int S_FACE = 24;
constexpr int S_LIGHT = 25;

struct Ray {
  float ox, oy, oz, dx, dy, dz, mint, maxt;
  float ix, iy, iz;  // reciprocal direction for the slab test
};

__device__ __forceinline__ float safe_inv(float c) {
  // the reference's 1 / where(|d| < 1e-20, 1e-20, d)
  return 1.0f / (fabsf(c) < 1e-20f ? 1e-20f : c);
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

__device__ __forceinline__ const float* octant_nodes(
    const float* __restrict__ nodes, int n_nodes, const Ray& r) {
  const int oct =
      (r.dx > 0.0f ? 4 : 0) + (r.dy > 0.0f ? 2 : 0) + (r.dz > 0.0f ? 1 : 0);
  return nodes + (size_t)oct * n_nodes * NODE_F;
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

// Moller-Trumbore against record [p0 | e1 | e2 | ...] (accel/intersect.py);
// true with t set when the hit lies inside the triangle and [mint, maxt].
__device__ __forceinline__ bool mt_test(const float4& a, const float4& b,
                                        const float4& c, const Ray& r,
                                        float& t) {
  const float e1x = a.w, e1y = b.x, e1z = b.y;
  const float e2x = b.z, e2y = b.w, e2z = c.x;
  const float pvx = r.dy * e2z - r.dz * e2y;
  const float pvy = r.dz * e2x - r.dx * e2z;
  const float pvz = r.dx * e2y - r.dy * e2x;
  const float det = e1x * pvx + e1y * pvy + e1z * pvz;
  if (!(fabsf(det) > DET_EPS)) return false;
  const float inv_det = 1.0f / det;
  const float tvx = r.ox - a.x, tvy = r.oy - a.y, tvz = r.oz - a.z;
  const float u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det;
  if (!(u >= 0.0f && u <= 1.0f)) return false;
  const float qvx = tvy * e1z - tvz * e1y;
  const float qvy = tvz * e1x - tvx * e1z;
  const float qvz = tvx * e1y - tvy * e1x;
  const float v = (r.dx * qvx + r.dy * qvy + r.dz * qvz) * inv_det;
  if (!(v >= 0.0f && u + v <= 1.0f)) return false;
  t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det;
  return t >= r.mint && t <= r.maxt;
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

__device__ __forceinline__ float4 ld4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__global__ void __launch_bounds__(THREADS)
    nearest_kernel(const float* __restrict__ rays,
                   const float* __restrict__ nodes, int n_nodes,
                   const float* __restrict__ tri,
                   const float* __restrict__ shade, float* __restrict__ out,
                   int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Ray r = load_ray(rays, n, i);
  const float* nb = octant_nodes(nodes, n_nodes, r);

  float tbest = fminf(r.maxt, BIG);
  int cbest = -1, kbest = 0;
  int visits = 0, steps = 0, tests = 0;
  if (r.maxt >= 0.0f) {
    int c = 0;  // the root's escape link is the table's end
    while (c < n_nodes) {
      const float* node = nb + (size_t)c * NODE_F;
      const float4 a = ld4(node), b = ld4(node + 4);
      ++steps;
      const bool hit = slab(a, b, r, tbest);
      const int count = (int)b.w;
      if (hit && count > 0) {
        const int cid = (int)__ldg(node + 8);
        const float* rec = tri + (size_t)cid * K * TRI_F;
        ++visits;
        tests += count;
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
      c = (hit && count == 0) ? c + 1 : (int)b.z;
    }
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
                   int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Ray r = load_ray(rays, n, i);
  const float* nb = octant_nodes(nodes, n_nodes, r);

  bool blocked = false;
  int visits = 0, steps = 0, tests = 0;
  if (r.maxt >= 0.0f) {
    int c = 0;
    while (c < n_nodes && !blocked) {
      const float* node = nb + (size_t)c * NODE_F;
      const float4 a = ld4(node), b = ld4(node + 4);
      ++steps;
      const bool hit = slab(a, b, r, r.maxt);
      const int count = (int)b.w;
      if (hit && count > 0) {
        const float* rec = tri + (size_t)__ldg(node + 8) * K * TRI_F;
        ++visits;
        for (int k = 0; k < count; ++k) {
          const float* p = rec + k * TRI_F;
          const float4 cc = ld4(p + 8);
          if (cc.y == 0.0f) continue;  // cannot block
          ++tests;
          float t;
          if (mt_test(ld4(p), ld4(p + 4), cc, r, t)) {
            blocked = true;
            break;
          }
        }
      }
      c = (hit && count == 0) ? c + 1 : (int)b.z;
    }
  }
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
// Returns cudaGetLastError() after the launch (0 = launched).
int kz_trace_nearest(const float* rays, const float* nodes, int n_nodes,
                     const float* tri, const float* shade, float* out, int n,
                     cudaStream_t stream) {
  if (n <= 0) return 0;
  nearest_kernel<<<blocks_for(n), THREADS, 0, stream>>>(
      rays, nodes, n_nodes, tri, shade, out, n);
  return (int)cudaGetLastError();
}

// out (8, n): row 0 blocked, rows 1-3 visits / node steps / triangle tests.
int kz_trace_any_hit(const float* rays, const float* nodes, int n_nodes,
                     const float* tri, float* out, int n,
                     cudaStream_t stream) {
  if (n <= 0) return 0;
  any_hit_kernel<<<blocks_for(n), THREADS, 0, stream>>>(
      rays, nodes, n_nodes, tri, out, n);
  return (int)cudaGetLastError();
}

const char* kz_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
