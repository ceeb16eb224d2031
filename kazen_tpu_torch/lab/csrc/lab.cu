// The lab probes on Hopper (sm_90a): K4, K5 and K6, plain SIMT kernels.
//
// Each computes what its Pallas original computes, at its shapes. They are
// probes, not parts of render(): the originals measured what a piece of the
// cluster-trace kernel costs on the TPU, and these ports measure the same
// functions on the card. Tensor cores (wgmma), TMA and cp.async are not
// used; a redesign that asks a Hopper question (tensor-core Moller-Trumbore
// against the f32 loop) is later work.
//
// Precision. HIGHEST is f32 products summed in f32. DEFAULT is the TPU's one
// bf16 pass: both operands rounded to bf16 (round to nearest even), their
// products (exact in f32) summed in f32. bf16-in takes bf16 operands.
//
// K4 kz_mm_probe replaces benchmarks/mxu_lab.py:make_mm_kernel (line 52):
//   out (M, N) = sum over reps of W^T f, W (K, M), f (K, N), the f32 sum of
//   the reps taken one after another. Bound by operations: 2 M K N reps
//   over 67 TFLOP/s (f32) or 989 (bf16 tensor cores, DEFAULT and bf16-in);
//   its bytes (a few MB) are nothing beside them. Design: a 64 x 64 output
//   tile per block of 256 threads, 4 x 4 outputs a thread in registers, the
//   tile's W and f slices in shared memory (2 K 64 floats, <= 64 KB for
//   K <= 128), operands rounded once as they are staged. Each rep re-reads
//   the slices after a compiler barrier, so the product is computed anew in
//   every rep, as the original's loop does, and is not hoisted out of it.
//   The f32 FMAs of the CUDA cores stay far from the bf16 bound.
//
// K5 kz_chain_probe replaces the `vpu_kernel` closure of
//   benchmarks/mxu_lab.py:main (line 127): 32 reps of the sign-folded
//   Moller-Trumbore acceptance chain on the four 128-row slices of a
//   (512, n), acc = min(acc, tt + r) from 0, out (128, n). One thread per
//   output element; the slices are re-read after a compiler barrier each
//   rep. The reciprocal is rcp.approx.ftz.f32, as the original's
//   pl.reciprocal(approx=True). Bound: ~2.6 MB and ~80 MFLOP at n = 1024,
//   about 1 us, below the launch latency.
//
// K6 kz_drain_probe replaces benchmarks/visit_lab.py:make_drain (line 45):
//   per block of 1024 lanes, `visits` simulated leaf visits. A visit copies
//   geo[cid] (cid = (7 b + 13 i) mod 256) to the block's buffer, forms
//   det, tn, un, vn for K columns as products over F rows against the
//   lane's feat column (qp = 1: four depth-16 products of w, w+1, w+2, w+3;
//   qp = 4: one depth-64 product whose 4K columns are the four quantities),
//   runs the chain, and keeps the least tt; with the fetch, a lane whose
//   least tt beats its acc row 0 takes it and the window's row 0 at its
//   argmin. Bound by operations: blocks 1024 visits (2 MACs + ~17 K), MACs
//   4 16 K (qp = 1) or 64 4K (qp = 4) a lane and visit. Design: one block
//   of 1024 threads per block of lanes, one lane a thread. The visit's
//   operands live in shared memory as an (F, 4K) f32 tile (column block j
//   holds quantity j's operand, rounded as the precision says, so both
//   packings run one inner loop); <= 128 KB for qp = 4, K = 128, dynamic
//   shared memory. Each thread takes four columns at a time: per row f,
//   one load of its feat value (global, L1/L2), four broadcast float4
//   loads of the tile and 16 FMAs. The TPU's 256 KB two-slot buffer is not
//   kept: only the current visit's tile and row 0 of the fetch window
//   wbuf[0:32, 0:K], the one row of the fetched product the original
//   stores. Row 0 lies in slot 0, written by even visits, so the window is
//   refreshed on even visits. The sums over f run f = 0, 1, ... in order,
//   as the plain version's; the products are by feat = 1 and exact, so an
//   FMA rounds as a separate product and sum would, and q has the same bits
//   in both. Columns are scanned in order with a strict '<', so the argmin
//   is the first, as jnp.argmin's. The fetch branch runs when any lane of
//   the block improved (__syncthreads_or: the original's jnp.any over the
//   block), and then sets row 1 of every lane of the block: the fetched
//   value where the lane improved, else 0 (its one-hot column is 0).
//   Port semantics for the original's two undefined reads: without the
//   copy (with_dma = 0) the buffer is never written there, and here holds
//   geo[0]; feat is written only at grid step 0 there (the TPU runs the
//   grid in order on one core), and here is ones for every block.
//
// The chain (shared by K5 and K6) is written in round-to-nearest steps
// where a product is inexact, so nvcc cannot fuse it into an FMA; the
// products by s = +-1 are exact. With finite inputs fminf and jnp.minimum
// agree. Optional diagnostics per lane (null pointers turn them off): the
// count of accepted tests, the least accepted tt (3e38 when none) and, for
// K6, the fetches taken. Every entry point returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr float BIG = 3.0e38f;
constexpr float DET_EPS = 1e-8f;

constexpr int MM_TILE = 64;
constexpr int MM_THREADS = 256;
enum MmMode { MM_HIGHEST = 0, MM_DEFAULT = 1, MM_BF16 = 2 };

constexpr int CHAIN_ROWS = 128;
constexpr int CHAIN_THREADS = 256;

constexpr int DRAIN_LANES = 1024;
constexpr int GEO_SLOTS = 256;

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float rcp_approx(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The sign-folded Moller-Trumbore acceptance of one test: tt, or BIG.
__device__ __forceinline__ float chain(float det, float tn, float un, float vn, bool& ok) {
  const float s = det < 0.f ? -1.f : 1.f;
  const float sd = det * s, su = un * s, sv = vn * s, st = tn * s;
  const float q = fminf(fminf(su, sv),
                        fminf(__fsub_rn(__fsub_rn(sd, su), sv), fminf(st, __fsub_rn(sd, st))));
  ok = (sd > DET_EPS) && (q >= 0.f);
  return ok ? __fmul_rn(st, rcp_approx(sd)) : BIG;
}

// ---------------------------------------------------------------------------
// K4
// ---------------------------------------------------------------------------

template <int MODE>
__device__ __forceinline__ float mm_operand(const void* p, size_t i) {
  if (MODE == MM_BF16) return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
  const float x = static_cast<const float*>(p)[i];
  return MODE == MM_DEFAULT ? round_bf16(x) : x;
}

template <int MODE>
__global__ void __launch_bounds__(MM_THREADS)
mm_kernel(const void* w, const void* f, float* out, int M, int K, int N, int reps) {
  extern __shared__ float4 mm_smem[];
  float* ws = reinterpret_cast<float*>(mm_smem);  // (K, 64): W[k, m0 + c]
  float* fs = ws + K * MM_TILE;                  // (K, 64): f[k, n0 + c]
  const int m0 = blockIdx.y * MM_TILE, n0 = blockIdx.x * MM_TILE;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  for (int i = tid; i < K * MM_TILE; i += MM_THREADS) {
    const int k = i / MM_TILE, c = i % MM_TILE;
    ws[i] = mm_operand<MODE>(w, (size_t)k * M + m0 + c);
    fs[i] = mm_operand<MODE>(f, (size_t)k * N + n0 + c);
  }
  __syncthreads();
  const float4* ws4 = reinterpret_cast<const float4*>(ws);
  const float4* fs4 = reinterpret_cast<const float4*>(fs);
  // rows m0 + 4 ty + i, columns n0 + 4 tx + j
  float acc[4][4] = {};
  for (int r = 0; r < reps; ++r) {
    asm volatile("" ::: "memory");  // the slices are read anew each rep
    float p[4][4] = {};
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      const float4 a4 = ws4[k * (MM_TILE / 4) + ty];
      const float4 b4 = fs4[k * (MM_TILE / 4) + tx];
      const float a[4] = {a4.x, a4.y, a4.z, a4.w};
      const float b[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) p[i][j] = fmaf(a[i], b[j], p[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = __fadd_rn(acc[i][j], p[i][j]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float4* o = reinterpret_cast<float4*>(out + (size_t)(m0 + 4 * ty + i) * N + n0 + 4 * tx);
    *o = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }
}

template <int MODE>
int launch_mm(const void* w, const void* f, float* out, int M, int K, int N, int reps,
              cudaStream_t stream) {
  const int smem = 2 * K * MM_TILE * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(mm_kernel<MODE>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(N / MM_TILE, M / MM_TILE);
  mm_kernel<MODE><<<grid, MM_THREADS, smem, stream>>>(w, f, out, M, K, N, reps);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K5
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(CHAIN_THREADS)
chain_kernel(const float* a, float* out, int* count, float* tmin, int n, int reps) {
  const int i = blockIdx.x * CHAIN_THREADS + threadIdx.x;
  if (i >= CHAIN_ROWS * n) return;
  const size_t slice = (size_t)CHAIN_ROWS * n;
  float acc = 0.f, lo = BIG;
  int accepted = 0;
  for (int r = 0; r < reps; ++r) {
    asm volatile("" ::: "memory");  // the slices are read anew each rep
    bool ok;
    const float tt = chain(a[i], a[slice + i], a[2 * slice + i], a[3 * slice + i], ok);
    acc = fminf(acc, __fadd_rn(tt, (float)r));
    if (ok) {
      ++accepted;
      lo = fminf(lo, tt);
    }
  }
  out[i] = acc;
  if (count != nullptr) {
    count[i] = accepted;
    tmin[i] = lo;
  }
}

// ---------------------------------------------------------------------------
// K6
// ---------------------------------------------------------------------------

// The (F, 4K) operand tile of one visit from one geo slot (F, width): column
// block j holds quantity j's operand (qp = 4: slot columns jK..jK+K-1;
// qp = 1: w + j on slot columns 0..K-1, the sum in f32), rounded to bf16
// when `round_ops`.
template <typename T>
__device__ void load_tile(const T* slot, int F, int K, int width, int qp, int round_ops,
                          float* tile) {
  const int cols = 4 * K;
  for (int i = threadIdx.x; i < F * cols; i += DRAIN_LANES) {
    const int f = i / cols, col = i % cols, j = col / K;
    float v = to_f32(slot[(size_t)f * width + (qp == 4 ? col : col - j * K)]);
    if (qp == 1 && j > 0) v = __fadd_rn(v, (float)j);
    tile[i] = round_ops ? round_bf16(v) : v;
  }
}

template <typename T>
__device__ void load_window(const T* slot, int K, float* window) {
  for (int k = threadIdx.x; k < K; k += DRAIN_LANES) window[k] = to_f32(slot[k]);
}

template <typename T>
__global__ void __launch_bounds__(DRAIN_LANES)
drain_kernel(const T* geo, const T* feat, float* out, int* count, float* tmin, int* fetches,
             int visits, int qp, int K, int width, int round_ops, int with_fetch,
             int with_dma) {
  extern __shared__ float4 drain_smem[];
  const int F = 16 * qp, cols = 4 * K;
  float* tile = reinterpret_cast<float*>(drain_smem);  // (F, 4K)
  float* window = tile + F * cols;                     // (K,): wbuf[0, 0:K]
  const int b = blockIdx.x, lane = threadIdx.x;
  const size_t slot_elems = (size_t)F * width;
  if (!with_dma) {  // the port's semantics: the never-written buffer holds geo[0]
    load_tile(geo, F, K, width, qp, round_ops, tile);
    load_window(geo, K, window);
  }
  float acc0 = 0.f, acc1 = 0.f, lo = BIG;
  int accepted = 0, taken = 0;
  for (int i = 0; i < visits; ++i) {
    if (with_dma) {
      const T* slot = geo + (size_t)((b * 7 + i * 13) % GEO_SLOTS) * slot_elems;
      __syncthreads();  // every lane is done with the last visit's tile
      load_tile(slot, F, K, width, qp, round_ops, tile);
      if (i % 2 == 0) load_window(slot, K, window);
    }
    __syncthreads();
    float leaf_min = BIG;
    int kwin = 0;
    for (int c = 0; c < K; c += 4) {
      float dot[4][4] = {};  // [quantity][column c + u]
      for (int f = 0; f < F; ++f) {
        float fv = to_f32(feat[(size_t)f * DRAIN_LANES + lane]);
        if (round_ops) fv = round_bf16(fv);
        const float* row = tile + (size_t)f * cols + c;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float4 v = *reinterpret_cast<const float4*>(row + j * K);
          dot[j][0] = fmaf(v.x, fv, dot[j][0]);
          dot[j][1] = fmaf(v.y, fv, dot[j][1]);
          dot[j][2] = fmaf(v.z, fv, dot[j][2]);
          dot[j][3] = fmaf(v.w, fv, dot[j][3]);
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        bool ok;
        const float tt = chain(dot[0][u], dot[1][u], dot[2][u], dot[3][u], ok);
        if (ok) {
          ++accepted;
          lo = fminf(lo, tt);
        }
        if (tt < leaf_min) {
          leaf_min = tt;
          kwin = c + u;
        }
      }
    }
    if (with_fetch) {
      const bool improved = leaf_min < acc0;
      if (__syncthreads_or(improved)) {
        acc1 = improved ? window[kwin] : 0.f;
        acc0 = improved ? leaf_min : acc0;
        ++taken;
      }
    } else {
      acc0 = fminf(acc0, leaf_min);
    }
  }
  const size_t n = (size_t)gridDim.x * DRAIN_LANES, col = (size_t)b * DRAIN_LANES + lane;
  out[col] = acc0;
  out[n + col] = acc1;
  for (int r = 2; r < 8; ++r) out[r * n + col] = 0.f;
  if (count != nullptr) {
    count[col] = accepted;
    tmin[col] = lo;
    fetches[col] = taken;
  }
}

template <typename T>
int launch_drain(const void* geo, const void* feat, float* out, int* count, float* tmin,
                 int* fetches, int blocks, int visits, int qp, int K, int width,
                 int round_ops, int with_fetch, int with_dma, cudaStream_t stream) {
  const int smem = (16 * qp * 4 * K + K) * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(drain_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  drain_kernel<T><<<blocks, DRAIN_LANES, smem, stream>>>(
      static_cast<const T*>(geo), static_cast<const T*>(feat), out, count, tmin, fetches,
      visits, qp, K, width, round_ops, with_fetch, with_dma);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// w (K, M), f (K, N), both f32 (mode 0 HIGHEST, 1 DEFAULT) or bf16 (mode 2);
// out (M, N) f32. M and N multiples of 64, 1 <= K <= 128.
int kz_mm_probe(const void* w, const void* f, float* out, int M, int K, int N, int reps,
                int mode, cudaStream_t stream) {
  switch (mode) {
    case MM_HIGHEST: return launch_mm<MM_HIGHEST>(w, f, out, M, K, N, reps, stream);
    case MM_DEFAULT: return launch_mm<MM_DEFAULT>(w, f, out, M, K, N, reps, stream);
    case MM_BF16: return launch_mm<MM_BF16>(w, f, out, M, K, N, reps, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// a (512, n) f32 -> out (128, n); count (int) and tmin (f32), (128, n), or null.
int kz_chain_probe(const float* a, float* out, int* count, float* tmin, int n, int reps,
                   cudaStream_t stream) {
  const int total = CHAIN_ROWS * n;
  chain_kernel<<<(total + CHAIN_THREADS - 1) / CHAIN_THREADS, CHAIN_THREADS, 0, stream>>>(
      a, out, count, tmin, n, reps);
  return (int)cudaGetLastError();
}

// geo (256, 16 qp, width) and feat (16 qp, 1024), f32 or bf16 (bf16 = 1);
// out (8, blocks 1024) f32; count, tmin, fetches (blocks 1024) or null.
int kz_drain_probe(const void* geo, const void* feat, float* out, int* count, float* tmin,
                   int* fetches, int blocks, int visits, int qp, int K, int width, int bf16,
                   int round_ops, int with_fetch, int with_dma, cudaStream_t stream) {
  if (bf16)
    return launch_drain<__nv_bfloat16>(geo, feat, out, count, tmin, fetches, blocks, visits, qp,
                                       K, width, round_ops, with_fetch, with_dma, stream);
  return launch_drain<float>(geo, feat, out, count, tmin, fetches, blocks, visits, qp, K,
                             width, round_ops, with_fetch, with_dma, stream);
}

const char* kz_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
