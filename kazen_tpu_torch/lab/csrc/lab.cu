// The lab probes on Hopper (sm_90a): K4, K5 and K6.
//
// Each computes what its Pallas original computes, at its shapes. They are
// probes, not parts of render(): the originals measured what a piece of the
// cluster-trace kernel costs on the TPU, and these ports measure the same
// functions on the card. K6 at DEFAULT and bf16 runs on the tensor cores
// (wgmma, bf16 operands from shared memory, f32 sums); K6 at HIGHEST, K4 at
// every precision and K5 run on the CUDA cores (the tensor cores have no
// f32 product: TF32 or a 3 x bf16 split would change the bits). TMA and
// cp.async are not used.
//
// Precision. HIGHEST is f32 products summed in f32. DEFAULT is the TPU's one
// bf16 pass: both operands rounded to bf16 (round to nearest even), their
// products (exact in f32) summed in f32. bf16-in takes bf16 operands.
//
// The tensor-core layout (K6). Both wgmma operands are read from shared
// memory, K-major (the contraction dimension contiguous), without swizzle:
// a core matrix is 8 rows x 16 bytes (8 bf16 values), 128 contiguous
// bytes, and core matrix (r / 8, k / 8) of a (rows, KD) operand lies at
// ((r / 8) (KD / 8) + k / 8) 128 bytes (core_off). The descriptor's leading
// byte offset is then 128 (the next core matrix along k) and its stride
// byte offset KD / 8 x 128 (the next 8 rows); a k-step of 16 moves the
// start by 256 bytes. Operands are converted and transposed into that
// layout as they are staged with ordinary stores, then made visible to the
// async proxy (fence.proxy.async, a barrier) before the first wgmma. Thread
// t of warp w of a warpgroup holds rows 16 w + t / 4 and 16 w + t / 4 + 8
// of a 64-row accumulator, columns 8 i + 2 (t % 4) + {0, 1}.
//
// K4 kz_mm_probe replaces benchmarks/mxu_lab.py:make_mm_kernel (line 52):
//   out (M, N) = sum over reps of W^T f, W (K, M), f (K, N), the f32 sum of
//   the reps taken one after another. Bound by operations: 2 M K N reps
//   over 67 TFLOP/s (f32) or 989 (bf16 tensor cores, DEFAULT and bf16-in);
//   its bytes (a few MB) are nothing beside them. Design: an R x C register
//   tile of outputs a thread, the block's W and f slices in shared memory
//   (K x (rows + columns) floats), operands rounded once as they are
//   staged. The tile is the largest whose grid gives at least every other
//   SM a block: 64 x 128 (8 x 8 a thread, 128 threads) at M = N = 1024,
//   64 x 64 (4 x 4, 256 threads) at M = 512, 32 x 32 (2 x 2) at M = 128,
//   which then runs 128 blocks and not 32. Each rep re-reads the slices
//   after a compiler barrier, so the product is computed anew in every rep,
//   as the original's loop does, and is not hoisted out of it. The sums
//   over k run in order with fmaf, so every tile equals the plain version
//   bit for bit.
//   DEFAULT and bf16-in stay on the CUDA cores on purpose: the plain
//   version sums P over k one product at a time, and any other order (a
//   wgmma's) changes P in its last bits; the 512 reps' round-to-nearest sums
//   turn such a change into more than the probe's limit of 1e-5 of the
//   output's maximum (tests/test_torch_lab.py,
//   test_mm_probe_limit_needs_the_plain_order). The f32 FMAs stay far from
//   the bf16 bound.
//
// K5 kz_chain_probe replaces the `vpu_kernel` closure of
//   benchmarks/mxu_lab.py:main (line 127): 32 reps of the sign-folded
//   Moller-Trumbore acceptance chain on the four 128-row slices of a
//   (512, n), acc = min(acc, tt + r) from 0, out (128, n). Bound by
//   operations: 19 f32 operations an element and rep, 4.19 M element-reps at
//   n = 1024, 1.19 us at 67 TFLOP/s (2.6 MB of bytes, 0.78 us). On the CUDA
//   cores none of them fuses into an FMA, and the issue rate (one
//   instruction a lane and clock) sets the pace: the test and its update of
//   acc take ~21 instructions an element-rep, 2.6 us at the H100's 1.98 GHz
//   boost clock with no stall, on top of a launch's own floor (an empty kernel's device
//   time, which chip_smoke.py's phase 17 measures). Design: four lanes a
//   thread (16-byte loads), blocks of one warp, 8 an SM, each block a
//   contiguous equal share of the lanes so that every SM gets the same work.
//   A block stages its slices into shared memory once (the original's VMEM);
//   each rep re-reads all four from there with volatile 16-byte loads, so
//   the compiler can neither reuse one rep's values in the next nor drop a
//   read (with plain global re-reads behind a compiler barrier, as an
//   earlier one-lane version of this kernel had them, ptxas merges the
//   loads and the tests of 3 of every 4 reps: it did about half the work).
//   The reads of 4 reps go first, then their 16 chains, which are
//   independent. Each test is chain(), K6's: the probe prices the
//   instructions the leaf test runs. A rejected test leaves acc as it is
//   and is skipped by predication.
// K6 kz_drain_probe replaces benchmarks/visit_lab.py:make_drain (line 45):
//   per block of 1024 lanes, `visits` simulated leaf visits. A visit copies
//   geo[cid] (cid = (7 b + 13 i) mod 256) to the block's buffer, forms
//   det, tn, un, vn for K columns as products over F rows against the
//   lane's feat column (qp = 1: four depth-16 products of w, w+1, w+2, w+3;
//   qp = 4: one depth-64 product whose 4K columns are the four quantities),
//   runs the chain, and keeps the least tt; with the fetch, a lane whose
//   least tt beats its acc row 0 takes it and the window's row 0 at its
//   argmin. Bound by operations: blocks 1024 visits (2 MACs + ~17 K), MACs
//   4 16 K (qp = 1) or 64 4K (qp = 4) a lane and visit, on the tensor cores
//   for DEFAULT and bf16, on the CUDA cores for HIGHEST.
//   DEFAULT and bf16 (drain_tc_kernel<T, QP>): one block of two
//   warpgroups per block of 1024 lanes, lanes on the M side. feat^T (1024,
//   F) is staged once (bf16, 32 KB for F = 16, 128 KB for 64). A visit's
//   tests go in chunks of 64 columns: the chunk's (F, 4 x 64) operand tile
//   (column block j quantity j's operand, w + j and the rounding applied as
//   it is staged, zero past K) is B, and four m64n64k16 products a k-step
//   with the same columns leave det, tn, un and vn of one (lane, test) at
//   the same register index of the same thread. The chain runs on those
//   registers; the least tt, its argmin (the first column on ties, as
//   jnp.argmin) and the accepted count are folded over the thread's
//   columns, then over the quad that shares a row with shuffles, then into
//   the lane's state in shared memory; the least tt of a visit is also its
//   least accepted tt (tt is BIG where rejected). The fold is bound by the
//   CUDA cores' instruction rate: a chunk wholly below K folds without a
//   column test (one branch and its reconvergence per pair of tests). Each
//   warpgroup walks 8 row tiles of 64 lanes a chunk, products then fold.
//   Two chunk buffers: while a row tile's products run, its threads stage
//   an eighth of the next chunk (the next visit's first chunk across a
//   visit's end; slots are known ahead) into the other buffer, so staging
//   overlaps the products and no buffer needs the whole (F, 4K) tile (<=
//   217 KB of shared memory at qp = 4, K = 224). The window row is
//   double-buffered by visit pair.
//   HIGHEST (drain_simt_kernel): one block of 1024 threads per block of
//   lanes, one lane a thread; the visit's (F, 4K) f32 operand tile in
//   shared memory (<= 128 KB for qp = 4, K = 128); per row f one load of
//   the lane's feat value (global, L1/L2), four broadcast float4 loads of
//   the tile and 16 FMAs for four columns. The sums over f run in order, as
//   the plain version's; the products are by feat = 1 and exact, so q has
//   the plain version's bits.
//   Both keep only the current tile and row 0 of the fetch window
//   wbuf[0:32, 0:K], the one row of the fetched product the original
//   stores; row 0 lies in slot 0, written by even visits. The fetch branch
//   runs when any lane of the block improved (__syncthreads_or: the
//   original's jnp.any over the block), and then sets row 1 of every lane
//   of the block: the fetched value where the lane improved, else 0 (its
//   one-hot column is 0). Port semantics for the original's two undefined
//   reads: without the copy (with_dma = 0) the buffer is never written
//   there, and here holds geo[0]; feat is written only at grid step 0
//   there (the TPU runs the grid in order on one core), and here is ones
//   for every block.
//
// The chain (K5 and K6) is written in round-to-nearest
// steps where a product is inexact, so nvcc cannot fuse it into an FMA; the
// products by s = +-1 are exact. With finite inputs fminf and jnp.minimum
// agree. Optional diagnostics per lane (null pointers turn them off): the
// count of accepted tests, the least accepted tt (3e38 when none) and, for
// K6, the fetches taken. Every entry point returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr float BIG = 3.0e38f;
constexpr float DET_EPS = 1e-8f;

constexpr int WG_THREADS = 128;  // one warpgroup
constexpr int WG_ROWS = 64;      // rows of its wgmma accumulator

enum MmMode { MM_HIGHEST = 0, MM_DEFAULT = 1, MM_BF16 = 2 };

constexpr int CHAIN_ROWS = 128;

constexpr int DRAIN_LANES = 1024;
constexpr int GEO_SLOTS = 256;
constexpr int TC_THREADS = 2 * WG_THREADS;
constexpr int TC_CHUNK = 64;                                     // tests a chunk
constexpr int TC_ROW_TILES = DRAIN_LANES / WG_ROWS / (TC_THREADS / WG_THREADS);  // a warpgroup's

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
// wgmma building blocks
// ---------------------------------------------------------------------------

// Element offset of (r, k) in a K-major (rows, kd) bf16 operand of 8 x 8
// core matrices (kd a multiple of 8).
__device__ __forceinline__ int core_off(int r, int k, int kd) {
  return (((r >> 3) * (kd >> 3) + (k >> 3)) << 6) + ((r & 7) << 3) + (k & 7);
}

// Eight values rounded to bf16 and stored as one 16-byte row of a core matrix.
__device__ __forceinline__ void store_row8(__nv_bfloat16* dst, const float (&v)[8]) {
  uint4 packed;
  uint32_t* w = reinterpret_cast<uint32_t*>(&packed);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * e], v[2 * e + 1]);
    w[e] = *reinterpret_cast<const uint32_t*>(&h);
  }
  *reinterpret_cast<uint4*>(dst) = packed;
}

// The descriptor of a K-major operand without swizzle starting at `p`:
// leading byte offset 128 (next core matrix along k), stride byte offset
// `sbo` (next 8 rows), both in 16-byte units.
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t sbo) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(128 >> 4) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32);
}
constexpr uint64_t DESC_KSTEP = 256 >> 4;  // a k-step of 16 bf16 values

__device__ __forceinline__ void fence_async_proxy() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
// Pins accumulator registers between the asynchronous wgmma statements.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define KZ_D8(d, i)                                                                     \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])

// D (64 x 64, f32) = A (64 x 16) B (16 x 64) + (scale_d ? D : 0), bf16 A and
// B K-major in shared memory.
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t a, uint64_t b,
                                                int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : KZ_D8(d, 0), KZ_D8(d, 8), KZ_D8(d, 16), KZ_D8(d, 24)
      : "l"(a), "l"(b), "r"(scale_d));
}

#undef KZ_D8

// ---------------------------------------------------------------------------
// K4
// ---------------------------------------------------------------------------

// V consecutive floats (V = 2 or 4) as one vector access.
template <int V>
__device__ __forceinline__ void load_vec(const float* p, float* v) {
  if constexpr (V == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
  } else {
    const float2 x = *reinterpret_cast<const float2*>(p);
    v[0] = x.x, v[1] = x.y;
  }
}

template <int V>
__device__ __forceinline__ void store_vec(float* p, const float* v) {
  if constexpr (V == 4)
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  else
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
}

template <int MODE>
__device__ __forceinline__ float mm_operand(const void* p, size_t i) {
  if (MODE == MM_BF16) return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
  const float x = static_cast<const float*>(p)[i];
  return MODE == MM_DEFAULT ? round_bf16(x) : x;
}

// A (TY R) x (16 C) output tile per block of 16 x TY threads, R x C
// outputs a thread: rows R ty + i, columns in groups of V = min(C, 4) at
// 16 V g + V tx + j (so a warp's vector loads of f's slice are contiguous).
template <int MODE, int R, int C, int TY>
__global__ void __launch_bounds__(16 * TY)
mm_kernel(const void* w, const void* f, float* out, int M, int K, int N, int reps) {
  constexpr int TM = TY * R, TN = 16 * C, THREADS = 16 * TY;
  constexpr int VR = R < 4 ? R : 4, VC = C < 4 ? C : 4;
  extern __shared__ float4 mm_smem[];
  float* ws = reinterpret_cast<float*>(mm_smem);  // (K, TM): W[k, m0 + c]
  float* fs = ws + K * TM;                        // (K, TN): f[k, n0 + c]
  const int m0 = blockIdx.y * TM, n0 = blockIdx.x * TN;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  for (int i = tid; i < K * TM; i += THREADS)
    ws[i] = mm_operand<MODE>(w, (size_t)(i / TM) * M + m0 + i % TM);
  for (int i = tid; i < K * TN; i += THREADS)
    fs[i] = mm_operand<MODE>(f, (size_t)(i / TN) * N + n0 + i % TN);
  __syncthreads();
  float acc[R][C] = {};
  for (int r = 0; r < reps; ++r) {
    asm volatile("" ::: "memory");  // the slices are read anew each rep
    float p[R][C] = {};
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      float a[R], b[C];
#pragma unroll
      for (int q = 0; q < R / VR; ++q) load_vec<VR>(ws + k * TM + R * ty + VR * q, a + VR * q);
#pragma unroll
      for (int g = 0; g < C / VC; ++g)
        load_vec<VC>(fs + k * TN + 16 * VC * g + VC * tx, b + VC * g);
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < C; ++j) p[i][j] = fmaf(a[i], b[j], p[i][j]);
    }
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < C; ++j) acc[i][j] = __fadd_rn(acc[i][j], p[i][j]);
  }
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int g = 0; g < C / VC; ++g)
      store_vec<VC>(out + (size_t)(m0 + R * ty + i) * N + n0 + 16 * VC * g + VC * tx,
                    acc[i] + VC * g);
}

template <int MODE, int R, int C, int TY>
int launch_mm_tile(const void* w, const void* f, float* out, int M, int K, int N, int reps,
                   cudaStream_t stream) {
  const int smem = K * (TY * R + 16 * C) * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(mm_kernel<MODE, R, C, TY>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  mm_kernel<MODE, R, C, TY><<<dim3(N / (16 * C), M / (TY * R)), 16 * TY, smem, stream>>>(
      w, f, out, M, K, N, reps);
  return (int)cudaGetLastError();
}

// The largest tile whose grid gives at least every other SM a block: 64 x
// 128 (8 x 8 outputs a thread), 64 x 64 (4 x 4) or 32 x 32 (2 x 2).
template <int MODE>
int launch_mm(const void* w, const void* f, float* out, int M, int K, int N, int reps,
              cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (N % 128 == 0 && 2 * (M / 64) * (N / 128) >= sms)
    return launch_mm_tile<MODE, 8, 8, 8>(w, f, out, M, K, N, reps, stream);
  if (2 * (M / 64) * (N / 64) >= sms)
    return launch_mm_tile<MODE, 4, 4, 16>(w, f, out, M, K, N, reps, stream);
  return launch_mm_tile<MODE, 2, 2, 16>(w, f, out, M, K, N, reps, stream);
}

// ---------------------------------------------------------------------------
// K5
// ---------------------------------------------------------------------------

// Four floats of the shared slab at p, read with one volatile 16-byte load:
// the compiler may neither reuse an earlier rep's values nor drop the load.
__device__ __forceinline__ void ld_shared_volatile4(const float* p, float (&v)[4]) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ld.volatile.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v[0]), "=f"(v[1]), "=f"(v[2]), "=f"(v[3]) : "r"(s));
}

constexpr int CHAIN_LANES = 4;     // lanes a thread (16-byte loads)
constexpr int CHAIN_THREADS = 32;  // one warp a block
constexpr int CHAIN_BLOCKS_PER_SM = 8;
constexpr int CHAIN_BATCH = 4;     // reps whose slices are read together

// One rep of a thread's lanes, on the slices it read (v[k][l]: slice k,
// lane l). A rejected test leaves acc as it is (tt = BIG there, BIG + r is
// BIG, and acc <= 0), so acc is updated only where the test passes.
template <bool DIAG>
__device__ __forceinline__ void chain_rep(const float (&v)[4][CHAIN_LANES], float rf,
                                          float (&acc)[CHAIN_LANES], float (&lo)[CHAIN_LANES],
                                          int (&accepted)[CHAIN_LANES]) {
#pragma unroll
  for (int l = 0; l < CHAIN_LANES; ++l) {
    bool ok;
    const float tt = chain(v[0][l], v[1][l], v[2][l], v[3][l], ok);
    if (ok) {
      acc[l] = fminf(acc[l], __fadd_rn(tt, rf));
      if (DIAG) {
        ++accepted[l];
        lo[l] = fminf(lo[l], tt);
      }
    }
  }
}

// CHAIN_LANES consecutive lanes a thread (a group); block b takes groups
// [b G / grid, (b + 1) G / grid), so every SM gets the same share. Each rep
// reads all four slices anew from shared memory (volatile: every read is
// made); the reads of CHAIN_BATCH reps go first, then their chains.
template <bool DIAG>
__global__ void __launch_bounds__(CHAIN_THREADS)
chain_kernel(const float* __restrict__ a, float* __restrict__ out, int* __restrict__ count,
             float* __restrict__ tmin, int groups, int reps) {
  constexpr int L = CHAIN_LANES, U = CHAIN_BATCH;
  __shared__ __align__(16) float slab[4][CHAIN_THREADS * L];
  const size_t slice = (size_t)groups * L;  // floats in one of the four slices
  const int begin = (int)((long long)blockIdx.x * groups / gridDim.x);
  const int end = (int)((long long)(blockIdx.x + 1) * groups / gridDim.x);
  const float* mine[4] = {&slab[0][threadIdx.x * L], &slab[1][threadIdx.x * L],
                          &slab[2][threadIdx.x * L], &slab[3][threadIdx.x * L]};
  for (int g = begin + (int)threadIdx.x; g < end; g += CHAIN_THREADS) {
    const size_t i = (size_t)g * L;
#pragma unroll
    for (int k = 0; k < 4; ++k) {  // the block's one read of the input
      float x[L];
      load_vec<L>(a + k * slice + i, x);
      store_vec<L>(&slab[k][threadIdx.x * L], x);
    }
    float acc[L], lo[L];
    int accepted[L];
#pragma unroll
    for (int l = 0; l < L; ++l) acc[l] = 0.f, lo[l] = BIG, accepted[l] = 0;
    int r = 0;
    for (; r + U <= reps; r += U) {
      float v[U][4][L];
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int k = 0; k < 4; ++k) ld_shared_volatile4(mine[k], v[u][k]);
#pragma unroll
      for (int u = 0; u < U; ++u) chain_rep<DIAG>(v[u], (float)(r + u), acc, lo, accepted);
    }
    for (; r < reps; ++r) {
      float v[4][L];
#pragma unroll
      for (int k = 0; k < 4; ++k) ld_shared_volatile4(mine[k], v[k]);
      chain_rep<DIAG>(v, (float)r, acc, lo, accepted);
    }
    store_vec<L>(out + i, acc);
    if (DIAG) {
      *reinterpret_cast<int4*>(count + i) =
          make_int4(accepted[0], accepted[1], accepted[2], accepted[3]);
      store_vec<L>(tmin + i, lo);
    }
  }
}

__global__ void empty_kernel() {}

int chain_blocks(int groups) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int blocks = sms * CHAIN_BLOCKS_PER_SM;
  return groups < blocks ? groups : blocks;
}

// ---------------------------------------------------------------------------
// K6
// ---------------------------------------------------------------------------

// The output rows and diagnostics of lane `lane` of block b.
__device__ __forceinline__ void drain_store(float* out, int* count, float* tmin, int* fetches,
                                            int lane, float acc0, float acc1, int accepted,
                                            float lo, int taken) {
  const size_t n = (size_t)gridDim.x * DRAIN_LANES, col = (size_t)blockIdx.x * DRAIN_LANES + lane;
  out[col] = acc0;
  out[n + col] = acc1;
  for (int r = 2; r < 8; ++r) out[r * n + col] = 0.f;
  if (count != nullptr) {
    count[col] = accepted;
    tmin[col] = lo;
    fetches[col] = taken;
  }
}

// HIGHEST: the f32 SIMT loop. The (F, 4K) operand tile of one visit from
// one geo slot (F, width): column block j holds quantity j's operand (qp =
// 4: slot columns jK..jK+K-1; qp = 1: w + j on slot columns 0..K-1, the sum
// in f32).
__device__ void load_tile(const float* slot, int F, int K, int width, int qp, float* tile) {
  const int cols = 4 * K;
  for (int i = threadIdx.x; i < F * cols; i += DRAIN_LANES) {
    const int f = i / cols, col = i % cols, j = col / K;
    const float v = slot[(size_t)f * width + (qp == 4 ? col : col - j * K)];
    tile[i] = qp == 1 && j > 0 ? __fadd_rn(v, (float)j) : v;
  }
}

__device__ void load_window(const float* slot, int K, float* window) {
  for (int k = threadIdx.x; k < K; k += DRAIN_LANES) window[k] = slot[k];
}

__global__ void __launch_bounds__(DRAIN_LANES)
drain_simt_kernel(const float* geo, const float* feat, float* out, int* count, float* tmin,
                  int* fetches, int visits, int qp, int K, int width, int with_fetch,
                  int with_dma) {
  extern __shared__ float4 drain_simt_smem[];
  const int F = 16 * qp, cols = 4 * K;
  float* tile = reinterpret_cast<float*>(drain_simt_smem);  // (F, 4K)
  float* window = tile + F * cols;                          // (K,): wbuf[0, 0:K]
  const int b = blockIdx.x, lane = threadIdx.x;
  const size_t slot_elems = (size_t)F * width;
  if (!with_dma) {  // the port's semantics: the never-written buffer holds geo[0]
    load_tile(geo, F, K, width, qp, tile);
    load_window(geo, K, window);
  }
  float acc0 = 0.f, acc1 = 0.f, lo = BIG;
  int accepted = 0, taken = 0;
  for (int i = 0; i < visits; ++i) {
    if (with_dma) {
      const float* slot = geo + (size_t)((b * 7 + i * 13) % GEO_SLOTS) * slot_elems;
      __syncthreads();  // every lane is done with the last visit's tile
      load_tile(slot, F, K, width, qp, tile);
      if (i % 2 == 0) load_window(slot, K, window);
    }
    __syncthreads();
    float leaf_min = BIG;
    int kwin = 0;
    for (int c = 0; c < K; c += 4) {
      float dot[4][4] = {};  // [quantity][column c + u]
      for (int f = 0; f < F; ++f) {
        const float fv = feat[(size_t)f * DRAIN_LANES + lane];
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
  drain_store(out, count, tmin, fetches, lane, acc0, acc1, accepted, lo, taken);
}

// DEFAULT and bf16: the tensor-core visit.

// One staging task of chunk c of a visit's operand tile into buf (4
// quantity blocks of (64, F), K-major): eight rows f0..f0+7 of column n of
// quantity q (qp = 4) or of all four (qp = 1, w + j), rounded to bf16, zero
// for columns past K.
template <typename T, int QP>
__device__ __forceinline__ void stage_chunk_task(const T* slot, int width, int K, int c, int task,
                                                 __nv_bfloat16* buf) {
  constexpr int F = 16 * QP;
  const int n = task % TC_CHUNK, rest = task / TC_CHUNK;
  const int f0 = rest % (F / 8) * 8, q = rest / (F / 8);
  const int k = c * TC_CHUNK + n;
  float v[8];
#pragma unroll
  for (int e = 0; e < 8; ++e)
    v[e] = k < K ? to_f32(slot[(size_t)(f0 + e) * width + (QP == 4 ? q * K : 0) + k]) : 0.f;
  if (QP == 4) {
    store_row8(buf + q * TC_CHUNK * F + core_off(n, f0, F), v);
    return;
  }
  store_row8(buf + core_off(n, f0, F), v);
#pragma unroll
  for (int j = 1; j < 4; ++j) {
    float vj[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) vj[e] = __fadd_rn(v[e], (float)j);
    store_row8(buf + j * TC_CHUNK * F + core_off(n, f0, F), vj);
  }
}

// A test's chain folded into a row's least tt, its column and its accepted
// count. tt is BIG where rejected, so the least tt is also the least
// accepted tt, or BIG.
__device__ __forceinline__ void fold_test(float det, float tn, float un, float vn, int col,
                                          float& v, int& k, int& n) {
  bool ok;
  const float tt = chain(det, tn, un, vn, ok);
  n += ok;
  if (tt < v) {
    v = tt;
    k = col;
  }
}

// The fold of a row over the four threads of the quad that holds it; ties
// go to the lower column.
__device__ __forceinline__ void quad_fold(float& v, int& k, int& n) {
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, off);
    const int ok = __shfl_xor_sync(0xffffffffu, k, off);
    n += __shfl_xor_sync(0xffffffffu, n, off);
    if (ov < v || (ov == v && ok < k)) {
      v = ov;
      k = ok;
    }
  }
}

// The chain of a row tile's chunk folded over the thread's two rows (a:
// accumulator entries 4 g + e, b: 4 g + 2 + e) and its columns col0 + 8 g +
// e; without FULL, columns from K on are skipped.
template <bool FULL>
__device__ __forceinline__ void fold_chunk(const float (&d)[4][32], int col0, int K, float& va,
                                           int& ka, int& na, float& vb, int& kb, int& nb) {
#pragma unroll
  for (int g = 0; g < TC_CHUNK / 8; ++g)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = col0 + 8 * g + e, ra = 4 * g + e, rb = 4 * g + 2 + e;
      if (FULL || col < K) {
        fold_test(d[0][ra], d[1][ra], d[2][ra], d[3][ra], col, va, ka, na);
        fold_test(d[0][rb], d[1][rb], d[2][rb], d[3][rb], col, vb, kb, nb);
      }
    }
}

struct LaneState {  // per lane of the block, in shared memory
  float* leaf_min;  // this visit's least tt
  int* kwin;        // its column
  float* acc0;
  float* acc1;
  int* accepted;
  float* lo;        // the least accepted tt over the visits so far
};

template <typename T, int QP>
__global__ void __launch_bounds__(TC_THREADS, 1)
drain_tc_kernel(const T* geo, const T* feat, float* out, int* count, float* tmin, int* fetches,
                int visits, int K, int width, int with_fetch, int with_dma) {
  constexpr int F = 16 * QP, KSTEPS = F / 16;
  constexpr int CHUNK_ELEMS = 4 * TC_CHUNK * F;
  constexpr int TASKS = (QP == 4 ? 4 : 1) * TC_CHUNK * (F / 8);  // staging tasks a chunk
  constexpr uint32_t SBO = F / 8 * 128;
  static_assert(TASKS <= TC_ROW_TILES * TC_THREADS, "a chunk is staged over the row tiles");
  extern __shared__ __align__(128) unsigned char drain_tc_smem[];
  __nv_bfloat16* feat_t = reinterpret_cast<__nv_bfloat16*>(drain_tc_smem);  // (1024, F)
  __nv_bfloat16* chunks = feat_t + DRAIN_LANES * F;                          // 2 x (4, 64, F)
  float* state = reinterpret_cast<float*>(chunks + 2 * CHUNK_ELEMS);
  const LaneState st{state,
                     reinterpret_cast<int*>(state + DRAIN_LANES),
                     state + 2 * DRAIN_LANES,
                     state + 3 * DRAIN_LANES,
                     reinterpret_cast<int*>(state + 4 * DRAIN_LANES),
                     state + 5 * DRAIN_LANES};
  float* windows = state + 6 * DRAIN_LANES;  // 2 x K: wbuf[0, 0:K] by visit pair
  const int b = blockIdx.x, tid = threadIdx.x;
  const int per_visit = (K + TC_CHUNK - 1) / TC_CHUNK, jobs = visits * per_visit;
  const size_t slot_elems = (size_t)F * width;
  auto slot_of = [&](int i) {
    return with_dma ? geo + (size_t)((b * 7 + i * 13) % GEO_SLOTS) * slot_elems : geo;
  };
  // the window of visit i, staged with its first chunk where it changes:
  // every even visit with the copy, visit 0 without it
  auto window_of = [&](int i) { return windows + (with_dma ? (i / 2) % 2 : 0) * K; };
  auto stages_window = [&](int i) { return with_dma ? i % 2 == 0 : i == 0; };

  for (int i = tid; i < DRAIN_LANES * (F / 8); i += TC_THREADS) {
    const int lane = i % DRAIN_LANES, f0 = i / DRAIN_LANES * 8;
    float v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = to_f32(feat[(size_t)(f0 + e) * DRAIN_LANES + lane]);
    store_row8(feat_t + core_off(lane, f0, F), v);
  }
  for (int l = tid; l < DRAIN_LANES; l += TC_THREADS) {
    st.leaf_min[l] = BIG;
    st.kwin[l] = 0;
    st.acc0[l] = 0.f;
    st.acc1[l] = 0.f;
    st.accepted[l] = 0;
    st.lo[l] = BIG;
  }
  if (jobs > 0) {
    for (int task = tid; task < TASKS; task += TC_THREADS)
      stage_chunk_task<T, QP>(slot_of(0), width, K, 0, task, chunks);
    for (int k = tid; k < K; k += TC_THREADS) window_of(0)[k] = to_f32(slot_of(0)[k]);
  }
  fence_async_proxy();
  __syncthreads();

  const int wg = tid / WG_THREADS, warp = tid % WG_THREADS / 32, t = tid % 32;
  int taken = 0;
  float d[4][32];
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int r = 0; r < 32; ++r) d[q][r] = 0.f;
  for (int job = 0; job < jobs; ++job) {
    const int i = job / per_visit, c = job % per_visit;
    const __nv_bfloat16* cur = chunks + (job % 2) * CHUNK_ELEMS;
    const bool more = job + 1 < jobs;
    const int ni = (job + 1) / per_visit, nc = (job + 1) % per_visit;
    const T* nslot = slot_of(ni);
    __nv_bfloat16* nbuf = chunks + ((job + 1) % 2) * CHUNK_ELEMS;
    uint64_t db[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) db[q] = smem_desc(cur + q * TC_CHUNK * F, SBO);
    for (int rt = 0; rt < TC_ROW_TILES; ++rt) {
      const int r0 = (wg * TC_ROW_TILES + rt) * WG_ROWS;
      const uint64_t da = smem_desc(feat_t + core_off(r0, 0, F), SBO);
#pragma unroll
      for (int q = 0; q < 4; ++q) fence_regs(d[q]);
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < KSTEPS; ++s)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          wgmma_m64n64k16(d[q], da + s * DESC_KSTEP, db[q] + s * DESC_KSTEP, s > 0);
      wgmma_commit();
      // an eighth of the next chunk while the products run
      if (more) {
        const int task = rt * TC_THREADS + tid;
        if (task < TASKS) stage_chunk_task<T, QP>(nslot, width, K, nc, task, nbuf);
        if (rt == 0 && nc == 0 && stages_window(ni))
          for (int k = tid; k < K; k += TC_THREADS) window_of(ni)[k] = to_f32(nslot[k]);
      }
      wgmma_wait<0>();
#pragma unroll
      for (int q = 0; q < 4; ++q) fence_regs(d[q]);
      // rows a = r0 + 16 warp + t / 4 and b = a + 8, columns c 64 + 8 g + 2 (t % 4) + e
      float va = BIG, vb = BIG;
      int ka = 0x7fffffff, kb = 0x7fffffff, na = 0, nb = 0;
      const int col0 = c * TC_CHUNK + 2 * (t % 4);
      if ((c + 1) * TC_CHUNK <= K)
        fold_chunk<true>(d, col0, K, va, ka, na, vb, kb, nb);
      else
        fold_chunk<false>(d, col0, K, va, ka, na, vb, kb, nb);
      quad_fold(va, ka, na);
      quad_fold(vb, kb, nb);
      if (t % 4 == 0) {
        const int la = r0 + 16 * warp + t / 4, lb = la + 8;
        if (va < st.leaf_min[la]) {  // an earlier chunk keeps a tie
          st.leaf_min[la] = va;
          st.kwin[la] = ka;
        }
        if (vb < st.leaf_min[lb]) {
          st.leaf_min[lb] = vb;
          st.kwin[lb] = kb;
        }
        st.accepted[la] += na;
        st.accepted[lb] += nb;
      }
    }
    fence_async_proxy();
    __syncthreads();  // the next chunk is staged, this one's products are read
    if (c == per_visit - 1) {  // the visit's end: the fetch
      if (with_fetch) {
        bool improved = false;
        for (int l = tid; l < DRAIN_LANES; l += TC_THREADS) improved |= st.leaf_min[l] < st.acc0[l];
        if (__syncthreads_or(improved)) {
          const float* window = window_of(i);
          for (int l = tid; l < DRAIN_LANES; l += TC_THREADS) {
            const bool better = st.leaf_min[l] < st.acc0[l];
            st.acc1[l] = better ? window[st.kwin[l]] : 0.f;
            if (better) st.acc0[l] = st.leaf_min[l];
          }
          ++taken;
        }
      } else {
        for (int l = tid; l < DRAIN_LANES; l += TC_THREADS)
          st.acc0[l] = fminf(st.acc0[l], st.leaf_min[l]);
      }
      for (int l = tid; l < DRAIN_LANES; l += TC_THREADS) {
        st.lo[l] = fminf(st.lo[l], st.leaf_min[l]);
        st.leaf_min[l] = BIG;
        st.kwin[l] = 0;
      }
      __syncthreads();
    }
  }
  for (int l = tid; l < DRAIN_LANES; l += TC_THREADS)
    drain_store(out, count, tmin, fetches, l, st.acc0[l], st.acc1[l], st.accepted[l], st.lo[l],
                taken);
}

int drain_tc_smem_bytes(int qp, int K) {
  const int F = 16 * qp;
  return (DRAIN_LANES * F + 2 * 4 * TC_CHUNK * F) * (int)sizeof(__nv_bfloat16) +
         (6 * DRAIN_LANES + 2 * K) * (int)sizeof(float);
}

template <typename T, int QP>
int launch_drain_tc(const void* geo, const void* feat, float* out, int* count, float* tmin,
                    int* fetches, int blocks, int visits, int K, int width, int with_fetch,
                    int with_dma, cudaStream_t stream) {
  const int smem = drain_tc_smem_bytes(QP, K);
  cudaError_t e = cudaFuncSetAttribute(drain_tc_kernel<T, QP>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  drain_tc_kernel<T, QP><<<blocks, TC_THREADS, smem, stream>>>(
      static_cast<const T*>(geo), static_cast<const T*>(feat), out, count, tmin, fetches, visits,
      K, width, with_fetch, with_dma);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_drain_tc_qp(const void* geo, const void* feat, float* out, int* count, float* tmin,
                       int* fetches, int blocks, int visits, int qp, int K, int width,
                       int with_fetch, int with_dma, cudaStream_t stream) {
  if (qp == 4)
    return launch_drain_tc<T, 4>(geo, feat, out, count, tmin, fetches, blocks, visits, K, width,
                                 with_fetch, with_dma, stream);
  if (qp == 1)
    return launch_drain_tc<T, 1>(geo, feat, out, count, tmin, fetches, blocks, visits, K, width,
                                 with_fetch, with_dma, stream);
  return (int)cudaErrorInvalidValue;
}

int launch_drain_simt(const void* geo, const void* feat, float* out, int* count, float* tmin,
                      int* fetches, int blocks, int visits, int qp, int K, int width,
                      int with_fetch, int with_dma, cudaStream_t stream) {
  const int smem = (16 * qp * 4 * K + K) * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(drain_simt_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  drain_simt_kernel<<<blocks, DRAIN_LANES, smem, stream>>>(
      static_cast<const float*>(geo), static_cast<const float*>(feat), out, count, tmin, fetches,
      visits, qp, K, width, with_fetch, with_dma);
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

// a (512, n) f32, 16-byte aligned -> out (128, n); count (int) and tmin
// (f32), (128, n), or both null.
int kz_chain_probe(const float* a, float* out, int* count, float* tmin, int n, int reps,
                   cudaStream_t stream) {
  const int groups = CHAIN_ROWS * n / CHAIN_LANES;
  const int blocks = chain_blocks(groups);
  if (count != nullptr)
    chain_kernel<true>
        <<<blocks, CHAIN_THREADS, 0, stream>>>(a, out, count, tmin, groups, reps);
  else
    chain_kernel<false>
        <<<blocks, CHAIN_THREADS, 0, stream>>>(a, out, count, tmin, groups, reps);
  return (int)cudaGetLastError();
}

// An empty kernel at kz_chain_probe's launch shape for n: the floor of a
// launch of that shape on the card.
int kz_chain_empty(int n, cudaStream_t stream) {
  empty_kernel<<<chain_blocks(CHAIN_ROWS * n / CHAIN_LANES), CHAIN_THREADS, 0, stream>>>();
  return (int)cudaGetLastError();
}

// geo (256, 16 qp, width) and feat (16 qp, 1024), f32 or bf16 (bf16 = 1);
// out (8, blocks 1024) f32; count, tmin, fetches (blocks 1024) or null.
// round_ops (DEFAULT, or bf16 operands) runs the tensor-core visit, else
// (f32 operands at HIGHEST) the f32 SIMT loop.
int kz_drain_probe(const void* geo, const void* feat, float* out, int* count, float* tmin,
                   int* fetches, int blocks, int visits, int qp, int K, int width, int bf16,
                   int round_ops, int with_fetch, int with_dma, cudaStream_t stream) {
  if (!round_ops) {
    if (bf16) return (int)cudaErrorInvalidValue;
    return launch_drain_simt(geo, feat, out, count, tmin, fetches, blocks, visits, qp, K, width,
                             with_fetch, with_dma, stream);
  }
  if (bf16)
    return launch_drain_tc_qp<__nv_bfloat16>(geo, feat, out, count, tmin, fetches, blocks, visits,
                                             qp, K, width, with_fetch, with_dma, stream);
  return launch_drain_tc_qp<float>(geo, feat, out, count, tmin, fetches, blocks, visits, qp, K,
                                   width, with_fetch, with_dma, stream);
}

const char* kz_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
