// The sampler's draws on Hopper (sm_90a): one launch a draw, one thread a
// lane, every stream field read once and every new field written once.
//
// Replaces no TPU kernel: kazen_tpu draws with XLA-fused elementwise code
// (kazen_tpu/samplers/streams.py, kazen_tpu/core/rng.py), which the port's
// plain PyTorch version (samplers/streams.py's _*_plain functions) runs on
// the card as ~100 separate int64 launches a draw, each reading and writing
// the whole lane state, with two host reads in every Kensler permute (its
// `l` copied onto the card and the cycle-walk's `ok.all()`).
// Same contract as the plain version: the four draws of samplers/streams.py
// (init_stream_jump, next_1d, next_2d, next_pixel_2d) for the four kinds
// (independent, stratified, correlated, pmj02bn), equal bit for bit on the
// card. Each (draw, kind) is one instance of draw_kernel<OP, KIND>; the
// kinds share the Murmur hash, pcg32 and the permute and differ only in
// which of them a draw combines.
//
// What bounds it: device-memory bytes. A lane reads its stream fields (8 B
// each: state and inc for pcg32, dim, px, py, sample_index; a jump pair at
// init where it is per lane) and writes the fields it changes and its
// uniforms: ~48 B a lane for a pmj02bn next_1d and ~64 B for its next_2d,
// 30-40 us at 2.07 M lanes and 3.35 TB/s (lab/sampler_check.py:lane_bytes);
// a con-2 draw runs in 50-59 us, 55-67% of that bound.
// The arithmetic is native uint64/uint32 in registers: Murmur64A, MixBits,
// pcg32's seed, step and affine jump, Kensler's permute, whose cycle-walk is
// a per-lane loop (no host read); a stratified 128-spp stream (n = 144)
// walks a few rounds on some lanes. The pmj02bn point sets (5 x 65536 x 2
// f32), the blue-noise ranks (48 x 128 x 128 f32) and the pixel-tile table
// go through the read-only cache; a draw touches one or two blue-noise
// tables (every lane is at the same dimension) and they stay in L2. The
// lanes' fields may be strided views (the ordered permute gathers the
// stream as columns of one (N, 7) tensor), so each field comes with its
// lane stride; the outputs are contiguous.
//
// Bit for bit with the plain version on the card. PyTorch's CUDA division
// of a float tensor by a Python number multiplies by the number's f32
// reciprocal (BinaryDivTrueKernel.cu), so `x / n` is `x * (1.0f / n)` here,
// each product and sum rounded on its own (-fmad=false); torch.clamp's
// max keeps a NaN; integer `%` and `//` floor as Python's do; the fields
// hold uint64 bit patterns in int64, as core/rng.py does.
//
// Not used, and why: shared memory (a lane reads its own fields once and
// the tables through the cache); one kernel for a bounce's draws (the
// benchmark attributes device time to the four draw functions, and the
// stream between draws is the main path's contract).
//
// Everything above the launches' banner compiles for the host too, against
// a header that defines the CUDA names for one host thread:
// tests/test_torch_sampler_kernel.py runs the kernel body on the CPU.
#include <stdint.h>

typedef long long i64;
typedef unsigned long long u64;
typedef unsigned int u32;

// Field for field the ctypes structure _Params of samplers/draw_kernel.py.
struct Params {
  // the stream's fields in: pointer and lane stride (elements)
  const i64* state;
  i64 state_s;
  const i64* inc;
  i64 inc_s;
  const i64* dim;
  i64 dim_s;
  const i64* px;
  i64 px_s;
  const i64* py;
  i64 py_s;
  const i64* sample_index;  // null at init: si0 on every lane
  i64 sample_index_s;
  const i64* jump_a;  // init: the jump (A, S) of each lane; null: ja0, js0
  i64 jump_a_s;
  const i64* jump_s;
  i64 jump_s_s;
  i64 si0;
  u64 ja0, js0, seed;
  // out, contiguous (null where the draw leaves the field as it was)
  i64* state_out;
  i64* inc_out;
  i64* dim_out;
  i64* si_out;
  float* u;  // (lanes,) or (lanes, 2)
  // pmj02bn's tables, contiguous
  const float* pmj;        // (5, 65536, 2)
  const float* bluenoise;  // (48, 128, 128)
  const float* tile;       // (tile_entries, 2)
  i64 lanes, tile_entries;
  int op, kind, n, res_x, res_y, tile_size;
};

namespace {

constexpr int THREADS = 256;
// kinds in samplers/streams.py:KINDS order; draws as samplers/draw_kernel.py names them
enum Kind { INDEPENDENT = 0, STRATIFIED = 1, CORRELATED = 2, PMJ02BN = 3 };
enum Op { INIT = 0, NEXT_1D = 1, NEXT_2D = 2, PIXEL_2D = 3 };

constexpr u64 PCG32_MULT = 0x5851F42D4C957F2DULL;
constexpr u64 MURMUR_M = 0xC6A4A7935BD1E995ULL;
// the tables' shapes as samplers/streams.py indexes them
constexpr i64 PMJ_SETS = 5;
constexpr i64 PMJ_SAMPLES = 65536;
constexpr i64 BN_TABLES = 48;
constexpr i64 BN_RES = 128;

// ---------------------------------------------------------------------------
// scalars with PyTorch's semantics
// ---------------------------------------------------------------------------

// Python's % and // on int64 (floor); the fast path is the lanes' case
__device__ __forceinline__ i64 floor_mod(i64 a, i64 b) {
  if ((u64)a < 0x80000000ULL && (u64)(b - 1) < 0x7FFFFFFFULL) return (i64)((u32)a % (u32)b);
  const i64 r = a % b;
  return (r != 0 && ((r < 0) != (b < 0))) ? r + b : r;
}
__device__ __forceinline__ i64 floor_div(i64 a, i64 b) {
  if ((u64)a < 0x80000000ULL && (u64)(b - 1) < 0x7FFFFFFFULL) return (i64)((u32)a / (u32)b);
  const i64 q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}
// torch.clamp(x, max=hi): NaN stays NaN
__device__ __forceinline__ float clamp_hi(float x, float hi) {
  return isnan(x) ? x : fminf(x, hi);
}
// samplers/streams.py:ONE_MINUS_EPSILON, 0x1.fffffep-1
__device__ __forceinline__ float one_minus_epsilon() { return __uint_as_float(0x3F7FFFFFu); }
// `x / n` of a float tensor by a Python int on the card: x * f32(1 / n)
__device__ __forceinline__ float inv(int n) { return __fdiv_rn(1.0f, (float)n); }
// a table read outside its table: NaN (the plain version's index raises)
__device__ __forceinline__ float2 nan2() {
  return make_float2(__uint_as_float(0x7FC00000u), __uint_as_float(0x7FC00000u));
}

// ---------------------------------------------------------------------------
// core/rng.py: Murmur64A, MixBits, pcg32, Kensler's permute
// ---------------------------------------------------------------------------

__device__ __forceinline__ u64 murmur_round(u64 h, u64 k) {
  k *= MURMUR_M;
  k ^= k >> 47;
  k *= MURMUR_M;
  h ^= k;
  return h * MURMUR_M;
}

__device__ __forceinline__ u64 murmur_finalize(u64 h) {
  h ^= h >> 47;
  h *= MURMUR_M;
  return h ^ (h >> 47);
}

__device__ __forceinline__ u64 pixel_block(i64 px, i64 py) {
  return ((u64)py << 32) | (u64)px;
}

// Hash(Point2i p, uint64 seed): blocks (py<<32|px), seed
__device__ __forceinline__ u64 hash_pixel_seed(i64 px, i64 py, u64 seed) {
  u64 h = 16ULL * MURMUR_M;
  h = murmur_round(h, pixel_block(px, py));
  h = murmur_round(h, seed);
  return murmur_finalize(h);
}

// low 32 bits of Hash(Point2i p, uint32 dim, uint64 seed): blocks
// (py<<32|px), (seed_lo<<32|dim); 4-byte tail seed_hi
__device__ __forceinline__ u32 hash32_pixel_dim_seed(i64 px, i64 py, i64 dim, u64 seed) {
  u64 h = 20ULL * MURMUR_M;
  h = murmur_round(h, pixel_block(px, py));
  h = murmur_round(h, (u64)dim | (seed << 32));
  h ^= seed >> 32;
  h *= MURMUR_M;
  return (u32)murmur_finalize(h);
}

__device__ __forceinline__ u64 mix_bits(u64 v) {
  v ^= v >> 31;
  v *= 0x7FB5D329728EA185ULL;
  v ^= v >> 27;
  v *= 0x81DADEF4BC2DD44DULL;
  return v ^ (v >> 33);
}

// pcg32::seed(initseq = h) = seed(MixBits(h), h), closed form
__device__ __forceinline__ void pcg_seed(u64 h, u64& state, u64& inc) {
  inc = (h << 1) | 1ULL;
  state = (inc + mix_bits(h)) * PCG32_MULT + inc;
}

// one pcg32 step and its output as a float in [0, 1) (the [1, 2) mantissa trick)
__device__ __forceinline__ float pcg_next_float(u64& state, u64 inc) {
  const u64 old = state;
  state = old * PCG32_MULT + inc;
  const u32 xs = (u32)(((old >> 18) ^ old) >> 27);
  const u32 rot = (u32)(old >> 59);
  const u32 out = (xs >> rot) | (xs << ((0u - rot) & 31u));
  return __uint_as_float((out >> 9) | 0x3F800000u) - 1.0f;
}

__device__ __forceinline__ u32 permute_round(u32 i, u32 w, u32 p) {
  i ^= p;
  i *= 0xE170893Du;
  i ^= p >> 16;
  i ^= (i & w) >> 4;
  i ^= p >> 8;
  i *= 0x0929EB3Fu;
  i ^= p >> 23;
  i ^= (i & w) >> 1;
  i *= 1u | (p >> 27);
  i *= 0x6935FA69u;
  i ^= (i & w) >> 11;
  i *= 0x74DCB303u;
  i ^= (i & w) >> 2;
  i *= 0x9E501CC3u;
  i ^= (i & w) >> 2;
  i *= 0xC860A3DFu;
  i &= w;
  i ^= i >> 5;
  return i;
}

// Kensler's cycle-walking permutation of [0, l): a do-while on each lane.
// Only the low 32 bits of i reach the first round's product, as in rng.py.
__device__ __forceinline__ u32 permute(i64 i, u32 l, u32 p) {
  u32 w = l - 1;
  w |= w >> 1;
  w |= w >> 2;
  w |= w >> 4;
  w |= w >> 8;
  w |= w >> 16;
  u32 cur = permute_round((u32)i, w, p);
  while (cur >= l) cur = permute_round(cur, w, p);
  return (cur + p) % l;
}

// getBlueNoise: table[idx % 48][x % 128][y % 128]
__device__ __forceinline__ float bluenoise(const Params& p, i64 t, i64 px, i64 py) {
  return __ldg(p.bluenoise + (floor_mod(t, BN_TABLES) * BN_RES + floor_mod(px, BN_RES)) * BN_RES +
               floor_mod(py, BN_RES));
}

// ---------------------------------------------------------------------------
// the draws
// ---------------------------------------------------------------------------

template <int OP, int KIND>
__global__ void __launch_bounds__(THREADS) draw_kernel(const Params p) {
  const i64 i = (i64)blockIdx.x * THREADS + threadIdx.x;
  if (i >= p.lanes) return;

  if constexpr (OP == INIT) {
    // generateSample(pixel, sampleIndex, dim = 0): seed from the pixel's
    // hash, then the jump to sampleIndex * 65536; pmj02bn never draws from
    // pcg32, so its state is not advanced and its dimensions start at 2
    const i64 px = p.px[i * p.px_s], py = p.py[i * p.py_s];
    u64 state, inc;
    pcg_seed(hash_pixel_seed(px, py, p.seed), state, inc);
    if constexpr (KIND != PMJ02BN) {
      const u64 a = p.jump_a ? (u64)p.jump_a[i * p.jump_a_s] : p.ja0;
      const u64 s = p.jump_a ? (u64)p.jump_s[i * p.jump_s_s] : p.js0;
      state = state * a + inc * s;
    }
    p.state_out[i] = (i64)state;
    p.inc_out[i] = (i64)inc;
    p.dim_out[i] = KIND == PMJ02BN ? 2 : 0;
    if (p.si_out) p.si_out[i] = p.si0;
  } else if constexpr (OP == PIXEL_2D) {
    // pmj02bn's nextPixel2D: the pixel-tile table, no dimension consumed
    const i64 px = p.px[i * p.px_s], py = p.py[i * p.py_s];
    const i64 si = p.sample_index[i * p.sample_index_s];
    const i64 ts = p.tile_size;
    const i64 off = (floor_mod(px, ts) + floor_mod(py, ts) * ts) * p.n + si;
    const float2* tile = reinterpret_cast<const float2*>(p.tile);
    reinterpret_cast<float2*>(p.u)[i] =
        off >= 0 && off < p.tile_entries ? __ldg(tile + off) : nan2();
  } else if constexpr (KIND == INDEPENDENT) {
    u64 state = (u64)p.state[i * p.state_s];
    const u64 inc = (u64)p.inc[i * p.inc_s];
    const float u0 = pcg_next_float(state, inc);
    if constexpr (OP == NEXT_1D) {
      p.u[i] = u0;
    } else {
      const float u1 = pcg_next_float(state, inc);
      reinterpret_cast<float2*>(p.u)[i] = make_float2(u0, u1);
    }
    p.state_out[i] = (i64)state;
  } else {
    const i64 px = p.px[i * p.px_s], py = p.py[i * p.py_s];
    const i64 dim = p.dim[i * p.dim_s];
    const i64 si = p.sample_index[i * p.sample_index_s];
    const u32 n = (u32)p.n;
    if constexpr (KIND == PMJ02BN) {
      if constexpr (OP == NEXT_1D) {
        const u32 index = permute(si, n, hash32_pixel_dim_seed(px, py, dim, p.seed));
        const float delta = bluenoise(p, dim, px, py);
        p.u[i] = clamp_hi(((float)index + delta) * inv(p.n), one_minus_epsilon());
        p.dim_out[i] = dim + 1;
      } else {
        // the point sets past the fifth are indexed by the permuted index;
        // only those lanes hash and permute
        const i64 inst = floor_div(dim, 2);
        const i64 index =
            inst >= PMJ_SETS ? (i64)permute(si, n, hash32_pixel_dim_seed(px, py, dim, p.seed)) : si;
        const float2* set =
            reinterpret_cast<const float2*>(p.pmj) + floor_mod(inst, PMJ_SETS) * PMJ_SAMPLES;
        const float2 v = index >= 0 && index < PMJ_SAMPLES ? __ldg(set + index) : nan2();
        float u0 = v.x + bluenoise(p, dim, px, py);
        float u1 = v.y + bluenoise(p, dim + 1, px, py);
        u0 = u0 >= 1.0f ? u0 - 1.0f : u0;
        u1 = u1 >= 1.0f ? u1 - 1.0f : u1;
        reinterpret_cast<float2*>(p.u)[i] =
            make_float2(clamp_hi(u0, one_minus_epsilon()), clamp_hi(u1, one_minus_epsilon()));
        p.dim_out[i] = dim + 2;
      }
    } else {
      u64 state = (u64)p.state[i * p.state_s];
      const u64 inc = (u64)p.inc[i * p.inc_s];
      const u32 h32 = hash32_pixel_dim_seed(px, py, dim, p.seed);
      if constexpr (OP == NEXT_1D) {
        const u32 stratum = permute(si, n, KIND == STRATIFIED ? h32 : h32 * 0x45FBE943u);
        const float delta = pcg_next_float(state, inc);
        p.u[i] = ((float)stratum + delta) * inv(p.n);
        p.dim_out[i] = dim + 1;
      } else if constexpr (KIND == STRATIFIED) {
        const u32 stratum = permute(si, n, h32);
        const u32 res = (u32)p.res_x;
        const float x = (float)(stratum % res);
        const float y = (float)(stratum / res);
        const float dx = pcg_next_float(state, inc);
        const float dy = pcg_next_float(state, inc);
        const float r = inv(p.res_x);
        reinterpret_cast<float2*>(p.u)[i] = make_float2((x + dx) * r, (y + dy) * r);
        p.dim_out[i] = dim + 2;
      } else {  // correlated
        const u32 rx = (u32)p.res_x, ry = (u32)p.res_y;
        const u32 s = permute(si, n, h32 * 0x51633E2Du);
        const u32 y = s / rx;
        const u32 x = s % rx;
        const float sx = (float)permute(x, rx, h32 * 0x68BC21EBu);
        const float sy = (float)permute(y, ry, h32 * 0x02E5BE93u);
        const float jx = pcg_next_float(state, inc);
        const float jy = pcg_next_float(state, inc);
        const float irx = inv(p.res_x), iry = inv(p.res_y);
        reinterpret_cast<float2*>(p.u)[i] =
            make_float2(((float)x + (sy + jx) * iry) * irx, ((float)y + (sx + jy) * irx) * iry);
        p.dim_out[i] = dim + 2;
      }
      p.state_out[i] = (i64)state;
    }
  }
}

}  // namespace

// ---------------------------------------------------------------------------
// the launches (nvcc only)
// ---------------------------------------------------------------------------

#include <cuda_runtime.h>

namespace {

template <int OP>
int launch(const Params& p, cudaStream_t stream) {
  const unsigned blocks = (unsigned)((p.lanes + THREADS - 1) / THREADS);
  switch (p.kind) {
    case INDEPENDENT:
      draw_kernel<OP, INDEPENDENT><<<blocks, THREADS, 0, stream>>>(p);
      break;
    case STRATIFIED:
      draw_kernel<OP, STRATIFIED><<<blocks, THREADS, 0, stream>>>(p);
      break;
    case CORRELATED:
      draw_kernel<OP, CORRELATED><<<blocks, THREADS, 0, stream>>>(p);
      break;
    case PMJ02BN:
      draw_kernel<OP, PMJ02BN><<<blocks, THREADS, 0, stream>>>(p);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int kz_sampler_draw(const Params* prm, void* stream) {
  if (prm->lanes <= 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (prm->op) {
    case INIT:
      return launch<INIT>(*prm, s);
    case NEXT_1D:
      return launch<NEXT_1D>(*prm, s);
    case NEXT_2D:
      return launch<NEXT_2D>(*prm, s);
    case PIXEL_2D:
      // only pmj02bn has a pixel draw of its own; the others alias next_2d
      if (prm->kind != PMJ02BN) return (int)cudaErrorInvalidValue;
      draw_kernel<PIXEL_2D, PMJ02BN><<<(unsigned)((prm->lanes + THREADS - 1) / THREADS), THREADS,
                                       0, s>>>(*prm);
      return (int)cudaGetLastError();
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* kz_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
