// The path_mis megakernel on Hopper (sm_90a): a lane's whole NEE+MIS path
// in one thread, for scenes of at most 128 faces.
//
// Replaces the Pallas kernel of kazen_tpu/integrate/megakernel.py:_make_kernel
// (K3). Same contract as the plain version in integrate/megakernel.py
// (megakernel_plain): o, d (N, 3), the lanes' pcg32 streams -> (6, N) rows
// [li r, li g, li b, rays, Moller-Trumbore tests, bounces], rows 0-3 equal
// to the plain version's bit for bit and rows 4-5 counting the same work.
// The inner design is the card's, not the TPU's:
//
// * Tables in shared memory: each block stages the face records (at most
//   128 x 2 x 64 B), the light triangles (64 x 128 B), the materials and the
//   light CDF, under 30 KB, once. Every lane of a warp reads the same face
//   record at the same time, so the reads are broadcasts.
// * One face pass per vertex. A thread holds one path as a small state
//   machine. Each iteration of the warp's loop runs one pass over the staged
//   faces, in which every live thread tests up to two rays from one origin:
//   its nearest-hit ray (the camera ray, the punch-through re-cast of a
//   camera ray that hit a primary-invisible light, or the BSDF ray) and its
//   shadow ray. The two share tv = o - p0, qv = tv x e1 and the face loads;
//   each (ray, face) pair keeps the plain version's Moller-Trumbore
//   operations, so its t, u, v and accept keep their bits. After the pass
//   the thread resolves the hits and shades its next vertex, which sets up
//   the rays of the next pass.
// * Persistent warps that refill finished paths (refill = 1): only the
//   blocks that fit on the card at once are launched. At the top of each
//   iteration, a warp-uniform point, the warp ballots its threads that hold
//   no path, one lane takes that many lane indices from a global counter
//   and a shuffle hands them out; a fresh lane's camera ray goes into that
//   iteration's pass. So a warp no longer runs as long as its longest path.
//   refill = 0 gives each thread one lane over the full grid (the schedule
//   of the first design, with this loop). Every ballot and shuffle sits in
//   warp-uniform control flow: no thread leaves the loop before its warp.
// * Material dispatch is a switch on the lane's own type, where the TPU
//   kernel runs every type and selects. pcg32 runs on native uint64_t; the
//   sampler's Murmur hash and Kensler permutation are bit-exact with
//   core/rng.py.
// * A shadow ray is traced only where its contribution is not 0, which
//   changes no output: the plain version adds the same zero.
//
// Why the shadow test may follow the BSDF sample: the integrator tests the
// shadow ray of a vertex before it samples the BSDF, and the test draws
// nothing and changes only li. Here it runs in the pass after the sample,
// together with the BSDF ray. The stream draws keep their order (the light
// sample's four, then the BSDF's three); accum is updated between the light
// sample's BSDF evaluation and the BSDF sample, as before; and the
// unoccluded contribution is added to li right after the pass, before the
// BSDF ray's background term or the next vertex's emitter term, so the
// float additions into li keep their order. A lane whose BSDF weight is 0
// ends after that pass, with only its shadow ray in it.
//
// Built with -fmad=false, so every product and sum rounds on its own, as
// the plain version's separate PyTorch operations do; the code keeps their
// order of operations. That also halves the reachable f32 rate: no product
// and sum issue as one FMA.
//
// What bounds it: a lane reads 72 bytes (ray and stream) and writes 16, and
// runs about (1 + punch + 2 x bounces) x F triangle tests of ~45 flops plus
// its shading: f32 arithmetic, the latency of long dependent chains of IEEE
// divisions and square roots, and lanes idle in their warps bound it, not
// device-memory bytes. Rows 4 and 5 count each lane's triangle tests and
// bounces, the data for the operation bound; the lane-slot counters (32 x a
// warp's iterations, and the threads that held a path in them) say how full
// the warps ran.
//
// Not used, and why: tensor cores (they would break the f32 contract rows
// 0-3 are held to bit for bit; the TPU kernel's split-bf16 product is not
// carried over for the same reason); TMA (the tables are under 30 KB and
// staged once per persistent block); a BVH (the class is F <= 128, and the
// reference removed its in-kernel walk); a division-free screen ahead of the
// Moller-Trumbore reciprocal (it would need a proof of a conservative margin
// and a test that the screened trace equals the unscreened one bit for bit).
#include <cuda_runtime.h>
#include <stdint.h>

// Field for field the ctypes structure _Params of integrate/megakernel.py.
// Outside the anonymous namespace: the extern "C" entry point takes it, and
// a type of internal linkage would give that entry point internal linkage.
struct Params {
  const float* o;  // (n, 3)
  const float* d;  // (n, 3)
  const long long* st_state;  // (n,) pcg32 state
  const long long* st_inc;    // (n,) pcg32 increment
  const long long* st_dim;    // (n,) sampler dimension
  const long long* st_px;
  const long long* st_py;
  const long long* st_idx;    // (n,) sample index
  const float* geo;    // (F, 16)
  const float* attr;   // (F, 16)
  const float* mats;   // (M, 16)
  const float* ltris;  // (max(L*max_lf, 1), 32)
  const float* lcdf;   // (max(L, 1), max_lf + 1)
  const float* linfo;  // (max(L, 1), 16)
  float* out;          // (6, n)
  unsigned int* next_lane;    // the refill counter, 0 at launch
  unsigned long long* slots;  // (2,) += 32 x warp iterations, live threads
  unsigned long long seed;
  int n, F, M, L, max_lf, max_depth, needs_punch, regularization,
      has_background, sampler, samp_n, res_x, res_y, refill, min_blocks;
  float trace_bias, acc_scale, bg_r, bg_g, bg_b;
};

namespace {

constexpr int THREADS = 128;
constexpr int GEO_F = 16;
constexpr int LTRI_F = 32;
constexpr int OUT_ROWS = 6;
constexpr float BIG = 3.0e38f;
constexpr float EPS = 1e-4f;
constexpr float DET_EPS = 1e-8f;
constexpr float MIN_ALPHA = 1e-3f;
constexpr double PI_D = 3.14159265358979323846;
constexpr float PI_F = (float)PI_D;
constexpr float INV_PI = (float)(1.0 / PI_D);
constexpr float PI_4 = (float)(PI_D / 4.0);
constexpr float PI_2 = (float)(PI_D / 2.0);
constexpr float TWO_PI = (float)(2.0 * PI_D);
// the clearcoat roughness lerp(t, 0.01, 0.3) = t * (0.3 - 0.01) + 0.01, with
// the span rounded once from double, as the plain version's constant is
constexpr float CC_SPAN = (float)(0.3 - 0.01);

enum { DIFFUSE = 0, DIELECTRIC = 1, MIRROR = 2, LAMBERTIAN = 3, GGX = 4, KISS = 8 };
enum { INDEPENDENT = 0, STRATIFIED = 1, CORRELATED = 2 };


// ---------------------------------------------------------------------------
// vectors
// ---------------------------------------------------------------------------

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 v3(float x, float y, float z) { return {x, y, z}; }
__device__ __forceinline__ V3 ld3(const float* p) { return {p[0], p[1], p[2]}; }
__device__ __forceinline__ float dot(V3 a, V3 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
__device__ __forceinline__ V3 add(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
__device__ __forceinline__ V3 sub(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ V3 scale(V3 a, float s) { return {a.x * s, a.y * s, a.z * s}; }
__device__ __forceinline__ V3 neg(V3 a) { return {-a.x, -a.y, -a.z}; }
__device__ __forceinline__ V3 normalize(V3 a) {
  return scale(a, 1.0f / sqrtf(fmaxf(dot(a, a), 1e-30f)));
}
__device__ __forceinline__ float norm(V3 a) { return sqrtf(fmaxf(dot(a, a), 0.0f)); }
__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

struct Frame {
  V3 s, t, n;
};

__device__ __forceinline__ V3 to_local(const Frame& f, V3 w) {
  return {dot(w, f.s), dot(w, f.t), dot(w, f.n)};
}
__device__ __forceinline__ V3 to_world(const Frame& f, V3 v) {
  return {f.s.x * v.x + f.t.x * v.y + f.n.x * v.z,
          f.s.y * v.x + f.t.y * v.y + f.n.y * v.z,
          f.s.z * v.x + f.t.z * v.y + f.n.z * v.z};
}

// coordinateSystem (common.cpp:434-445): (b, c) with b = c x a
__device__ __forceinline__ void coordinate_system(V3 a, V3& b, V3& c) {
  const float inv_len_x = 1.0f / sqrtf(a.x * a.x + a.z * a.z + 1e-30f);
  const float inv_len_y = 1.0f / sqrtf(a.y * a.y + a.z * a.z + 1e-30f);
  c = fabsf(a.x) > fabsf(a.y) ? v3(a.z * inv_len_x, 0.0f, -a.x * inv_len_x)
                              : v3(0.0f, a.z * inv_len_y, -a.y * inv_len_y);
  b = cross(c, a);
}

__device__ __forceinline__ V3 reflect(V3 wi, V3 n) {
  return sub(scale(n, 2.0f * dot(wi, n)), wi);
}

__device__ __forceinline__ float power_heuristic(float a, float b) {
  const float a2 = a * a;
  const float b2 = b * b;
  return a2 > 0.0f ? a2 / (a2 + b2) : 0.0f;
}

// square_to_cosine_hemisphere (warp.cpp:86-115)
__device__ V3 cosine_hemisphere(float s0, float s1) {
  const float r1 = 2.0f * s0 - 1.0f;
  const float r2 = 2.0f * s1 - 1.0f;
  const bool use_r1 = r1 * r1 > r2 * r2;
  float r = use_r1 ? r1 : r2;
  const float safe_r1 = r1 == 0.0f ? 1.0f : r1;
  const float safe_r2 = r2 == 0.0f ? 1.0f : r2;
  float phi = use_r1 ? PI_4 * (r2 / safe_r1) : PI_2 - (r1 / safe_r2) * PI_4;
  if (r1 == 0.0f && r2 == 0.0f) r = phi = 0.0f;
  const float px = r * cosf(phi);
  const float py = r * sinf(phi);
  const float z = sqrtf(fmaxf(1.0f - px * px - py * py, 0.0f));
  return {px, py, z == 0.0f ? 1e-10f : z};
}

// ---------------------------------------------------------------------------
// sample streams (samplers/streams.py, core/rng.py)
// ---------------------------------------------------------------------------

constexpr uint64_t PCG_MULT = 0x5851F42D4C957F2DULL;
constexpr uint64_t MURMUR_M = 0xC6A4A7935BD1E995ULL;

struct Stream {
  uint64_t state, inc;
  uint32_t dim, px, py, idx;
};

__device__ __forceinline__ float pcg_next_float(Stream& s) {
  const uint64_t old = s.state;
  s.state = old * PCG_MULT + s.inc;
  const uint32_t xorshifted = (uint32_t)(((old >> 18) ^ old) >> 27);
  const uint32_t rot = (uint32_t)(old >> 59);
  const uint32_t u = (xorshifted >> rot) | (xorshifted << ((0u - rot) & 31u));
  return __uint_as_float((u >> 9) | 0x3F800000u) - 1.0f;
}

__device__ __forceinline__ uint64_t murmur_round(uint64_t h, uint64_t k) {
  k *= MURMUR_M;
  k ^= k >> 47;
  k *= MURMUR_M;
  h ^= k;
  return h * MURMUR_M;
}

// low 32 bits of Hash(Point2i(px, py), uint32 dim, uint64 seed), a 20-byte
// MurmurHash64A key (hash.h:15-65)
__device__ uint32_t hash32_pixel_dim_seed(const Stream& s, uint64_t seed) {
  uint64_t h = 20ULL * MURMUR_M;
  h = murmur_round(h, ((uint64_t)s.py << 32) | s.px);
  h = murmur_round(h, ((seed & 0xFFFFFFFFULL) << 32) | s.dim);
  h ^= seed >> 32;
  h *= MURMUR_M;
  h ^= h >> 47;
  h *= MURMUR_M;
  h ^= h >> 47;
  return (uint32_t)h;
}

__device__ __forceinline__ uint32_t permute_round(uint32_t i, uint32_t w, uint32_t p) {
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

// Kensler's permute(i, l, p) (common.cpp:316-344)
__device__ uint32_t permute(uint32_t i, uint32_t l, uint32_t p) {
  uint32_t w = l - 1;
  w |= w >> 1;
  w |= w >> 2;
  w |= w >> 4;
  w |= w >> 8;
  w |= w >> 16;
  do {
    i = permute_round(i, w, p);
  } while (i >= l);
  return (i + p) % l;
}

template <int KIND>
__device__ float draw_1d(Stream& s, const Params& p) {
  if (KIND == INDEPENDENT) return pcg_next_float(s);
  const uint32_t h = hash32_pixel_dim_seed(s, p.seed);
  const uint32_t l = (uint32_t)p.samp_n;
  const uint32_t stratum =
      permute(s.idx, l, KIND == STRATIFIED ? h : h * 0x45FBE943u);
  const float delta = pcg_next_float(s);
  s.dim += 1;
  return ((float)stratum + delta) / (float)p.samp_n;
}

template <int KIND>
__device__ void draw_2d(Stream& s, const Params& p, float& u0, float& u1) {
  if (KIND == INDEPENDENT) {
    u0 = pcg_next_float(s);
    u1 = pcg_next_float(s);
    return;
  }
  const uint32_t h = hash32_pixel_dim_seed(s, p.seed);
  const uint32_t l = (uint32_t)p.samp_n;
  if (KIND == STRATIFIED) {
    const uint32_t res = (uint32_t)p.res_x;
    const uint32_t stratum = permute(s.idx, l, h);
    const float x = (float)(stratum % res);
    const float y = (float)(stratum / res);
    const float dx = pcg_next_float(s);
    const float dy = pcg_next_float(s);
    u0 = (x + dx) / (float)p.res_x;
    u1 = (y + dy) / (float)p.res_x;
  } else {
    const uint32_t rx = (uint32_t)p.res_x, ry = (uint32_t)p.res_y;
    const uint32_t st = permute(s.idx, l, h * 0x51633E2Du);
    const uint32_t y = st / rx;
    const uint32_t x = st % rx;
    const float sx = (float)permute(x, rx, h * 0x68BC21EBu);
    const float sy = (float)permute(y, ry, h * 0x02E5BE93u);
    const float jx = pcg_next_float(s);
    const float jy = pcg_next_float(s);
    u0 = ((float)x + (sy + jx) / (float)p.res_y) / (float)p.res_x;
    u1 = ((float)y + (sx + jy) / (float)p.res_x) / (float)p.res_y;
  }
  s.dim += 2;
}

// ---------------------------------------------------------------------------
// trace (brute force over the staged face records)
// ---------------------------------------------------------------------------

struct Tables {
  const float* geo;
  const float* attr;
  const float* mats;
  const float* ltris;
  const float* lcdf;
  const float* linfo;
};

// Moller-Trumbore (mesh.cpp:55-92) of direction d against a face with edges
// e1, e2, given tv = o - p0 and qv = tv x e1, which depend only on the
// origin and the face and so serve every ray from o
__device__ __forceinline__ bool mt_test(V3 e1, V3 e2, V3 tv, V3 qv, V3 d, float& t,
                                        float& u, float& v) {
  const V3 pv = cross(d, e2);
  const float det = dot(e1, pv);
  const bool ok = fabsf(det) > DET_EPS;
  const float inv_det = 1.0f / (ok ? det : 1.0f);
  u = dot(tv, pv) * inv_det;
  v = dot(d, qv) * inv_det;
  t = dot(e2, qv) * inv_det;
  return ok && u >= 0.0f && u <= 1.0f && v >= 0.0f && u + v <= 1.0f;
}

struct Hit {
  int face;  // -1: no hit
  float u, v;
};

// the winner's records, as the plain version's _Hit
struct Surf {
  bool found, has_n, has_uv;
  int mat, light;
  bool light_pv;
  float u, v;
  V3 p0, e1, e2, n0, n1, n2;
  float uv0x, uv0y, uv1x, uv1y, uv2x, uv2y;
};

__device__ Surf fetch(const Tables& tb, Hit h) {
  Surf s;
  s.found = h.face >= 0;
  const int f = s.found ? h.face : 0;
  const float* g = tb.geo + f * GEO_F;
  const float* a = tb.attr + f * GEO_F;
  s.u = s.found ? h.u : 0.0f;
  s.v = s.found ? h.v : 0.0f;
  s.p0 = ld3(g);
  s.e1 = ld3(g + 3);
  s.e2 = ld3(g + 6);
  s.mat = (int)g[9];
  s.light = s.found ? (int)g[10] : -1;
  s.light_pv = g[11] > 0.0f;
  s.has_n = g[12] > 0.0f;
  s.has_uv = g[13] > 0.0f;
  s.n0 = ld3(a);
  s.n1 = ld3(a + 3);
  s.n2 = ld3(a + 6);
  s.uv0x = a[9];
  s.uv0y = a[10];
  s.uv1x = a[11];
  s.uv1y = a[12];
  s.uv2x = a[13];
  s.uv2y = a[14];
  return s;
}

// the hit point with Hanika's terminator offset (accel.cpp:141-153)
__device__ V3 hanika_point(const Surf& s) {
  const float b0 = 1.0f - s.u - s.v, b1 = s.u, b2 = s.v;
  const V3 p0 = s.p0;
  const V3 p1 = add(p0, s.e1);
  const V3 p2 = add(p0, s.e2);
  const V3 orig_p = add(add(scale(p0, b0), scale(p1, b1)), scale(p2, b2));
  if (!s.has_n) return orig_p;
  V3 tu = sub(orig_p, p0), tv = sub(orig_p, p1), tw = sub(orig_p, p2);
  tu = sub(tu, scale(s.n0, fminf(dot(tu, s.n0), 0.0f)));
  tv = sub(tv, scale(s.n1, fminf(dot(tv, s.n1), 0.0f)));
  tw = sub(tw, scale(s.n2, fminf(dot(tw, s.n2), 0.0f)));
  return add(orig_p, add(add(scale(tu, b0), scale(tv, b1)), scale(tw, b2)));
}

// shading frame (accel.cpp:156-235)
__device__ Frame shading_frame(const Surf& s) {
  const float b0 = 1.0f - s.u - s.v, b1 = s.u, b2 = s.v;
  const V3 cr = cross(s.e1, s.e2);
  const V3 shn_raw = add(add(scale(s.n0, b0), scale(s.n1, b1)), scale(s.n2, b2));
  const V3 sh_n = normalize(shn_raw);
  const float duv0x = s.uv1x - s.uv0x, duv0y = s.uv1y - s.uv0y;
  const float duv1x = s.uv2x - s.uv0x, duv1y = s.uv2y - s.uv0y;
  const float determinant = duv0x * duv1y - duv0y * duv1x;
  Frame fr;
  if (s.has_n && s.has_uv && norm(cr) > 0.0f && determinant > 0.0f) {
    const float inv_det = 1.0f / determinant;
    const V3 dpdu = scale(sub(scale(s.e1, duv1y), scale(s.e2, duv0y)), inv_det);
    fr.s = normalize(sub(dpdu, scale(shn_raw, dot(shn_raw, dpdu))));
    fr.t = normalize(cross(sh_n, fr.s));
    fr.n = sh_n;
  } else {
    fr.n = s.has_n ? sh_n : normalize(cr);
    coordinate_system(fr.n, fr.s, fr.t);
  }
  return fr;
}

// ---------------------------------------------------------------------------
// BSDFs (bsdf.cpp, ggx_brdf.h); directions in the local shading frame
// ---------------------------------------------------------------------------

struct Mat {
  int btype;
  V3 base;
  float metallic, roughness, aniso, specular, spec_tint, clearcoat, cc_rough,
      sheen, sheen_tint, int_ior, ext_ior;
};

__device__ Mat load_mat(const Tables& tb, int m) {
  const float* r = tb.mats + m * 16;
  Mat mp;
  mp.btype = (int)r[0];
  mp.base = ld3(r + 1);
  mp.metallic = r[4];
  mp.roughness = r[5];
  mp.aniso = r[6];
  mp.specular = r[7];
  mp.spec_tint = r[8];
  mp.clearcoat = r[9];
  mp.cc_rough = r[10];
  mp.sheen = r[11];
  mp.sheen_tint = r[12];
  mp.int_ior = r[13];
  mp.ext_ior = r[14];
  return mp;
}

__device__ __forceinline__ void r2a(float roughness, float aniso, float& ax, float& ay) {
  const float a = fmaxf(roughness * roughness, MIN_ALPHA);
  ax = a * (1.0f + aniso);
  ay = a * (1.0f - aniso);
}

__device__ __forceinline__ float smith_lambda(V3 v, float ax, float ay) {
  const float vz2 = fmaxf(v.z * v.z, 1e-9f);
  const float sq = (ax * ax * v.x * v.x + ay * ay * v.y * v.y) / vz2;
  return (-1.0f + sqrtf(1.0f + sq)) * 0.5f;
}

__device__ __forceinline__ float smith_g1(V3 v, V3 h, float ax, float ay) {
  const float g = 1.0f / (1.0f + smith_lambda(v, ax, ay));
  return dot(v, h) <= 0.0f ? 0.0f : g;
}

__device__ __forceinline__ float smith_g2(V3 v, V3 l, V3 h, float ax, float ay) {
  const float g = 1.0f / (1.0f + smith_lambda(v, ax, ay) + smith_lambda(l, ax, ay));
  return (dot(v, h) <= 0.0f || dot(l, h) < 0.0f) ? 0.0f : g;
}

__device__ __forceinline__ float ggx_ndf(V3 h, float ax, float ay) {
  const float ell = (h.x * h.x) / (ax * ax) + (h.y * h.y) / (ay * ay) + h.z * h.z;
  return 1.0f / (PI_F * ax * ay * ell * ell);
}

__device__ __forceinline__ float vndf(V3 v, V3 h, float ax, float ay) {
  const float vdoth = dot(v, h);
  const float vz = v.z == 0.0f ? 1e-9f : v.z;
  const float val = ggx_ndf(h, ax, ay) * smith_g1(v, h, ax, ay) * vdoth / vz;
  return vdoth <= 0.0f ? 0.0f : val;
}

// sampleGGXSmithVNDF (ggx_brdf.h:96-120)
__device__ V3 sample_vndf(V3 v, float ax, float ay, float u0, float u1) {
  const V3 vh = normalize(v3(ax * v.x, ay * v.y, v.z));
  const float lensq = vh.x * vh.x + vh.y * vh.y;
  const float inv_len = 1.0f / sqrtf(fmaxf(lensq, 1e-9f));
  const V3 t1 = lensq > 0.0f ? v3(-vh.y * inv_len, vh.x * inv_len, 0.0f)
                             : v3(1.0f, 0.0f, 0.0f);
  const V3 t2 = normalize(cross(vh, t1));
  const float r = sqrtf(u0);
  const float phi = TWO_PI * u1;
  const float p1 = r * cosf(phi);
  float p2 = r * sinf(phi);
  const float s = 0.5f * (1.0f + vh.z);
  p2 = (1.0f - s) * sqrtf(fmaxf(1.0f - p1 * p1, 0.0f)) + s * p2;
  const float pz = sqrtf(fmaxf(1.0f - p1 * p1 - p2 * p2, 0.0f));
  const V3 nh = add(add(scale(t1, p1), scale(t2, p2)), scale(vh, pz));
  return normalize(v3(ax * nh.x, ay * nh.y, fmaxf(nh.z, 1e-6f)));
}

__device__ __forceinline__ V3 schlick3(V3 f0, float cos_theta) {
  const float w = powf(clampf(1.0f - cos_theta, 0.0f, 1.0f), 5.0f);
  return {f0.x + (1.0f - f0.x) * w, f0.y + (1.0f - f0.y) * w,
          f0.z + (1.0f - f0.z) * w};
}

__device__ __forceinline__ float schlick_weight(float x) {
  x = clampf(1.0f - x, 0.0f, 1.0f);
  const float x2 = x * x;
  return x2 * x2 * x;
}

// dielectric Fresnel (common.cpp:447-476)
__device__ float fresnel(float cos_i, float ext_ior, float int_ior) {
  const bool enter = cos_i >= 0.0f;
  const float eta_i = enter ? ext_ior : int_ior;
  const float eta_t = enter ? int_ior : ext_ior;
  const float ci = fabsf(cos_i);
  const float eta = eta_i / eta_t;
  const float sin_t2 = eta * eta * (1.0f - ci * ci);
  const float ct = sqrtf(fmaxf(1.0f - sin_t2, 0.0f));
  const float rs = (eta_i * ci - eta_t * ct) / (eta_i * ci + eta_t * ct);
  const float rp = (eta_t * ci - eta_i * ct) / (eta_t * ci + eta_i * ct);
  const float f = sin_t2 > 1.0f ? 1.0f : 0.5f * (rs * rs + rp * rp);
  return ext_ior == int_ior ? 0.0f : f;
}

// GGX f*cos and pdf of wo
__device__ void ggx_eval_pdf(const Mat& mp, V3 wi, V3 wo, V3& f, float& pdf) {
  float ax, ay;
  r2a(mp.roughness, mp.aniso, ax, ay);
  const V3 h = normalize(add(wi, wo));
  const float sgl =
      wi.z * wo.z < 0.0f
          ? 0.0f
          : ggx_ndf(h, ax, ay) * smith_g2(wi, wo, h, ax, ay) /
                fmaxf(4.0f * fabsf(wi.z) * fabsf(wo.z), 1e-9f);
  const V3 fr = schlick3(mp.base, dot(wi, h));
  float jac = 4.0f * dot(wi, h);
  jac = jac == 0.0f ? 1e-9f : jac;
  if (wi.z > 0.0f && wo.z > 0.0f) {
    f = v3(sgl * fr.x * wo.z, sgl * fr.y * wo.z, sgl * fr.z * wo.z);
    pdf = vndf(wi, h, ax, ay) / jac;
  } else {
    f = v3(0.0f, 0.0f, 0.0f);
    pdf = 0.0f;
  }
}

// kiss eval + pdf (bsdf.cpp:1226-1299)
__device__ void kiss_eval_pdf(const Mat& mp, V3 wi, V3 wo, float accum, V3& fv3,
                              float& pdf_out) {
  const V3 v = wi, l = wo;
  const V3 h = normalize(add(v, l));
  const V3 base = mp.base;
  const float metallic = mp.metallic;
  const float roughness = fminf(mp.roughness + accum, 1.0f);
  float ax, ay, cax, cay, pax, pay;
  r2a(roughness, mp.aniso, ax, ay);
  const float cc_rough = mp.cc_rough * CC_SPAN + 0.01f;
  r2a(cc_rough, mp.aniso, cax, cay);
  r2a(cc_rough, 0.0f, pax, pay);

  const float cdlum = 0.212671f * base.x + 0.715160f * base.y + 0.072169f * base.z;
  const bool pos = cdlum > 0.0f;
  const float inv_lum = 1.0f / fmaxf(cdlum, 1e-9f);
  const V3 ctint = pos ? v3(base.x * inv_lum, base.y * inv_lum, base.z * inv_lum)
                       : v3(1.0f, 1.0f, 1.0f);
  const float spec08 = 0.08f * mp.specular;
  const float st = mp.spec_tint;
  const V3 ctintmix = v3(spec08 * (st + (1.0f - st) * ctint.x),
                         spec08 * (st + (1.0f - st) * ctint.y),
                         spec08 * (st + (1.0f - st) * ctint.z));
  const V3 cspec0 = v3(ctintmix.x + metallic * (base.x - ctintmix.x),
                       ctintmix.y + metallic * (base.y - ctintmix.y),
                       ctintmix.z + metallic * (base.z - ctintmix.z));
  const float fl = schlick_weight(l.z);
  const float fvw = schlick_weight(v.z);
  const float fh = schlick_weight(dot(l, h));
  const float cos_d = dot(v, h);
  const float lambert = (1.0f - 0.5f * fl) * (1.0f - 0.5f * fvw);
  const float rr = 2.0f * roughness * cos_d * cos_d;
  const float retro = rr * (fl + fvw + fl * fvw * (rr - 1.0f));
  const float sht = mp.sheen_tint;
  const float sheen_s = fh * mp.sheen;
  const V3 fsheen = v3(sheen_s * (sht + (1.0f - sht) * ctint.x),
                       sheen_s * (sht + (1.0f - sht) * ctint.y),
                       sheen_s * (sht + (1.0f - sht) * ctint.z));

  const float denom = fmaxf(4.0f * fabsf(v.z) * fabsf(l.z), 1e-9f);
  const bool opp = v.z * l.z < 0.0f;
  const float sg = opp ? 0.0f : ggx_ndf(h, ax, ay) * smith_g2(v, l, h, ax, ay) / denom;
  const V3 f_spec = schlick3(cspec0, cos_d);
  const float cg = opp ? 0.0f : ggx_ndf(h, cax, cay) * smith_g2(v, l, h, cax, cay) / denom;
  const V3 f_cc = schlick3(v3(0.04f, 0.04f, 0.04f), cos_d);
  const float cc_s = 0.25f * mp.clearcoat;
  const float diff = lambert + retro;
  const V3 val = v3(
      ((1.0f - metallic) * (base.x * INV_PI * diff + fsheen.x) + sg * f_spec.x +
       cc_s * cg * f_cc.x) * l.z,
      ((1.0f - metallic) * (base.y * INV_PI * diff + fsheen.y) + sg * f_spec.y +
       cc_s * cg * f_cc.y) * l.z,
      ((1.0f - metallic) * (base.z * INV_PI * diff + fsheen.z) + sg * f_spec.z +
       cc_s * cg * f_cc.z) * l.z);

  const float diffuse_p = (1.0f - metallic) * 0.5f;
  const float gtr2 = 1.0f / (1.0f + mp.clearcoat);
  float jac = 4.0f * dot(wi, h);
  jac = jac == 0.0f ? 1e-9f : jac;
  const float spec_pdf = vndf(wi, h, ax, ay) / jac;
  const float coat_pdf = vndf(wi, h, pax, pay) / jac;
  const float pdf = diffuse_p * INV_PI * l.z +
                    (1.0f - diffuse_p) * (gtr2 * spec_pdf + (1.0f - gtr2) * coat_pdf);
  const bool m = wi.z > 0.0f && wo.z > 0.0f;
  fv3 = m ? val : v3(0.0f, 0.0f, 0.0f);
  pdf_out = m ? pdf : 0.0f;
}

__device__ void bsdf_eval_pdf(const Mat& mp, V3 wi, V3 wo, float accum, V3& f,
                              float& pdf) {
  const bool up = wi.z > 0.0f && wo.z > 0.0f;
  switch (mp.btype) {
    case DIFFUSE:
    case LAMBERTIAN:
      pdf = up ? INV_PI * wo.z : 0.0f;
      f = up ? v3(mp.base.x * INV_PI * wo.z, mp.base.y * INV_PI * wo.z,
                  mp.base.z * INV_PI * wo.z)
             : v3(0.0f, 0.0f, 0.0f);
      return;
    case GGX:
      ggx_eval_pdf(mp, wi, wo, f, pdf);
      return;
    case KISS:
      kiss_eval_pdf(mp, wi, wo, accum, f, pdf);
      return;
    default:  // mirror, dielectric: discrete lobes
      f = v3(0.0f, 0.0f, 0.0f);
      pdf = 0.0f;
  }
}

struct BsdfSample {
  V3 wo, w;
  float eta, pdf;
  bool disc;
};

__device__ BsdfSample bsdf_sample(const Mat& mp, V3 wi, float s1, float s2a,
                                  float s2b, float accum) {
  BsdfSample r;
  r.eta = 1.0f;
  r.pdf = 0.0f;
  r.disc = false;
  switch (mp.btype) {
    case DIFFUSE:
    case LAMBERTIAN:
      r.wo = cosine_hemisphere(s2a, s2b);
      r.w = wi.z > 0.0f ? mp.base : v3(0.0f, 0.0f, 0.0f);
      r.pdf = (wi.z > 0.0f && r.wo.z > 0.0f) ? INV_PI * r.wo.z : 0.0f;
      break;
    case MIRROR: {
      r.wo = v3(-wi.x, -wi.y, wi.z);
      const float w = wi.z > 0.0f ? 1.0f : 0.0f;
      r.w = v3(w, w, w);
      r.disc = true;
      break;
    }
    case DIELECTRIC: {
      const float cos_i = wi.z;
      const float fr = fresnel(cos_i, mp.ext_ior, mp.int_ior);
      const bool outside = cos_i >= 0.0f;
      const float nz = outside ? 1.0f : -1.0f;
      const float factor =
          outside ? mp.int_ior / mp.ext_ior : mp.ext_ior / mp.int_ior;
      // refract(-wi, n, factor) with n = (0, 0, nz)
      const float ci = -wi.z * nz;
      const float eta_eff = ci < 0.0f ? 1.0f / factor : factor;
      const float cos_t2 = 1.0f - (1.0f - ci * ci) * (eta_eff * eta_eff);
      const float sign = ci >= 0.0f ? 1.0f : -1.0f;
      const float root = sqrtf(fmaxf(cos_t2, 0.0f));
      const V3 refr =
          cos_t2 <= 0.0f
              ? v3(0.0f, 0.0f, 0.0f)
              : v3(-wi.x * eta_eff, -wi.y * eta_eff,
                   nz * (-ci * eta_eff + sign * root) + -wi.z * eta_eff);
      const bool choose = s1 < fr;
      r.wo = choose ? v3(-wi.x, -wi.y, wi.z) : refr;
      r.eta = choose ? 1.0f : mp.int_ior / mp.ext_ior;
      r.w = v3(1.0f, 1.0f, 1.0f);
      r.disc = true;
      break;
    }
    case GGX: {
      float ax, ay;
      r2a(mp.roughness, mp.aniso, ax, ay);
      r.wo = reflect(wi, sample_vndf(wi, ax, ay, s2a, s2b));
      V3 f;
      ggx_eval_pdf(mp, wi, r.wo, f, r.pdf);
      const float inv_pdf = 1.0f / fmaxf(r.pdf, 1e-9f);
      r.w = (wi.z > 0.0f && r.wo.z > 0.0f && r.pdf > 0.0f)
                ? v3(f.x * inv_pdf, f.y * inv_pdf, f.z * inv_pdf)
                : v3(0.0f, 0.0f, 0.0f);
      break;
    }
    default: {  // kiss (bsdf.cpp:1301-1370)
      const float diffuse = (1.0f - mp.metallic) * 0.5f;
      const float gtr2 = 1.0f / (1.0f + mp.clearcoat);
      if (s1 < diffuse) {
        r.wo = cosine_hemisphere(s2a, s2b);
      } else {
        const float s_rescaled = (s1 - diffuse) / fmaxf(1.0f - diffuse, 1e-9f);
        const bool flip = wi.z <= 0.0f;
        const V3 wi_f = flip ? neg(wi) : wi;
        // the half-vector uses the unregularized roughness (bsdf.cpp:1317)
        float ax, ay;
        if (s_rescaled < gtr2) {
          r2a(mp.roughness, mp.aniso, ax, ay);
        } else {
          r2a(mp.cc_rough * CC_SPAN + 0.01f, 0.0f, ax, ay);
        }
        V3 h = sample_vndf(wi_f, ax, ay, s2a, s2b);
        h = flip ? neg(h) : h;
        r.wo = normalize(reflect(wi, h));
      }
      V3 val;
      kiss_eval_pdf(mp, wi, r.wo, accum, val, r.pdf);
      const float inv_pdf = 1.0f / fmaxf(r.pdf, 1e-9f);
      const bool ok = wi.z > 0.0f && r.wo.z > 0.0f && r.pdf > EPS &&
                      isfinite(r.wo.x) && isfinite(r.wo.y) && isfinite(r.wo.z);
      const float wx = val.x * inv_pdf, wy = val.y * inv_pdf, wz = val.z * inv_pdf;
      r.w = v3(ok && isfinite(wx) ? wx : 0.0f, ok && isfinite(wy) ? wy : 0.0f,
               ok && isfinite(wz) ? wz : 0.0f);
    }
  }
  return r;
}

// ---------------------------------------------------------------------------
// the kernel
// ---------------------------------------------------------------------------

constexpr unsigned FULL_MASK = 0xFFFFFFFFu;

// what the nearest-hit ray of a path's next face pass is
enum { CAMERA = 0, PUNCH = 1, BOUNCE = 2 };

// One path, as a thread carries it from one face pass to the next. The
// shading frame, material and light of a vertex live only between the pass
// that finds it and its shading, in the same iteration.
struct Path {
  int lane;         // -1: the thread holds no path
  int stage;        // CAMERA, PUNCH or BOUNCE
  bool near, shad;  // the pass traces a nearest-hit ray / a shadow ray
  bool disc;        // the BSDF ray's lobe was discrete
  Stream rs;
  V3 o;             // the origin of the ray that found the current vertex
  V3 d;             // the nearest-hit ray's direction
  V3 pt;            // the current vertex: the origin of the pass's rays
  V3 sd, cch;       // the shadow ray's direction and the light it carries
  float smaxt;
  float bpdf;       // the BSDF ray's pdf
  Hit light_hit;    // the camera ray's hit, kept where a re-cast misses
  V3 li, tpt;
  float eta, bw, accum, nrays;
  int tests, bounces, depth;
};

__device__ __forceinline__ void start_path(Path& q, const Params& p, int i) {
  q.lane = i;
  q.rs.state = (uint64_t)p.st_state[i];
  q.rs.inc = (uint64_t)p.st_inc[i];
  q.rs.dim = (uint32_t)p.st_dim[i];
  q.rs.px = (uint32_t)p.st_px[i];
  q.rs.py = (uint32_t)p.st_py[i];
  q.rs.idx = (uint32_t)p.st_idx[i];
  q.o = ld3(p.o + 3 * (size_t)i);
  q.d = ld3(p.d + 3 * (size_t)i);
  q.pt = q.o;
  q.stage = CAMERA;
  q.near = true;
  q.shad = false;
  q.li = v3(0.0f, 0.0f, 0.0f);
  q.tpt = v3(1.0f, 1.0f, 1.0f);
  q.eta = 1.0f;
  q.bw = 1.0f;
  q.accum = 0.0f;
  q.nrays = 1.0f;  // the camera ray
  q.tests = 0;
  q.bounces = 0;
  q.depth = 0;
}

__device__ __forceinline__ void end_path(Path& q, const Params& p) {
  float* out = p.out + q.lane;
  const size_t stride = (size_t)p.n;
  out[0] = q.li.x;
  out[stride] = q.li.y;
  out[2 * stride] = q.li.z;
  out[3 * stride] = q.nrays;
  out[4 * stride] = (float)q.tests;
  out[5 * stride] = (float)q.bounces;
  q.lane = -1;
  q.near = q.shad = false;
}

// One pass over the staged faces from q.pt: the nearest hit of the
// nearest-hit ray at t >= mint (of faces at the same t the first in face
// order wins, strict t < best), and the shadow ray's any hit in [bias,
// smaxt], which faces of primary-invisible lights never block. The shadow
// ray stops testing at its first blocker and counts the faces it tested;
// q.shad stays true where nothing blocked it.
__device__ __forceinline__ Hit face_pass(Path& q, const Tables& tb, int F, float bias) {
  Hit h = {-1, 0.0f, 0.0f};
  if (q.lane < 0) return h;
  const float mint = q.stage == BOUNCE ? bias : EPS;
  float best = BIG;
  for (int f = 0; f < F; ++f) {
    const float* g = tb.geo + f * GEO_F;
    const float4 a = *reinterpret_cast<const float4*>(g);
    const float4 b = *reinterpret_cast<const float4*>(g + 4);
    const V3 p0 = v3(a.x, a.y, a.z), e1 = v3(a.w, b.x, b.y), e2 = v3(b.z, b.w, g[8]);
    const V3 tv = sub(q.pt, p0);
    const V3 qv = cross(tv, e1);
    float t, u, v;
    if (q.near && mt_test(e1, e2, tv, qv, q.d, t, u, v) && t >= mint && t < best) {
      best = t;
      h = {f, u, v};
    }
    if (q.shad && !(g[10] >= 0.0f && g[11] == 0.0f)) {
      ++q.tests;
      if (mt_test(e1, e2, tv, qv, q.sd, t, u, v) && t >= bias && t <= q.smaxt) q.shad = false;
    }
  }
  return h;
}

// Shades vertex q.depth of a live path (integrator.cpp:224-309), with
// shading frame fr, material mat and light id light, and sets up the rays
// of its next face pass. True where the path ends here.
template <int KIND>
__device__ bool shade(Path& q, const Tables& tb, const Params& p, const Frame& fr, int mat,
                      int light) {
  const int L = p.L, max_lf = p.max_lf;
  const float bias = p.trace_bias;
  ++q.bounces;
  const V3 wi = to_local(fr, neg(q.d));
  const Mat mp = load_mat(tb, mat);

  // (1) an emitter hit ends the lane (integrator.cpp:226-231)
  if (light >= 0) {
    const float* info = tb.linfo + light * 16;
    if (dot(fr.n, neg(normalize(sub(q.pt, q.o)))) > 0.0f) {
      q.li = v3(q.li.x + q.bw * q.tpt.x * info[0], q.li.y + q.bw * q.tpt.y * info[1],
                q.li.z + q.bw * q.tpt.z * info[2]);
    }
    return true;
  }

  // (2) Russian roulette from depth 3 (integrator.cpp:237-244)
  if (q.depth >= 3) {
    const float u_rr = draw_1d<KIND>(q.rs, p);
    const float prob =
        fminf(fmaxf(fmaxf(q.tpt.x, q.tpt.y), q.tpt.z) * q.eta * q.eta, 0.95f);
    if (prob <= u_rr) return true;
    q.tpt = scale(q.tpt, 1.0f / fmaxf(prob, 1e-9f));
  }

  // (3) NEE with MIS (integrator.cpp:247-294); the shadow ray is traced in
  // the next face pass, beside the BSDF ray (see the header note)
  q.shad = false;
  if (L > 0) {
    const float u_pick = draw_1d<KIND>(q.rs, p);
    const float u_tri = draw_1d<KIND>(q.rs, p);
    const float u_a = draw_1d<KIND>(q.rs, p);
    const float u_b = draw_1d<KIND>(q.rs, p);
    const int pick = (int)clampf(floorf((float)L * u_pick), 0.0f, (float)(L - 1));
    const float* cdf = tb.lcdf + pick * (max_lf + 1);
    int tri = 0;
    for (int k = 1; k < max_lf; ++k) tri += u_tri >= cdf[k] ? 1 : 0;
    const float* r = tb.ltris + (pick * max_lf + tri) * LTRI_F;
    const float su0 = sqrtf(u_a);
    const float wu = 1.0f - su0;
    const float wv = u_b * su0;
    const V3 lp0 = ld3(r), le1 = ld3(r + 3), le2 = ld3(r + 6), ln0 = ld3(r + 9);
    const V3 lp = add(add(lp0, scale(le1, wu)), scale(le2, wv));
    const V3 ln =
        r[22] > 0.0f
            ? add(ln0, add(scale(sub(ld3(r + 12), ln0), wu), scale(sub(ld3(r + 15), ln0), wv)))
            : normalize(cross(le1, le2));
    const V3 to_l = sub(lp, q.pt);
    const float dist = norm(to_l);
    const V3 nee_wi = scale(to_l, 1.0f / fmaxf(dist, 1e-9f));
    const float cos_th = dot(ln, neg(nee_wi));
    const float nee_pdf =
        cos_th > 0.0f ? r[21] * dist * dist / fmaxf(cos_th, 1e-9f) : 0.0f;
    const bool valid = nee_pdf > 0.0f && isfinite(nee_pdf) && cos_th > 0.0f;
    const float inv_npdf = 1.0f / fmaxf(nee_pdf, 1e-9f);
    const V3 ls = valid ? v3(r[18] * inv_npdf, r[19] * inv_npdf, r[20] * inv_npdf)
                        : v3(0.0f, 0.0f, 0.0f);
    V3 f_nee;
    float pdf_b;
    bsdf_eval_pdf(mp, wi, to_local(fr, nee_wi), q.accum, f_nee, pdf_b);
    const float w_light = power_heuristic(nee_pdf, pdf_b);
    // Ls *= numLights (scene.h:56: the pick's pdf is 1/numLights)
    const float nl = (float)L;
    const V3 cch = v3(q.tpt.x * ls.x * nl * f_nee.x * w_light,
                      q.tpt.y * ls.y * nl * f_nee.y * w_light,
                      q.tpt.z * ls.z * nl * f_nee.z * w_light);
    // only a shadow ray that can add light is traced and counted
    if (cch.x != 0.0f || cch.y != 0.0f || cch.z != 0.0f) {
      q.nrays += 1.0f;
      q.shad = true;
      q.sd = nee_wi;
      q.smaxt = dist - bias;
      q.cch = cch;
    }
  }

  // (4) roughness regularization (integrator.cpp:297-301)
  if (p.regularization) {
    const float reg = mp.btype == KISS ? mp.roughness : 0.0f;
    q.accum = q.accum + reg * p.acc_scale;
  }

  // (5) BSDF sample (integrator.cpp:303-309); a zero weight ends the path
  // after its shadow ray's pass
  const float s1 = draw_1d<KIND>(q.rs, p);
  float s2a, s2b;
  draw_2d<KIND>(q.rs, p, s2a, s2b);
  const BsdfSample bs = bsdf_sample(mp, wi, s1, s2a, s2b, q.accum);
  q.tpt = v3(q.tpt.x * bs.w.x, q.tpt.y * bs.w.y, q.tpt.z * bs.w.z);
  q.eta = q.eta * bs.eta;
  q.near = bs.w.x > 0.0f || bs.w.y > 0.0f || bs.w.z > 0.0f;
  if (q.near) {
    q.d = to_world(fr, bs.wo);
    q.stage = BOUNCE;
    q.disc = bs.disc;
    q.bpdf = bs.pdf;
  }
  return !q.near && !q.shad;
}

// After a face pass, for a thread that holds a path: the shadow ray's
// light, then the nearest hit, then the new vertex's shading. Every path
// takes the same code whatever its stage, so a warp whose threads are at
// different stages does not run the work of each stage in turn.
template <int KIND>
__device__ void advance(Path& q, const Tables& tb, const Params& p, Hit h) {
  // an unoccluded shadow ray adds its light before any later term into li
  if (q.shad) q.li = add(q.li, q.cch);
  q.shad = false;
  bool done = !q.near;  // where not, the BSDF weight was 0: the pass held
                        // the shadow ray only
  if (!done) {
    q.tests += p.F;
    if (q.stage == BOUNCE) q.nrays += 1.0f;
    if (q.stage == PUNCH && h.face < 0) h = q.light_hit;  // a missed re-cast
                                                           // keeps the light hit
    if (h.face < 0) {
      // (6) a BSDF ray that misses sees the background (integrator.cpp:312-331);
      // a camera ray that misses ends the lane
      if (q.stage == BOUNCE && p.has_background && isfinite(q.d.x) && isfinite(q.d.y) &&
          isfinite(q.d.z)) {
        q.li = v3(q.li.x + q.tpt.x * p.bg_r, q.li.y + q.tpt.y * p.bg_g,
                  q.li.z + q.tpt.z * p.bg_b);
      }
      done = true;
    } else {
      const Surf s = fetch(tb, h);
      const V3 new_p = hanika_point(s);
      const Frame fr = shading_frame(s);
      if (q.stage == CAMERA && p.needs_punch && s.light >= 0 && !s.light_pv) {
        // punch-through of a primary-invisible light (integrator.cpp:213-220):
        // the re-cast is the next pass's nearest-hit ray
        q.light_hit = h;
        q.pt = add(new_p, scale(q.d, p.trace_bias));
        q.stage = PUNCH;
      } else {
        if (q.stage == BOUNCE) {
          // the MIS weight an emitter hit by this ray gets (1 after a
          // discrete lobe)
          if (q.disc) {
            q.bw = 1.0f;
          } else if (s.light >= 0) {
            const V3 to_p = sub(new_p, q.pt);
            const float dist_n = norm(to_p);
            const float cos_n = dot(fr.n, neg(scale(to_p, 1.0f / fmaxf(dist_n, 1e-9f))));
            const float lpdf =
                cos_n > 0.0f
                    ? tb.linfo[s.light * 16 + 3] * dist_n * dist_n / fmaxf(cos_n, 1e-9f)
                    : 0.0f;
            q.bw = power_heuristic(q.bpdf, lpdf);
          }
          q.o = q.pt;
          ++q.depth;
        }
        q.pt = new_p;
        done = q.depth >= p.max_depth || shade<KIND>(q, tb, p, fr, s.mat, s.light);
      }
    }
  }
  if (done) end_path(q, p);
}

template <int KIND, int MIN_BLOCKS>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS) megakernel(Params p) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int F = p.F, L = p.L, max_lf = p.max_lf;
  const int n_ltri = L > 0 ? L * max_lf : 1;
  const int n_linfo = L > 0 ? L : 1;
  const int n_lcdf = n_linfo * (max_lf + 1);
  Tables tb;
  tb.geo = sm;
  tb.attr = tb.geo + F * GEO_F;
  tb.mats = tb.attr + F * GEO_F;
  tb.ltris = tb.mats + p.M * 16;
  tb.linfo = tb.ltris + n_ltri * LTRI_F;
  tb.lcdf = tb.linfo + n_linfo * 16;
  {
    const float* src[6] = {p.geo, p.attr, p.mats, p.ltris, p.linfo, p.lcdf};
    const int len[6] = {F * GEO_F, F * GEO_F, p.M * 16, n_ltri * LTRI_F,
                        n_linfo * 16, n_lcdf};
    float* dst = sm;
    for (int k = 0; k < 6; ++k) {
      for (int j = threadIdx.x; j < len[k]; j += blockDim.x) dst[j] = src[k][j];
      dst += len[k];
    }
  }
  __syncthreads();

  const unsigned lane_bit = 1u << (threadIdx.x & 31u);
  Path q;
  q.lane = -1;
  q.near = q.shad = false;
  bool exhausted = false;  // no lane is left for this thread
  unsigned long long iters = 0, live_threads = 0;
  for (;;) {
    // the warp-uniform top of an iteration: threads without a path take
    // the next lanes, one counter update for the warp
    __syncwarp();
    const unsigned want = __ballot_sync(FULL_MASK, q.lane < 0 && !exhausted);
    if (want != 0u) {
      unsigned first;
      if (p.refill) {
        const int leader = __ffs(want) - 1;
        unsigned base = 0u;
        if ((threadIdx.x & 31u) == (unsigned)leader) {
          base = atomicAdd(p.next_lane, (unsigned)__popc(want));
        }
        base = __shfl_sync(FULL_MASK, base, leader);
        first = base + (unsigned)__popc(want & (lane_bit - 1u));
      } else {  // one lane a thread over the full grid
        first = blockIdx.x * blockDim.x + threadIdx.x;
      }
      if (want & lane_bit) {
        if (first < (unsigned)p.n) {
          start_path(q, p, (int)first);
        } else {
          exhausted = true;
        }
        if (!p.refill) exhausted = true;
      }
    }
    const unsigned live = __ballot_sync(FULL_MASK, q.lane >= 0);
    if (live == 0u) break;
    ++iters;
    live_threads += (unsigned)__popc(live);

    const Hit h = face_pass(q, tb, F, p.trace_bias);
    if (q.lane >= 0) advance<KIND>(q, tb, p, h);
  }
  if ((threadIdx.x & 31u) == 0u) {
    atomicAdd(p.slots, 32ull * iters);
    atomicAdd(p.slots + 1, live_threads);
  }
}

template <int KIND>
const void* kernel_for(int min_blocks) {
  switch (min_blocks) {
    case 1:
      return (const void*)megakernel<KIND, 1>;
    case 2:
      return (const void*)megakernel<KIND, 2>;
    case 3:
      return (const void*)megakernel<KIND, 3>;
    case 4:
      return (const void*)megakernel<KIND, 4>;
    case 5:
      return (const void*)megakernel<KIND, 5>;
    case 6:
      return (const void*)megakernel<KIND, 6>;
    case 8:
      return (const void*)megakernel<KIND, 8>;
    default:
      return nullptr;
  }
}

// the instance for the sampler and __launch_bounds__(THREADS, min_blocks)
const void* kernel_for(int sampler, int min_blocks) {
  switch (sampler) {
    case INDEPENDENT:
      return kernel_for<INDEPENDENT>(min_blocks);
    case STRATIFIED:
      return kernel_for<STRATIFIED>(min_blocks);
    case CORRELATED:
      return kernel_for<CORRELATED>(min_blocks);
    default:
      return nullptr;
  }
}

size_t smem_bytes(const Params& p) {
  const int n_ltri = p.L > 0 ? p.L * p.max_lf : 1;
  const int n_linfo = p.L > 0 ? p.L : 1;
  const size_t floats = (size_t)2 * p.F * GEO_F + (size_t)p.M * 16 +
                        (size_t)n_ltri * LTRI_F + (size_t)n_linfo * 16 +
                        (size_t)n_linfo * (p.max_lf + 1);
  return floats * sizeof(float);
}

}  // namespace

extern "C" {

// Launches the megakernel on `stream`: the instance for p->sampler and
// p->min_blocks, over the full grid (p->refill = 0) or over the blocks that
// fit on the card at once (p->refill = 1). p->next_lane and p->slots must
// be zero. Returns the launch's CUDA error code (0 = launched).
int kz_megakernel(const Params* p, cudaStream_t stream) {
  if (p->n <= 0) return 0;
  const void* fn = kernel_for(p->sampler, p->min_blocks);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(*p);
  int blocks = (p->n + THREADS - 1) / THREADS;
  if (p->refill) {
    int per_sm = 0, dev = 0, sms = 0;
    cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, THREADS, smem);
    if (e == cudaSuccess) e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    const int resident = (per_sm > 0 ? per_sm : 1) * sms;
    blocks = blocks < resident ? blocks : resident;
  }
  Params prm = *p;
  void* args[] = {&prm};
  const cudaError_t e = cudaLaunchKernel(fn, dim3(blocks), dim3(THREADS), args, smem, stream);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

// info = [registers a thread, local-memory bytes a thread (spills and
// stack), blocks resident on an SM] of the instance kz_megakernel would
// launch for *p. Returns a CUDA error code (0 = ok).
int kz_megakernel_info(const Params* p, int* info) {
  const void* fn = kernel_for(p->sampler, p->min_blocks);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  int per_sm = 0;
  cudaError_t e = cudaFuncGetAttributes(&attr, fn);
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, THREADS, smem_bytes(*p));
  }
  if (e != cudaSuccess) return (int)e;
  info[0] = attr.numRegs;
  info[1] = (int)attr.localSizeBytes;
  info[2] = per_sm;
  return 0;
}

const char* kz_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
