// A bounce's shade stage on Hopper (sm_90a): one thread per lane, from the
// trace kernel K1's rows to the columns the ordered permute gathers.
//
// Replaces no TPU kernel: kazen_tpu shades with XLA-fused elementwise code
// (kazen_tpu/integrate/path_mis.py's bounce body), which the port's plain
// PyTorch version runs as ~1,600 separate launches a bounce on the card.
// Same contract as the plain version, integrate/path_mis.py:_shade_plain:
// the hit's rows, the lane state after _shade_prologue and the bounce's
// seven uniforms -> the (n, 24) float columns [p, nee_wi, smaxt, pd, li,
// throughput, eta, accum, contrib, bsdf_pdf, discrete, alive], the light
// pick and the hit cluster (int64, for path_mis.packet_key), and the
// bounce's shadow-ray and path-ray counts. Per lane, in _bounce_ordered's
// order: shade prep from the rows (closed-form u, v; Hanika's point; the
// shading frame), the emitter hit with its MIS weight, Russian roulette,
// NEE (uniform light pick, an area-light sample from the light's CDF, the
// BSDF's eval and pdf, the power heuristic, the shadow ray's maxt), the
// roughness regularization and the BSDF sample.
//
// The design answers what the plain version spends: every BSDF type's
// branch on every lane, each op a launch with its operands in device
// memory. Here a lane branches on its own material type and evaluates only
// its own lobe, and its intermediates stay in registers: a lane reads its
// rows (34 floats), its state and uniforms (~25 floats) and writes 24
// floats and two int64, about 330 bytes, so device-memory bytes bound it
// (0.20 ms at 2.07 M lanes and 3.35 TB/s; lab/shade_check.py:lane_bytes);
// the tables (materials, light triangles, the light CDF) are a few KB and
// stay in L1/L2. It runs at ~27% of that bound (0.74 ms a con-2 launch):
// a lane's chain of IEEE divisions, square roots and sin/cos, and the
// warp's lanes on other lobes, hold it, at 96 registers.
//
// Bit for bit with the plain version on the card. Built with -fmad=false,
// so every product and sum rounds on its own, as PyTorch's separate ops do;
// the code keeps the plain version's order of operations (including the
// left-to-right association of every Python expression), its f32 constants
// (each Python float rounded once to f32, as a scalar operand is), its
// NaN-propagating clamp and max, and the reciprocal that `1.0 / x` is.
// A 3-vector dot product (`(a * b).sum(-1)`) is a reduction whose order
// PyTorch's CUDA reduce picks from the product's memory layout: over the
// fastest dimension two threads add (x0 + x2) + x1; over a strided one a
// thread adds (x0 + x1) + x2; each starts from +0, so a zero sum is +0.
// DOT_A and DOT_B are those two orders, and each call site takes the one its
// operands' layout gives in the plain version (the hit's trace rows are
// transposed views, so the shade prep's products are strided; vectors made
// with torch.stack are not). The one site whose layout depends on an input,
// to_local(-ray_d), takes it from the wrapper (wi_order_b).
//
// Image-textured material fields and the normal map are template instances
// (TEX, NMAP) picked from the scene (shade/bounce_kernel.py): an untextured
// scene runs the instance without them. TEX fetches each textured field of
// the lane's material once, at the top, from the flat texel pool
// (textures._eval_leaf: bilinear with periodic wrap, the v-flip and uv
// scale; trilinear across the mip chain at the footprint's lod; the mean of
// the anisotropic probes), in the plain version's order of operations.
// NMAP resolves the normalmap wrapper as bsdf.make_ctx does: the nested
// material's row, the frame perturbed by the tangent-space normal (its
// reduce orders taken from its operands' layouts, as above), the
// directions re-expressed in it, and the unperturbed fallback where the
// mapped normal faces away from wi. The footprint (lod and the major uv
// half-axis, path_mis._texture_footprint) is derived here from the hit's t,
// dpdu, dpdv and shading normal, for the lanes that fetch a textured field.
// The untextured instance keeps 96 registers and no spill; TEX takes 112,
// TEX with NMAP 122 (no spill); NMAP alone 96 with 12 bytes of spill.
//
// ROUGH adds the Beckmann lobes of roughconductor (per-channel eta and k),
// roughplastic (the ks split of a diffuse and a glossy lobe) and
// roughdielectric (reflect and refract, Walter's alpha scaling for the
// sampled normal, the eta^2 Jacobian), from a second material table (alpha,
// eta, k). ENV adds the importance-sampled environment as the last NEE
// stratum (lights.sample_env_light): the row and column CDFs' searches, the
// texel's solid-angle pdf, the background along the sampled direction
// (lights.background_radiance: the lat-long lookup at the background's own
// level of detail), an unbounded shadow ray and the power heuristic against
// the BSDF's pdf. A scene with either runs the instance with every switch
// on (the other switches then cost a branch on the material type).
//
// Everything above the launches' banner compiles for the host too, against
// a header that defines the CUDA names for one host thread:
// tests/shade_host.py runs the kernel body on the CPU.
//
// Not used, and why: shared memory (the tables are read through the cache
// and each lane reads its own rows once); warp-level material sorting (the
// lanes arrive in the permute's packet order, which groups clusters, and so
// mostly materials, already); tensor cores (f32 bit-exact contract); CUDA
// texture objects (their filtering is not the plain version's arithmetic).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// Field for field the ctypes structure _Params of shade/bounce_kernel.py.
struct Params {
  const float* rows;  // (40, n) K1's rows, a row every rows_s floats
  long long rows_s;
  const float* ray_o;
  long long o_sl, o_sc;  // element strides: lane, component
  const float* ray_d;
  long long d_sl, d_sc;
  const float* li;
  long long li_sl, li_sc;
  const float* thr;
  long long thr_sl, thr_sc;
  const float* eta;
  long long eta_s;
  const float* bsdf_pdf;
  long long pdf_s;
  const float* accum;
  long long acc_s;
  const unsigned char* alive;     // (n,) bool
  const unsigned char* discrete;  // (n,) bool
  const float* u_rr;    // (n,), unused without RR
  const float* u_pick;  // (n,) x4, unused without lights
  const float* u_tri;
  const float* u_a;
  const float* u_b;
  const float* s1;  // (n,)
  const float* s2;  // (n, 2)
  const float* mats;   // (M, 16)
  const float* ltris;  // (Lr * maxlf, 18) [p0 p1 p2 n0 n1 n2]
  const float* linfo;  // (Lr, 8) [radiance 3, inv_area, has_n]
  const float* lcdf;   // (Lr, maxlf + 1)
  const int* mat_i;    // (M, 8) [tex_base, tex_metallic, tex_roughness, tex_normal, nested]
  const long long* tex_i;  // (T, 19) [ttype, offset, width, height, n_levels, mip_offset 14]
  const float* tex_f;      // (T, 4) [uv_scale, const rgb]
  const float* texels;     // (P, 3)
  const float* beck;       // (M, 8) [alpha, eta 3, k 3, 0] of the rough* lobes
  const float* env_row;    // (Eh + 1,) the environment's row marginal CDF
  const float* env_col;    // (Eh, Ew + 1) its per-row conditional CDFs
  const float* env_pdf;    // (Eh, Ew) solid-angle pdf of each texel
  const float* bg;         // (8,) [bg_color 3, intensity, texture id, 0 0 0]
  float* out;          // (n, 24)
  long long* pick;     // (n,)
  long long* cluster;  // (n,)
  unsigned long long* counts;  // (2,) += shadow rays, path rays
  int n, L, maxlf, n_strat, draw_rr, regularization, wi_order_b;
  int tex_fields;  // textured fields: FIELD_* bits
  int footprint;   // 0 level-0 bilinear, 1 trilinear at lod, 2 and the probes
  int nmap;        // a normalmap material is present
  float trace_bias, acc_scale;
  float pixel_cone;  // one pixel's footprint angle (static.pixel_cone as f32)
  int rough;       // a rough* material is present
  int env;         // the environment is the last NEE stratum (pick == L)
  int env_h, env_w, env_steps;  // the tables' size; the column search's steps
  int bg_mode;     // the background lookup: 0 level-0 bilinear, 1 trilinear
  float bg_lod;    // at this level of detail
};

namespace {

constexpr int THREADS = 128;
constexpr int OUT_COLS = 24;
constexpr int LTRI_F = 18;
constexpr int LINFO_F = 8;
constexpr int MAT_F = 16;
constexpr int MAT_I = 8;
constexpr int TEX_I = 5 + 14;  // + scene/compiler.py's MAX_MIP_LEVELS
constexpr int TEX_F = 4;
constexpr int TEX_IMAGE = 0, TEX_CONSTANT = 1;
constexpr int N_ANISO_PROBES = 4;
enum { FIELD_BASE = 1, FIELD_METALLIC = 2, FIELD_ROUGHNESS = 4, FIELD_NORMAL = 8 };
constexpr double PI_D = 3.14159265358979323846;
// Python floats as PyTorch hands them to a kernel: rounded once to f32
constexpr float INV_PI = (float)(1.0 / PI_D);
constexpr float PI_F = (float)PI_D;
constexpr float TWO_PI = (float)(2.0 * PI_D);
constexpr float PI_4 = (float)(PI_D / 4.0);
constexpr float PI_2 = (float)(PI_D / 2.0);
constexpr float INV_TWOPI = (float)(0.5 / PI_D);
constexpr float INF_F = 3.0e38f;  // path_mis.INF
constexpr int BECK_F = 8;

enum { DIFFUSE = 0, DIELECTRIC = 1, MIRROR = 2, LAMBERTIAN = 3, GGX = 4, ROUGHCONDUCTOR = 5,
       ROUGHPLASTIC = 6, ROUGHDIELECTRIC = 7, KISS = 8, NORMALMAP = 9 };

// ---------------------------------------------------------------------------
// scalars with PyTorch's semantics
// ---------------------------------------------------------------------------

// torch.clamp(x, min=lo) / (max=hi) / (lo, hi): NaN stays NaN
__device__ __forceinline__ float clamp_lo(float x, float lo) {
  return isnan(x) ? x : fmaxf(x, lo);
}
__device__ __forceinline__ float clamp_hi(float x, float hi) {
  return isnan(x) ? x : fminf(x, hi);
}
__device__ __forceinline__ float clamp2(float x, float lo, float hi) {
  return isnan(x) ? x : fminf(fmaxf(x, lo), hi);
}
// amax over a 3-vector: NaN propagates
__device__ __forceinline__ float nanmax(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fmaxf(a, b));
}
__device__ __forceinline__ float rcp(float x) { return 1.0f / x; }

// ---------------------------------------------------------------------------
// 3-vectors
// ---------------------------------------------------------------------------

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 v3(float x, float y, float z) { return {x, y, z}; }
__device__ __forceinline__ V3 add(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
__device__ __forceinline__ V3 sub(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ V3 mul(V3 a, V3 b) { return {a.x * b.x, a.y * b.y, a.z * b.z}; }
__device__ __forceinline__ V3 scale(V3 a, float s) { return {a.x * s, a.y * s, a.z * s}; }
__device__ __forceinline__ V3 divs(V3 a, float s) { return {a.x / s, a.y / s, a.z / s}; }
__device__ __forceinline__ V3 neg(V3 a) { return {-a.x, -a.y, -a.z}; }
__device__ __forceinline__ V3 sel(bool m, V3 a, V3 b) { return m ? a : b; }
__device__ __forceinline__ V3 mask3(bool m, V3 a) { return m ? a : v3(0.0f, 0.0f, 0.0f); }
__device__ __forceinline__ bool all_finite(V3 a) {
  return isfinite(a.x) && isfinite(a.y) && isfinite(a.z);
}
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}

enum Order { DOT_A = 0, DOT_B = 1 };

// (a * b).sum(-1) in the reduce order of the product's layout (see above)
template <int O>
__device__ __forceinline__ float dot(V3 a, V3 b) {
  const float x0 = a.x * b.x, x1 = a.y * b.y, x2 = a.z * b.z;
  return (O == DOT_A ? ((x0 + x2) + x1) : ((x0 + x1) + x2)) + 0.0f;
}
__device__ __forceinline__ float dot_o(bool b_order, V3 a, V3 b) {
  return b_order ? dot<DOT_B>(a, b) : dot<DOT_A>(a, b);
}
// km.norm: sqrt(clamp(dot(v, v), min=1e-18))
template <int O>
__device__ __forceinline__ float norm(V3 v) {
  return sqrtf(clamp_lo(dot<O>(v, v), (float)1e-18));
}
// km.normalize: v / clamp(norm(v), min=1e-9)
template <int O>
__device__ __forceinline__ V3 normalize(V3 v) {
  return divs(v, clamp_lo(norm<O>(v), (float)1e-9));
}

struct Frame {
  V3 s, t, n;
};

// Frame.to_local(v): each dot takes v's layout
__device__ __forceinline__ V3 to_local(bool b_order, const Frame& f, V3 v) {
  return {dot_o(b_order, v, f.s), dot_o(b_order, v, f.t), dot_o(b_order, v, f.n)};
}
// Frame.to_world(v): s * v.x + t * v.y + n * v.z
__device__ __forceinline__ V3 to_world(const Frame& f, V3 v) {
  return add(add(scale(f.s, v.x), scale(f.t, v.y)), scale(f.n, v.z));
}

// km.coordinate_system: (b, c) with b = c x a
__device__ __forceinline__ void coordinate_system(V3 a, V3& b, V3& c) {
  const bool use_x = fabsf(a.x) > fabsf(a.y);
  const float inv_len_x = rcp(sqrtf((a.x * a.x + a.z * a.z) + (float)1e-30));
  const float inv_len_y = rcp(sqrtf((a.y * a.y + a.z * a.z) + (float)1e-30));
  c = use_x ? v3(a.z * inv_len_x, 0.0f, -a.x * inv_len_x)
            : v3(0.0f, a.z * inv_len_y, -a.y * inv_len_y);
  b = cross(c, a);
}

// km.reflect(wi, n): 2 (wi . n) n - wi
__device__ __forceinline__ V3 reflect(V3 wi, V3 n) {
  return sub(scale(n, 2.0f * dot<DOT_A>(wi, n)), wi);
}

// path_mis.power_heuristic
__device__ __forceinline__ float power_heuristic(float a, float b) {
  const float a2 = a * a;
  const float b2 = b * b;
  const bool ok = a2 > 0.0f;
  return ok ? a2 / (ok ? a2 + b2 : 1.0f) : 0.0f;
}

// ---------------------------------------------------------------------------
// warps and Fresnel (core/warp.py, core/math.py)
// ---------------------------------------------------------------------------

__device__ V3 cosine_hemisphere(float s0, float s1) {
  const float r1 = 2.0f * s0 - 1.0f;
  const float r2 = 2.0f * s1 - 1.0f;
  const bool use_r1 = r1 * r1 > r2 * r2;
  float r = use_r1 ? r1 : r2;
  const float safe_r1 = r1 == 0.0f ? 1.0f : r1;
  const float safe_r2 = r2 == 0.0f ? 1.0f : r2;
  float phi = use_r1 ? PI_4 * (r2 / safe_r1) : PI_2 - (r1 / safe_r2) * PI_4;
  const bool degen = r1 == 0.0f && r2 == 0.0f;
  r = degen ? 0.0f : r;
  phi = degen ? 0.0f : phi;
  const float px = r * cosf(phi);
  const float py = r * sinf(phi);
  float z = sqrtf(clamp_lo((1.0f - px * px) - py * py, 0.0f));
  z = z == 0.0f ? (float)1e-10 : z;
  return {px, py, z};
}

// km.fresnel: unpolarized dielectric reflectance
__device__ float fresnel(float cos_i, float ext_ior, float int_ior) {
  const bool enter = cos_i >= 0.0f;
  const float eta_i = enter ? ext_ior : int_ior;
  const float eta_t = enter ? int_ior : ext_ior;
  const float ci = fabsf(cos_i);
  const float eta = eta_i / eta_t;
  const float sin_t2 = (eta * eta) * (1.0f - ci * ci);
  const bool ok = sin_t2 < 1.0f;
  const float ct = sqrtf(ok ? 1.0f - sin_t2 : 1.0f);
  const float rs = (eta_i * ci - eta_t * ct) / (eta_i * ci + eta_t * ct);
  const float rp = (eta_t * ci - eta_i * ct) / (eta_t * ci + eta_i * ct);
  const float f = ok ? 0.5f * (rs * rs + rp * rp) : 1.0f;
  return ext_ior == int_ior ? 0.0f : f;
}

// km.refract(wi, n, eta); wi here is -wi_local (a stacked vector: DOT_A)
__device__ V3 refract(V3 wi, V3 n, float eta) {
  const float cos_i = dot<DOT_A>(wi, n);
  const float eta_eff = cos_i < 0.0f ? rcp(eta) : eta;
  const float cos_t2 = 1.0f - (1.0f - cos_i * cos_i) * (eta_eff * eta_eff);
  const float sign = cos_i >= 0.0f ? 1.0f : -1.0f;
  const bool ok = cos_t2 > 0.0f;
  const float ct = sqrtf(ok ? cos_t2 : 1.0f);
  const float k = (-cos_i) * eta_eff + sign * ct;
  const V3 wt = add(scale(n, k), scale(wi, eta_eff));
  return mask3(ok, wt);
}

// ---------------------------------------------------------------------------
// GGX-Smith (shade/ggx.py); every product here is of stacked vectors: DOT_A
// ---------------------------------------------------------------------------

struct Mat {
  int btype;
  V3 base;
  float metallic, roughness, aniso, specular, spec_tint, clearcoat, cc_rough, sheen,
      sheen_tint, int_ior, ext_ior;
};

__device__ __forceinline__ Mat load_mat(const float* mats, long long m) {
  const float* r = mats + m * MAT_F;
  Mat mp;
  mp.btype = (int)r[0];
  mp.base = v3(r[1], r[2], r[3]);
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

// roughness_to_alpha: clamp(r^2, min=1e-3) * (1 +- a)
__device__ __forceinline__ void r2a(float roughness, float aniso, float& ax, float& ay) {
  const float a = clamp_lo(roughness * roughness, (float)1e-3);
  ax = a * (1.0f + aniso);
  ay = a * (1.0f - aniso);
}

__device__ __forceinline__ float smith_lambda(V3 v, float ax, float ay) {
  const float vz2 = clamp_lo(v.z * v.z, (float)1e-9);
  const float sq = ((ax * ax) * (v.x * v.x) + (ay * ay) * (v.y * v.y)) / vz2;
  return (sqrtf(sq + 1.0f) + -1.0f) * 0.5f;
}

__device__ __forceinline__ float smith_g1(V3 v, V3 h, float ax, float ay) {
  const float g = rcp(1.0f + smith_lambda(v, ax, ay));
  return dot<DOT_A>(v, h) <= 0.0f ? 0.0f : g;
}

__device__ __forceinline__ float smith_g2(V3 v, V3 l, V3 h, float ax, float ay) {
  const float g = rcp((1.0f + smith_lambda(v, ax, ay)) + smith_lambda(l, ax, ay));
  return (dot<DOT_A>(v, h) <= 0.0f || dot<DOT_A>(l, h) < 0.0f) ? 0.0f : g;
}

__device__ __forceinline__ float ggx_ndf(V3 h, float ax, float ay) {
  const float ell = ((h.x * h.x) / (ax * ax) + (h.y * h.y) / (ay * ay)) + h.z * h.z;
  return rcp(((PI_F * ax) * ay) * (ell * ell));
}

__device__ __forceinline__ float vndf(V3 v, V3 h, float ax, float ay) {
  const float vdoth = dot<DOT_A>(v, h);
  const float d = ggx_ndf(h, ax, ay);
  const float g1 = smith_g1(v, h, ax, ay);
  const float vz = v.z == 0.0f ? (float)1e-9 : v.z;
  const float val = ((d * g1) * vdoth) / vz;
  return vdoth <= 0.0f ? 0.0f : val;
}

// sample_vndf (Heitz 2018)
__device__ V3 sample_vndf(V3 v, float ax, float ay, float u0, float u1) {
  const V3 vh = normalize<DOT_A>(v3(ax * v.x, ay * v.y, v.z));
  const float lensq = vh.x * vh.x + vh.y * vh.y;
  const float inv_len = rcp(sqrtf(clamp_lo(lensq, (float)1e-9)));
  const V3 t1 = lensq > 0.0f ? v3(-vh.y * inv_len, vh.x * inv_len, 0.0f)
                             : v3(1.0f, 0.0f, 0.0f);
  const V3 t2 = normalize<DOT_A>(cross(vh, t1));
  const float r = sqrtf(u0);
  const float phi = TWO_PI * u1;
  const float p1 = r * cosf(phi);
  float p2 = r * sinf(phi);
  const float s = 0.5f * (1.0f + vh.z);
  p2 = (1.0f - s) * sqrtf(clamp_lo(1.0f - p1 * p1, 0.0f)) + s * p2;
  const float pz = sqrtf(clamp_lo((1.0f - p1 * p1) - p2 * p2, 0.0f));
  const V3 nh = add(add(scale(t1, p1), scale(t2, p2)), scale(vh, pz));
  return normalize<DOT_A>(v3(ax * nh.x, ay * nh.y, clamp_lo(nh.z, (float)1e-6)));
}

// schlick_fresnel(f0, cos): f0 + (1 - f0) pow(clamp(1 - cos, 0, 1), 5)
__device__ __forceinline__ V3 schlick3(V3 f0, float cos_theta) {
  const float w = powf(clamp2(1.0f - cos_theta, 0.0f, 1.0f), 5.0f);
  return {f0.x + (1.0f - f0.x) * w, f0.y + (1.0f - f0.y) * w, f0.z + (1.0f - f0.z) * w};
}

// eval_ggx_smith_brdf's brdf (h given: the caller's normalize(v + l))
__device__ __forceinline__ V3 ggx_smith_brdf(V3 v, V3 l, V3 h, V3 f0, float ax, float ay) {
  const float d = ggx_ndf(h, ax, ay);
  const float g = smith_g2(v, l, h, ax, ay);
  const V3 f = schlick3(f0, dot<DOT_A>(v, h));
  const float denom = (4.0f * fabsf(v.z)) * fabsf(l.z);
  const V3 brdf = scale(f, (d * g) / clamp_lo(denom, (float)1e-9));
  return mask3(!(v.z * l.z < 0.0f), brdf);
}

// ---------------------------------------------------------------------------
// BSDFs (shade/bsdf.py), local frame; each lane runs its own type only
// ---------------------------------------------------------------------------

// _ggx_eval and _ggx_pdf
__device__ void ggx_eval_pdf(const Mat& mp, V3 wi, V3 wo, V3& f, float& pdf) {
  float ax, ay;
  r2a(mp.roughness, mp.aniso, ax, ay);
  const V3 h = normalize<DOT_A>(add(wi, wo));
  const bool m = wi.z > 0.0f && wo.z > 0.0f;
  const V3 brdf = ggx_smith_brdf(wi, wo, h, mp.base, ax, ay);
  f = mask3(m, scale(brdf, wo.z));
  const float denom = 4.0f * dot<DOT_A>(wi, h);
  const float p = vndf(wi, h, ax, ay) / (denom == 0.0f ? (float)1e-9 : denom);
  pdf = m ? p : 0.0f;
}

__device__ __forceinline__ float schlick_weight(float x) {
  x = clamp2(1.0f - x, 0.0f, 1.0f);
  return ((x * x) * (x * x)) * x;
}

// km.lerp(t, a, b) = (1 - t) a + t b
__device__ __forceinline__ float lerp(float t, float a, float b) {
  return (1.0f - t) * a + t * b;
}

// _kiss_eval_pdf (= _kiss_eval and _kiss_pdf, which share its arithmetic)
__device__ void kiss_eval_pdf(const Mat& mp, V3 v, V3 l, float accum, V3& f_out,
                              float& pdf_out) {
  const V3 h = normalize<DOT_A>(add(v, l));
  const V3 cdlin = mp.base;
  const float metallic = mp.metallic;
  const float roughness = clamp_hi(mp.roughness + accum, 1.0f);
  float ax, ay, cax, cay, pax, pay;
  r2a(roughness, mp.aniso, ax, ay);
  const float cc_rough = lerp(mp.cc_rough, (float)0.01, (float)0.3);
  r2a(cc_rough, mp.aniso, cax, cay);
  r2a(cc_rough, 0.0f, pax, pay);

  const float cdlum =
      (cdlin.x * (float)0.212671 + cdlin.y * (float)0.715160) + cdlin.z * (float)0.072169;
  const bool pos = cdlum > 0.0f;
  const float lum = clamp_lo(cdlum, (float)1e-9);
  const V3 ctint = pos ? divs(cdlin, lum) : v3(1.0f, 1.0f, 1.0f);
  const float spec08 = (float)0.08 * mp.specular;
  const float st = mp.spec_tint;
  const V3 ctintmix = v3(spec08 * ((1.0f - st) * 1.0f + st * ctint.x),
                         spec08 * ((1.0f - st) * 1.0f + st * ctint.y),
                         spec08 * ((1.0f - st) * 1.0f + st * ctint.z));
  const V3 cspec0 = v3(lerp(metallic, ctintmix.x, cdlin.x), lerp(metallic, ctintmix.y, cdlin.y),
                       lerp(metallic, ctintmix.z, cdlin.z));
  const float fl = schlick_weight(l.z);
  const float fv = schlick_weight(v.z);
  const float fh = schlick_weight(dot<DOT_A>(l, h));
  const float cos_d = dot<DOT_A>(v, h);
  const float lambert = (1.0f - 0.5f * fl) * (1.0f - 0.5f * fv);
  const float rr = ((2.0f * roughness) * cos_d) * cos_d;
  const float retro = rr * ((fl + fv) + (fl * fv) * (rr - 1.0f));
  const float sht = mp.sheen_tint;
  const float fhs = fh * mp.sheen;
  const V3 fsheen = v3(fhs * ((1.0f - sht) * 1.0f + sht * ctint.x),
                       fhs * ((1.0f - sht) * 1.0f + sht * ctint.y),
                       fhs * ((1.0f - sht) * 1.0f + sht * ctint.z));

  const float denom = clamp_lo((4.0f * fabsf(v.z)) * fabsf(l.z), (float)1e-9);
  const bool opp = v.z * l.z < 0.0f;
  const float dg_spec = (ggx_ndf(h, ax, ay) * smith_g2(v, l, h, ax, ay)) / denom;
  const V3 spec = mask3(!opp, scale(schlick3(cspec0, cos_d), dg_spec));
  const float dg_cc = (ggx_ndf(h, cax, cay) * smith_g2(v, l, h, cax, cay)) / denom;
  const float f04 = (float)0.04;
  const V3 cc = mask3(!opp, scale(schlick3(v3(f04, f04, f04), cos_d), dg_cc));
  const float cc_w = 0.25f * mp.clearcoat;
  const float kd = INV_PI * (lambert + retro);
  const float one_m = 1.0f - metallic;
  const V3 val = v3(
      ((one_m * (cdlin.x * kd + fsheen.x) + spec.x) + cc_w * cc.x) * l.z,
      ((one_m * (cdlin.y * kd + fsheen.y) + spec.y) + cc_w * cc.y) * l.z,
      ((one_m * (cdlin.z * kd + fsheen.z) + spec.z) + cc_w * cc.z) * l.z);

  const float diffuse_p = one_m * 0.5f;
  const float gtr2 = rcp(mp.clearcoat + 1.0f);
  float jac = 4.0f * dot<DOT_A>(v, h);
  jac = jac == 0.0f ? (float)1e-9 : jac;
  const float spec_pdf = vndf(v, h, ax, ay) / jac;
  const float coat_pdf = vndf(v, h, pax, pay) / jac;
  const float pdf = (diffuse_p * INV_PI) * l.z +
                    (1.0f - diffuse_p) * (gtr2 * spec_pdf + (1.0f - gtr2) * coat_pdf);
  const bool m = v.z > 0.0f && l.z > 0.0f;
  f_out = mask3(m, val);
  pdf_out = m ? pdf : 0.0f;
}

// ---------------------------------------------------------------------------
// Beckmann microfacets (shade/ggx.py, core/warp.py) and the rough* lobes
// (shade/bsdf.py); every product is of stacked vectors: DOT_A
// ---------------------------------------------------------------------------

struct Beck {
  float alpha;
  V3 eta, k;  // roughconductor's per-channel eta and k
};

__device__ __forceinline__ Beck load_beck(const float* beck, long long m) {
  const float* r = beck + m * BECK_F;
  return {r[0], v3(r[1], r[2], r[3]), v3(r[4], r[5], r[6])};
}

__device__ __forceinline__ bool is_rough(int btype) {
  return btype == ROUGHCONDUCTOR || btype == ROUGHPLASTIC || btype == ROUGHDIELECTRIC;
}

// ggx.beckmann_ndf
__device__ float beckmann_ndf(V3 m, float alpha) {
  const float ct = m.z;
  const float ct2 = clamp_lo(ct * ct, (float)1e-9);
  const float tan2 = clamp_lo(1.0f - ct * ct, 0.0f) / ct2;
  const float a2 = alpha * alpha;
  return expf(-tan2 / a2) / ((PI_F * a2) * (ct2 * ct2));
}

// ggx.smith_beckmann_g1
__device__ float beckmann_g1(V3 v, V3 m, float alpha) {
  const float ct = v.z;
  const float tan_theta =
      fabsf(sqrtf(clamp_lo(1.0f - ct * ct, 0.0f)) / (ct == 0.0f ? (float)1e-9 : ct));
  const float a = rcp(alpha * clamp_lo(tan_theta, (float)1e-2));
  const float a2 = a * a;
  const float approx = ((float)3.535 * a + (float)2.181 * a2) /
                       ((1.0f + (float)2.276 * a) + (float)2.577 * a2);
  const float g = (a >= (float)1.6 || tan_theta == 0.0f) ? 1.0f : approx;
  return dot<DOT_A>(v, m) * ct <= 0.0f ? 0.0f : g;
}

// warp.square_to_beckmann
__device__ V3 square_to_beckmann(float s0, float s1, float alpha) {
  const float phi = TWO_PI * s0;
  const float theta = atanf(alpha * sqrtf(logf(rcp(clamp_lo(1.0f - s1, (float)1e-9)))));
  const float st = sinf(theta), ct = cosf(theta);
  return {st * cosf(phi), st * sinf(phi), ct};
}

// warp.square_to_beckmann_pdf (x ** 3 is x * x * x on the card)
__device__ float beckmann_pdf(V3 m, float alpha) {
  const float ct = clamp2(m.z, -1.0f, 1.0f);
  const float tan2 = clamp_lo(1.0f - ct * ct, 0.0f) / clamp_lo(ct * ct, (float)1e-9);
  const float c = clamp_lo(ct, (float)1e-9);
  const float pdf = expf(-tan2 / (alpha * alpha)) / (((PI_F * alpha) * alpha) * ((c * c) * c));
  return ct > 0.0f ? pdf : 0.0f;
}

// ggx.fresnel_conductor, per channel
__device__ __forceinline__ float fresnel_cond1(float ci, float eta, float k) {
  const float tmp_f = eta * eta + k * k;
  const float ci2 = ci * ci;
  const float tmp = tmp_f * ci2;
  const float e2 = (2.0f * eta) * ci;
  const float rparl2 = ((tmp - e2) + 1.0f) / ((tmp + e2) + 1.0f);
  const float rperp2 = ((tmp_f - e2) + ci2) / ((tmp_f + e2) + ci2);
  return (rparl2 + rperp2) / 2.0f;
}

// km.fresnel_dielectric: (F, cos_theta_t)
__device__ float fresnel_dielectric(float cos_i, float eta, float& cos_t) {
  const float sc = cos_i > 0.0f ? rcp(eta) : eta;
  const float cos_t2 = 1.0f - (1.0f - cos_i * cos_i) * (sc * sc);
  const float ci = fabsf(cos_i);
  const bool ok = cos_t2 > 0.0f;
  const float ct = sqrtf(ok ? cos_t2 : 1.0f);
  const float rs = (ci - eta * ct) / (ci + eta * ct);
  const float rp = (eta * ci - ct) / (eta * ci + ct);
  cos_t = ok ? (cos_i > 0.0f ? -ct : ct) : 0.0f;
  return ok ? 0.5f * (rs * rs + rp * rp) : 1.0f;
}

// bsdf._safe_wh: the half-vector, +z where it is undefined
__device__ V3 safe_wh(V3 wi, V3 wo, bool& ok) {
  const V3 h = add(wi, wo);
  ok = wi.z > 0.0f && wo.z > 0.0f && dot<DOT_A>(h, h) > (float)1e-12;
  const V3 hs = ok ? h : v3(0.0f, 0.0f, 1.0f);
  return divs(hs, norm<DOT_A>(hs));
}

// _roughconductor_eval and _roughconductor_pdf
__device__ void conductor_eval_pdf(const Beck& bk, V3 wi, V3 wo, V3& f, float& pdf) {
  bool m;
  const V3 wh = safe_wh(wi, wo, m);
  const float c = dot<DOT_A>(wh, wo);
  const V3 fr = v3(fresnel_cond1(c, bk.eta.x, bk.k.x), fresnel_cond1(c, bk.eta.y, bk.k.y),
                   fresnel_cond1(c, bk.eta.z, bk.k.z));
  const float d = beckmann_ndf(wh, bk.alpha);
  const float g = beckmann_g1(wi, wh, bk.alpha) * beckmann_g1(wo, wh, bk.alpha);
  f = mask3(m, scale(fr, (d * g) / clamp_lo(4.0f * wi.z, (float)1e-9)));
  const float denom = 4.0f * c;
  const float safe = fabsf(denom) < (float)1e-9 ? (float)1e-9 : denom;
  pdf = m ? (d * wh.z) / safe : 0.0f;
}

// _roughplastic_eval and _roughplastic_pdf (ks = 1 - max of the diffuse colour)
__device__ void plastic_eval_pdf(const Mat& mp, const Beck& bk, V3 wi, V3 wo, V3& f,
                                 float& pdf) {
  bool m;
  const V3 wh = safe_wh(wi, wo, m);
  const float c = dot<DOT_A>(wh, wo);
  const float d = beckmann_ndf(wh, bk.alpha);
  const float fr = fresnel(c, mp.ext_ior, mp.int_ior);
  const float g = beckmann_g1(wo, wh, bk.alpha) * beckmann_g1(wi, wh, bk.alpha);
  const float ks = 1.0f - nanmax(nanmax(mp.base.x, mp.base.y), mp.base.z);
  const float spec = (((ks * d) * fr) * g) / clamp_lo(4.0f * wi.z, (float)1e-9);
  const float kd = INV_PI * wo.z;
  f = mask3(m, v3(mp.base.x * kd + spec, mp.base.y * kd + spec, mp.base.z * kd + spec));
  const float jh = rcp(clamp_lo(4.0f * fabsf(c), (float)1e-9));
  const float p = ((ks * d) * wh.z) * jh + ((1.0f - ks) * wo.z) * INV_PI;
  pdf = m ? p : 0.0f;
}

// _roughdielectric_eval and _roughdielectric_pdf
__device__ void rough_dielectric_eval_pdf(const Mat& mp, const Beck& bk, V3 wi, V3 wo, V3& f,
                                          float& pdf) {
  // _rd_half
  const float cos_i = wi.z;
  const float eta0 = mp.int_ior / mp.ext_ior;
  const bool is_reflect = cos_i * wo.z > 0.0f;
  const float eta = cos_i > 0.0f ? eta0 : mp.ext_ior / mp.int_ior;
  const V3 wm = normalize<DOT_A>(is_reflect ? add(wi, wo) : add(wi, scale(wo, eta)));
  // the pdf's Jacobian, on the unflipped half-vector
  const float o_m = dot<DOT_A>(wo, wm);
  const float dwm_r = rcp(o_m == 0.0f ? (float)1e-9 : 4.0f * o_m);
  const float sq = dot<DOT_A>(wi, wm) + eta * o_m;
  const float dwm_t = ((eta * eta) * o_m) / clamp_lo(sq * sq, (float)1e-9);
  // wm * sign(wm.z): torch.sign is 0 at +-0
  const float sg = (float)(0.0f < wm.z) - (float)(wm.z < 0.0f);
  const V3 wf = scale(wm, sg);
  const float i_f = dot<DOT_A>(wi, wf), o_f = dot<DOT_A>(wo, wf);
  float cos_t;
  const float fr = fresnel_dielectric(i_f, eta0, cos_t);
  const float d = beckmann_ndf(wf, bk.alpha);
  const float g = beckmann_g1(wo, wf, bk.alpha) * beckmann_g1(wi, wf, bk.alpha);
  const float refl = ((fr * g) * d) / clamp_lo(4.0f * fabsf(cos_i), (float)1e-9);
  const float denom = i_f + eta * o_f;
  const float cd2 = cos_i * (denom * denom);
  const float trans = fabsf(((((((1.0f - fr) * d) * g) * eta) * eta) * i_f) * o_f /
                            (cd2 == 0.0f ? (float)1e-9 : cd2));
  float val = is_reflect ? refl : trans;
  val = cos_i == 0.0f ? 0.0f : val;
  f = v3(val, val, val);
  const float prob = (d * wf.z) * (is_reflect ? fr : 1.0f - fr);
  pdf = fabsf(prob * (is_reflect ? dwm_r : dwm_t));
}

// the rough* lobes' eval and pdf
__device__ void rough_eval_pdf(const Mat& mp, const Beck& bk, V3 wi, V3 wo, V3& f,
                               float& pdf) {
  if (mp.btype == ROUGHCONDUCTOR)
    conductor_eval_pdf(bk, wi, wo, f, pdf);
  else if (mp.btype == ROUGHPLASTIC)
    plastic_eval_pdf(mp, bk, wi, wo, f, pdf);
  else
    rough_dielectric_eval_pdf(mp, bk, wi, wo, f, pdf);
}

// eval_pdf_base: (f * cos, pdf) of the lane's own type (rough* lobes:
// rough_eval_pdf)
__device__ void bsdf_eval_pdf(const Mat& mp, V3 wi, V3 wo, float accum, V3& f, float& pdf) {
  switch (mp.btype) {
    case DIFFUSE:
    case LAMBERTIAN: {
      const bool m = wi.z > 0.0f && wo.z > 0.0f;
      const float k = INV_PI * wo.z;
      f = mask3(m, scale(mp.base, k));
      pdf = m ? k : 0.0f;
      return;
    }
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

struct Sample {
  V3 wo, w;
  float eta, pdf;
  bool disc;
};

// the rough* lobes' samples (_roughconductor_sample, _roughplastic_sample,
// _roughdielectric_sample)
__device__ Sample rough_sample(const Mat& mp, const Beck& bk, V3 wi, float s1, float s2a,
                               float s2b) {
  Sample r;
  r.eta = 1.0f;
  r.disc = false;
  V3 val;
  if (mp.btype == ROUGHDIELECTRIC) {
    const float cos_i = wi.z;
    const float eta0 = mp.int_ior / mp.ext_ior;
    const float alpha = bk.alpha * ((float)1.2 - (float)0.2 * sqrtf(fabsf(cos_i)));
    const V3 wm = square_to_beckmann(s2a, s2b, alpha);
    const float pdf_m = beckmann_pdf(wm, alpha);
    const float i_m = dot<DOT_A>(wi, wm);
    float cos_t;
    const float fr = fresnel_dielectric(i_m, eta0, cos_t);
    const bool refl = s1 <= fr;
    // _rd_refract
    const float eta_eff = cos_t < 0.0f ? rcp(eta0) : eta0;
    const V3 refracted = sub(scale(wm, i_m * eta_eff + cos_t), scale(wi, eta_eff));
    r.wo = refl ? reflect(wi, wm) : refracted;
    r.eta = refl ? 1.0f : (cos_t < 0.0f ? eta0 : mp.ext_ior / mp.int_ior);
    const float cos_o = r.wo.z;
    const bool ok = (refl ? cos_i * cos_o > 0.0f : (cos_i * cos_o < 0.0f && cos_t != 0.0f)) &&
                    pdf_m > 0.0f;
    const float d = beckmann_ndf(wm, alpha);
    const float g = beckmann_g1(r.wo, wm, alpha) * beckmann_g1(wi, wm, alpha);
    const float pc = pdf_m * cos_i;
    const float w = fabsf(((d * g) * i_m) / (pc == 0.0f ? (float)1e-9 : pc));
    r.w = mask3(ok, v3(w, w, w));
    rough_dielectric_eval_pdf(mp, bk, wi, r.wo, val, r.pdf);
    return r;
  }
  const V3 wh = square_to_beckmann(s2a, s2b, bk.alpha);
  if (mp.btype == ROUGHCONDUCTOR) {
    r.wo = normalize<DOT_A>(reflect(wi, wh));
    conductor_eval_pdf(bk, wi, r.wo, val, r.pdf);
  } else {
    const float ks = 1.0f - nanmax(nanmax(mp.base.x, mp.base.y), mp.base.z);
    const V3 wo_spec = normalize<DOT_A>(reflect(wi, wh));
    r.wo = s1 < ks ? wo_spec : cosine_hemisphere(s2a, s2b);
    plastic_eval_pdf(mp, bk, wi, r.wo, val, r.pdf);
  }
  const V3 w = divs(val, clamp_lo(r.pdf, (float)1e-9));
  r.w = mask3(wi.z > 0.0f && r.wo.z > 0.0f && r.pdf > 0.0f, w);
  return r;
}

// the lane's own type's sample (rough* lobes: rough_sample)
__device__ Sample bsdf_sample(const Mat& mp, V3 wi, float s1, float s2a, float s2b,
                              float accum) {
  Sample r;
  r.eta = 1.0f;
  r.pdf = 0.0f;
  r.disc = false;
  switch (mp.btype) {
    case DIFFUSE:
    case LAMBERTIAN:
      r.wo = cosine_hemisphere(s2a, s2b);
      r.w = mask3(wi.z > 0.0f, mp.base);
      r.pdf = (wi.z > 0.0f && r.wo.z > 0.0f) ? INV_PI * r.wo.z : 0.0f;
      break;
    case MIRROR:
      r.wo = v3(-wi.x, -wi.y, wi.z);
      r.w = mask3(wi.z > 0.0f, v3(1.0f, 1.0f, 1.0f));
      r.disc = true;
      break;
    case DIELECTRIC: {
      const float cos_i = wi.z;
      const float fr = fresnel(cos_i, mp.ext_ior, mp.int_ior);
      const bool outside = cos_i >= 0.0f;
      const V3 n = v3(0.0f, 0.0f, outside ? 1.0f : -1.0f);
      const float factor = outside ? mp.int_ior / mp.ext_ior : mp.ext_ior / mp.int_ior;
      const V3 refracted = refract(neg(wi), n, factor);
      const bool reflect_it = s1 < fr;
      r.wo = reflect_it ? v3(-wi.x, -wi.y, wi.z) : refracted;
      r.eta = reflect_it ? 1.0f : mp.int_ior / mp.ext_ior;
      r.w = v3(1.0f, 1.0f, 1.0f);
      r.disc = true;
      break;
    }
    case GGX: {
      float ax, ay;
      r2a(mp.roughness, mp.aniso, ax, ay);
      r.wo = reflect(wi, sample_vndf(wi, ax, ay, s2a, s2b));
      V3 val;
      ggx_eval_pdf(mp, wi, r.wo, val, r.pdf);
      const V3 w = divs(val, clamp_lo(r.pdf, (float)1e-9));
      r.w = mask3(wi.z > 0.0f && r.wo.z > 0.0f && r.pdf > 0.0f, w);
      break;
    }
    case KISS: {
      const float diffuse = (1.0f - mp.metallic) * 0.5f;
      const float gtr2 = rcp(mp.clearcoat + 1.0f);
      const V3 wo_diff = cosine_hemisphere(s2a, s2b);
      const float s_rescaled = (s1 - diffuse) / clamp_lo(1.0f - diffuse, (float)1e-9);
      const bool flip = wi.z <= 0.0f;
      const V3 wi_f = flip ? neg(wi) : wi;
      float sax, say, cax, cay;
      r2a(mp.roughness, mp.aniso, sax, say);
      r2a(lerp(mp.cc_rough, (float)0.01, (float)0.3), 0.0f, cax, cay);
      const bool use_spec = s_rescaled < gtr2;
      V3 h = sample_vndf(wi_f, use_spec ? sax : cax, use_spec ? say : cay, s2a, s2b);
      h = flip ? neg(h) : h;
      const V3 wo_spec = normalize<DOT_A>(reflect(wi, h));
      r.wo = s1 < diffuse ? wo_diff : wo_spec;
      V3 val;
      kiss_eval_pdf(mp, wi, r.wo, accum, val, r.pdf);
      V3 w = divs(val, clamp_lo(r.pdf, (float)1e-9));
      const bool ok = wi.z > 0.0f && r.wo.z > 0.0f && r.pdf > (float)1e-4 && all_finite(r.wo);
      w = v3(isfinite(w.x) ? w.x : 0.0f, isfinite(w.y) ? w.y : 0.0f,
             isfinite(w.z) ? w.z : 0.0f);
      r.w = mask3(ok, w);
      break;
    }
    default:  // outside the kernel's class (supported_reason keeps it out)
      r.wo = v3(0.0f, 0.0f, 0.0f);
      r.w = v3(0.0f, 0.0f, 0.0f);
  }
  return r;
}

// ---------------------------------------------------------------------------
// image textures (shade/textures.py), a leaf node over the flat texel pool
// ---------------------------------------------------------------------------

// torch.minimum: NaN propagates
__device__ __forceinline__ float nanmin(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fminf(a, b));
}
// torch.remainder of int64: the sign of the divisor
__device__ __forceinline__ long long pymod(long long a, long long b) {
  long long r = a % b;
  return (r != 0 && ((r < 0) != (b < 0))) ? r + b : r;
}

// _bilinear_wh: a bilinear fetch at texel coordinates (x, y), periodic wrap
__device__ V3 bilinear(const float* texels, long long off, long long w, long long h, float x,
                       float y) {
  x = x - 0.5f;
  y = y - 0.5f;
  const float x0 = floorf(x), y0 = floorf(y);
  const float fx = x - x0, fy = y - y0;
  long long x0i = (long long)x0, y0i = (long long)y0;
  const long long x1i = pymod(x0i + 1, w), y1i = pymod(y0i + 1, h);
  x0i = pymod(x0i, w);
  y0i = pymod(y0i, h);
  const float* c00 = texels + 3 * (off + y0i * w + x0i);
  const float* c10 = texels + 3 * (off + y0i * w + x1i);
  const float* c01 = texels + 3 * (off + y1i * w + x0i);
  const float* c11 = texels + 3 * (off + y1i * w + x1i);
  const float gx = 1.0f - fx, gy = 1.0f - fy;
  float r[3];
#pragma unroll
  for (int c = 0; c < 3; ++c)
    r[c] = (((__ldg(c00 + c) * gx) * gy + (__ldg(c10 + c) * fx) * gy) +
            (__ldg(c01 + c) * gx) * fy) + (__ldg(c11 + c) * fx) * fy;
  return {r[0], r[1], r[2]};
}

// _bilinear_level: the chain's level l, max(1, w >> l) x max(1, h >> l)
__device__ __forceinline__ V3 bilinear_level(const float* texels, const long long* ti,
                                             long long level, float u, float v) {
  const long long wl = ti[2] >> level, hl = ti[3] >> level;
  const long long w = wl < 1 ? 1 : wl, h = hl < 1 ? 1 : hl;
  return bilinear(texels, ti[5 + level], w, h, u * (float)w, v * (float)h);
}

// _eval_leaf of node tid at (uvx, uvy) with the lane's footprint: an image
// (bilinear, trilinear at lod, or the mean of the probes along the major
// half-axis, as p.footprint says; BG: the background's lookup, as
// p.bg_mode says), a constant, or 0 for a composite node
template <bool BG = false>
__device__ V3 eval_leaf(const Params& p, long long tid, float uvx, float uvy, float lod,
                        float adu, float adv) {
  const int mode = BG ? p.bg_mode : p.footprint;
  const long long* ti = p.tex_i + tid * TEX_I;
  const float* tf = p.tex_f + tid * TEX_F;
  const float uvs = tf[0];  // uv scale
  const long long w = ti[2], h = ti[3];
  V3 img;
  if (mode == 0) {
    const float u = uvx * uvs;
    const float v = (1.0f - uvy) * uvs;
    img = bilinear(p.texels, ti[1], w, h, u * (float)w, v * (float)h);
  } else {
    const long long n_levels = ti[4];
    const float res = (float)(w > h ? w : h);
    float lam = lod + log2f(res * clamp_lo(uvs, (float)1e-9));
    lam = nanmin(clamp_lo(lam, 0.0f), (float)(n_levels - 1));
    const long long l0 = (long long)floorf(lam);
    const long long l1 = l0 + 1 < n_levels - 1 ? l0 + 1 : n_levels - 1;
    const float f = lam - (float)l0;
    const float g = 1.0f - f;
    // trilinear(uv + t * aniso), t in [-1, 1] as f32; one probe without it
    const int probes = mode == 2 ? N_ANISO_PROBES : 1;
    img = v3(0.0f, 0.0f, 0.0f);
    for (int k = 0; k < probes; ++k) {
      const float t = (float)(2.0 * k / (N_ANISO_PROBES - 1) - 1.0);
      const float pu = probes > 1 ? uvx + t * adu : uvx;
      const float pv = probes > 1 ? uvy + t * adv : uvy;
      const float u = pu * uvs;
      const float v = (1.0f - pv) * uvs;
      const V3 a = bilinear_level(p.texels, ti, l0, u, v);
      const V3 b = bilinear_level(p.texels, ti, l1, u, v);
      const V3 tri = add(scale(a, g), scale(b, f));
      img = probes > 1 ? add(img, tri) : tri;
    }
    if (probes > 1) img = scale(img, 1.0f / N_ANISO_PROBES);
  }
  const long long tt = ti[0];
  if (tt == TEX_IMAGE) return img;
  if (tt == TEX_CONSTANT) return v3(tf[1], tf[2], tf[3]);
  return v3(0.0f, 0.0f, 0.0f);
}

// eval_texture of a material field: its node where tex_id >= 0, else const
__device__ __forceinline__ V3 field_value(const Params& p, int tex_id, V3 cst, float uvx,
                                          float uvy, float lod, float adu, float adv) {
  return tex_id >= 0 ? eval_leaf(p, tex_id, uvx, uvy, lod, adu, adv) : cst;
}

// ---------------------------------------------------------------------------
// the importance-sampled environment (shade/lights.py)
// ---------------------------------------------------------------------------

// background_radiance along d: the lat-long lookup (textures.dir_to_uv) of
// the background's image at its own level of detail, or its constant, times
// its intensity; 0 along a non-finite direction
__device__ V3 background(const Params& p, V3 d) {
  const long long tid = (long long)p.bg[4];
  V3 col = v3(p.bg[0], p.bg[1], p.bg[2]);
  if (tid >= 0) {
    const float u = (atan2f(d.x, d.z) + PI_F) * INV_TWOPI;
    const float v = (asinf(clamp2(d.y, -1.0f, 1.0f)) + PI_2) * INV_PI;
    col = eval_leaf<true>(p, tid, u, v, p.bg_lod, 0.0f, 0.0f);
  }
  return mask3(all_finite(d), scale(col, p.bg[3]));
}

// sample_env_light at (u1, u2): the direction, its pdf and radiance / pdf.
// A division by the table's size is a product with its reciprocal, as
// PyTorch's CUDA division by a Python number.
__device__ void env_sample(const Params& p, float u1, float u2, V3& wi, float& pdf, V3& ls) {
  const long long eh = p.env_h, ew = p.env_w;
  const float* row = p.env_row;
  // searchsorted(row_cdf, u1, right=True) - 1, clamped to a row
  long long lo = 0, hi = eh + 1;
  while (lo < hi) {
    const long long mid = lo + ((hi - lo) >> 1);
    if (!(u1 < row[mid])) lo = mid + 1;
    else hi = mid;
  }
  long long i = lo - 1;
  i = i < 0 ? 0 : (i > eh - 1 ? eh - 1 : i);
  const float seg = clamp_lo(row[i + 1] - row[i], (float)1e-12);
  const float dv = clamp2((u1 - row[i]) / seg, 0.0f, 1.0f);
  const float v = ((float)i + dv) * (1.0f / (float)eh);
  // lights._bisect_rows over the row's conditional CDF
  const float* col = p.env_col + i * (ew + 1);
  long long jlo = 0, jhi = ew;
  for (int s = 0; s < p.env_steps; ++s) {
    const long long mid = (jlo + jhi) / 2;
    const bool right = u2 >= col[mid];
    jlo = right ? mid : jlo;
    jhi = right ? jhi : mid;
  }
  const long long j = jlo;
  const float segc = clamp_lo(col[j + 1] - col[j], (float)1e-12);
  const float du = clamp2((u2 - col[j]) / segc, 0.0f, 1.0f);
  const float u = ((float)j + du) * (1.0f / (float)ew);
  const float phi = u * TWO_PI - PI_F;
  const float lat = (v - 0.5f) * PI_F;
  const float cos_lat = cosf(lat);
  wi = v3(cos_lat * sinf(phi), sinf(lat), cos_lat * cosf(phi));
  pdf = p.env_pdf[i * ew + j];
  ls = mask3(pdf > 0.0f, divs(background(p, wi), clamp_lo(pdf, (float)1e-12)));
}

// path_mis._texture_footprint of one lane, for p.footprint 1 (lod) or 2 (and
// the major uv half-axis): t is the hit's (3e38 on a miss), dpdu, dpdv and n
// the interaction's after the uv_ok fallback, d the ray. Each dot takes the
// reduce order of its product's layout in the plain version: the
// interaction's dpdu and dpdv are the hit rows' strided layout (DOT_B), what
// derives from ray_d takes ray_d's (wi_b), the cross product is stacked
// (DOT_A).
__device__ void texture_footprint(const Params& p, bool wi_b, float t, V3 dpdu, V3 dpdv,
                                  V3 n, V3 d, float& lod, float& adu, float& adv) {
  const float foot = clamp_hi(fabsf(t), (float)1e8) * p.pixel_cone;
  const float iso_len =
      foot / clamp_lo(nanmin(norm<DOT_B>(dpdu), norm<DOT_B>(dpdv)), (float)1e-6);
  if (p.footprint == 1) {
    lod = log2f(clamp_lo(iso_len, (float)1e-9));
    return;
  }
  const float dn = dot_o(wi_b, d, n);
  const float cosv = clamp2(fabsf(dn), 1.0f / 16.0f, 1.0f);  // 1 / _MAX_ANISO
  const V3 tang = sub(d, scale(n, dn));
  const float tl = sqrtf(clamp_lo(dot_o(wi_b, tang, tang), (float)1e-18));
  const V3 m_dir = divs(tang, clamp_lo(tl, (float)1e-9));
  const V3 mi_dir = cross(n, m_dir);
  const float e = dot<DOT_B>(dpdu, dpdu);
  const float fg = dot<DOT_B>(dpdu, dpdv);
  const float g = dot<DOT_B>(dpdv, dpdv);
  const float det = e * g - fg * fg;
  const bool ok = det > (float)1e-16 && tl > (float)1e-5;
  const float det_s = ok ? det : 1.0f;
  const float half = 0.5f * foot;
  // uv_vec of the major and the minor half-axis
  const V3 wm = scale(m_dir, half / cosv);
  const float b1 = dot_o(wi_b, wm, dpdu), b2 = dot_o(wi_b, wm, dpdv);
  const V3 wn = scale(mi_dir, half);
  const float c1 = dot<DOT_A>(wn, dpdu), c2 = dot<DOT_A>(wn, dpdv);
  const float idu = (g * c1 - fg * c2) / det_s, idv = (e * c2 - fg * c1) / det_s;
  const float minor_len = 2.0f * sqrtf(clamp_lo(idu * idu + idv * idv, (float)1e-30));
  lod = log2f(clamp_lo(ok ? minor_len : iso_len, (float)1e-9));
  adu = ok ? (g * b1 - fg * b2) / det_s : 0.0f;
  adv = ok ? (e * b2 - fg * b1) / det_s : 0.0f;
}

// ---------------------------------------------------------------------------
// the stage
// ---------------------------------------------------------------------------

__device__ __forceinline__ V3 ld(const float* p, long long i, long long sl, long long sc) {
  const float* q = p + i * sl;
  return {q[0], q[sc], q[2 * sc]};
}

template <bool TEX, bool NMAP, bool ROUGH, bool ENV>
__global__ void __launch_bounds__(THREADS) shade_kernel(const Params p) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  const bool active = i < p.n;
  bool shadow = false, alive_out = false;
  if (active) {
    const float* rows = p.rows;
#define R(r) rows[(long long)(r) * p.rows_s + i]
    // (1) the hit: prepare_from_rows (shade/interaction.py)
    const bool valid = R(3) >= 0.0f;
    const V3 p0 = v3(R(4), R(5), R(6)), p1 = v3(R(7), R(8), R(9)), p2 = v3(R(10), R(11), R(12));
    const V3 n0 = v3(R(13), R(14), R(15)), n1 = v3(R(16), R(17), R(18)),
             n2 = v3(R(19), R(20), R(21));
    const float uv0x = R(22), uv0y = R(23), uv1x = R(24), uv1y = R(25), uv2x = R(26),
                uv2y = R(27);
    const long long light = (long long)(valid ? R(28) : -1.0f);
    const long long material = (long long)R(30);
    const bool has_n = R(31) > 0.0f;
    const bool has_uv = R(32) > 0.0f;
    const long long cluster = (long long)R(33);
#undef R
    const V3 o = ld(p.ray_o, i, p.o_sl, p.o_sc);
    const V3 d = ld(p.ray_d, i, p.d_sl, p.d_sc);
    // Moller-Trumbore's (u, v) against the chosen face (accel/intersect.py)
    const V3 e1 = sub(p1, p0), e2 = sub(p2, p0);
    const float pvx = d.y * e2.z - d.z * e2.y;
    const float pvy = d.z * e2.x - d.x * e2.z;
    const float pvz = d.x * e2.y - d.y * e2.x;
    const float det = (e1.x * pvx + e1.y * pvy) + e1.z * pvz;
    const bool det_ok = fabsf(det) > (float)1e-8;
    const float inv_det = rcp(det_ok ? det : 1.0f);
    const V3 tv = sub(o, p0);
    const float u = ((tv.x * pvx + tv.y * pvy) + tv.z * pvz) * inv_det;
    const float qvx = tv.y * e1.z - tv.z * e1.y;
    const float qvy = tv.z * e1.x - tv.x * e1.z;
    const float qvz = tv.x * e1.y - tv.y * e1.x;
    const float v = ((d.x * qvx + d.y * qvy) + d.z * qvz) * inv_det;
    // and its t, the footprint's distance (a miss's comes from row 0)
    const float t_mt = TEX ? ((e2.x * qvx + e2.y * qvy) + e2.z * qvz) * inv_det : 0.0f;
    // _prepare_core: Hanika's point, the shading frame
    const float b0 = (1.0f - u) - v, b1 = u, b2 = v;
    const V3 orig_p = add(add(scale(p0, b0), scale(p1, b1)), scale(p2, b2));
    V3 tu = sub(orig_p, p0), tw_v = sub(orig_p, p1), tw = sub(orig_p, p2);
    tu = sub(tu, scale(n0, clamp_hi(dot<DOT_B>(tu, n0), 0.0f)));
    tw_v = sub(tw_v, scale(n1, clamp_hi(dot<DOT_B>(tw_v, n1), 0.0f)));
    tw = sub(tw, scale(n2, clamp_hi(dot<DOT_B>(tw, n2), 0.0f)));
    const V3 p_h = add(add(add(orig_p, scale(tu, b0)), scale(tw_v, b1)), scale(tw, b2));
    const V3 hp = has_n ? p_h : orig_p;
    const V3 dp0 = e1, dp1 = e2;
    const V3 cr = cross(dp0, dp1);
    const V3 gn = normalize<DOT_A>(cr);
    const V3 sh_normal = add(add(scale(n0, b0), scale(n1, b1)), scale(n2, b2));
    const V3 sh_n = normalize<DOT_B>(sh_normal);
    const float duv0x = uv1x - uv0x, duv0y = uv1y - uv0y;
    const float duv1x = uv2x - uv0x, duv1y = uv2y - uv0y;
    const float determinant = duv0x * duv1y - duv0y * duv1x;
    const float cross_len = norm<DOT_A>(cr);
    const bool uv_ok = has_n && has_uv && cross_len > 0.0f && determinant > 0.0f;
    const float inv_d = rcp(determinant != 0.0f ? determinant : 1.0f);
    const V3 dpdu = scale(sub(scale(dp0, duv1y), scale(dp1, duv0y)), inv_d);
    const V3 s_uv = normalize<DOT_B>(sub(dpdu, scale(sh_normal, dot<DOT_B>(sh_normal, dpdu))));
    const V3 t_uv = normalize<DOT_A>(cross(sh_n, s_uv));
    const V3 n_fb = has_n ? sh_n : gn;
    V3 fb_s, fb_t;
    coordinate_system(n_fb, fb_s, fb_t);
    Frame fr;
    fr.s = sel(uv_ok, s_uv, fb_s);
    fr.t = sel(uv_ok, t_uv, fb_t);
    fr.n = sel(uv_ok, sh_n, n_fb);
    const V3 wi_local = to_local(p.wi_order_b != 0, fr, neg(d));
    // the lane's material: a normalmap's nested row (bsdf.make_ctx's mp_eff)
    Mat mp = load_mat(p.mats, material);
    long long eff = material;
    bool is_nm = false;
    if (NMAP && mp.btype == NORMALMAP) {
      is_nm = true;
      eff = p.mat_i[material * MAT_I + 4];
      mp = load_mat(p.mats, eff);
    }
    Beck bk = {0.0f, v3(0.0f, 0.0f, 0.0f), v3(0.0f, 0.0f, 0.0f)};
    if (ROUGH && is_rough(mp.btype)) bk = load_beck(p.beck, eff);
    // the hit's uv (_prepare_core) and footprint, for the texture fetches
    float uvx = 0.0f, uvy = 0.0f, lod = 0.0f, adu = 0.0f, adv = 0.0f;
    int nrm_id = -1;
    if (TEX) {
      uvx = has_uv ? (b0 * uv0x + b1 * uv1x) + b2 * uv2x : u;
      uvy = has_uv ? (b0 * uv0y + b1 * uv1y) + b2 * uv2y : v;
      // each textured field once: base for lambertian, GGX and kiss (diffuse
      // keeps its row's albedo), metallic and roughness for kiss, the normal
      // map's normal
      const int* ids = p.mat_i + eff * MAT_I;
      const bool kiss = mp.btype == KISS;
      const int base_id = (p.tex_fields & FIELD_BASE) &&
                                  (kiss || mp.btype == GGX || mp.btype == LAMBERTIAN)
                              ? ids[0]
                              : -1;
      const int met_id = (p.tex_fields & FIELD_METALLIC) && kiss ? ids[1] : -1;
      const int rough_id = (p.tex_fields & FIELD_ROUGHNESS) && kiss ? ids[2] : -1;
      if (NMAP && is_nm && (p.tex_fields & FIELD_NORMAL))
        nrm_id = p.mat_i[material * MAT_I + 3];
      // the footprint, only where a lane fetches a textured field
      if (p.footprint > 0 && (base_id >= 0 || met_id >= 0 || rough_id >= 0 || nrm_id >= 0)) {
        const float t_hit = valid ? t_mt : p.rows[i];
        const V3 dpdv = scale(add(scale(dp0, -duv1x), scale(dp1, duv0x)), inv_d);
        texture_footprint(p, p.wi_order_b != 0, t_hit, sel(uv_ok, dpdu, fb_s),
                          sel(uv_ok, dpdv, fb_t), fr.n, d, lod, adu, adv);
      }
      mp.base = field_value(p, base_id, mp.base, uvx, uvy, lod, adu, adv);
      mp.metallic = field_value(p, met_id, v3(mp.metallic, mp.metallic, mp.metallic), uvx,
                                uvy, lod, adu, adv).x;
      mp.roughness = field_value(p, rough_id, v3(mp.roughness, mp.roughness, mp.roughness),
                                 uvx, uvy, lod, adu, adv).x;
    }
    // the normal map's frame (bsdf.make_ctx); the orders are its operands'
    // layouts: n_t, wi and cross products are stacked (DOT_A), what comes
    // through sh_frame.to_world takes the hit rows' strided layout (DOT_B)
    bool perturbed = false;
    Frame pf = fr;
    V3 wi_eff = wi_local;
    if (NMAP && is_nm) {
      V3 rgb = v3(0.5f, 0.5f, 1.0f);
      if (TEX) rgb = field_value(p, nrm_id, rgb, uvx, uvy, lod, adu, adv);
      const V3 n_t = v3(2.0f * rgb.x - 1.0f, 2.0f * rgb.y - 1.0f, 2.0f * rgb.z - 1.0f);
      const bool shortcut = wi_local.z > 0.0f && dot<DOT_A>(n_t, wi_local) <= 0.0f;
      const V3 dpdu_h = sel(uv_ok, dpdu, fb_s);
      pf.n = normalize<DOT_B>(to_world(fr, normalize<DOT_A>(n_t)));
      pf.s = normalize<DOT_B>(sub(dpdu_h, scale(pf.n, dot<DOT_B>(pf.n, dpdu_h))));
      pf.t = normalize<DOT_A>(cross(pf.n, pf.s));
      perturbed = !shortcut;
      if (perturbed) wi_eff = to_local(true, pf, to_world(fr, wi_local));
    }

    V3 li = ld(p.li, i, p.li_sl, p.li_sc);
    V3 thr = ld(p.thr, i, p.thr_sl, p.thr_sc);
    float eta = p.eta[i * p.eta_s];
    float accum = p.accum[i * p.acc_s];
    bool alive = p.alive[i] != 0;

    // (2) emitter hit: the light's eval and pdf at the hit, MIS from the
    // carried (bsdf_pdf, discrete); the lane ends on a light
    {
      const long long lidx = light < 0 ? 0 : light;
      const float* lin = p.linfo + lidx * LINFO_F;
      const V3 to_p = sub(hp, o);
      const float dist = norm<DOT_B>(to_p);
      const V3 wi = divs(to_p, clamp_lo(dist, (float)1e-9));
      const float cos_p = dot<DOT_B>(fr.n, neg(wi));
      const float lpdf = cos_p > 0.0f
                             ? (lin[3] * (dist * dist)) / clamp_lo(cos_p, (float)1e-9)
                             : 0.0f;
      const V3 wi_e = normalize<DOT_B>(sub(hp, o));
      const float cos_e = dot<DOT_B>(fr.n, neg(wi_e));
      const V3 le = cos_e > 0.0f ? v3(lin[0], lin[1], lin[2]) : v3(0.0f, 0.0f, 0.0f);
      const float bw = p.discrete[i] ? 1.0f : power_heuristic(p.bsdf_pdf[i * p.pdf_s], lpdf);
      const bool hit_light = alive && light >= 0;
      li = add(li, mask3(hit_light, mul(scale(thr, bw), le)));
      alive = alive && !hit_light;
    }

    // (3) Russian roulette
    if (p.draw_rr) {
      const float prob =
          clamp_hi((nanmax(nanmax(thr.x, thr.y), thr.z) * eta) * eta, (float)0.95);
      alive = alive && !(prob <= p.u_rr[i]);
      thr = scale(thr, alive ? rcp(clamp_lo(prob, (float)1e-9)) : 1.0f);
    }

    // (4) NEE: uniform pick, an area-light sample (or the environment's),
    // the BSDF's eval and pdf
    long long pick = 0;
    V3 nee_wi = d;
    V3 contrib = v3(0.0f, 0.0f, 0.0f);
    float smaxt = -1.0f;
    if (p.n_strat > 0) {
      long long k = (long long)floorf((float)p.n_strat * p.u_pick[i]);
      pick = k < 0 ? 0 : (k > p.n_strat - 1 ? p.n_strat - 1 : k);
      V3 ls;
      float pdf, nee_maxt;
      if (ENV && p.env && pick == p.L) {
        env_sample(p, p.u_a[i], p.u_b[i], nee_wi, pdf, ls);
        nee_maxt = INF_F;
      } else {
        const long long l = pick > p.L - 1 ? p.L - 1 : pick;
        const float* cdf = p.lcdf + l * (p.maxlf + 1);
        const float ut = p.u_tri[i];
        int tri = 0;
        for (int j = 1; j < p.maxlf; ++j) tri += ut >= cdf[j] ? 1 : 0;
        tri = tri > p.maxlf - 1 ? p.maxlf - 1 : tri;
        const float su0 = sqrtf(p.u_a[i]);
        const float lu = 1.0f - su0;
        const float lv = p.u_b[i] * su0;
        const float* t = p.ltris + (l * p.maxlf + tri) * LTRI_F;
        const V3 q0 = v3(t[0], t[1], t[2]), q1 = v3(t[3], t[4], t[5]), q2 = v3(t[6], t[7], t[8]);
        const V3 m0 = v3(t[9], t[10], t[11]), m1 = v3(t[12], t[13], t[14]),
                 m2 = v3(t[15], t[16], t[17]);
        const V3 lp = add(add(q0, scale(sub(q1, q0), lu)), scale(sub(q2, q0), lv));
        const float* lin = p.linfo + l * LINFO_F;
        const V3 n_interp = add(add(m0, scale(sub(m1, m0), lu)), scale(sub(m2, m0), lv));
        const V3 n_geo = normalize<DOT_A>(cross(sub(q1, q0), sub(q2, q0)));
        const V3 ln = lin[4] > 0.0f ? n_interp : n_geo;
        const V3 to_light = sub(lp, hp);
        const float dist = norm<DOT_A>(to_light);
        const V3 wi = divs(to_light, clamp_lo(dist, (float)1e-9));
        const float cosl = dot<DOT_A>(ln, neg(wi));
        pdf = cosl > 0.0f ? (lin[3] * (dist * dist)) / clamp_lo(cosl, (float)1e-9) : 0.0f;
        const V3 rad = cosl > 0.0f ? v3(lin[0], lin[1], lin[2]) : v3(0.0f, 0.0f, 0.0f);
        const bool lvalid = pdf > 0.0f && isfinite(pdf);
        ls = mask3(lvalid, divs(rad, clamp_lo(pdf, (float)1e-9)));
        nee_wi = wi;
        nee_maxt = dist - p.trace_bias;
      }
      const V3 wo_local = to_local(false, fr, nee_wi);
      V3 wo_eff = wo_local;
      bool flipped = false;  // the perturbation flips wo's hemisphere
      if (NMAP && perturbed) {
        wo_eff = to_local(true, pf, to_world(fr, wo_local));
        flipped = wo_local.z * wo_eff.z <= 0.0f;
      }
      V3 f;
      float pdf_b;
      if (ROUGH && is_rough(mp.btype))
        rough_eval_pdf(mp, bk, wi_eff, wo_eff, f, pdf_b);
      else
        bsdf_eval_pdf(mp, wi_eff, wo_eff, accum, f, pdf_b);
      if (flipped) {
        f = v3(0.0f, 0.0f, 0.0f);
        pdf_b = 0.0f;
      }
      const float w_light = power_heuristic(pdf, pdf_b);
      contrib = mask3(alive, scale(mul(mul(thr, scale(ls, (float)p.n_strat)), f), w_light));
      shadow = alive && (contrib.x != 0.0f || contrib.y != 0.0f || contrib.z != 0.0f);
      smaxt = shadow ? nee_maxt : -1.0f;
    }

    // (5) roughness regularization: kiss returns its roughness, others 0
    if (p.regularization) {
      const float reg = mp.btype == KISS ? mp.roughness : 0.0f;
      accum = alive ? accum + reg * p.acc_scale : accum;
    }

    // (6) BSDF sample
    Sample res = ROUGH && is_rough(mp.btype)
                     ? rough_sample(mp, bk, wi_eff, p.s1[i], p.s2[2 * i], p.s2[2 * i + 1])
                     : bsdf_sample(mp, wi_eff, p.s1[i], p.s2[2 * i], p.s2[2 * i + 1], accum);
    if (NMAP && perturbed) {
      // back through the perturbed frame; a hemisphere flip gets nothing
      const V3 wo_back = to_local(true, fr, to_world(pf, res.wo));
      const bool flipped = wo_back.z * res.wo.z <= 0.0f;
      res.wo = wo_back;
      if (flipped) {
        res.w = v3(0.0f, 0.0f, 0.0f);
        res.pdf = 0.0f;
      }
    }
    thr = alive ? mul(thr, res.w) : thr;
    eta = alive ? eta * res.eta : eta;
    alive = alive && (res.w.x > 0.0f || res.w.y > 0.0f || res.w.z > 0.0f);
    const V3 pd = to_world(fr, res.wo);
    alive_out = alive;

    float* out = p.out + i * OUT_COLS;
    const float cols[OUT_COLS] = {
        hp.x, hp.y, hp.z, nee_wi.x, nee_wi.y, nee_wi.z, smaxt, pd.x, pd.y, pd.z,
        li.x, li.y, li.z, thr.x, thr.y, thr.z, eta, accum, contrib.x, contrib.y, contrib.z,
        res.pdf, res.disc ? 1.0f : 0.0f, alive ? 1.0f : 0.0f};
#pragma unroll
    for (int c = 0; c < OUT_COLS; ++c) out[c] = cols[c];
    p.pick[i] = pick;
    p.cluster[i] = cluster;
  }
  // the bounce's ray counts, one atomic a warp
  const unsigned n_shadow = __popc(__ballot_sync(0xFFFFFFFFu, shadow));
  const unsigned n_path = __popc(__ballot_sync(0xFFFFFFFFu, alive_out));
  if ((threadIdx.x & 31) == 0) {
    if (n_shadow) atomicAdd(p.counts, (unsigned long long)n_shadow);
    if (n_path) atomicAdd(p.counts + 1, (unsigned long long)n_path);
  }
}

}  // namespace

// ---------------------------------------------------------------------------
// the launches (nvcc only)
// ---------------------------------------------------------------------------

extern "C" int kz_shade_bounce(const Params* prm, void* stream) {
  if (prm->n <= 0) return 0;
  const long long blocks = ((long long)prm->n + THREADS - 1) / THREADS;
  cudaStream_t s = (cudaStream_t)stream;
  const bool tex = prm->tex_fields != 0, nmap = prm->nmap != 0;
  if (prm->rough || prm->env)
    shade_kernel<true, true, true, true><<<(unsigned)blocks, THREADS, 0, s>>>(*prm);
  else if (tex && nmap)
    shade_kernel<true, true, false, false><<<(unsigned)blocks, THREADS, 0, s>>>(*prm);
  else if (tex)
    shade_kernel<true, false, false, false><<<(unsigned)blocks, THREADS, 0, s>>>(*prm);
  else if (nmap)
    shade_kernel<false, true, false, false><<<(unsigned)blocks, THREADS, 0, s>>>(*prm);
  else
    shade_kernel<false, false, false, false><<<(unsigned)blocks, THREADS, 0, s>>>(*prm);
  return (int)cudaGetLastError();
}

extern "C" const char* kz_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
