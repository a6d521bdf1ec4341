// Fused shading step per ray (kernel K2), Heitz BSDF.
//
// Replaces logipathtracer_tpu/ops/pallas/shade.py::shade_pallas ->
// _kernel / _shade_tile in all its variants.  Per lane: miss writes
// mask * env (an assignment) and kills the path; otherwise emission with
// the pre-bounce mask, barycentrics, shading normal, tangent basis, lobe
// pick, the Heitz multiple-scattering walk of at most max_order orders,
// and Russian roulette, with the parity-hash or Threefry draws in the
// JAX package's order.  The arithmetic repeats the plain PyTorch version
// (ops/kernels/shade.py::shade_plain, the port of the jnp shade path)
// operation by operation.
//
// Optional inputs, each a null pointer when unused (the lane then takes
// the form without textures / NEE, unchanged):
//  * mat [R, 10]: material overrides resolved by the texture prologue
//    (the TPU kernel's tex variant): base rgba, emission, metallic,
//    roughness (floored before its texture multiply: not floored here),
//    transmission.  ffm [R, 3] + nmap [R]: the normal-mapped front-face
//    normal; `outside` and the emission MIS weight keep the unmapped n.
//  * light_tris [L, 16] + light_cdf [L] + prev_pdf [R] (the nee
//    variant): diffuse lanes draw r1, r2, r3 after the lobe pick, pick a
//    light by binary search (searchsorted-left, clamped to L - 1; the
//    table stays in global memory, no light-count cap), sample a point on
//    it, and the walk estimates f * cos toward it.  Outputs: prev_pdf',
//    the shadow query (origin, direction, t_lim) and the pending
//    contribution; lanes without a light sample get the parked query
//    (origin 1e30, direction +z, t_lim 1, contribution 0).
// The TPU kernel's tri_sel variant is this gather form: every lane reads
// its own tri_shade[tri] row.
//
// Design.  What bounds the work is instruction issue: per hit lane a
// prologue of ~250 operations (three powf, five normalizations with
// IEEE divides) and per walk order ~150-300 (logf, sinf/cosf, divides,
// sqrt, two to five draws); the bytes are ~140 per lane.  One thread
// per lane in pool order, kBlock lanes a block: a dead lane copies
// through and a miss writes the environment, neither reading tri_shade;
// a hit lane shades whole in registers, the prologue (its tri_shade row
// in float4 loads: rows are 256 B), the walk and the epilogue.  One
// copy of the per-lane code serves the three lobes: a copy per lobe
// (inlined libm and Threefry each) thrashed the instruction cache.  On
// an H100 (PERF.md) two forms that regroup the lanes lost to this one:
// queuing a block's hit lanes by lobe before they shade cost 4-8% on
// the wavefront's dense, coherence-sorted pools and tied over a
// megakernel sample; re-queuing the walking lanes every k orders (walk
// state in shared memory, two barriers a round) lost more, since nearly
// every block holds a lane that walks 4-8 orders and its rounds held
// the block's other warps at barriers.
//
// Built with -fmad=false and no fast math: products and sums round as
// in the plain version, divides and sqrt are IEEE, and min/max/clamp
// propagate NaN as torch does.  logf/expf/sinf/cosf/powf are the
// device libm's and may differ from the host's by a few ulps; sincosf
// gives sinf's and cosf's bits on every float (lpt_sincos_probe, held
// by a card test).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kInf = 3.4e38f;
constexpr double kPi = 3.141592653589;  // shaders/common/constants.glsl:5
constexpr float kPiF = static_cast<float>(kPi);
constexpr float kPark = 1e30f;
constexpr float kTLimScale = static_cast<float>(1.0 - 1e-3);
constexpr int kMatCols = 10;
constexpr int kBlock = 256;    // lanes of a block, one thread each
constexpr int kMinBlocks = 2;  // blocks an SM must fit (registers)

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 mk(float x, float y, float z) {
  V3 r;
  r.x = x;
  r.y = y;
  r.z = z;
  return r;
}
__device__ __forceinline__ V3 neg(V3 a) { return mk(-a.x, -a.y, -a.z); }
__device__ __forceinline__ float dot(V3 a, V3 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return mk(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
            a.x * b.y - a.y * b.x);
}
__device__ __forceinline__ float nan_f() { return __int_as_float(0x7fc00000); }
// torch.clamp(x, min=lo): NaN stays NaN.
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return x != x ? x : fmaxf(x, lo);
}
// torch.clamp(x, max=hi): NaN stays NaN.
__device__ __forceinline__ float clamp_max(float x, float hi) {
  return x != x ? x : fminf(x, hi);
}
__device__ __forceinline__ float clamp01(float x) {
  return x != x ? x : fminf(fmaxf(x, 0.0f), 1.0f);
}
__device__ __forceinline__ float nmax(float a, float b) {
  return (a != a || b != b) ? nan_f() : fmaxf(a, b);
}
// v / sqrt(max(|v|^2, 1e-38)), each component divided.
__device__ __forceinline__ V3 normalize(V3 v) {
  const float s = sqrtf(clamp_min(dot(v, v), 1e-38f));
  return mk(v.x / s, v.y / s, v.z / s);
}
__device__ __forceinline__ V3 load3(const float* p, int i) {
  return mk(p[3 * i], p[3 * i + 1], p[3 * i + 2]);
}
__device__ __forceinline__ void store3(float* p, int i, V3 v) {
  p[3 * i] = v.x;
  p[3 * i + 1] = v.y;
  p[3 * i + 2] = v.z;
}

// ---- RNG: state words as u32; masked draws are plain branches --------
__device__ __forceinline__ float rand_parity(uint32_t& s0, uint32_t& s1) {
  s0 += 1u;
  s1 += 1u;
  const uint32_t mul = 1103515245u;
  const uint32_t qx = mul * ((s0 >> 1) ^ s1);
  const uint32_t qy = mul * ((s1 >> 1) ^ s0);
  const uint32_t n = mul * (qx ^ (qy >> 3));
  return __uint2float_rn(n) * 2.3283064365386963e-10f;  // 2^-32
}

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

__device__ __forceinline__ float rand_threefry(uint32_t& s0, uint32_t& s1) {
  s0 += 1u;
  s1 += 1u;
  const uint32_t ks0 = 0xCAFEF00Du, ks1 = 0xBAADF00Du;
  const uint32_t ks2 = 0x1BD11BDAu ^ ks0 ^ ks1;
  const uint32_t ka[5] = {ks1, ks2, ks0, ks1, ks2};
  const uint32_t kb[5] = {ks2, ks0, ks1, ks2, ks0};
  const int rot[8] = {13, 15, 26, 6, 17, 29, 16, 24};
  uint32_t x0 = s0 + ks0, x1 = s1 + ks1;
#pragma unroll
  for (int block = 0; block < 5; ++block) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x0 = x0 + x1;
      x1 = rotl(x1, rot[4 * (block % 2) + i]);
      x1 = x1 ^ x0;
    }
    x0 = x0 + ka[block];
    x1 = x1 + kb[block] + static_cast<uint32_t>(block + 1);
  }
  return static_cast<float>(x0 >> 8) * 5.9604644775390625e-8f;  // 2^-24
}

// The RNG is a run-time choice, uniform over the launch: a template on
// it made the front end take two minutes over this file.
__device__ __forceinline__ float draw(bool parity, uint32_t& s0,
                                      uint32_t& s1) {
  return parity ? rand_parity(s0, s1) : rand_threefry(s0, s1);
}

__device__ __forceinline__ float srgb(float c) {
  return c <= 0.04045f ? c / 12.92f : powf((c + 0.055f) / 1.055f, 2.4f);
}

// GGX visible-normal sample (ops/bsdf.py sample_vndf).
__device__ __forceinline__ V3 sample_vndf(V3 ve, float alpha, float r1,
                                          float r2) {
  const V3 vh = normalize(mk(alpha * ve.x, alpha * ve.y, ve.z));
  const V3 t1 = vh.z < 1.0f ? normalize(cross(mk(0.0f, 0.0f, 1.0f), vh))
                            : mk(1.0f, 0.0f, 0.0f);
  const V3 t2 = cross(vh, t1);
  const float r = sqrtf(r1);
  const float phi = static_cast<float>(2.0 * kPi) * r2;
  float sin_phi, cos_phi;
  sincosf(phi, &sin_phi, &cos_phi);
  const float t1c = r * cos_phi;
  float t2c = r * sin_phi;
  const float s = 0.5f * (1.0f + vh.z);
  t2c = (1.0f - s) * sqrtf(clamp_min(1.0f - t1c * t1c, 0.0f)) + s * t2c;
  const float nz = sqrtf(clamp_min(1.0f - t1c * t1c - t2c * t2c, 0.0f));
  const V3 nh = mk(t1c * t1.x + t2c * t2.x + nz * vh.x,
                   t1c * t1.y + t2c * t2.y + nz * vh.y,
                   t1c * t1.z + t2c * t2.z + nz * vh.z);
  return normalize(mk(alpha * nh.x, alpha * nh.y, clamp_min(nh.z, 0.0f)));
}

__device__ __forceinline__ float fresnel_dielectric(float vdoth, float eta) {
  const float cos_t2 = 1.0f - (1.0f - vdoth * vdoth) / (eta * eta);
  const float cos_t = sqrtf(clamp_min(cos_t2, 0.0f));
  const float rs = (vdoth - eta * cos_t) / (vdoth + eta * cos_t);
  const float rp = (eta * vdoth - cos_t) / (eta * vdoth + cos_t);
  const float f = 0.5f * (rs * rs + rp * rp);
  return cos_t2 <= 0.0f ? 1.0f : f;
}

// lpt_shade's arguments, passed to the kernel as one value.
struct Args {
  const float* tri_shade;
  const float *origin, *direction, *acc, *mask;
  const bool* alive;
  const int64_t* seed;
  const int* bounce;
  const float* t;
  const int* tri;
  int R;
  float *o_origin, *o_direction, *o_acc, *o_mask;
  bool* o_alive;
  int64_t* o_seed;
  float env, rr_threshold;
  int rr_bounces, max_order;
  const float *mat, *ffm;
  const bool* nmap;
  const float *light_tris, *light_cdf, *prev_pdf;
  int n_lights;
  float *o_pdf, *o_so, *o_sd, *o_tlim, *o_contrib;
  int nee_mis;
  float total_area;
  int parity;
};

// The lane's tri_shade row (256 B, 16-byte aligned) as float4s.
__device__ __forceinline__ const float4* shade_row(const Args& a, int lane) {
  const int tri = a.tri[lane] < 0 ? 0 : a.tri[lane];
  return reinterpret_cast<const float4*>(a.tri_shade) +
         16 * static_cast<size_t>(tri);
}

// One hit lane: the prologue (hit point, barycentrics, material, lobe
// pick, frame, light sample), the Heitz walk (ops/bsdf.py heitz_sample)
// and the epilogue (weight, direction, the NEE contribution, Russian
// roulette), in the order of shade_plain.
__device__ __forceinline__ void shade_lane(const Args& a, int lane) {
  const bool nee = a.light_tris != nullptr;
  const V3 o = load3(a.origin, lane);
  const V3 d = load3(a.direction, lane);
  V3 acc = load3(a.acc, lane);
  V3 mk3 = load3(a.mask, lane);
  uint32_t s0 = static_cast<uint32_t>(a.seed[2 * lane]);
  uint32_t s1 = static_cast<uint32_t>(a.seed[2 * lane + 1]);
  const float t = a.t[lane];
  const float pdf = nee ? a.prev_pdf[lane] : 0.0f;
  // The row: tri_shade[tri, 0:32] (triangle), [32:64] (object).
  const float4* row = shade_row(a, lane);
  const float4 n01 = __ldg(row), n12 = __ldg(row + 1), n2u = __ldg(row + 2);
  const float4 uv0 = __ldg(row + 3), vab = __ldg(row + 4),
               vbc = __ldg(row + 5);
  const float4 os0 = __ldg(row + 8), os1 = __ldg(row + 9),
               os2 = __ldg(row + 10), os3 = __ldg(row + 11),
               os4 = __ldg(row + 12), os5 = __ldg(row + 13),
               os6 = __ldg(row + 14), os7 = __ldg(row + 15);
  // object space hit point and barycentrics (inverse rows os[9:21])
  const V3 lo = mk(os2.y * o.x + os2.z * o.y + os2.w * o.z + os3.x,
                   os3.y * o.x + os3.z * o.y + os3.w * o.z + os4.x,
                   os4.y * o.x + os4.z * o.y + os4.w * o.z + os5.x);
  const V3 ld = mk(os2.y * d.x + os2.z * d.y + os2.w * d.z,
                   os3.y * d.x + os3.z * d.y + os3.w * d.z,
                   os4.y * d.x + os4.z * d.y + os4.w * d.z);
  const V3 pw = mk(o.x + t * d.x, o.y + t * d.y, o.z + t * d.z);
  const V3 pl = mk(lo.x + t * ld.x, lo.y + t * ld.y, lo.z + t * ld.z);
  const V3 v0 = mk(uv0.w, vab.x, vab.y);  // ts[15:18]
  const V3 ab = mk(vab.z - v0.x, vab.w - v0.y, vbc.x - v0.z);
  const V3 ac = mk(vbc.y - v0.x, vbc.z - v0.y, vbc.w - v0.z);
  const V3 ah = mk(pl.x - v0.x, pl.y - v0.y, pl.z - v0.z);
  const float ab_ab = dot(ab, ab), ab_ac = dot(ab, ac), ac_ac = dot(ac, ac);
  const float ab_ah = dot(ab, ah), ac_ah = dot(ac, ah);
  const float inv_denom = 1.0f / (ab_ab * ac_ac - ab_ac * ab_ac);
  const float bv = (ac_ac * ab_ah - ab_ac * ac_ah) * inv_denom;
  const float bw = (ab_ab * ac_ah - ab_ac * ab_ah) * inv_denom;
  const float bu = 1.0f - bv - bw;

  // material: the object's (os[21:31]), or the texture prologue's
  const float ior = os7.w;
  float roughness, metallic, transmission;
  V3 bc, em;
  if (a.mat != nullptr) {
    const float* mt = a.mat + kMatCols * static_cast<size_t>(lane);
    bc = mk(mt[0], mt[1], mt[2]);
    em = mk(mt[4], mt[5], mt[6]);
    metallic = mt[7];
    roughness = mt[8];
    transmission = mt[9];
  } else {
    bc = mk(os5.y, os5.z, os5.w);
    em = mk(os6.y, os6.z, os6.w);
    metallic = os7.x;
    roughness = clamp_min(os7.y, 0.001f);
    transmission = os7.z;
  }
  const V3 base = mk(srgb(bc.x), srgb(bc.y), srgb(bc.z));

  // lobe pick (heitz/interaction_type.glsl:10-29): 0 diffuse, 1 metal,
  // 2 transmission
  const float met_w0 = metallic;
  const float trans_w0 = (1.0f - metallic) * transmission;
  const float diel_w = (1.0f - transmission) * (1.0f - metallic);
  const float norm = 1.0f / (met_w0 + trans_w0 + diel_w);
  const float met_w = met_w0 * norm;
  const float trans_w = trans_w0 * norm;
  const float r_lobe = draw(a.parity != 0, s0, s1);
  const int lobe = r_lobe < met_w ? 1 : (r_lobe < met_w + trans_w ? 2 : 0);

  // shading normal: mat3(world) @ interpolated normal, no inverse
  // transpose (path_tracing.comp:272); normals ts[0:9], world os[0:9]
  const V3 nl = mk(bu * n01.x + bv * n01.w + bw * n12.z,
                   bu * n01.y + bv * n12.x + bw * n12.w,
                   bu * n01.z + bv * n12.y + bw * n2u.x);
  const V3 n = normalize(mk(os0.x * nl.x + os0.y * nl.y + os0.z * nl.z,
                            os0.w * nl.x + os1.x * nl.y + os1.y * nl.z,
                            os1.z * nl.x + os1.w * nl.y + os2.x * nl.z));
  const float ndotd = dot(n, d);
  V3 ff = ndotd < 0.0f ? n : neg(n);

  // emission with the pre-bounce mask; under NEE + MIS a light found by
  // a BSDF ray from a light-sampled vertex is weighted
  // prev_pdf / (prev_pdf + p_light)
  if (nee) {
    const float p_light_hit =
        t * t / (clamp_min(fabsf(ndotd), 1e-9f) * a.total_area);
    const bool is_emitter = nmax(nmax(em.x, em.y), em.z) > 0.0f;
    const float mis_w = a.nee_mis ? pdf / (pdf + p_light_hit) : 0.0f;
    const float w_emit = (pdf > 0.0f && is_emitter) ? mis_w : 1.0f;
    acc = mk(acc.x + mk3.x * em.x * w_emit, acc.y + mk3.y * em.y * w_emit,
             acc.z + mk3.z * em.z * w_emit);
  } else {
    acc = mk(acc.x + mk3.x * em.x, acc.y + mk3.y * em.y,
             acc.z + mk3.z * em.z);
  }
  store3(a.o_origin, lane, pw);
  store3(a.o_acc, lane, acc);

  if (a.ffm != nullptr && a.nmap[lane]) ff = load3(a.ffm, lane);
  const V3 axis = fabsf(ff.x) > 0.1f ? mk(0.0f, 1.0f, 0.0f)
                                     : mk(1.0f, 0.0f, 0.0f);
  const V3 u = normalize(cross(axis, ff));
  const V3 v = cross(ff, u);

  const V3 nd = neg(d);
  const V3 view = mk(dot(nd, u), dot(nd, v), dot(nd, ff));
  const bool outside = dot(n, nd) > 0.0f;
  const float alpha = roughness * roughness;

  // next-event estimation: a point on a light picked by area
  const bool nee_lane = nee && lobe == 0;
  bool ev_on = false;
  V3 ev_dir = mk(0.0f, 0.0f, 0.0f), mle = ev_dir;
  float esc_rate = 0.0f, g = 0.0f;
  if (nee_lane) {
    const float r1 = draw(a.parity != 0, s0, s1);
    const float r2 = draw(a.parity != 0, s0, s1);
    const float r3 = draw(a.parity != 0, s0, s1);
    int lo_i = 0, hi_i = a.n_lights;  // first cdf value >= r1
    while (lo_i < hi_i) {
      const int mid = (lo_i + hi_i) >> 1;
      if (a.light_cdf[mid] < r1)
        lo_i = mid + 1;
      else
        hi_i = mid;
    }
    const float* lrow =
        a.light_tris + 16 * (lo_i < a.n_lights ? lo_i : a.n_lights - 1);
    const V3 e1 = mk(lrow[3], lrow[4], lrow[5]);
    const V3 e2 = mk(lrow[6], lrow[7], lrow[8]);
    const V3 le = mk(lrow[9], lrow[10], lrow[11]);
    const float su = sqrtf(r2);
    const float lbu = 1.0f - su, lbv = r3 * su;
    const V3 lp = mk(lrow[0] + lbu * e1.x + lbv * e2.x,
                     lrow[1] + lbu * e1.y + lbv * e2.y,
                     lrow[2] + lbu * e1.z + lbv * e2.z);
    const V3 ldir = mk(lp.x - pw.x, lp.y - pw.y, lp.z - pw.z);
    const float dist2 = clamp_min(dot(ldir, ldir), 1e-12f);
    const float dist = sqrtf(dist2);
    const V3 wl = mk(ldir.x / dist, ldir.y / dist, ldir.z / dist);
    V3 ln = cross(e1, e2);
    const float ln_len = clamp_min(sqrtf(dot(ln, ln)), 1e-20f);
    ln = mk(ln.x / ln_len, ln.y / ln_len, ln.z / ln_len);
    const float cos_l = fabsf(dot(ln, neg(wl)));  // two-sided emitter
    const float cos_s = dot(ff, wl);
    const float p_light = dist2 / (clamp_min(cos_l, 1e-9f) * a.total_area);
    const float p_bsdf_l = clamp_min(cos_s, 0.0f) / kPiF;
    const float w_light = a.nee_mis ? p_light / (p_light + p_bsdf_l) : 1.0f;
    ev_on = cos_s > 0.0f;
    ev_dir = mk(dot(wl, u), dot(wl, v), cos_s);
    const float sx = ev_dir.x * alpha, sy = ev_dir.y * alpha;
    const float proj_l = clamp_min(
        0.5f * (sqrtf(sx * sx + sy * sy + cos_s * cos_s) - cos_s), 1e-7f);
    esc_rate = proj_l / clamp_min(cos_s, 1e-7f);
    // the light side of the contribution, f_eval aside
    g = cos_l * a.total_area / dist2 * w_light;
    mle = mk(mk3.x * le.x, mk3.y * le.y, mk3.z * le.z);
    store3(a.o_so, lane, pw);
    store3(a.o_sd, lane, wl);
    a.o_tlim[lane] = dist * kTLimScale;
  } else if (nee) {
    store3(a.o_so, lane, mk(kPark, kPark, kPark));
    store3(a.o_sd, lane, mk(0.0f, 0.0f, 1.0f));
    a.o_tlim[lane] = 1.0f;
  }

  // The Heitz walk (ops/bsdf.py heitz_sample) of the lobe.  With the
  // NEE hook on, f_eval accumulates the diffuse BSDF-times-cosine
  // estimate toward the light at every scattering vertex (no extra
  // draws).
  const float ior_out = outside ? 1.0f : ior;
  const float ior_in = outside ? ior : 1.0f;
  V3 light = neg(view);
  float height = 0.0f;
  V3 energy = mk(1.0f, 1.0f, 1.0f), f_eval = mk(0.0f, 0.0f, 0.0f);
  bool walk_outside = true;
  bool walking = true;
  for (int order = 0; order < a.max_order; ++order) {
    const bool below = lobe == 2 && !walk_outside;
    const V3 hd = below ? neg(light) : light;
    const float h_in = below ? -height : height;
    const float r_h = draw(a.parity != 0, s0, s1);
    const float sx = hd.x * alpha, sy = hd.y * alpha, sz = hd.z;
    const float length = sqrtf(sx * sx + sy * sy + sz * sz);
    const float projected = clamp_min(0.5f * (length - hd.z), 1e-7f);
    const float delta = -logf(1.0f - r_h) * hd.z / projected;
    const float h_raw = h_in + delta;
    const float h_new = below ? -h_raw : h_raw;
    const bool left = below ? (h_new < 0.0f) : (h_new > 0.0f);
    height = h_new;
    if (left) {
      walking = false;
      break;
    }
    const V3 wo = neg(light);
    const float r1 = draw(a.parity != 0, s0, s1);
    const float r2 = draw(a.parity != 0, s0, s1);
    const V3 m = sample_vndf(wo, alpha, r1, r2);
    const float vdoth = dot(wo, m);
    V3 nd_;
    if (lobe == 0) {
      if (ev_on) {
        const float phase_l = clamp_min(dot(ev_dir, m), 0.0f) / kPiF;
        const float esc = expf(clamp_max(height * esc_rate, 0.0f));
        const float pe = phase_l * esc;
        f_eval = mk(f_eval.x + pe * (energy.x * base.x),
                    f_eval.y + pe * (energy.y * base.y),
                    f_eval.z + pe * (energy.z * base.z));
      }
      const V3 du = m.z < 1.0f ? normalize(cross(mk(0.0f, 0.0f, 1.0f), m))
                               : mk(1.0f, 0.0f, 0.0f);
      const V3 dv = cross(m, du);
      const float rd1 = draw(a.parity != 0, s0, s1);
      const float rd2 = draw(a.parity != 0, s0, s1);
      const float c1 = 2.0f * rd1 - 1.0f;
      const float c2 = 2.0f * rd2 - 1.0f;
      const float c1s = c1 == 0.0f ? 1.0f : c1;
      const float c2s = c2 == 0.0f ? 1.0f : c2;
      const bool use_c1 = c1 * c1 > c2 * c2;
      float radius = use_c1 ? c1 : c2;
      float phi = use_c1 ? static_cast<float>(kPi / 4.0) * (c2 / c1s)
                         : static_cast<float>(kPi / 2.0) -
                               (c1 / c2s) * static_cast<float>(kPi / 4.0);
      if (c1 == 0.0f && c2 == 0.0f) {
        radius = 0.0f;
        phi = 0.0f;
      }
      float sin_phi, cos_phi;
      sincosf(phi, &sin_phi, &cos_phi);
      const float ddx = radius * cos_phi;
      const float ddy = radius * sin_phi;
      const float ddz = sqrtf(clamp_min(1.0f - ddx * ddx - ddy * ddy, 0.0f));
      nd_ = mk(ddx * du.x + ddy * dv.x + ddz * m.x,
               ddx * du.y + ddy * dv.y + ddz * m.y,
               ddx * du.z + ddy * dv.z + ddz * m.z);
      energy = mk(energy.x * base.x, energy.y * base.y, energy.z * base.z);
    } else if (lobe == 2) {
      const float eta = walk_outside ? ior_in / ior_out : ior_out / ior_in;
      const float fres = fresnel_dielectric(vdoth, eta);
      const float r_f = draw(a.parity != 0, s0, s1);
      if (r_f < fres) {
        nd_ = mk(2.0f * m.x * vdoth - wo.x, 2.0f * m.y * vdoth - wo.y,
                 2.0f * m.z * vdoth - wo.z);
      } else {
        const float cos_i = dot(wo, m);
        const float cos_t2 = 1.0f - (1.0f - cos_i * cos_i) / (eta * eta);
        const float cos_t = -sqrtf(clamp_min(cos_t2, 0.0f));
        const float fac = cos_i / eta + cos_t;
        nd_ = normalize(mk(m.x * fac - wo.x / eta, m.y * fac - wo.y / eta,
                           m.z * fac - wo.z / eta));
        walk_outside = !walk_outside;
      }
    } else {
      const float vc = clamp01(vdoth);
      nd_ = mk(2.0f * m.x * vc - wo.x, 2.0f * m.y * vc - wo.y,
               2.0f * m.z * vc - wo.z);
      energy = mk(energy.x * base.x, energy.y * base.y, energy.z * base.z);
    }
    light = nd_;
  }
  if (lobe == 0 && walking) {  // exhausted diffuse walk
    energy = mk(0.0f, 0.0f, 0.0f);
    light = mk(0.0f, 0.0f, 1.0f);
  }
  const V3 weight = lobe == 2 ? base : energy;

  // The epilogue.
  float new_pdf = 0.0f;
  if (nee) {
    V3 contrib = mk(0.0f, 0.0f, 0.0f);
    if (nee_lane) {
      // f_eval carries the surface cosine; the light side remains.
      if (ev_on)
        contrib = mk(mle.x * f_eval.x * g, mle.y * f_eval.y * g,
                     mle.z * f_eval.z * g);
      new_pdf = clamp_min(light.z, 0.0f) / kPiF;
    }
    store3(a.o_contrib, lane, contrib);
  }
  mk3 = mk(mk3.x * weight.x, mk3.y * weight.y, mk3.z * weight.z);
  store3(a.o_direction, lane,
         mk(light.x * u.x + light.y * v.x + light.z * ff.x,
            light.x * u.y + light.y * v.y + light.z * ff.y,
            light.x * u.z + light.y * v.z + light.z * ff.z));

  // Russian roulette (path_tracing.comp:317-323)
  bool live = true;
  const float q = nmax(nmax(mk3.x, mk3.y), mk3.z);
  if (q < a.rr_threshold && a.bounce[lane] > a.rr_bounces) {
    const float r_rr = draw(a.parity != 0, s0, s1);
    if (r_rr > q) {
      live = false;
    } else {
      mk3 = mk(mk3.x / q, mk3.y / q, mk3.z / q);
    }
  }
  store3(a.o_mask, lane, mk3);
  a.o_alive[lane] = live;
  a.o_seed[2 * lane] = static_cast<int64_t>(s0);
  a.o_seed[2 * lane + 1] = static_cast<int64_t>(s1);
  if (nee) a.o_pdf[lane] = live ? new_pdf : pdf;
}

__global__ void __launch_bounds__(kBlock, kMinBlocks)
    shade_kernel(const Args a) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= a.R) return;
  const bool live = a.alive[i];
  if (live && !(a.t[i] >= kInf)) {
    shade_lane(a, i);
    return;
  }
  // A dead lane copies through, a miss writes mask * env.
  const V3 mk3 = load3(a.mask, i);
  store3(a.o_origin, i, load3(a.origin, i));
  store3(a.o_direction, i, load3(a.direction, i));
  store3(a.o_acc, i,
         live ? mk(mk3.x * a.env, mk3.y * a.env, mk3.z * a.env)
              : load3(a.acc, i));
  store3(a.o_mask, i, mk3);
  a.o_alive[i] = false;
  a.o_seed[2 * i] =
      static_cast<int64_t>(static_cast<uint32_t>(a.seed[2 * i]));
  a.o_seed[2 * i + 1] =
      static_cast<int64_t>(static_cast<uint32_t>(a.seed[2 * i + 1]));
  if (a.light_tris != nullptr) {
    a.o_pdf[i] = a.prev_pdf[i];
    store3(a.o_so, i, mk(kPark, kPark, kPark));
    store3(a.o_sd, i, mk(0.0f, 0.0f, 1.0f));
    a.o_tlim[i] = 1.0f;
    store3(a.o_contrib, i, mk(0.0f, 0.0f, 0.0f));
  }
}

// Every float's sincosf against its sinf and cosf, bit for bit.
__device__ __noinline__ float sin_alone(float x) { return sinf(x); }
__device__ __noinline__ float cos_alone(float x) { return cosf(x); }

__global__ void sincos_probe_kernel(unsigned long long* bad) {
  unsigned long long count = 0;
  for (unsigned long long k = blockIdx.x * 256ull + threadIdx.x;
       k < (1ull << 32); k += 256ull * gridDim.x) {
    const float x = __uint_as_float(static_cast<uint32_t>(k));
    float s, c;
    sincosf(x, &s, &c);
    if (__float_as_uint(s) != __float_as_uint(sin_alone(x)) ||
        __float_as_uint(c) != __float_as_uint(cos_alone(x)))
      ++count;
  }
  if (count) atomicAdd(bad, count);
}

}  // namespace

extern "C" int lpt_shade(const void* tri_shade, const void* origin,
                         const void* direction, const void* acc,
                         const void* mask, const void* alive,
                         const void* seed, const void* bounce, const void* t,
                         const void* tri, int R, void* o_origin,
                         void* o_direction, void* o_acc, void* o_mask,
                         void* o_alive, void* o_seed, float env,
                         float rr_threshold, int rr_bounces, int max_order,
                         int parity, const void* mat, const void* ffm,
                         const void* nmap, const void* light_tris,
                         const void* light_cdf, const void* prev_pdf,
                         int n_lights, void* o_pdf, void* o_so, void* o_sd,
                         void* o_tlim, void* o_contrib, int nee_mis,
                         float total_area, void* stream) {
  const Args a = {
      static_cast<const float*>(tri_shade), static_cast<const float*>(origin),
      static_cast<const float*>(direction), static_cast<const float*>(acc),
      static_cast<const float*>(mask), static_cast<const bool*>(alive),
      static_cast<const int64_t*>(seed), static_cast<const int*>(bounce),
      static_cast<const float*>(t), static_cast<const int*>(tri), R,
      static_cast<float*>(o_origin), static_cast<float*>(o_direction),
      static_cast<float*>(o_acc), static_cast<float*>(o_mask),
      static_cast<bool*>(o_alive), static_cast<int64_t*>(o_seed), env,
      rr_threshold, rr_bounces, max_order, static_cast<const float*>(mat),
      static_cast<const float*>(ffm), static_cast<const bool*>(nmap),
      static_cast<const float*>(light_tris),
      static_cast<const float*>(light_cdf),
      static_cast<const float*>(prev_pdf), n_lights,
      static_cast<float*>(o_pdf), static_cast<float*>(o_so),
      static_cast<float*>(o_sd), static_cast<float*>(o_tlim),
      static_cast<float*>(o_contrib), nee_mis, total_area, parity};
  const int blocks = (R + kBlock - 1) / kBlock;
  shade_kernel<<<blocks, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// Adds to *bad (an int64) the floats, over all 2^32 bit patterns, whose
// sincosf differs in a bit from their sinf or cosf.
extern "C" int lpt_sincos_probe(void* bad, void* stream) {
  sincos_probe_kernel<<<4096, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned long long*>(bad));
  return static_cast<int>(cudaGetLastError());
}
