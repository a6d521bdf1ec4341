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
// One thread per lane.  Bound: operations — log/exp/sin/cos/pow and ~600
// flops per walk order, with divergence between lanes of a warp (lobe,
// walk length), which this simple design does not address.
//
// Built with -fmad=false and no fast math: products and sums round as
// in the plain version, divides and sqrt are IEEE, and min/max/clamp
// propagate NaN as torch does.  logf/expf/sinf/cosf/powf are the
// device libm's and may differ from the host's by a few ulps.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kInf = 3.4e38f;
constexpr double kPi = 3.141592653589;  // shaders/common/constants.glsl:5
constexpr float kPiF = static_cast<float>(kPi);
constexpr float kPark = 1e30f;
constexpr float kTLimScale = static_cast<float>(1.0 - 1e-3);
constexpr int kMatCols = 10;

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

struct Rng {
  uint32_t s0, s1;
  bool parity;
  __device__ __forceinline__ float draw() {
    return parity ? rand_parity(s0, s1) : rand_threefry(s0, s1);
  }
};

__device__ __forceinline__ float srgb(float c) {
  return c <= 0.04045f ? c / 12.92f : powf((c + 0.055f) / 1.055f, 2.4f);
}

// GGX visible-normal sample (ops/bsdf.py sample_vndf).
__device__ V3 sample_vndf(V3 ve, float alpha, float r1, float r2) {
  const V3 vh = normalize(mk(alpha * ve.x, alpha * ve.y, ve.z));
  const V3 t1 = vh.z < 1.0f ? normalize(cross(mk(0.0f, 0.0f, 1.0f), vh))
                            : mk(1.0f, 0.0f, 0.0f);
  const V3 t2 = cross(vh, t1);
  const float r = sqrtf(r1);
  const float phi = static_cast<float>(2.0 * kPi) * r2;
  const float t1c = r * cosf(phi);
  float t2c = r * sinf(phi);
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

// Walk-side NEE inputs: the light direction in tangent space and the
// escape-probability rate toward it (ops/bsdf.py heitz_sample eval_dir).
struct Eval {
  bool on;  // a light-sampled diffuse lane whose light is above the surface
  V3 dir;
  float esc_rate;
};

// Fused Heitz walk for one lane (ops/bsdf.py heitz_sample).  With
// ev.on, f_eval accumulates the diffuse BSDF-times-cosine estimate toward
// ev.dir at every scattering vertex (no extra draws).
__device__ void heitz_sample(V3 base, V3 view, float roughness, float ior,
                             bool outside, int lobe, int max_order, Rng& rng,
                             const Eval& ev, V3& weight, V3& light,
                             V3& f_eval) {
  const float alpha = roughness * roughness;
  const bool is_diff = lobe == 0, is_metal = lobe == 1, is_trans = lobe == 2;
  light = neg(view);
  float height = 0.0f;
  V3 energy = mk(1.0f, 1.0f, 1.0f);
  const float ior_out = outside ? 1.0f : ior;
  const float ior_in = outside ? ior : 1.0f;
  bool walk_outside = true;
  bool walking = true;
  for (int order = 0; order < max_order && walking; ++order) {
    const bool below = is_trans && !walk_outside;
    const V3 hd = below ? neg(light) : light;
    const float h_in = below ? -height : height;
    const float r_h = rng.draw();
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
    const float r1 = rng.draw();
    const float r2 = rng.draw();
    const V3 m = sample_vndf(wo, alpha, r1, r2);
    const float vdoth = dot(wo, m);
    V3 nd;
    if (is_diff) {
      if (ev.on) {
        const float phase_l = clamp_min(dot(ev.dir, m), 0.0f) / kPiF;
        const float esc = expf(clamp_max(height * ev.esc_rate, 0.0f));
        const float pe = phase_l * esc;
        f_eval = mk(f_eval.x + pe * (energy.x * base.x),
                    f_eval.y + pe * (energy.y * base.y),
                    f_eval.z + pe * (energy.z * base.z));
      }
      const V3 du = m.z < 1.0f ? normalize(cross(mk(0.0f, 0.0f, 1.0f), m))
                               : mk(1.0f, 0.0f, 0.0f);
      const V3 dv = cross(m, du);
      const float rd1 = rng.draw();
      const float rd2 = rng.draw();
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
      const float ddx = radius * cosf(phi);
      const float ddy = radius * sinf(phi);
      const float ddz = sqrtf(clamp_min(1.0f - ddx * ddx - ddy * ddy, 0.0f));
      nd = mk(ddx * du.x + ddy * dv.x + ddz * m.x,
              ddx * du.y + ddy * dv.y + ddz * m.y,
              ddx * du.z + ddy * dv.z + ddz * m.z);
      energy = mk(energy.x * base.x, energy.y * base.y, energy.z * base.z);
    } else if (is_trans) {
      const float eta = walk_outside ? ior_in / ior_out : ior_out / ior_in;
      const float fres = fresnel_dielectric(vdoth, eta);
      const float r_f = rng.draw();
      if (r_f < fres) {
        nd = mk(2.0f * m.x * vdoth - wo.x, 2.0f * m.y * vdoth - wo.y,
                2.0f * m.z * vdoth - wo.z);
      } else {
        const float cos_i = dot(wo, m);
        const float cos_t2 = 1.0f - (1.0f - cos_i * cos_i) / (eta * eta);
        const float cos_t = -sqrtf(clamp_min(cos_t2, 0.0f));
        const float fac = cos_i / eta + cos_t;
        nd = normalize(mk(m.x * fac - wo.x / eta, m.y * fac - wo.y / eta,
                          m.z * fac - wo.z / eta));
        walk_outside = !walk_outside;
      }
    } else {
      const float vc = clamp01(vdoth);
      nd = mk(2.0f * m.x * vc - wo.x, 2.0f * m.y * vc - wo.y,
              2.0f * m.z * vc - wo.z);
      if (is_metal)
        energy = mk(energy.x * base.x, energy.y * base.y, energy.z * base.z);
    }
    light = nd;
  }
  if (is_diff && walking) {  // exhausted diffuse walk
    energy = mk(0.0f, 0.0f, 0.0f);
    light = mk(0.0f, 0.0f, 1.0f);
  }
  weight = is_trans ? base : energy;
}

__global__ void shade_kernel(
    const float* __restrict__ tri_shade, const float* __restrict__ origin,
    const float* __restrict__ direction, const float* __restrict__ acc,
    const float* __restrict__ mask, const bool* __restrict__ alive,
    const int64_t* __restrict__ seed, const int* __restrict__ bounce,
    const float* __restrict__ t_in, const int* __restrict__ tri_in, int R,
    float* __restrict__ o_origin, float* __restrict__ o_direction,
    float* __restrict__ o_acc, float* __restrict__ o_mask,
    bool* __restrict__ o_alive, int64_t* __restrict__ o_seed, float env,
    float rr_threshold, int rr_bounces, int max_order, int parity,
    const float* __restrict__ mat, const float* __restrict__ ffm,
    const bool* __restrict__ nmap, const float* __restrict__ light_tris,
    const float* __restrict__ light_cdf, const float* __restrict__ prev_pdf,
    int n_lights, float* __restrict__ o_pdf, float* __restrict__ o_so,
    float* __restrict__ o_sd, float* __restrict__ o_tlim,
    float* __restrict__ o_contrib, int nee_mis, float total_area) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= R) return;
  const bool nee = light_tris != nullptr;
  V3 o = mk(origin[3 * i], origin[3 * i + 1], origin[3 * i + 2]);
  V3 d = mk(direction[3 * i], direction[3 * i + 1], direction[3 * i + 2]);
  V3 a = mk(acc[3 * i], acc[3 * i + 1], acc[3 * i + 2]);
  V3 mk3 = mk(mask[3 * i], mask[3 * i + 1], mask[3 * i + 2]);
  bool live = alive[i];
  Rng rng;
  rng.s0 = static_cast<uint32_t>(seed[2 * i]);
  rng.s1 = static_cast<uint32_t>(seed[2 * i + 1]);
  rng.parity = parity != 0;
  const float t = t_in[i];
  const float pdf = nee ? prev_pdf[i] : 0.0f;
  float pdf_out = pdf;
  // Shadow query of a lane without a light sample: parked.
  V3 so = mk(kPark, kPark, kPark), sd = mk(0.0f, 0.0f, 1.0f);
  V3 contrib = mk(0.0f, 0.0f, 0.0f);
  float t_lim = 1.0f;

  if (live && t >= kInf) {  // miss: acc = mask * env (assignment)
    a = mk(mk3.x * env, mk3.y * env, mk3.z * env);
    live = false;
  } else if (live) {
    const int tri = tri_in[i] < 0 ? 0 : tri_in[i];
    const float* ts = tri_shade + 64 * static_cast<size_t>(tri);
    const float* os = ts + 32;
    // object space hit point and barycentrics
    const V3 lo = mk(os[9] * o.x + os[10] * o.y + os[11] * o.z + os[12],
                     os[13] * o.x + os[14] * o.y + os[15] * o.z + os[16],
                     os[17] * o.x + os[18] * o.y + os[19] * o.z + os[20]);
    const V3 ld = mk(os[9] * d.x + os[10] * d.y + os[11] * d.z,
                     os[13] * d.x + os[14] * d.y + os[15] * d.z,
                     os[17] * d.x + os[18] * d.y + os[19] * d.z);
    const V3 pw = mk(o.x + t * d.x, o.y + t * d.y, o.z + t * d.z);
    const V3 pl = mk(lo.x + t * ld.x, lo.y + t * ld.y, lo.z + t * ld.z);
    const V3 v0 = mk(ts[15], ts[16], ts[17]);
    const V3 ab = mk(ts[18] - v0.x, ts[19] - v0.y, ts[20] - v0.z);
    const V3 ac = mk(ts[21] - v0.x, ts[22] - v0.y, ts[23] - v0.z);
    const V3 ah = mk(pl.x - v0.x, pl.y - v0.y, pl.z - v0.z);
    const float ab_ab = dot(ab, ab), ab_ac = dot(ab, ac), ac_ac = dot(ac, ac);
    const float ab_ah = dot(ab, ah), ac_ah = dot(ac, ah);
    const float inv_denom = 1.0f / (ab_ab * ac_ac - ab_ac * ab_ac);
    const float bv = (ac_ac * ab_ah - ab_ac * ac_ah) * inv_denom;
    const float bw = (ab_ab * ac_ah - ab_ac * ab_ah) * inv_denom;
    const float bu = 1.0f - bv - bw;

    // material: the object's, or the texture prologue's overrides
    const float ior = os[31];
    const float* mt = mat != nullptr ? mat + kMatCols * i : nullptr;
    const float metallic = mt ? mt[7] : os[28];
    const float roughness = mt ? mt[8] : clamp_min(os[29], 0.001f);
    const float transmission = mt ? mt[9] : os[30];
    const float* bc = mt ? mt : os + 21;
    const float* ec = mt ? mt + 4 : os + 25;
    const V3 base = mk(srgb(bc[0]), srgb(bc[1]), srgb(bc[2]));
    const V3 em = mk(ec[0], ec[1], ec[2]);

    // lobe pick (heitz/interaction_type.glsl:10-29)
    const float met_w0 = metallic;
    const float trans_w0 = (1.0f - metallic) * transmission;
    const float diel_w = (1.0f - transmission) * (1.0f - metallic);
    const float norm = 1.0f / (met_w0 + trans_w0 + diel_w);
    const float met_w = met_w0 * norm;
    const float trans_w = trans_w0 * norm;
    const float r_lobe = rng.draw();
    const int lobe = r_lobe < met_w ? 1 : (r_lobe < met_w + trans_w ? 2 : 0);

    // shading normal: mat3(world) @ interpolated normal, no inverse
    // transpose (path_tracing.comp:272)
    const V3 nl = mk(bu * ts[0] + bv * ts[3] + bw * ts[6],
                     bu * ts[1] + bv * ts[4] + bw * ts[7],
                     bu * ts[2] + bv * ts[5] + bw * ts[8]);
    const V3 n = normalize(mk(os[0] * nl.x + os[1] * nl.y + os[2] * nl.z,
                              os[3] * nl.x + os[4] * nl.y + os[5] * nl.z,
                              os[6] * nl.x + os[7] * nl.y + os[8] * nl.z));
    const float ndotd = dot(n, d);
    V3 ff = ndotd < 0.0f ? n : neg(n);

    // emission with the pre-bounce mask; under NEE + MIS a light found by
    // a BSDF ray from a light-sampled vertex is weighted
    // prev_pdf / (prev_pdf + p_light)
    if (nee) {
      const float p_light_hit =
          t * t / (clamp_min(fabsf(ndotd), 1e-9f) * total_area);
      const bool is_emitter = nmax(nmax(em.x, em.y), em.z) > 0.0f;
      const float mis_w = nee_mis ? pdf / (pdf + p_light_hit) : 0.0f;
      const float w_emit = (pdf > 0.0f && is_emitter) ? mis_w : 1.0f;
      a = mk(a.x + mk3.x * em.x * w_emit, a.y + mk3.y * em.y * w_emit,
             a.z + mk3.z * em.z * w_emit);
    } else {
      a = mk(a.x + mk3.x * em.x, a.y + mk3.y * em.y, a.z + mk3.z * em.z);
    }

    if (ffm != nullptr && nmap[i])
      ff = mk(ffm[3 * i], ffm[3 * i + 1], ffm[3 * i + 2]);
    const V3 axis = fabsf(ff.x) > 0.1f ? mk(0.0f, 1.0f, 0.0f)
                                       : mk(1.0f, 0.0f, 0.0f);
    const V3 u = normalize(cross(axis, ff));
    const V3 v = cross(ff, u);

    const V3 nd = neg(d);
    const V3 view = mk(dot(nd, u), dot(nd, v), dot(nd, ff));
    const bool outside = dot(n, nd) > 0.0f;

    // next-event estimation: a point on a light picked by area
    const bool nee_lane = nee && lobe == 0;
    Eval ev;
    ev.on = false;
    V3 le = mk(0.0f, 0.0f, 0.0f), wl = le;
    float dist2 = 1.0f, dist = 1.0f, cos_l = 0.0f, cos_s = 0.0f;
    float w_light = 1.0f;
    if (nee_lane) {
      const float r1 = rng.draw();
      const float r2 = rng.draw();
      const float r3 = rng.draw();
      int lo_i = 0, hi_i = n_lights;  // first cdf value >= r1
      while (lo_i < hi_i) {
        const int mid = (lo_i + hi_i) >> 1;
        if (light_cdf[mid] < r1)
          lo_i = mid + 1;
        else
          hi_i = mid;
      }
      const float* row = light_tris + 16 * (lo_i < n_lights ? lo_i
                                                           : n_lights - 1);
      const V3 e1 = mk(row[3], row[4], row[5]);
      const V3 e2 = mk(row[6], row[7], row[8]);
      le = mk(row[9], row[10], row[11]);
      const float su = sqrtf(r2);
      const float lbu = 1.0f - su, lbv = r3 * su;
      const V3 lp = mk(row[0] + lbu * e1.x + lbv * e2.x,
                       row[1] + lbu * e1.y + lbv * e2.y,
                       row[2] + lbu * e1.z + lbv * e2.z);
      const V3 ldir = mk(lp.x - pw.x, lp.y - pw.y, lp.z - pw.z);
      dist2 = clamp_min(dot(ldir, ldir), 1e-12f);
      dist = sqrtf(dist2);
      wl = mk(ldir.x / dist, ldir.y / dist, ldir.z / dist);
      V3 ln = cross(e1, e2);
      const float ln_len = clamp_min(sqrtf(dot(ln, ln)), 1e-20f);
      ln = mk(ln.x / ln_len, ln.y / ln_len, ln.z / ln_len);
      cos_l = fabsf(dot(ln, neg(wl)));  // two-sided emitter
      cos_s = dot(ff, wl);
      const float p_light = dist2 / (clamp_min(cos_l, 1e-9f) * total_area);
      const float p_bsdf_l = clamp_min(cos_s, 0.0f) / kPiF;
      w_light = nee_mis ? p_light / (p_light + p_bsdf_l) : 1.0f;
      ev.on = cos_s > 0.0f;
      ev.dir = mk(dot(wl, u), dot(wl, v), cos_s);
      const float alpha = roughness * roughness;
      const float sx = ev.dir.x * alpha, sy = ev.dir.y * alpha;
      const float proj_l = clamp_min(
          0.5f * (sqrtf(sx * sx + sy * sy + cos_s * cos_s) - cos_s), 1e-7f);
      ev.esc_rate = proj_l / clamp_min(cos_s, 1e-7f);
    }

    V3 weight, lt, f_eval = mk(0.0f, 0.0f, 0.0f);
    heitz_sample(base, view, roughness, ior, outside, lobe, max_order, rng,
                 ev, weight, lt, f_eval);
    float new_pdf = 0.0f;
    if (nee_lane) {
      // f_eval carries the surface cosine; the light side remains.
      if (cos_s > 0.0f) {
        const float g = cos_l * total_area / dist2 * w_light;
        contrib = mk(mk3.x * le.x * f_eval.x * g, mk3.y * le.y * f_eval.y * g,
                     mk3.z * le.z * f_eval.z * g);
      }
      so = pw;
      sd = wl;
      t_lim = dist * kTLimScale;
      new_pdf = clamp_min(lt.z, 0.0f) / kPiF;
    }
    mk3 = mk(mk3.x * weight.x, mk3.y * weight.y, mk3.z * weight.z);
    o = pw;
    d = mk(lt.x * u.x + lt.y * v.x + lt.z * ff.x,
           lt.x * u.y + lt.y * v.y + lt.z * ff.y,
           lt.x * u.z + lt.y * v.z + lt.z * ff.z);

    // Russian roulette (path_tracing.comp:317-323)
    const float q = nmax(nmax(mk3.x, mk3.y), mk3.z);
    if (q < rr_threshold && bounce[i] > rr_bounces) {
      const float r_rr = rng.draw();
      if (r_rr > q) {
        live = false;
      } else {
        mk3 = mk(mk3.x / q, mk3.y / q, mk3.z / q);
      }
    }
    if (live) pdf_out = new_pdf;
  }
  o_origin[3 * i] = o.x;
  o_origin[3 * i + 1] = o.y;
  o_origin[3 * i + 2] = o.z;
  o_direction[3 * i] = d.x;
  o_direction[3 * i + 1] = d.y;
  o_direction[3 * i + 2] = d.z;
  o_acc[3 * i] = a.x;
  o_acc[3 * i + 1] = a.y;
  o_acc[3 * i + 2] = a.z;
  o_mask[3 * i] = mk3.x;
  o_mask[3 * i + 1] = mk3.y;
  o_mask[3 * i + 2] = mk3.z;
  o_alive[i] = live;
  o_seed[2 * i] = static_cast<int64_t>(rng.s0);
  o_seed[2 * i + 1] = static_cast<int64_t>(rng.s1);
  if (nee) {
    o_pdf[i] = pdf_out;
    o_so[3 * i] = so.x;
    o_so[3 * i + 1] = so.y;
    o_so[3 * i + 2] = so.z;
    o_sd[3 * i] = sd.x;
    o_sd[3 * i + 1] = sd.y;
    o_sd[3 * i + 2] = sd.z;
    o_tlim[i] = t_lim;
    o_contrib[3 * i] = contrib.x;
    o_contrib[3 * i + 1] = contrib.y;
    o_contrib[3 * i + 2] = contrib.z;
  }
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
  const int threads = 128;
  const int blocks = (R + threads - 1) / threads;
  shade_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(tri_shade), static_cast<const float*>(origin),
      static_cast<const float*>(direction), static_cast<const float*>(acc),
      static_cast<const float*>(mask), static_cast<const bool*>(alive),
      static_cast<const int64_t*>(seed), static_cast<const int*>(bounce),
      static_cast<const float*>(t), static_cast<const int*>(tri), R,
      static_cast<float*>(o_origin), static_cast<float*>(o_direction),
      static_cast<float*>(o_acc), static_cast<float*>(o_mask),
      static_cast<bool*>(o_alive), static_cast<int64_t*>(o_seed), env,
      rr_threshold, rr_bounces, max_order, parity,
      static_cast<const float*>(mat), static_cast<const float*>(ffm),
      static_cast<const bool*>(nmap), static_cast<const float*>(light_tris),
      static_cast<const float*>(light_cdf),
      static_cast<const float*>(prev_pdf), n_lights,
      static_cast<float*>(o_pdf), static_cast<float*>(o_so),
      static_cast<float*>(o_sd), static_cast<float*>(o_tlim),
      static_cast<float*>(o_contrib), nee_mis, total_area);
  return static_cast<int>(cudaGetLastError());
}
