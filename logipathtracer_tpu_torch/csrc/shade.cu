// Fused shading step per ray (kernel K2): untextured, non-NEE, Heitz.
//
// Replaces logipathtracer_tpu/ops/pallas/shade.py::shade_pallas ->
// _kernel / _shade_tile (gather form).  Per lane: miss writes mask * env
// (an assignment) and kills the path; otherwise emission with the
// pre-bounce mask, barycentrics, shading normal, tangent basis, lobe
// pick, the Heitz multiple-scattering walk of at most max_order orders,
// and Russian roulette, with the parity-hash or Threefry draws in the
// JAX package's order.  The arithmetic repeats the plain PyTorch version
// (ops/kernels/shade.py::shade_plain, the port of the jnp shade path)
// operation by operation.
//
// One thread per lane; each reads its tri_shade[tri] row (64 floats)
// itself.  Bound: operations — log/sin/cos/pow and ~600 flops per walk
// order, with divergence between lanes of a warp (lobe, walk length),
// which this simple design does not address.
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

// Fused Heitz walk for one lane (ops/bsdf.py heitz_sample).
__device__ void heitz_sample(V3 base, V3 view, float roughness, float ior,
                             bool outside, int lobe, int max_order, Rng& rng,
                             V3& weight, V3& light) {
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
    float rr_threshold, int rr_bounces, int max_order, int parity) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= R) return;
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

    const float roughness = clamp_min(os[29], 0.001f);
    const float metallic = os[28], transmission = os[30], ior = os[31];
    const V3 base = mk(srgb(os[21]), srgb(os[22]), srgb(os[23]));
    const V3 em = mk(os[25], os[26], os[27]);

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
    const V3 ff = ndotd < 0.0f ? n : neg(n);
    const V3 axis = fabsf(ff.x) > 0.1f ? mk(0.0f, 1.0f, 0.0f)
                                       : mk(1.0f, 0.0f, 0.0f);
    const V3 u = normalize(cross(axis, ff));
    const V3 v = cross(ff, u);

    a = mk(a.x + mk3.x * em.x, a.y + mk3.y * em.y, a.z + mk3.z * em.z);

    const V3 nd = neg(d);
    const V3 view = mk(dot(nd, u), dot(nd, v), dot(nd, ff));
    const bool outside = dot(n, nd) > 0.0f;
    V3 weight, lt;
    heitz_sample(mk(base.x, base.y, base.z), view, roughness, ior, outside,
                 lobe, max_order, rng, weight, lt);
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
                         int parity, void* stream) {
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
      rr_threshold, rr_bounces, max_order, parity);
  return static_cast<int>(cudaGetLastError());
}
