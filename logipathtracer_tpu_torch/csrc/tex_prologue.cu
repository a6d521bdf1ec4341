// The texture prologue (tex_prologue_kernel): per live lane, the texture
// taps that resolve its material overrides for the shading kernel K2.
//
// Replaces no Pallas kernel: the JAX package ran the prologue as XLA,
// outside any kernel (logipathtracer_tpu/render/megakernel.py
// _resolve_tex_prologue), and the port ran it as plain PyTorch, ~250 ops
// over the whole pool (ops/kernels/tex_prologue.py prologue_plain, whose
// arithmetic this repeats operation by operation).
//
// Per live lane (alive and t < INF, K2's test): the object-space hit
// point, barycentrics and uv from the lane's tri_shade row; for each slot
// the scene marks (`slots`, bit s for slot s: base colour, emission,
// metallic-roughness, transmission, normal) and the lane's object
// textures, a bilinear tap (four texels, or one row of the quad atlas
// with its CLAMP low-edge corner override), a GL NEAREST tap where the
// sampler asks for one (`nearest_aware`), or with mips a trilinear pair
// of levels at the lod of the clamped footprint; then the factors
// multiplied in texture order (the roughness floored before its
// multiply) and, with a normal map, the mapped front-face normal about
// the pre-map tangent basis.  Outputs: mat [R, 10] (base rgba, emission,
// metallic, roughness, transmission) and, when the normal slot is used,
// ff_mapped [R, 3] and has_nmap [R].  A lane that is not live reads
// nothing and writes zeros, as does ff_mapped where no normal map
// applies: K2 reads none of it there.
//
// Bound: DRAM bytes.  Each lane's own inputs (37 B for a live lane, 5 B
// for one that is not) and outputs (53 B), and a tap's four texels of
// 4 B from an atlas larger than the L2; the tri_shade and obj_tex tables
// (3.3 MB in the PBR scene) stay in L2 and count once a call.  On the
// PBR scene's 2^20-lane bounce pool (857,881 live lanes, 2,550,153 taps)
// that is ~0.13 GB, 0.04 ms at 3.35 TB/s, or ~0.42 GB and 0.125 ms if
// every texel costs its own 32-B sector.  Design: one thread a lane,
// every intermediate in registers; the row in float4 loads; every
// slot's texel addresses resolved first and all their loads issued
// before any texel is used, so that the DRAM latencies of the taps
// overlap instead of running as serial taps.
//
// Built with -fmad=false, no fast math and no hardware filtering: every
// product and sum rounds as in the plain version on the card, divides
// (the normalizations) and sqrt are IEEE, min/max propagate NaN as
// torch's do, and log2f is the device libm's, which torch.log2 takes on
// the card.  The packed texels unpack as torch unpacks them on the card,
// by a multiply with the f32 reciprocal of 255 (one ulp from the CPU's
// IEEE divide on 126 of the 256 values): the plain version there, and
// the benchmark's plain reference, take that multiply.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kInf = 3.4e38f;
constexpr int kMatCols = 10;
constexpr int kSlots = 5;
constexpr int kNormalSlot = 4;
constexpr int kBlock = 256;  // lanes of a block, one thread each
constexpr int kWrapClamp = 33071;
constexpr int kWrapMirror = 33648;

struct V3 {
  float x, y, z;
};
struct C4 {
  float x, y, z, w;
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
// torch.maximum / torch.minimum: NaN in either gives NaN.
__device__ __forceinline__ float nmax(float a, float b) {
  return (a != a || b != b) ? nan_f() : fmaxf(a, b);
}
__device__ __forceinline__ float nmin(float a, float b) {
  return (a != a || b != b) ? nan_f() : fminf(a, b);
}
// v / sqrt(max(|v|^2, 1e-38)), each component divided.
__device__ __forceinline__ V3 normalize(V3 v) {
  const float s = sqrtf(clamp_min(dot(v, v), 1e-38f));
  return mk(v.x / s, v.y / s, v.z / s);
}

// torch.remainder on int32: floor mod, the sign of the divisor.
__device__ __forceinline__ int floor_mod(int a, int b) {
  int r = a % b;
  if (r != 0 && ((r < 0) != (b < 0))) r += b;
  return r;
}
// c + 1 with int32 wrap-around, as torch's int32 add (c may be a
// saturated float conversion).
__device__ __forceinline__ int inc(int c) {
  return static_cast<int>(static_cast<unsigned>(c) + 1u);
}
// ops/texture.py _wrap: REPEAT, CLAMP or MIRROR on a texel coordinate.
__device__ __forceinline__ int wrap(int c, int size, int mode) {
  if (mode == kWrapClamp) return min(max(c, 0), size - 1);
  if (mode == kWrapMirror) {
    const int period = 2 * size;
    const int m = floor_mod(floor_mod(c, period) + period, period);
    return m < size ? m : period - 1 - m;
  }
  return floor_mod(c, size);
}

// lpt_tex_prologue's arguments, passed to the kernel as one value.
struct Args {
  const float* tri_shade;  // [T, 64]
  const int* obj_tex;      // [O, 5]
  const int* atlas_u32;    // packed RGBA8 atlas [AH * AW], or null
  const float4* atlas_f4;  // f32 atlas [AH * AW] float4s, or null
  const int4* quad;        // quad atlas [AH * AW] int4s, or null
  const int* table;        // [NE, 8]: x, y, w, h, wrap_s, wrap_t, mag, min
  const int* mip_base;     // [NT]
  const int* mip_count;    // [NT]
  const float *origin, *direction, *t;
  const int *obj, *tri;
  const bool* alive;  // null: every lane with a hit is live
  int R, n_texels, aw, n_entries, n_tex, slots, nearest_aware;
  float mip_spread;
  float* mat;
  float* ffm;
  bool* nmap;
};

struct Entry {
  int x0, y0, w, h, ws, wt, mag_n, min_n;
};

// Table row k, clamped into the table (ops/texture.py _take).
__device__ __forceinline__ Entry entry_at(const Args& a, int k) {
  k = min(max(k, 0), a.n_entries - 1);
  const int4* p = reinterpret_cast<const int4*>(a.table) + 2 * k;
  const int4 lo = __ldg(p), hi = __ldg(p + 1);
  Entry e;
  e.x0 = lo.x;
  e.y0 = lo.y;
  e.w = lo.z;
  e.h = lo.w;
  e.ws = hi.x;
  e.wt = hi.y;
  e.mag_n = hi.z;
  e.min_n = hi.w;
  return e;
}

// The atlas row of texel (cx, cy) of entry e, wrapped and clamped into
// the atlas.
__device__ __forceinline__ int texel(const Args& a, const Entry& e, int cx,
                                     int cy) {
  const int px = wrap(cx, e.w, e.ws) + e.x0;
  const int py = wrap(cy, e.h, e.wt) + e.y0;
  return min(max(py * a.aw + px, 0), a.n_texels - 1);
}

// One level's filtered fetch with its addresses resolved: the corners
// c00, c10, c01, c11 (the quad atlas: idx[0] alone; NEAREST: idx[0]
// alone, from the atlas).
struct Tap {
  int idx[4];
  float ax, ay;
  bool nearest, lo_s, lo_t;
};

template <bool kQuad>
__device__ __forceinline__ Tap plan_tap(const Args& a, const Entry& e,
                                        float u, float v, bool nearest) {
  Tap p;
  const float wf = static_cast<float>(e.w), hf = static_cast<float>(e.h);
  p.nearest = nearest;
  p.lo_s = p.lo_t = false;
  if (nearest) {
    // GL NEAREST: the texel at floor(uv * size).
    p.idx[0] = texel(a, e, static_cast<int>(floorf(u * wf)),
                     static_cast<int>(floorf(v * hf)));
    p.idx[1] = p.idx[2] = p.idx[3] = p.idx[0];
    p.ax = p.ay = 0.0f;
    return p;
  }
  const float fx = u * wf - 0.5f;
  const float fy = v * hf - 0.5f;
  const float ixf = floorf(fx), iyf = floorf(fy);
  p.ax = fx - ixf;
  p.ay = fy - iyf;
  const int ix = static_cast<int>(ixf), iy = static_cast<int>(iyf);
  p.idx[0] = texel(a, e, ix, iy);
  if (kQuad) {
    p.lo_s = e.ws == kWrapClamp && ix < 0;
    p.lo_t = e.wt == kWrapClamp && iy < 0;
    p.idx[1] = p.idx[2] = p.idx[3] = p.idx[0];
  } else {
    p.idx[1] = texel(a, e, inc(ix), iy);
    p.idx[2] = texel(a, e, ix, inc(iy));
    p.idx[3] = texel(a, e, inc(ix), inc(iy));
  }
  return p;
}

// A tap's loaded texels: packed words (their int32 bit patterns) or f32
// texels.
template <bool kPacked>
struct Raw;
template <>
struct Raw<true> {
  int v[4];
};
template <>
struct Raw<false> {
  float4 c[4];
};

template <bool kPacked, bool kQuad>
__device__ __forceinline__ void load_tap(const Args& a, const Tap& p,
                                         Raw<kPacked>& r) {
  if constexpr (kPacked) {
    if (kQuad && !p.nearest) {
      const int4 q = __ldg(a.quad + p.idx[0]);
      r.v[0] = q.x;
      r.v[1] = q.y;
      r.v[2] = q.z;
      r.v[3] = q.w;
    } else if (p.nearest) {
      r.v[0] = __ldg(a.atlas_u32 + p.idx[0]);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) r.v[k] = __ldg(a.atlas_u32 + p.idx[k]);
    }
  } else {
    if (p.nearest) {
      r.c[0] = __ldg(a.atlas_f4 + p.idx[0]);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) r.c[k] = __ldg(a.atlas_f4 + p.idx[k]);
    }
  }
}

// ops/texture.py _unpack as torch runs it on the card: (v >> 8i) & 0xFF
// as f32, times the f32 reciprocal of 255 (torch's division of a CUDA
// tensor by a Python number), one rounding.
constexpr float kInv255 = 1.0f / 255.0f;
__device__ __forceinline__ C4 unpack(int v) {
  C4 c;
  c.x = static_cast<float>(v & 0xFF) * kInv255;
  c.y = static_cast<float>((v >> 8) & 0xFF) * kInv255;
  c.z = static_cast<float>((v >> 16) & 0xFF) * kInv255;
  c.w = static_cast<float>((v >> 24) & 0xFF) * kInv255;
  return c;
}
__device__ __forceinline__ C4 c4(float4 f) {
  C4 c;
  c.x = f.x;
  c.y = f.y;
  c.z = f.z;
  c.w = f.w;
  return c;
}
// a * wa + b * wb, per channel.
__device__ __forceinline__ C4 blend(C4 a, float wa, C4 b, float wb) {
  C4 r;
  r.x = a.x * wa + b.x * wb;
  r.y = a.y * wa + b.y * wb;
  r.z = a.z * wa + b.z * wb;
  r.w = a.w * wa + b.w * wb;
  return r;
}

// ops/texture.py _bilinear / _nearest on the loaded texels.
template <bool kPacked, bool kQuad>
__device__ __forceinline__ C4 filter_tap(const Tap& p, const Raw<kPacked>& r) {
  C4 c00, c10, c01, c11;
  if constexpr (kPacked) {
    c00 = unpack(r.v[0]);
    if (p.nearest) return c00;
    if (kQuad) {
      // The CLAMP low edge: both true corners are texel 0, the packed
      // neighbour texel 1, so the corners are overridden.
      c10 = p.lo_s ? c00 : unpack(r.v[1]);
      c01 = p.lo_t ? c00 : unpack(r.v[2]);
      c11 = p.lo_s ? c01 : (p.lo_t ? c10 : unpack(r.v[3]));
    } else {
      c10 = unpack(r.v[1]);
      c01 = unpack(r.v[2]);
      c11 = unpack(r.v[3]);
    }
  } else {
    c00 = c4(r.c[0]);
    if (p.nearest) return c00;
    c10 = c4(r.c[1]);
    c01 = c4(r.c[2]);
    c11 = c4(r.c[3]);
  }
  const float bx = 1.0f - p.ax, by = 1.0f - p.ay;
  const C4 top = blend(c00, bx, c10, p.ax);
  const C4 bot = blend(c01, bx, c11, p.ax);
  return blend(top, by, bot, p.ay);
}

template <bool kPacked, bool kQuad, bool kMip>
__global__ void __launch_bounds__(kBlock)
    tex_prologue_kernel(const Args a) {
  constexpr int kLevels = kMip ? 2 : 1;
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= a.R) return;
  const bool normal_slot = (a.slots >> kNormalSlot) & 1;
  const float t = a.t[i];
  float2* mat2 =
      reinterpret_cast<float2*>(a.mat + kMatCols * static_cast<size_t>(i));
  if (!((a.alive == nullptr || a.alive[i]) && !(t >= kInf))) {
#pragma unroll
    for (int k = 0; k < kMatCols / 2; ++k) mat2[k] = make_float2(0.0f, 0.0f);
    if (normal_slot) {
      a.ffm[3 * i] = a.ffm[3 * i + 1] = a.ffm[3 * i + 2] = 0.0f;
      a.nmap[i] = false;
    }
    return;
  }
  const V3 o = mk(a.origin[3 * i], a.origin[3 * i + 1], a.origin[3 * i + 2]);
  const V3 d = mk(a.direction[3 * i], a.direction[3 * i + 1],
                  a.direction[3 * i + 2]);
  const int tri = max(a.tri[i], 0);
  const int* ot = a.obj_tex + kSlots * static_cast<size_t>(max(a.obj[i], 0));
  int tid[kSlots];
#pragma unroll
  for (int s = 0; s < kSlots; ++s)
    tid[s] = ((a.slots >> s) & 1) ? __ldg(ot + s) : -1;

  // The row: tri_shade[tri, 0:32] (triangle), [32:64] (object).
  const float4* row = reinterpret_cast<const float4*>(a.tri_shade) +
                       16 * static_cast<size_t>(tri);
  const float4 n01 = __ldg(row), n12 = __ldg(row + 1), n2u = __ldg(row + 2);
  const float4 uv0 = __ldg(row + 3), vab = __ldg(row + 4),
               vbc = __ldg(row + 5);
  const float4 os0 = __ldg(row + 8), os1 = __ldg(row + 9),
               os2 = __ldg(row + 10), os3 = __ldg(row + 11),
               os4 = __ldg(row + 12), os5 = __ldg(row + 13),
               os6 = __ldg(row + 14), os7 = __ldg(row + 15);
  // object-space hit point (inverse rows os[9:21]) and barycentrics
  const V3 lo = mk(os2.y * o.x + os2.z * o.y + os2.w * o.z + os3.x,
                   os3.y * o.x + os3.z * o.y + os3.w * o.z + os4.x,
                   os4.y * o.x + os4.z * o.y + os4.w * o.z + os5.x);
  const V3 ld = mk(os2.y * d.x + os2.z * d.y + os2.w * d.z,
                   os3.y * d.x + os3.z * d.y + os3.w * d.z,
                   os4.y * d.x + os4.z * d.y + os4.w * d.z);
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
  // uv: ts[9:11], [11:13], [13:15]
  const float u = bu * n2u.y + bv * n2u.w + bw * uv0.y;
  const float v = bu * n2u.z + bv * uv0.x + bw * uv0.z;

  // Every tap's addresses, then every load, then the filters.
  Tap taps[kSlots][kLevels];
  float frac[kSlots];
  if constexpr (kMip) {
    // texel density: ts[24] over the object's x-axis scale
    const float4 dn = __ldg(row + 6);
    const float scale = sqrtf(
        clamp_min(os0.x * os0.x + os0.w * os0.w + os1.z * os1.z, 1e-20f));
    const float density_w = dn.x / scale;
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      if (tid[s] < 0) continue;
      const int tc = min(max(tid[s], 0), a.n_tex - 1);
      const int base = __ldg(a.mip_base + tc);
      const int cnt = __ldg(a.mip_count + tc);
      const Entry eb = entry_at(a, base);
      const float dim = static_cast<float>(max(eb.w, eb.h));
      const float footprint = a.mip_spread * t * density_w * dim;
      const float lod = log2f(clamp_min(footprint, 1.0f));
      const float lv = nmin(nmax(lod, 0.0f), static_cast<float>(cnt - 1));
      const float l0f = floorf(lv);
      frac[s] = lv - l0f;
      const int l0 = static_cast<int>(l0f);
      const int l1 = min(l0 + 1, cnt - 1);
      const Entry e0 = entry_at(a, base + l0);
      const Entry e1 = entry_at(a, base + l1);
      const bool n0 = a.nearest_aware && (l0 == 0 ? e0.mag_n : e0.min_n) == 1;
      const bool n1 = a.nearest_aware && e1.min_n == 1;
      taps[s][0] = plan_tap<kQuad>(a, e0, u, v, n0);
      taps[s][kLevels - 1] = plan_tap<kQuad>(a, e1, u, v, n1);
    }
  } else {
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      if (tid[s] < 0) continue;
      const Entry e = entry_at(a, tid[s]);
      taps[s][0] =
          plan_tap<kQuad>(a, e, u, v, a.nearest_aware && e.mag_n == 1);
    }
  }
  Raw<kPacked> raw[kSlots][kLevels];
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    if (tid[s] < 0) continue;
#pragma unroll
    for (int l = 0; l < kLevels; ++l)
      load_tap<kPacked, kQuad>(a, taps[s][l], raw[s][l]);
  }
  C4 tex[kSlots];
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    if (tid[s] < 0) continue;
    tex[s] = filter_tap<kPacked, kQuad>(taps[s][0], raw[s][0]);
    if constexpr (kMip) {
      const C4 c1 = filter_tap<kPacked, kQuad>(taps[s][1], raw[s][1]);
      tex[s] = blend(tex[s], 1.0f - frac[s], c1, frac[s]);
    }
  }

  // The object's factors (os[21:31]), multiplied in texture order.
  C4 bc;
  bc.x = os5.y;
  bc.y = os5.z;
  bc.z = os5.w;
  bc.w = os6.x;
  V3 em = mk(os6.y, os6.z, os6.w);
  float metallic = os7.x;
  float roughness = clamp_min(os7.y, 0.001f);
  float transmission = os7.z;
  if (tid[0] >= 0) {
    bc.x = bc.x * tex[0].x;
    bc.y = bc.y * tex[0].y;
    bc.z = bc.z * tex[0].z;
    bc.w = bc.w * tex[0].w;
  }
  if (tid[1] >= 0) em = mk(em.x * tex[1].x, em.y * tex[1].y, em.z * tex[1].z);
  if (tid[2] >= 0) {
    metallic = metallic * tex[2].z;
    roughness = roughness * tex[2].y;
  }
  if (tid[3] >= 0) transmission = transmission * tex[3].x;
  mat2[0] = make_float2(bc.x, bc.y);
  mat2[1] = make_float2(bc.z, bc.w);
  mat2[2] = make_float2(em.x, em.y);
  mat2[3] = make_float2(em.z, metallic);
  mat2[4] = make_float2(roughness, transmission);
  if (!normal_slot) return;

  // The normal map about the pre-map basis (megakernel.py:353-381).
  const bool has = tid[kNormalSlot] >= 0;
  a.nmap[i] = has;
  V3 out = mk(0.0f, 0.0f, 0.0f);
  if (has) {
    const V3 nl = mk(bu * n01.x + bv * n01.w + bw * n12.z,
                     bu * n01.y + bv * n12.x + bw * n12.w,
                     bu * n01.z + bv * n12.y + bw * n2u.x);
    const V3 n = normalize(mk(os0.x * nl.x + os0.y * nl.y + os0.z * nl.z,
                              os0.w * nl.x + os1.x * nl.y + os1.y * nl.z,
                              os1.z * nl.x + os1.w * nl.y + os2.x * nl.z));
    const V3 ff = dot(n, d) < 0.0f ? n : neg(n);
    const V3 axis = fabsf(ff.x) > 0.1f ? mk(0.0f, 1.0f, 0.0f)
                                       : mk(1.0f, 0.0f, 0.0f);
    const V3 tu = normalize(cross(axis, ff));
    const V3 tv = cross(ff, tu);
    const C4 nm = tex[kNormalSlot];
    const V3 tn = normalize(mk(nm.x * 2.0f - 1.0f, nm.y * 2.0f - 1.0f,
                               nm.z * 2.0f - 1.0f));
    out = normalize(mk(tn.x * tu.x + tn.y * tv.x + tn.z * ff.x,
                       tn.x * tu.y + tn.y * tv.y + tn.z * ff.y,
                       tn.x * tu.z + tn.y * tv.z + tn.z * ff.z));
  }
  a.ffm[3 * i] = out.x;
  a.ffm[3 * i + 1] = out.y;
  a.ffm[3 * i + 2] = out.z;
}

template <bool kPacked, bool kQuad, bool kMip>
void launch(const Args& a, cudaStream_t stream) {
  const int blocks = (a.R + kBlock - 1) / kBlock;
  tex_prologue_kernel<kPacked, kQuad, kMip><<<blocks, kBlock, 0, stream>>>(a);
}

}  // namespace

// atlas: the packed RGBA8 atlas (int32 words) when `packed`, else the
// f32 atlas (float4 texels); quad: the quad atlas (int4 rows, packed
// atlases only) or null; alive: null takes every lane with a hit.  Mip
// chains come in the f32 atlas alone (scene/compile.py _pack_textures).
extern "C" int lpt_tex_prologue(
    const void* tri_shade, const void* obj_tex, const void* atlas,
    const void* quad, const void* table, const void* mip_base,
    const void* mip_count, const void* origin, const void* direction,
    const void* t, const void* obj, const void* tri, const void* alive,
    int R, int n_texels, int aw, int n_entries, int n_tex, int slots,
    int nearest_aware, int packed, int mip, float mip_spread, void* mat,
    void* ffm, void* nmap, void* stream) {
  const Args a = {static_cast<const float*>(tri_shade),
                  static_cast<const int*>(obj_tex),
                  packed ? static_cast<const int*>(atlas) : nullptr,
                  packed ? nullptr : static_cast<const float4*>(atlas),
                  static_cast<const int4*>(quad),
                  static_cast<const int*>(table),
                  static_cast<const int*>(mip_base),
                  static_cast<const int*>(mip_count),
                  static_cast<const float*>(origin),
                  static_cast<const float*>(direction),
                  static_cast<const float*>(t),
                  static_cast<const int*>(obj),
                  static_cast<const int*>(tri),
                  static_cast<const bool*>(alive),
                  R, n_texels, aw, n_entries, n_tex, slots, nearest_aware,
                  mip_spread,
                  static_cast<float*>(mat),
                  static_cast<float*>(ffm),
                  static_cast<bool*>(nmap)};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mip && (packed || quad != nullptr)) return cudaErrorInvalidValue;
  if (mip)
    launch<false, false, true>(a, s);
  else if (!packed)
    launch<false, false, false>(a, s);
  else if (quad != nullptr)
    launch<true, true, false>(a, s);
  else
    launch<true, false, false>(a, s);
  return static_cast<int>(cudaGetLastError());
}
