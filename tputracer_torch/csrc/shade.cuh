// The shading code of one lane that csrc/pt.cu's PT kernels and
// csrc/walk.cu's BDPT walk kernel share: float3 arithmetic, finalize_hit's
// point, normal and material (surface), and the BSDFs (bsdf.sample_bsdf,
// eval_bsdf, pdf_bsdf) for one lane of a known material kind.
//
// Bits: every multiply, add, divide and square root is rounded on its
// own (-fmad=false, IEEE division and sqrt) in the torch version's order,
// with torch's clamp and amax NaN rules; 1.0 / x is the reciprocal, as
// torch's CUDA kernels compute it; a tensor times a Python scalar is a
// product with the scalar rounded to float; the lookups are plain reads of
// in-range rows (lookup.fetch's forward); cosf and sinf are the libdevice
// functions torch's cos and sin call.  So each function gives the torch
// version's bits for the lanes it is called on.
//
// The functions that read the scene's tables take the kernel's argument
// struct that holds them (``a``: pt.cu's Args, walk.cu's WalkArgs), by
// the tables' names; passed as separate pointers instead, they cost
// pt_finish_kernel a register (47 -> 48, ptxas).

#pragma once

namespace tpt {

// scene.types' material kinds
constexpr int kDiffuse = 0;
constexpr int kMirror = 1;
constexpr int kGlass = 2;

constexpr double kPiD = 3.14159265358979323846;
// bsdf.INV_PI, a Python scalar, rounded to float as torch rounds it
constexpr float kInvPi = static_cast<float>(1.0 / kPiD);
// geometry.cosine_sample_hemisphere's 2.0 * math.pi, rounded to float
constexpr float kTwoPi = static_cast<float>(2.0 * kPiD);
constexpr float kMinSq = static_cast<float>(1e-20);  // normalize, pt._power2
constexpr float kMinCosT2 = static_cast<float>(1e-12);   // Fresnel's cos_t
constexpr float kMinPick = static_cast<float>(1e-4);     // the glass pick

struct Vec {
  float x, y, z;
};

__device__ __forceinline__ Vec load3(const float* p) {
  return {p[0], p[1], p[2]};
}

__device__ __forceinline__ void store3(float* p, Vec v) {
  p[0] = v.x;
  p[1] = v.y;
  p[2] = v.z;
}

__device__ __forceinline__ Vec add(Vec a, Vec b) {
  return {a.x + b.x, a.y + b.y, a.z + b.z};
}

__device__ __forceinline__ Vec sub(Vec a, Vec b) {
  return {a.x - b.x, a.y - b.y, a.z - b.z};
}

__device__ __forceinline__ Vec neg(Vec a) { return {-a.x, -a.y, -a.z}; }

__device__ __forceinline__ Vec mul(Vec a, Vec b) {
  return {a.x * b.x, a.y * b.y, a.z * b.z};
}

__device__ __forceinline__ Vec scale(Vec a, float s) {
  return {a.x * s, a.y * s, a.z * s};
}

// geometry.dot: x, y, z in that order
__device__ __forceinline__ float dot(Vec a, Vec b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}

// torch.clamp(x, min=lo) on the card: NaN stays NaN
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return isnan(x) ? x : fmaxf(x, lo);
}

// torch.clamp(x, lo, hi) on the card: NaN stays NaN
__device__ __forceinline__ float clamp(float x, float lo, float hi) {
  return isnan(x) ? x : fminf(fmaxf(x, lo), hi);
}

// torch.amax(v, dim=-1) on the card: NaN if any channel is NaN
__device__ __forceinline__ float amax(Vec v) {
  if (isnan(v.x) || isnan(v.y) || isnan(v.z)) return nanf("");
  return fmaxf(fmaxf(v.x, v.y), v.z);
}

// geometry.normalize: v * reciprocal(sqrt(clamp(v.v, min=1e-20)))
__device__ __forceinline__ Vec normalize(Vec v) {
  return scale(v, 1.0f / sqrtf(clamp_min(dot(v, v), kMinSq)));
}

// geometry.face_forward
__device__ __forceinline__ Vec face_forward(Vec n, Vec w) {
  return dot(n, w) < 0.0f ? neg(n) : n;
}

// the hit of a lane that hit something: finalize_hit's point, outward
// normal and material
struct Surface {
  Vec p, n;
  int mat;
};

// finalize_hit of a hit (t, prim) of the ray (o, d); ``a`` holds the
// scene's tri_n (T, 3), tri_mat (T,), sph_c (S, 3), sph_r (S,), sph_mat
// (S,) and n_tri_pad
template <typename Tables>
__device__ __forceinline__ Surface surface(const Tables& a, Vec o, Vec d,
                                           float t, int prim) {
  Surface s;
  s.p = add(o, scale(d, t));
  if (prim < a.n_tri_pad) {
    s.n = normalize(load3(a.tri_n + 3LL * prim));
    s.mat = a.tri_mat[prim];
  } else {
    const int k = prim - a.n_tri_pad;
    const Vec c = load3(a.sph_c + 3 * k);
    const float r = a.sph_r[k];
    const Vec pc = sub(s.p, c);
    s.n = {pc.x / r, pc.y / r, pc.z / r};
    s.mat = a.sph_mat[k];
  }
  return s;
}

// bsdf.eval_bsdf's diffuse lobe (ns = face_forward(n, wo)); ``a`` holds
// the scene's mat_albedo (M, 3)
template <typename Tables>
__device__ __forceinline__ Vec eval_bsdf(const Tables& a, int kind, int mat,
                                         Vec ns, Vec wo, Vec wi) {
  const bool sel = kind == kDiffuse && dot(wi, ns) > 0.0f &&
                   dot(wo, ns) > 0.0f;
  if (!sel) return {0.0f, 0.0f, 0.0f};
  return scale(load3(a.mat_albedo + 3 * mat), kInvPi);
}

// bsdf.pdf_bsdf (ns = face_forward(n, wo))
__device__ __forceinline__ float pdf_bsdf(int kind, Vec ns, Vec wo, Vec wi) {
  const float p = clamp_min(dot(wi, ns), 0.0f) * kInvPi;
  return kind == kDiffuse && dot(wo, ns) > 0.0f ? p : 0.0f;
}

// bsdf.sample_bsdf of one lane (decision_scene None): the direction, the
// weight, the pdf; ns = face_forward(n, wo); ``a`` holds the scene's
// mat_albedo (M, 3) and mat_ior (M,) and the call's transport_radiance
// as ``transport``
template <typename Tables>
__device__ __forceinline__ void sample_bsdf(const Tables& a, int kind,
                                            int mat, Vec n, Vec ns, Vec wo,
                                            float u0, float u1, float u2,
                                            Vec& wi, Vec& w, float& pdf) {
  const Vec albedo = load3(a.mat_albedo + 3 * mat);
  // the mirror direction, also the glass's reflection
  const Vec wi_m = sub(scale(ns, 2.0f * dot(wo, ns)), wo);
  w = albedo;
  pdf = 0.0f;
  if (kind == kGlass) {
    const bool entering = dot(wo, n) > 0.0f;
    const float ior = a.mat_ior[mat];
    const float eta_i = entering ? 1.0f : ior;
    const float eta_t = entering ? ior : 1.0f;
    const float cos_i = fabsf(dot(wo, ns));
    // bsdf._fresnel_dielectric
    const float eta = eta_i / eta_t;
    const float sin2_t = (eta * eta) * clamp_min(1.0f - cos_i * cos_i, 0.0f);
    const bool tir = sin2_t >= 1.0f;
    const float cos_t = sqrtf(clamp(1.0f - sin2_t, kMinCosT2, 1.0f));
    const float r_par = (eta_t * cos_i - eta_i * cos_t) /
                        (eta_t * cos_i + eta_i * cos_t);
    const float r_per = (eta_i * cos_i - eta_t * cos_t) /
                        (eta_i * cos_i + eta_t * cos_t);
    const float fr = tir ? 1.0f : 0.5f * (r_par * r_par + r_per * r_per);
    const bool pick_reflect = u0 < fr || tir;
    if (pick_reflect) {
      wi = wi_m;
      w = scale(albedo, fr / clamp(fr, kMinPick, 1.0f));
    } else {
      const float k = eta * cos_i - cos_t;
      wi = normalize(add(scale(wo, -eta), scale(ns, k)));
      const float pt = clamp(1.0f - fr, kMinPick, 1.0f);
      const float scale_refr = a.transport ? eta * eta : 1.0f;
      w = scale(albedo, (1.0f - fr) / pt * scale_refr);
    }
  } else if (kind == kMirror) {
    wi = wi_m;
  } else {
    // cosine hemisphere about ns (geometry.cosine_sample_hemisphere,
    // to_world and onb)
    const float r = sqrtf(u1);
    const float phi = kTwoPi * u2;
    const float lx = r * cosf(phi);
    const float ly = r * sinf(phi);
    const float lz = sqrtf(clamp_min(1.0f - u1, 0.0f));
    const float sg = ns.z >= 0.0f ? 1.0f : -1.0f;
    const float ia = (1.0f / (sg + ns.z)) * -1.0f;
    const float b = ns.x * ns.y * ia;
    const Vec tx = {1.0f + sg * ns.x * ns.x * ia, sg * b, -sg * ns.x};
    const Vec bx = {b, sg + ns.y * ns.y * ia, -ns.y};
    wi = add(add(scale(tx, lx), scale(bx, ly)), scale(ns, lz));
    if (kind == kDiffuse) pdf = clamp_min(dot(wi, ns), 0.0f) * kInvPi;
  }
}

}  // namespace tpt
