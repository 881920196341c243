// BDPT's connection strategies for Hopper (sm_90a), Veach 1997 ch. 10:
// the s >= 1, t >= 2 (s, t) strategies of a chunk of paths, and the t = 1
// light-tracing splats, each in two kernels around the shadow rays.
//
// Replaces no TPU kernel.  The JAX package writes the strategies as array
// ops (tputracer/integrators/bdpt.py) and XLA fuses them; the port's torch
// versions run them as many elementwise kernels a chunk at 4 bounces, each
// reading and writing a few (n,) vectors: ~3,400 for the connections
// (bdpt.connection_radiance_plain: a BSDF eval at both ends, the geometry
// term and the MIS ratio chains of every strategy) and ~1,400 for the
// splats (bdpt.t1_splats_plain: the projection onto the film, the BSDF
// eval, the importance, the t = 1 chains and an index_add_ whose masked
// lanes all add into one dump row).  Here each thread takes one path
// through every strategy:
//
//   connect_prepare_kernel  for each strategy, in connection_radiance's
//       order (t = 2.., s = 1..min(ny, V - t)): the direction, f at both
//       ends, G, the contribution c, the candidate mask and the shadow
//       ray (origin, direction, tmax = 0 off the mask), into (S, n)
//       buffers;
//   (the caller's S shadow-ray calls, unchanged)
//   connect_finish_kernel  for each strategy in the same order: the
//       mask less the occluded lanes, the MIS weight (balance or power,
//       delta suppression, both ratio chains in their loop order) and the
//       running sum of c * w, which it writes.
//
//   splat_prepare_kernel  for each t = 1 strategy (s = 1..min(ny, V - 1)):
//       the camera -> y direction, its pixel on the film, f at y, the
//       importance and the contribution c, the candidate mask and the
//       shadow ray's direction and tmax into (S, n) buffers, and the
//       lane's one shadow-ray origin, the camera's position;
//   (the caller's S shadow-ray calls, unchanged)
//   splat_finish_kernel  for each surviving splat, the MIS weight of
//       (s, 1) (mis_weight with the camera as z) and c * w added into the
//       chunk's (H * W, 3) film with float atomics.  Masked and occluded
//       lanes add nothing.
//
// What bounds it: bytes.  A lane's arithmetic is a few hundred float ops
// a strategy; at 4 bounces the two connection kernels move about 1.34 KB
// a lane (the joined vertices' fields read once, 41 B a strategy written
// by the first and read back by the second, connect_bytes_per_lane in
// chip_smoke.py), and the two splat kernels about 0.74 KB
// (splat_bytes_per_lane), far below the card's ops-per-byte line.  So the
// design reads each vertex field a strategy needs straight from the
// walk's own (n,) and (n, 3) tensors, through a table of their pointers
// (no copy into a packed layout), keeps every intermediate of a strategy
// in registers, and in the second kernel reads the chains' pdfs only on
// lanes whose connection or splat survived its shadow ray.  The tables
// are filled on the device by a small kernel whose parameters carry the
// pointers, so a CUDA graph's replay fills them again and any number of
// vertices fits.  The camera is read on the device too (its (3,) tensors
// and the terms bdpt.py derives from them with torch), so a replay sees
// the camera copied into the graph's inputs.
//
// Bits: every multiply, add, divide and square root is rounded on its
// own (-fmad=false, IEEE division and sqrt) in the torch version's order,
// with its clamps and its NaN rules (clamp propagates NaN, amax too), and
// a tensor divided by a Python scalar as torch's CUDA kernel does it, a
// product with the scalar's float reciprocal.  So the connections' sum
// equals the torch version's on the card bit for bit, and so do each
// splat's contribution and pixel; a lane's bits depend only on its own
// inputs.  The film's atomic sums, like index_add_'s, add in no fixed
// order.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;      // threads per block
constexpr int kTableChunk = 480;   // table entries a fill launch carries

// a vertex's fields in the table, kFields entries a vertex: zs[0..nz),
// then ys[0..ny)
enum Field { kP, kNg, kWo, kBeta, kPdfFwd, kPdfRev, kMat, kValid, kDelta,
             kFields };

constexpr int kDiffuse = 0;
constexpr double kPiD = 3.14159265358979323846;
// bsdf.INV_PI: the double 1 / pi, rounded to float as torch rounds a
// Python scalar
constexpr float kInvPi = static_cast<float>(1.0 / kPiD);
// x / math.pi on a CUDA tensor: torch multiplies by 1 / float(pi)
constexpr float kDivPi = 1.0f / static_cast<float>(kPiD);
constexpr float kMinDist2 = static_cast<float>(1e-12);
constexpr float kShadowScale = static_cast<float>(1.0 - 1e-3);
// the camera's least cosine (bdpt._camera_pdf_sa, t1_splats' in_front)
constexpr float kMinCos = static_cast<float>(1e-6);

struct Vec {
  float x, y, z;
};

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

// bdpt._remap0
__device__ __forceinline__ float remap0(float x) { return x > 0.0f ? x : 1.0f; }

// geometry.face_forward
__device__ __forceinline__ Vec face_forward(Vec n, Vec w) {
  return dot(n, w) < 0.0f ? neg(n) : n;
}

// a vertex field of lane i, through the pointer table
struct Verts {
  const long long* tab;
  long long i;

  template <typename T>
  __device__ __forceinline__ const T* ptr(int v, Field f) const {
    return reinterpret_cast<const T*>(__ldg(tab + v * kFields + f));
  }
  __device__ __forceinline__ Vec vec(int v, Field f) const {
    const float* p = ptr<float>(v, f) + 3 * i;
    return {p[0], p[1], p[2]};
  }
  __device__ __forceinline__ float scalar(int v, Field f) const {
    return ptr<float>(v, f)[i];
  }
  __device__ __forceinline__ int mat(int v) const {
    return ptr<int>(v, kMat)[i];
  }
  __device__ __forceinline__ bool flag(int v, Field f) const {
    return ptr<unsigned char>(v, f)[i] != 0;
  }
};

// bsdf.eval_bsdf: the diffuse lobe's albedo / pi on the same side, else 0
__device__ __forceinline__ Vec eval_bsdf(const int* kinds, const float* albedo,
                                         int mat, Vec n, Vec wo, Vec wi) {
  const Vec ns = face_forward(n, wo);
  const bool sel = kinds[mat] == kDiffuse && dot(wi, ns) > 0.0f &&
                   dot(wo, ns) > 0.0f;
  if (!sel) return {0.0f, 0.0f, 0.0f};
  const float* a = albedo + 3 * mat;
  return {a[0] * kInvPi, a[1] * kInvPi, a[2] * kInvPi};
}

// bsdf.pdf_bsdf
__device__ __forceinline__ float pdf_bsdf(const int* kinds, int mat, Vec n,
                                          Vec wo, Vec wi) {
  const Vec ns = face_forward(n, wo);
  const float p = clamp_min(dot(wi, ns), 0.0f) * kInvPi;
  return kinds[mat] == kDiffuse && dot(wo, ns) > 0.0f ? p : 0.0f;
}

// bdpt._convert_density: 1.0 / x is torch's reciprocal, then * 1.0
__device__ __forceinline__ float convert_density(float pdf_sa, Vec p_from,
                                                 Vec p_to, Vec n_to) {
  const Vec w = sub(p_to, p_from);
  const float dist2 = clamp_min(dot(w, w), kMinDist2);
  const float inv = 1.0f / dist2;
  const float cos = fabsf(dot(n_to, w)) * sqrtf(inv);
  return pdf_sa * cos * inv;
}

// the (3,) vector at p
__device__ __forceinline__ Vec load3(const float* p) {
  return {p[0], p[1], p[2]};
}

// the camera as the t = 1 strategies see it: the camera vertex's position
// and normal (bdpt._camera_forward) and the image plane's area at unit
// distance (bdpt._camera_area)
struct Camera {
  Vec o, fwd;
  float area;
};

__device__ __forceinline__ Camera camera_of(const float* o, const float* fwd,
                                            const float* area) {
  return {load3(o), load3(fwd), *area};
}

// bdpt._camera_pdf_sa: cos ** 3 is cos * cos * cos in torch's CUDA pow,
// and 1.0 / x torch's reciprocal
__device__ __forceinline__ float camera_pdf_sa(const Camera& cam, Vec d) {
  const float cos = clamp_min(dot(d, cam.fwd), kMinCos);
  return 1.0f / (cam.area * (cos * cos * cos));
}

// the unit direction from z to y and the clamped squared distance, as
// connection_radiance and _mis_weight compute them
__device__ __forceinline__ Vec direction(Vec zp, Vec yp, float& dist2,
                                         float& dist) {
  const Vec d = sub(yp, zp);
  dist2 = clamp_min(dot(d, d), kMinDist2);
  dist = sqrtf(dist2);
  return {d.x / dist, d.y / dist, d.z / dist};
}

// the pointers one fill launch carries in its parameters (3,840 bytes)
struct TableChunk {
  long long v[kTableChunk];
};

__global__ void __launch_bounds__(kTableChunk)
    connect_table_kernel(long long* __restrict__ dst, const TableChunk src,
                         int count) {
  const int j = threadIdx.x;
  if (j < count) dst[j] = src.v[j];
}

__global__ void __launch_bounds__(kThreads)
    connect_prepare_kernel(const long long* __restrict__ tab, int nz, int ny,
                           int n_verts, long long n,
                           const int* __restrict__ kinds,
                           const float* __restrict__ albedo, float eps,
                           float* __restrict__ orig, float* __restrict__ dir,
                           float* __restrict__ tmax,
                           float* __restrict__ contrib,
                           unsigned char* __restrict__ mask) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  const Verts v{tab, i};
  long long k = 0;
  for (int t = 2; t <= nz; ++t) {
    const int s_end = min(ny, n_verts - t);
    if (s_end < 1) continue;
    const int zi = t - 1;
    const Vec zp = v.vec(zi, kP), zn = v.vec(zi, kNg), zwo = v.vec(zi, kWo);
    const Vec zb = v.vec(zi, kBeta);
    const int zm = v.mat(zi);
    const bool z_ok = v.flag(zi, kValid) && !v.flag(zi, kDelta);
    for (int s = 1; s <= s_end; ++s, ++k) {
      const int yi = nz + s - 1;
      const Vec yp = v.vec(yi, kP), yn = v.vec(yi, kNg), yb = v.vec(yi, kBeta);
      float dist2, dist;
      const Vec d_zy = direction(zp, yp, dist2, dist);
      const Vec d_yz = neg(d_zy);
      const Vec f_z = eval_bsdf(kinds, albedo, zm, zn, zwo, d_zy);
      Vec f_y;
      if (s == 1) {
        // y0 is the emitter sample: its one-sided emission indicator
        const float ind = dot(yn, d_yz) > 0.0f ? 1.0f : 0.0f;
        f_y = {ind, ind, ind};
      } else {
        f_y = eval_bsdf(kinds, albedo, v.mat(yi), yn, v.vec(yi, kWo), d_yz);
      }
      const float g = fabsf(dot(zn, d_zy)) * fabsf(dot(yn, d_yz)) / dist2;
      const Vec c = scale(mul(mul(mul(zb, f_z), f_y), yb), g);
      // torch.amax(c, -1) > 0: false where any channel is NaN
      const bool c_pos = !(isnan(c.x) || isnan(c.y) || isnan(c.z)) &&
                         (c.x > 0.0f || c.y > 0.0f || c.z > 0.0f);
      const bool m = z_ok && v.flag(yi, kValid) && !v.flag(yi, kDelta) && c_pos;
      const Vec o = face_forward(zn, d_zy);
      const long long j = k * n + i;
      orig[3 * j] = zp.x + o.x * eps;
      orig[3 * j + 1] = zp.y + o.y * eps;
      orig[3 * j + 2] = zp.z + o.z * eps;
      dir[3 * j] = d_zy.x;
      dir[3 * j + 1] = d_zy.y;
      dir[3 * j + 2] = d_zy.z;
      tmax[j] = m ? dist * kShadowScale : 0.0f;
      contrib[3 * j] = c.x;
      contrib[3 * j + 1] = c.y;
      contrib[3 * j + 2] = c.z;
      mask[j] = m;
    }
  }
}

// bdpt._mis_weight(s, t) of lane v.i, s >= 1: z is zs[t - 1] of the table
// for t >= 2, and for t = 1 the camera `cam` (its vertex's position and
// normal; z's own chain is empty there)
__device__ __forceinline__ float mis_weight(const Verts& v, const int* kinds,
                                            int nz, int s, int t, bool power,
                                            const Camera& cam) {
  const int zi = t - 1, yi = nz + s - 1;
  Vec zp = cam.o, zn = cam.fwd, zwo{0.0f, 0.0f, 0.0f};
  int zm = 0;
  if (t >= 2) {
    zp = v.vec(zi, kP);
    zn = v.vec(zi, kNg);
    zwo = v.vec(zi, kWo);
    zm = v.mat(zi);
  }
  const Vec yp = v.vec(yi, kP), yn = v.vec(yi, kNg);
  float dist2, dist;
  const Vec d_zy = direction(zp, yp, dist2, dist);
  const Vec d_yz = neg(d_zy);
  Vec ywo{0.0f, 0.0f, 0.0f};
  int ym = 0;
  if (s >= 2) {
    ywo = v.vec(yi, kWo);
    ym = v.mat(yi);
  }
  // pdf of z from the light side: rev_z[t - 1], read only for t >= 2
  float rev_z1 = 0.0f;
  if (t >= 2) {
    const float sa_y = s == 1 ? clamp_min(dot(yn, d_yz), 0.0f) * kDivPi
                              : pdf_bsdf(kinds, ym, yn, ywo, d_yz);
    rev_z1 = convert_density(sa_y, yp, zp, zn);
  }
  // pdf of z's predecessor through z: rev_z[t - 2], read only for t >= 3
  float rev_z2 = 0.0f;
  if (t >= 3)
    rev_z2 = convert_density(pdf_bsdf(kinds, zm, zn, d_zy, zwo), zp,
                             v.vec(zi - 1, kP), v.vec(zi - 1, kNg));
  // pdf of y from the eye side: rev_y[s - 1], the camera's for t = 1
  const float sa_z = t == 1 ? camera_pdf_sa(cam, d_zy)
                            : pdf_bsdf(kinds, zm, zn, zwo, d_zy);
  const float rev_y1 = convert_density(sa_z, zp, yp, yn);
  // pdf of y's predecessor through y: rev_y[s - 2]
  float rev_y2 = 0.0f;
  if (s >= 2)
    rev_y2 = convert_density(pdf_bsdf(kinds, ym, yn, d_yz, ywo), yp,
                             v.vec(yi - 1, kP), v.vec(yi - 1, kNg));

  float sum = 0.0f;
  float ri = 1.0f;
  for (int a = t - 1; a > 0; --a) {
    const float rev = a == t - 1 ? rev_z1
                      : a == t - 2 ? rev_z2
                                   : v.scalar(a, kPdfRev);
    ri = ri * remap0(rev) / remap0(v.scalar(a, kPdfFwd));
    const bool ok = !v.flag(a, kDelta) && !v.flag(a - 1, kDelta);
    sum = sum + (ok ? (power ? ri * ri : ri) : 0.0f);
  }
  ri = 1.0f;
  for (int a = s - 1; a >= 0; --a) {
    const int ya = nz + a;
    const float rev = a == s - 1 ? rev_y1
                      : a == s - 2 ? rev_y2
                                   : v.scalar(ya, kPdfRev);
    ri = ri * remap0(rev) / remap0(v.scalar(ya, kPdfFwd));
    bool ok = !v.flag(ya, kDelta);
    if (a > 0) ok = ok && !v.flag(ya - 1, kDelta);
    sum = sum + (ok ? (power ? ri * ri : ri) : 0.0f);
  }
  return 1.0f / (sum + 1.0f);
}

__global__ void __launch_bounds__(kThreads)
    connect_finish_kernel(const long long* __restrict__ tab,
                          const long long* __restrict__ occ, int nz, int ny,
                          int n_verts, long long n, int power,
                          const int* __restrict__ kinds,
                          const float* __restrict__ contrib,
                          const unsigned char* __restrict__ mask,
                          float* __restrict__ out) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  const Verts v{tab, i};
  const Camera none{};   // read only by t = 1
  float lx = 0.0f, ly = 0.0f, lz = 0.0f;
  long long k = 0;
  for (int t = 2; t <= nz; ++t) {
    const int s_end = min(ny, n_verts - t);
    for (int s = 1; s <= s_end; ++s, ++k) {
      const long long j = k * n + i;
      const unsigned char* hit =
          reinterpret_cast<const unsigned char*>(__ldg(occ + k));
      float ax = 0.0f, ay = 0.0f, az = 0.0f;
      if (mask[j] && !hit[i]) {
        const float w = mis_weight(v, kinds, nz, s, t, power != 0, none);
        ax = contrib[3 * j] * w;
        ay = contrib[3 * j + 1] * w;
        az = contrib[3 * j + 2] * w;
      }
      lx = lx + ax;
      ly = ly + ay;
      lz = lz + az;
    }
  }
  out[3 * i] = lx;
  out[3 * i + 1] = ly;
  out[3 * i + 2] = lz;
}

// torch.clamp(x, lo, hi) on the card: NaN stays NaN
__device__ __forceinline__ float clamp(float x, float lo, float hi) {
  return isnan(x) ? x : fminf(fmaxf(x, lo), hi);
}

// the vertex table holds ys[0..ny) alone (nz = 0); the camera's terms are
// (3,) tensors (o, corner, du, dv, fwd) and 0-d ones (area, du2, dv2)
__global__ void __launch_bounds__(kThreads)
    splat_prepare_kernel(const long long* __restrict__ tab, int ny,
                         int n_verts, long long n, int width, int height,
                         const int* __restrict__ kinds,
                         const float* __restrict__ albedo,
                         const float* __restrict__ cam_o,
                         const float* __restrict__ corner,
                         const float* __restrict__ du,
                         const float* __restrict__ dv,
                         const float* __restrict__ fwd,
                         const float* __restrict__ area,
                         const float* __restrict__ du2,
                         const float* __restrict__ dv2,
                         float* __restrict__ orig, float* __restrict__ dir,
                         float* __restrict__ tmax,
                         float* __restrict__ contrib,
                         unsigned char* __restrict__ mask,
                         int* __restrict__ pix) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  const Verts v{tab, i};
  const Camera cam = camera_of(cam_o, fwd, area);
  // cam.corner - cam.o, the image plane's corner seen from the camera
  const Vec c0 = sub(load3(corner), cam.o);
  const Vec ax_u = load3(du), ax_v = load3(dv);
  const float u2 = *du2, v2 = *dv2;
  const float fw = static_cast<float>(width), fh = static_cast<float>(height);
  // (width * height) / x: a Python int over a tensor, reciprocal(x) * wh
  const float wh = static_cast<float>(static_cast<long long>(width) * height);
  orig[3 * i] = cam.o.x;
  orig[3 * i + 1] = cam.o.y;
  orig[3 * i + 2] = cam.o.z;
  const int s_end = min(ny, n_verts - 1);
  for (int s = 1; s <= s_end; ++s) {
    const int yi = s - 1;
    const Vec yp = v.vec(yi, kP), yn = v.vec(yi, kNg), yb = v.vec(yi, kBeta);
    float dist2, dist;
    const Vec d = direction(cam.o, yp, dist2, dist);   // camera -> y
    const float cos_c = dot(d, cam.fwd);
    const bool in_front = cos_c > kMinCos;
    // project onto the unit-distance image plane -> film uv
    const float cc = clamp_min(cos_c, kMinCos);
    const Vec rel = sub({d.x / cc, d.y / cc, d.z / cc}, c0);
    const float uu = dot(rel, ax_u) / u2;
    const float vv = dot(rel, ax_v) / v2;
    // clamped to one pixel outside the film before the cast, as there
    const long long px =
        static_cast<long long>(floorf(clamp(uu * fw, -1.0f, fw)));
    const long long py =
        static_cast<long long>(floorf(clamp(vv * fh, -1.0f, fh)));
    const bool on_film =
        px >= 0 && px < width && py >= 0 && py < height && in_front;
    const Vec d_yc = neg(d);
    Vec f_y;
    if (s == 1) {
      // y0 is the emitter sample: its one-sided emission indicator
      const float ind = dot(yn, d_yc) > 0.0f ? 1.0f : 0.0f;
      f_y = {ind, ind, ind};
    } else {
      f_y = eval_bsdf(kinds, albedo, v.mat(yi), yn, v.vec(yi, kWo), d_yc);
    }
    const float cos_y = fabsf(dot(yn, d));
    // importance W = WH / (A cos^3); camera -> y adds cos_y / r^2
    const float imp = 1.0f / (cam.area * (cc * cc * cc)) * wh;
    const float g = imp * cos_y / dist2;
    const Vec c = scale(mul(yb, f_y), g);
    // torch.amax(c, -1) > 0: false where any channel is NaN
    const bool c_pos = !(isnan(c.x) || isnan(c.y) || isnan(c.z)) &&
                       (c.x > 0.0f || c.y > 0.0f || c.z > 0.0f);
    const bool m = v.flag(yi, kValid) && !v.flag(yi, kDelta) && on_film &&
                   c_pos;
    const long long j = static_cast<long long>(s - 1) * n + i;
    dir[3 * j] = d.x;
    dir[3 * j + 1] = d.y;
    dir[3 * j + 2] = d.z;
    tmax[j] = m ? dist * kShadowScale : 0.0f;
    contrib[3 * j] = c.x;
    contrib[3 * j + 1] = c.y;
    contrib[3 * j + 2] = c.z;
    mask[j] = m;
    pix[j] = m ? static_cast<int>(py * width + px) : 0;
  }
}

__global__ void __launch_bounds__(kThreads)
    splat_finish_kernel(const long long* __restrict__ tab,
                        const long long* __restrict__ occ, int ny,
                        int n_verts, long long n, int power,
                        const int* __restrict__ kinds,
                        const float* __restrict__ cam_o,
                        const float* __restrict__ fwd,
                        const float* __restrict__ area,
                        const float* __restrict__ contrib,
                        const unsigned char* __restrict__ mask,
                        const int* __restrict__ pix,
                        float* __restrict__ film) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  const Verts v{tab, i};
  const Camera cam = camera_of(cam_o, fwd, area);
  const int s_end = min(ny, n_verts - 1);
  for (int s = 1; s <= s_end; ++s) {
    const long long j = static_cast<long long>(s - 1) * n + i;
    const unsigned char* hit =
        reinterpret_cast<const unsigned char*>(__ldg(occ + s - 1));
    if (!mask[j] || hit[i]) continue;
    const float w = mis_weight(v, kinds, 0, s, 1, power != 0, cam);
    float* f = film + 3 * static_cast<long long>(pix[j]);
    atomicAdd(f, contrib[3 * j] * w);
    atomicAdd(f + 1, contrib[3 * j + 1] * w);
    atomicAdd(f + 2, contrib[3 * j + 2] * w);
  }
}

// copies `count` entries of the host array `src` into `dst` on the device
int fill_table(long long* dst, const long long* src, int count,
               cudaStream_t stream) {
  for (int off = 0; off < count; off += kTableChunk) {
    const int m = count - off < kTableChunk ? count - off : kTableChunk;
    TableChunk chunk;
    for (int j = 0; j < m; ++j) chunk.v[j] = src[off + j];
    connect_table_kernel<<<1, kTableChunk, 0, stream>>>(dst + off, chunk, m);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

unsigned grid_of(long long n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

// Fills the vertex table `dev_tab` from the host array `host_tab`
// (n_tab = (nz + ny) * kFields pointers, 0 for a field never read), then
// runs the first kernel on n lanes into the (S, n) and (S, n, 3) buffers.
// Returns cudaGetLastError() after the launches: a refused launch never
// runs, and a later synchronize would not report it.
int tpt_connect_prepare(const long long* host_tab, int n_tab,
                        long long* dev_tab, int nz, int ny, int n_verts,
                        long long n, const int* kinds, const float* albedo,
                        float eps, float* orig, float* dir, float* tmax,
                        float* contrib, unsigned char* mask, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int err = fill_table(dev_tab, host_tab, n_tab, st);
  if (err != 0 || n <= 0) return err;
  connect_prepare_kernel<<<grid_of(n), kThreads, 0, st>>>(
      dev_tab, nz, ny, n_verts, n, kinds, albedo, eps, orig, dir, tmax,
      contrib, mask);
  return static_cast<int>(cudaGetLastError());
}

// Fills `dev_occ` with the S occlusion results' pointers (`host_occ`),
// then runs the second kernel on n lanes, writing the (n, 3) sum `out`.
int tpt_connect_finish(const long long* host_occ, int n_occ,
                       long long* dev_occ, const long long* dev_tab, int nz,
                       int ny, int n_verts, long long n, int power,
                       const int* kinds, const float* contrib,
                       const unsigned char* mask, float* out, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int err = fill_table(dev_occ, host_occ, n_occ, st);
  if (err != 0 || n <= 0) return err;
  connect_finish_kernel<<<grid_of(n), kThreads, 0, st>>>(
      dev_tab, dev_occ, nz, ny, n_verts, n, power, kinds, contrib, mask, out);
  return static_cast<int>(cudaGetLastError());
}

// Fills the vertex table `dev_tab` from `host_tab` (n_tab = ny * kFields
// pointers of ys alone), then runs the first splat kernel on n lanes into
// the (n, 3) origins and the (S, n) and (S, n, 3) buffers.
int tpt_splat_prepare(const long long* host_tab, int n_tab,
                      long long* dev_tab, int ny, int n_verts, long long n,
                      int width, int height, const int* kinds,
                      const float* albedo, const float* cam_o,
                      const float* corner, const float* du, const float* dv,
                      const float* fwd, const float* area, const float* du2,
                      const float* dv2, float* orig, float* dir, float* tmax,
                      float* contrib, unsigned char* mask, int* pix,
                      void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int err = fill_table(dev_tab, host_tab, n_tab, st);
  if (err != 0 || n <= 0) return err;
  splat_prepare_kernel<<<grid_of(n), kThreads, 0, st>>>(
      dev_tab, ny, n_verts, n, width, height, kinds, albedo, cam_o, corner,
      du, dv, fwd, area, du2, dv2, orig, dir, tmax, contrib, mask, pix);
  return static_cast<int>(cudaGetLastError());
}

// Fills `dev_occ` with the S occlusion results' pointers (`host_occ`),
// then runs the second splat kernel on n lanes, adding into `film`.
int tpt_splat_finish(const long long* host_occ, int n_occ, long long* dev_occ,
                     const long long* dev_tab, int ny, int n_verts,
                     long long n, int power, const int* kinds,
                     const float* cam_o, const float* fwd, const float* area,
                     const float* contrib, const unsigned char* mask,
                     const int* pix, float* film, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int err = fill_table(dev_occ, host_occ, n_occ, st);
  if (err != 0 || n <= 0) return err;
  splat_finish_kernel<<<grid_of(n), kThreads, 0, st>>>(
      dev_tab, dev_occ, ny, n_verts, n, power, kinds, cam_o, fwd, area,
      contrib, mask, pix, film);
  return static_cast<int>(cudaGetLastError());
}

const char* tpt_connect_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
