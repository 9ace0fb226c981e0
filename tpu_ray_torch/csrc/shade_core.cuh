// Device code shared by the fused pool step, the hit-record + scatter kernel
// (pool_step.cu) and the whole-wave megakernel (megakernel.cu): the parameter
// block, the murmur3 streams, the textures, the shade core (hit record +
// textures + scatter of one lane) and one pool iteration of a lane (estimator
// update, Russian roulette, path death, camera regeneration, hashed or
// Sobol').  Four bits of ``flags`` select what the JAX package selects by
// static arguments or by its XLA path: SAMPLER_SOBOL the scrambled Sobol'
// camera sample (qmc.cuh), STRICT the reference estimator (table-noise
// Perlin octaves, the Lambertian's mixture with an unhittable light in
// scenes without lights, the ball-radius isotropic phase), HAS_CHECKER_FANCY
// checkers whose children are textures (each child evaluated by its own
// row of the texture table, textures.texture_value), SAMPLER_B0 the work
// queue's sobol-b0 first-bounce scatter draws (qmc.cuh sobol_bounce0).
// They are template arguments of the core (SOBOL_ON, STRICT_ON, FANCY_ON,
// B0_ON), and each kernel's C entry launches the instantiation that the
// bits name: the uniform, fixed path is compiled without any of the
// branches, which, compiled in and skipped, cost the step 2% of its time
// (one H100, PERF.md).  The hit record (hit_record) and the texture value
// (albedo) are device functions of their own, which the first-hit AOV
// kernel (aov.cu) calls too.  The four kernels run this one copy,
// statement for statement in the order of the plain version
// tpu_ray_torch/ops/shade.py, so a lane's discrete decisions are the same
// in all of them.  Needs IEEE arithmetic: no fast math, --fmad=false.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "qmc.cuh"
#include "sweep_pairs.cuh"

#define PRIM_COLS 40

enum { PRIM_SPHERE = 0, PRIM_BOX = 1, PRIM_QUAD = 2, PRIM_MEDIUM_SPHERE = 3 };
enum { MAT_LAMBERTIAN = 0, MAT_METAL = 1, MAT_DIELECTRIC = 2,
       MAT_DIFFUSE_LIGHT = 3, MAT_ISOTROPIC = 4 };
enum { TEX_CHECKER = 1, TEX_PERLIN = 2, TEX_IMAGE = 3 };
enum {
  HAS_MOVING = 1 << 0, HAS_QUADS = 1 << 1, HAS_SOLID_BOX = 1 << 2,
  HAS_MEDIA = 1 << 3, HAS_CHECKER = 1 << 4, HAS_PERLIN = 1 << 5,
  HAS_EMISSIVE = 1 << 6, HAS_LAMBERTIAN = 1 << 7, HAS_METAL = 1 << 8,
  HAS_DIELECTRIC = 1 << 9, HAS_ISOTROPIC = 1 << 10, HAS_IMAGE = 1 << 11,
  ANY_TRANSFORM = 1 << 12,
  HAS_CHECKER_FANCY = 1 << 13,   // a checker with a non-constant child
  // render-wide switches (ops/shade.py::_params), not scene features
  SAMPLER_SOBOL = 1 << 14, STRICT = 1 << 15, SAMPLER_B0 = 1 << 16
};

// per-texture rows (ops/shade.py::texture_table): 0 kind | 1:4 colour
// | 4 Perlin scale | 5 image id | 6 Perlin instance | 7 hash salt (bits)
#define TEX_COLS 8

// layout mirrored by tpu_ray_torch/ops/shade.py::_params (32-bit words)
struct StepParams {
  float cam[21];       // origin, lower_left, horizontal, vertical, u, v, (lens r, t0, t1)
  float bg[3];
  float inv_w, inv_h, t_min;
  uint32_t kd0, kd1, sample0, cam_salt;
  int n_samples, max_depth, rr_depth, n_lights, flags, init;
  int img_h, img_w;    // padded atlas rows and columns per image
};
static_assert(sizeof(StepParams) == 4 * (24 + 15),
              "StepParams layout");

// The words of a work-queue render that change from one render to the next
// while everything else of its iterations stays: a render replayed from
// CUDA graphs (tpu_ray_torch/integrator.py::QueuePlan) writes them into one
// block on the device before its first replay, and the kernels it replays
// read them from there, where their by-value arguments would stay frozen at
// the capture's.  Layout mirrored by tpu_ray_torch/ops/queue.py::
// render_words.  A null block pointer: the by-value arguments, as ever.
struct RenderWords {
  uint32_t kd_isect[2];  // tr_bvh's kd0, kd1 (the media draws)
  uint32_t kd_scat[2];   // tr_pool_step's StepParams kd0, kd1
  uint32_t cam_salt;     // tr_queue_inject's; the sobol-b0 step's P.cam_salt
  uint32_t id0;          // tr_path_ids' id0
  long long gs0;         // tr_queue_inject's work_base / (W * H)
};
static_assert(sizeof(RenderWords) == 32, "RenderWords layout");

#define TWO_PI 6.28318548202514648f      // float32(2 pi)
#define INV_PI 0.31830987334251404f      // float32(1 / pi)
#define RR_PMIN 0.05000000074505806f     // float32(0.05)
#define RR_COL 14
#define PI_F 3.14159274101257324f        // float32(pi)
#define HALF_PI_F 1.57079637050628662f   // float32(pi / 2)
#define IMG_EPS 9.99999974737875164e-05f // float32(1e-4)
#define INV_255 0.00392156885936856270f  // float32(1 / 255)

struct V3 { float x, y, z; };

__device__ __forceinline__ float dot3(V3 a, V3 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}
__device__ __forceinline__ V3 cross3(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
__device__ __forceinline__ V3 normalize3(V3 a) {
  const float n2 = dot3(a, a);
  const float inv = n2 > 0.0f ? 1.0f / sqrtf(jmax(n2, 1e-30f)) : 0.0f;
  return {a.x * inv, a.y * inv, a.z * inv};
}
__device__ __forceinline__ V3 reflect3(V3 v, V3 n) {
  const float d = dot3(v, n);
  return {v.x - 2.0f * d * n.x, v.y - 2.0f * d * n.y, v.z - 2.0f * d * n.z};
}
__device__ __forceinline__ V3 refract3(V3 uv, V3 n, float ratio) {
  const float ct = dot3({-uv.x, -uv.y, -uv.z}, n);
  const V3 rp = {ratio * (uv.x + ct * n.x), ratio * (uv.y + ct * n.y),
                 ratio * (uv.z + ct * n.z)};
  const float s = -sqrtf(jmax(1.0f - dot3(rp, rp), 0.0f));
  return {rp.x + s * n.x, rp.y + s * n.y, rp.z + s * n.z};
}
// orthonormal basis about w = unit(n), applied to local x
__device__ __forceinline__ V3 onb_apply(V3 n, V3 x) {
  const V3 w = normalize3(n);
  const bool pick = fabsf(w.x) > 0.9f;
  const V3 a = {pick ? 0.0f : 1.0f, pick ? 1.0f : 0.0f, 0.0f};
  const V3 v = normalize3(cross3(w, a));
  const V3 u = cross3(w, v);
  return {x.x * u.x + x.y * v.x + x.z * w.x, x.x * u.y + x.y * v.y + x.z * w.y,
          x.x * u.z + x.y * v.z + x.z * w.z};
}
__device__ __forceinline__ V3 unit_vector_from(float u0, float u1) {
  const float a = TWO_PI * u0;
  const float z = 2.0f * u1 - 1.0f;
  const float r = sqrtf(jmax(1.0f - z * z, 0.0f));
  return {r * cosf(a), r * sinf(a), z};
}
__device__ __forceinline__ V3 cosine_direction_from(float u0, float u1) {
  const float z = sqrtf(jmax(1.0f - u1, 0.0f));
  const float phi = TWO_PI * u0;
  const float sq = sqrtf(u1);
  return {cosf(phi) * sq, sinf(phi) * sq, z};
}
__device__ __forceinline__ V3 to_sphere_from(float u0, float u1, float radius,
                                             float dist_squared) {
  const float ctm = sqrtf(jmax(1.0f - radius * radius / dist_squared, 0.0f));
  const float z = 1.0f + u1 * (ctm - 1.0f);
  const float phi = TWO_PI * u0;
  const float sq = sqrtf(jmax(1.0f - z * z, 0.0f));
  return {cosf(phi) * sq, sinf(phi) * sq, z};
}

// --- murmur3 streams (core/rng.py) -----------------------------------------
__device__ __forceinline__ uint32_t fmix(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}
__device__ __forceinline__ float hash_col(uint32_t base, uint32_t i) {
  const uint32_t salt = 0x9E3779B9u * (i + 1u);
  const uint32_t bits = fmix(fmix(base + salt) ^ salt);
  return (float)(bits >> 8) * (1.0f / 16777216.0f);
}

// --- hash-gradient Perlin marble (megakernel._perlin_noise / _marble) -------
__device__ float perlin_noise(uint32_t salt, float qx, float qy, float qz) {
  const float ix = floorf(qx), iy = floorf(qy), iz = floorf(qz);
  const float ux = qx - ix, uy = qy - iy, uz = qz - iz;
  const float hx_ = ux * ux * (3.0f - 2.0f * ux);
  const float hy_ = uy * uy * (3.0f - 2.0f * uy);
  const float hz_ = uz * uz * (3.0f - 2.0f * uz);
  const uint32_t cx0 = (uint32_t)(int)ix * 0x8DA6B343u;
  const uint32_t cy0 = (uint32_t)(int)iy * 0xD8163841u;
  const uint32_t cz0 = (uint32_t)(int)iz * 0xCB1AB31Fu;
  const uint32_t hx[2] = {cx0, cx0 + 0x8DA6B343u};
  const uint32_t hy[2] = {cy0, cy0 + 0xD8163841u};
  const uint32_t hz[2] = {cz0, cz0 + 0xCB1AB31Fu};
  const float to_signed = 2.0f / 16777216.0f;
  float acc = 0.0f;
  for (int di = 0; di < 2; ++di) {
    const float w0 = di ? hx_ : 1.0f - hx_;
    const float ox = ux - (float)di;
    for (int dj = 0; dj < 2; ++dj) {
      const float w1 = dj ? hy_ : 1.0f - hy_;
      const float oy = uy - (float)dj;
      for (int dk = 0; dk < 2; ++dk) {
        const float w2 = dk ? hz_ : 1.0f - hz_;
        const float oz = uz - (float)dk;
        const uint32_t h1 = fmix(hx[di] ^ hy[dj] ^ hz[dk] ^ salt);
        const uint32_t h2 = fmix(h1 ^ 0x68E31DA4u);
        const uint32_t h3 = fmix(h2 ^ 0xB5297A4Du);
        const float gx = (float)(h1 >> 8) * to_signed - 1.0f;
        const float gy = (float)(h2 >> 8) * to_signed - 1.0f;
        const float gz = (float)(h3 >> 8) * to_signed - 1.0f;
        acc = acc + (w0 * w1 * w2) * (gx * ox + gy * oy + gz * oz);
      }
    }
  }
  return acc;
}

// scene tables shared by the kernels
struct Tables {
  const float* __restrict__ tab;          // (N, 40) prim + material rows
  const uint32_t* __restrict__ salt;      // (N) Perlin salt per prim
  const float* __restrict__ lights;       // (L, 25)
  const uint32_t* __restrict__ atlas;     // (I, img_h, img_w) packed RGB
  const int* __restrict__ img_size;       // (I, 2) width, height
  const int* __restrict__ perlin_id;      // (N) Perlin instance per prim
  const int* __restrict__ perm;           // (P, 3, 256) strict-mode tables
  const float* __restrict__ ranvec;       // (P, 256, 3)
  // checkers with textured children (HAS_CHECKER_FANCY) only; null else
  const float* __restrict__ texrow;       // (T, TEX_COLS) texture rows
  const int* __restrict__ kids;           // (M, 2) odd, even texture ids
};

// --- the reference's table-noise octave (strict mode) ----------------------
// textures.py::_perlin_noise_table: gradient ranvec[permX[(i+di) & 255] ^
// permY[..] ^ permZ[..]] of Perlin instance pid; & 255 on the int32 lattice
// coordinate is the mathematical mod for negative ones too.  The tables are
// 6 KB per instance and stay in L1 / L2.
__device__ float perlin_noise_table(const Tables& T, int pid, float qx,
                                    float qy, float qz) {
  const float ix = floorf(qx), iy = floorf(qy), iz = floorf(qz);
  const float ux = qx - ix, uy = qy - iy, uz = qz - iz;
  const float hx_ = ux * ux * (3.0f - 2.0f * ux);
  const float hy_ = uy * uy * (3.0f - 2.0f * uy);
  const float hz_ = uz * uz * (3.0f - 2.0f * uz);
  const int i0 = (int)ix, j0 = (int)iy, k0 = (int)iz;
  const int* perm = T.perm + pid * 768;
  const int px[2] = {perm[i0 & 255], perm[(i0 + 1) & 255]};
  const int py[2] = {perm[256 + (j0 & 255)], perm[256 + ((j0 + 1) & 255)]};
  const int pz[2] = {perm[512 + (k0 & 255)], perm[512 + ((k0 + 1) & 255)]};
  const float* rv = T.ranvec + pid * 768;
  float acc = 0.0f;
  for (int di = 0; di < 2; ++di) {
    const float w0 = di ? hx_ : 1.0f - hx_;
    const float ox = ux - (float)di;
    for (int dj = 0; dj < 2; ++dj) {
      const float w1 = dj ? hy_ : 1.0f - hy_;
      const float oy = uy - (float)dj;
      for (int dk = 0; dk < 2; ++dk) {
        const float w2 = dk ? hz_ : 1.0f - hz_;
        const float oz = uz - (float)dk;
        const float* g = rv + 3 * (px[di] ^ py[dj] ^ pz[dk]);
        acc = acc + (w0 * w1 * w2) * (g[0] * ox + g[1] * oy + g[2] * oz);
      }
    }
  }
  return acc;
}

// 7-octave turbulence marble: the hash-gradient octave of stream ``salt``,
// or with TABLE the reference's table octave of Perlin instance ``pid``
template <bool TABLE>
__device__ float marble(const Tables& T, uint32_t salt, int pid, float scale,
                        float px, float py, float pz) {
  float acc = 0.0f, ppx = px, ppy = py, ppz = pz, weight = 1.0f;
  for (int o = 0; o < 7; ++o) {
    const float qx = scale * ppx, qy = scale * ppy, qz = scale * ppz;
    const float noise = TABLE ? perlin_noise_table(T, pid, qx, qy, qz)
                              : perlin_noise(salt, qx, qy, qz);
    acc = acc + weight * noise;
    ppx = 2.0f * ppx;
    ppy = 2.0f * ppy;
    ppz = 2.0f * ppz;
    weight = weight * 0.5f;
  }
  return 0.5f * (1.0f + sinf(pz + 10.0f * fabsf(acc)));
}

// textures.image_value_from: clamp, v-flip, one packed-texel load
__device__ __forceinline__ V3 image_texel(const StepParams& P, const Tables& T,
                                          int iid, float u, float v) {
  const float nx = (float)T.img_size[2 * iid];
  const float ny = (float)T.img_size[2 * iid + 1];
  const int ti = (int)floorf(jmin(jmax(u * nx, 0.0f), nx - IMG_EPS));
  const int tj = (int)floorf(
      jmin(jmax((1.0f - v) * ny - IMG_EPS, 0.0f), ny - IMG_EPS));
  const uint32_t tex = T.atlas[((long long)iid * P.img_h + tj) * P.img_w + ti];
  return {(float)(tex & 0xFFu) * INV_255, (float)((tex >> 8) & 0xFFu) * INV_255,
          (float)((tex >> 16) & 0xFFu) * INV_255};
}

// textures._base_value: a checker's child, evaluated by its own texture row
// as a texture that is not a checker (a checker child, which the scene
// compiler refuses, would be its constant colour)
template <bool STRICT_ON>
__device__ V3 child_texture(const StepParams& P, const Tables& T, int tex,
                            V3 p, float u, float v) {
  const float* tr = T.texrow + (long long)tex * TEX_COLS;
  const int kind = (int)tr[0];
  V3 val = {tr[1], tr[2], tr[3]};
  if ((P.flags & HAS_PERLIN) && kind == TEX_PERLIN) {
    const float m = marble<STRICT_ON>(T, STRICT_ON ? 0u : __float_as_uint(tr[7]),
                                      STRICT_ON ? (int)tr[6] : 0, tr[4], p.x,
                                      p.y, p.z);
    val = {m, m, m};
  }
  if ((P.flags & HAS_IMAGE) && kind == TEX_IMAGE)
    val = image_texel(P, T, (int)tr[5], u, v);
  return val;
}

// The hit record of a lane's sweep result (ops/intersect.py::_hit_record):
// point, face-flipped normal, front face and texture (u, v).
struct Hit {
  V3 p, n;
  float u, v;
  bool front;
};

// ``row`` is the winner's prim row, ``ts`` its hit distance made finite.
__device__ __forceinline__ Hit hit_record(const StepParams& P, const float* row,
                                          V3 o, V3 d, float tm, float ts) {
  const int fl = P.flags;
  Hit h;
  const V3 p = {o.x + ts * d.x, o.y + ts * d.y, o.z + ts * d.z};
  h.p = p;
  h.u = 0.0f;
  h.v = 0.0f;
  const int kind = (int)row[0];
  V3 n;
  if (kind == PRIM_QUAD && (fl & HAS_QUADS)) {
    n = {row[5], row[6], row[7]};
    if (fl & HAS_IMAGE) {
      const V3 q = {p.x - row[2], p.y - row[3], p.z - row[4]};
      h.u = q.x * row[10] + q.y * row[11] + q.z * row[12];
      h.v = q.x * row[13] + q.y * row[14] + q.z * row[15];
    }
  } else if (kind == PRIM_BOX && (fl & HAS_SOLID_BOX)) {
    const float ix = 1.0f / d.x, iy = 1.0f / d.y, iz = 1.0f / d.z;
    const float tax = (row[2] - o.x) * ix, tbx = (row[5] - o.x) * ix;
    const float tay = (row[3] - o.y) * iy, tby = (row[6] - o.y) * iy;
    const float taz = (row[4] - o.z) * iz, tbz = (row[7] - o.z) * iz;
    const float n0 = jmin(tax, tbx), n1 = jmin(tay, tby), n2 = jmin(taz, tbz);
    const float f0 = jmax(tax, tbx), f1 = jmax(tay, tby), f2 = jmax(taz, tbz);
    const float tn_b = jmax(jmax(n0, n1), n2);
    int ax_n = n1 > n0 ? 1 : 0;
    ax_n = n2 > jmax(n0, n1) ? 2 : ax_n;
    int ax_f = f1 < f0 ? 1 : 0;
    ax_f = f2 < jmin(f0, f1) ? 2 : ax_f;
    const int axis = tn_b > P.t_min ? ax_n : ax_f;
    n = {axis == 0 ? 1.0f : 0.0f, axis == 1 ? 1.0f : 0.0f,
         axis == 2 ? 1.0f : 0.0f};
    if (fl & HAS_IMAGE) {
      // face uv: z-face -> (x, y), y-face -> (x, z), x-face -> (y, z)
      const float fx = (p.x - row[2]) / jmax(row[5] - row[2], 1e-30f);
      const float fy = (p.y - row[3]) / jmax(row[6] - row[3], 1e-30f);
      const float fz = (p.z - row[4]) / jmax(row[7] - row[4], 1e-30f);
      h.u = axis == 0 ? fy : fx;
      h.v = axis == 2 ? fy : fz;
    }
  } else {
    float cx = row[2], cy = row[3], cz = row[4];
    if (fl & HAS_MOVING) {
      const float dt = tm - row[8];
      cx = cx + row[5] * dt;
      cy = cy + row[6] * dt;
      cz = cz + row[7] * dt;
    }
    const float rr = jmax(row[9], 1e-12f);
    n = {(p.x - cx) / rr, (p.y - cy) / rr, (p.z - cz) / rr};
    if (fl & HAS_IMAGE) {
      // spherical uv of the outward normal
      const float phi = atan2f(n.z, n.x);
      const float theta = asinf(jmin(jmax(n.y, -1.0f), 1.0f));
      h.u = 1.0f - (phi + PI_F) / TWO_PI;
      h.v = (theta + HALF_PI_F) / PI_F;
    }
  }
  bool front = dot3(d, n) < 0.0f;
  if (!front) n = {-n.x, -n.y, -n.z};
  if ((fl & HAS_MEDIA) && kind >= PRIM_MEDIUM_SPHERE) {
    n = {1.0f, 0.0f, 0.0f};
    front = true;
    h.u = 0.0f;
    h.v = 0.0f;
  }
  h.n = n;
  h.front = front;
  return h;
}

// The texture value at a hit of prim ``idx`` (row ``row``):
// textures.texture_value_packed from the row's material columns, or with
// FANCY_ON a checker's children by their texture rows (texture_value).
template <bool STRICT_ON, bool FANCY_ON>
__device__ __forceinline__ V3 albedo(const StepParams& P, const Tables& T,
                                     const float* row, int idx, V3 p, float u,
                                     float v) {
  const int fl = P.flags;
  V3 att = {row[20], row[21], row[22]};
  const int tex_kind = (int)row[19];
  if ((fl & HAS_CHECKER) && tex_kind == TEX_CHECKER) {
    const float sines = sinf(10.0f * p.x) * sinf(10.0f * p.y) *
                        sinf(10.0f * p.z);
    if (FANCY_ON) {
      const int* kid = T.kids + 2 * (int)row[1];
      att = child_texture<STRICT_ON>(P, T, sines < 0.0f ? kid[0] : kid[1], p,
                                     u, v);
    } else {
      att = sines < 0.0f ? V3{row[23], row[24], row[25]}
                         : V3{row[26], row[27], row[28]};
    }
  }
  if ((fl & HAS_PERLIN) && tex_kind == TEX_PERLIN) {
    const float m = marble<STRICT_ON>(T, STRICT_ON ? 0u : T.salt[idx],
                                      STRICT_ON ? T.perlin_id[idx] : 0,
                                      row[29], p.x, p.y, p.z);
    att = {m, m, m};
  }
  if ((fl & HAS_IMAGE) && tex_kind == TEX_IMAGE)
    att = image_texel(P, T, (int)row[39], u, v);
  return att;
}

struct Shade {
  V3 p, n, dir, w, emitted;
  float u, v;
  int mat;
  bool front, scattered;
  uint32_t base;
};

// Hit record + textures + scatter of one lane whose sweep result is
// (ts, idx), ts already made finite (ops/shade.py::_shade); (kd0, kd1) are
// the scatter key's words.  With B0_ON, a lane whose ``first`` is set (its
// first bounce) takes scatter columns 2, 3 (the light's uv) and 6, 7 (the
// cosine lobe's) from b0u[0..3] instead of the hashed draws: the queue's
// sobol-b0 first bounce.  Without B0_ON neither argument is read.
template <bool STRICT_ON, bool FANCY_ON, bool B0_ON>
__device__ Shade shade_core(const StepParams& P, const Tables& T, V3 o, V3 d,
                            float tm, float ts, int idx, uint32_t slot,
                            uint32_t kd0, uint32_t kd1, bool first,
                            const float* b0u) {
  const int fl = P.flags;
  Shade s;
  s.emitted = {0.0f, 0.0f, 0.0f};
  s.dir = d;
  s.w = {0.0f, 0.0f, 0.0f};
  const float* row = T.tab + (long long)idx * PRIM_COLS;
  s.mat = (int)row[1];
  const float t_min = P.t_min;

  const Hit h = hit_record(P, row, o, d, tm, ts);
  const V3 p = h.p, n = h.n;
  const bool front = h.front;
  s.p = p;
  s.n = n;
  s.u = h.u;
  s.v = h.v;
  s.front = front;

  const int mkind = (int)row[16];
  const uint32_t base = fmix(slot + kd0) ^ kd1;
  s.base = base;
  const V3 att = albedo<STRICT_ON, FANCY_ON>(P, T, row, idx, p, h.u, h.v);
  const V3 unit_d = normalize3(d);
  if ((fl & HAS_EMISSIVE) && mkind == MAT_DIFFUSE_LIGHT && !front)
    s.emitted = att;

  // ---- scatter: the lane's own material branch ----
  V3 dir = d, w = {0.0f, 0.0f, 0.0f};
  const float* lights = T.lights;
  if (mkind == MAT_LAMBERTIAN && (fl & HAS_LAMBERTIAN)) {
    const bool b0 = B0_ON && first;
    const V3 cos_dir = onb_apply(n, cosine_direction_from(
        b0 ? b0u[2] : hash_col(base, 6), b0 ? b0u[3] : hash_col(base, 7)));
    const int L = P.n_lights;
    if (L > 0) {
      const int pick = min((int)(hash_col(base, 1) * (float)L), L - 1);
      const float* lr = lights + pick * 25;
      V3 light_dir;
      if (lr[13] > 0.5f) {
        const float u2 = b0 ? b0u[0] : hash_col(base, 2);
        const float u3 = b0 ? b0u[1] : hash_col(base, 3);
        light_dir = {lr[0] + u2 * lr[3] + u3 * lr[6] - p.x,
                     lr[1] + u2 * lr[4] + u3 * lr[7] - p.y,
                     lr[2] + u2 * lr[5] + u3 * lr[8] - p.z};
      } else {
        const V3 dc = {lr[9] - p.x, lr[10] - p.y, lr[11] - p.z};
        const float d2 = dot3(dc, dc);
        light_dir = onb_apply(dc, to_sphere_from(
            hash_col(base, 4), hash_col(base, 5), lr[12], jmax(d2, 1e-12f)));
      }
      dir = normalize3(hash_col(base, 0) < 0.5f ? light_dir : cos_dir);
      const float cos_pdf = jmax(dot3(dir, n), 0.0f) * INV_PI;
      float pdf_sum = 0.0f;
      for (int li = 0; li < L; ++li) {
        const float* q = lights + li * 25;
        float pdf;
        if (q[13] > 0.5f) {
          const V3 nl = {q[14], q[15], q[16]};
          const float dn = dot3(dir, nl);
          const float tq = (q[17] - (p.x * nl.x + p.y * nl.y + p.z * nl.z)) / dn;
          const float xx = p.x + tq * dir.x - q[0];
          const float xy_ = p.y + tq * dir.y - q[1];
          const float xz = p.z + tq * dir.z - q[2];
          const float uq = xx * q[18] + xy_ * q[19] + xz * q[20];
          const float vq = xx * q[21] + xy_ * q[22] + xz * q[23];
          const bool hq = (tq > t_min) && (uq >= 0.0f) && (uq <= 1.0f) &&
                          (vq >= 0.0f) && (vq <= 1.0f);
          pdf = hq ? tq * tq / jmax(fabsf(dn) * q[24], 1e-12f) : 0.0f;
        } else {
          const float ocx = p.x - q[9], ocy = p.y - q[10], ocz = p.z - q[11];
          const float bq = ocx * dir.x + ocy * dir.y + ocz * dir.z;
          const float oc2 = ocx * ocx + ocy * ocy + ocz * ocz;
          const float r2 = q[12] * q[12];
          const float disc = bq * bq - (oc2 - r2);
          const float sd = sqrtf(jmax(disc, 0.0f));
          const bool hs = (disc > 0.0f) &&
                          ((-bq - sd > t_min) || (-bq + sd > t_min));
          const float ctm = sqrtf(jmax(1.0f - r2 / jmax(oc2, 1e-12f), 0.0f));
          const float solid = TWO_PI * (1.0f - ctm);
          pdf = hs ? 1.0f / jmax(solid, 1e-12f) : 0.0f;
        }
        pdf_sum = pdf_sum + pdf;
      }
      const float pdf_val = 0.5f * (pdf_sum / (float)L + cos_pdf);
      const float w_mis = pdf_val > 0.0f ? cos_pdf / jmax(pdf_val, 1e-12f)
                                         : 0.0f;
      w = {att.x * w_mis, att.y * w_mis, att.z * w_mis};
    } else if (STRICT_ON) {
      // the reference's mixture with an unhittable light: half the draws go
      // to (1,0,0) at light density 0, so the weight is 2 att above the
      // surface and its 0/0 sample below it is floored to black
      const V3 one_x = {1.0f, 0.0f, 0.0f};
      dir = normalize3(hash_col(base, 0) < 0.5f ? one_x : cos_dir);
      const float f = dot3(dir, n) > 0.0f ? 2.0f : 0.0f;
      w = {att.x * f, att.y * f, att.z * f};
    } else {
      dir = normalize3(cos_dir);
      w = att;
    }
  } else if (mkind == MAT_METAL && (fl & HAS_METAL)) {
    const float fuzz = row[17];
    const V3 refl = reflect3(unit_d, n);
    const V3 fv = unit_vector_from(hash_col(base, 8), hash_col(base, 9));
    dir = {refl.x + fuzz * fv.x, refl.y + fuzz * fv.y, refl.z + fuzz * fv.z};
    w = att;
  } else if (mkind == MAT_DIELECTRIC && (fl & HAS_DIELECTRIC)) {
    const float ri = row[18];
    const float ratio = front ? 1.0f / ri : ri;
    const float ct = jmin(dot3({-unit_d.x, -unit_d.y, -unit_d.z}, n), 1.0f);
    const float st = sqrtf(jmax(1.0f - ct * ct, 0.0f));
    const float q = (1.0f - ratio) / (1.0f + ratio);
    const float r0 = q * q;
    const float x = 1.0f - ct;
    const float x2 = x * x;
    const float refl_prob = r0 + (1.0f - r0) * (x * (x2 * x2));
    const bool do_reflect = (ratio * st > 1.0f) ||
                            (hash_col(base, 10) < refl_prob);
    dir = do_reflect ? reflect3(unit_d, n) : refract3(unit_d, n, ratio);
    w = {1.0f, 1.0f, 1.0f};
  } else if (mkind == MAT_ISOTROPIC && (fl & HAS_ISOTROPIC)) {
    dir = unit_vector_from(hash_col(base, 11), hash_col(base, 12));
    w = att;
    if (STRICT_ON) {
      // the reference's non-unit ball direction weighed by cos/pi against
      // the medium's fixed normal; cbrt in double rounded once to float is
      // the correctly rounded root (core/vec.py::cbrt_rn)
      const float rad = (float)cbrt((double)jmax(hash_col(base, 13), 1e-6f));
      dir = {dir.x * rad, dir.y * rad, dir.z * rad};
      const float c = jmax(dot3(n, dir), 0.0f) * INV_PI;
      w = {att.x * c, att.y * c, att.z * c};
    }
  }
  s.dir = dir;
  s.w = w;
  s.scattered = !((fl & HAS_EMISSIVE) && mkind == MAT_DIFFUSE_LIGHT);
  return s;
}

// One lane of the pool (ops/shade.py state layout).
struct Lane {
  V3 o, d;
  float tm;
  V3 tp, ac;
  int bounce, sample, active;
};

// One pool iteration of a lane: shade its sweep result (t, idx), update the
// estimator (integrator.trace_pool body), and regenerate the camera sample
// where the path died (rng.hash_uniforms2 + camera.rays_from_uniforms).
// ``init`` runs the regeneration alone, for every lane.  With B0_ON a lane
// at bounce 0 takes its light and cosine scatter draws from Sobol' dims
// 7-10 of (b0_pix, b0_gs) under b0_salt (the queue's sobol-b0).  The key
// words (kd0, kd1) and b0_salt come as arguments, P's (P.cam_salt) or a
// render block's (RenderWords); the camera regeneration, which the queue
// never runs (n_samples = 0), reads P.cam_salt.
template <bool SOBOL_ON, bool STRICT_ON, bool FANCY_ON, bool B0_ON>
__device__ __forceinline__ void pool_iteration(
    const StepParams& P, const Tables& T, float xs, float ys, uint32_t slot,
    uint32_t kd0, uint32_t kd1, bool init, float t, int idx, Lane& L,
    uint32_t b0_pix, uint32_t b0_gs, uint32_t b0_salt) {
  V3 o = L.o, d = L.d, tp = L.tp, ac = L.ac;
  float tm = L.tm;
  int bounce = L.bounce, sample = L.sample;

  bool act, dead_now;
  if (init) {
    act = false;
    dead_now = true;
  } else {
    act = L.active > 0;
    dead_now = false;
  }

  if (act) {
    const bool hit = isfinite(t);
    bool miss = !hit, emit = false, cont = false;
    V3 p = o, emitted = {0.0f, 0.0f, 0.0f}, dir = d, w = {0.0f, 0.0f, 0.0f};
    uint32_t base = 0;
    if (hit) {
      float q[4];
      const bool first = B0_ON && bounce == 0;
      if (first) sobol_bounce0(b0_pix, b0_gs, b0_salt, q);
      const Shade s = shade_core<STRICT_ON, FANCY_ON, B0_ON>(
          P, T, o, d, tm, t, idx, slot, kd0, kd1, first, q);
      p = s.p;
      emitted = s.emitted;
      dir = s.dir;
      w = s.w;
      base = s.base;
      emit = !s.scattered;
      cont = s.scattered;
    }

    // ---- pool update (integrator.trace_pool body) ----
    ac.x = ac.x + (miss ? tp.x * P.bg[0] : 0.0f) + (emit ? tp.x * emitted.x : 0.0f);
    ac.y = ac.y + (miss ? tp.y * P.bg[1] : 0.0f) + (emit ? tp.y * emitted.y : 0.0f);
    ac.z = ac.z + (miss ? tp.z * P.bg[2] : 0.0f) + (emit ? tp.z * emitted.z : 0.0f);
    bool kill = false, do_rr = false;
    float p_rr = 1.0f;
    if (P.rr_depth) {
      const float tp_in = jmax(jmax(tp.x, tp.y), tp.z);
      p_rr = jmin(jmax(tp_in, RR_PMIN), 1.0f);
      do_rr = cont && bounce >= P.rr_depth;
      kill = do_rr && hash_col(base, RR_COL) >= p_rr;
    }
    if (cont) {
      tp = {tp.x * w.x, tp.y * w.y, tp.z * w.z};
      bounce = bounce + 1;
    }
    if (do_rr && !kill) tp = {tp.x / p_rr, tp.y / p_rr, tp.z / p_rr};
    const float tp_max = jmax(jmax(tp.x, tp.y), tp.z);
    dead_now = miss || emit || kill || (cont && bounce >= P.max_depth) ||
               (cont && tp_max <= 0.0f);
    if (cont) {
      o = p;
      d = dir;
    }
  }

  // ---- camera regeneration (rng.hash_uniforms2 or the scrambled Sobol'
  // point of (slot, plain global sample), + rays_from_uniforms) ----
  const bool want = dead_now && sample < P.n_samples;
  if (want) {
    float u[5];
    if (SOBOL_ON) {
      sobol_camera(slot, P.sample0 + (uint32_t)sample, P.cam_salt, u);
    } else {
      const uint32_t b_w = (P.sample0 + (uint32_t)sample) ^ P.cam_salt;
      const uint32_t cb = fmix(slot + 0x9E3779B9u) ^ (b_w * 0x85EBCA6Bu);
      for (int k = 0; k < 5; ++k) u[k] = hash_col(cb, k);
    }
    const float u0 = u[0], u1 = u[1], u2 = u[2], u3 = u[3], u4 = u[4];
    const float* c = P.cam;
    const float sx = xs + u0 * P.inv_w;
    const float sy = ys + u1 * P.inv_h;
    const float r = c[18] * sqrtf(u2);
    const float phi = TWO_PI * u3;
    const float rc = r * cosf(phi), rs = r * sinf(phi);
    const float offx = rc * c[12] + rs * c[15];
    const float offy = rc * c[13] + rs * c[16];
    const float offz = rc * c[14] + rs * c[17];
    tm = c[19] + (c[20] - c[19]) * u4;
    o = {c[0] + offx, c[1] + offy, c[2] + offz};
    d = {c[3] + sx * c[6] + sy * c[9] - c[0] - offx,
         c[4] + sx * c[7] + sy * c[10] - c[1] - offy,
         c[5] + sx * c[8] + sy * c[11] - c[2] - offz};
    tp = {1.0f, 1.0f, 1.0f};
    bounce = 0;
    sample = sample + 1;
  }
  L.o = o; L.d = d; L.tm = tm; L.tp = tp; L.ac = ac;
  L.bounce = bounce; L.sample = sample;
  L.active = ((act && !dead_now) || want) ? 1 : 0;
}
