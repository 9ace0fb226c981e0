// Per-(ray, prim) hit distances shared by the dense sweep (sweep.cu), the
// compacted-list and mask-gated sweeps (sweep_compact.cu) and the whole-wave
// megakernel (megakernel.cu): the kernels must return the same t bit for bit,
// so they run this one copy of the math.  Each function returns the hit
// distance of one prim row (16 floats, layout in tpu_ray_torch/ops/sweep.py)
// or +inf, with the operations and their order of
// tpu_ray_torch/ops/sweep.py::_block_t.  NaN fails every comparison, which
// needs IEEE arithmetic (no fast math, --fmad=false).
//
// A row is read from shared memory as float4s (16 B, one LDS.128 each: all
// lanes of a warp read the same row, which shared memory broadcasts) and the
// values, not a pointer, are handed to the pair functions:
//   sphere  a = (cx, cy, cz, vx)  b = (vy, vz, time0, r^2)
//   box     a = (lo x, y, z, hi x)  b = (hi y, hi z, -, -)
//   quad    a = (p0 x, y, z, n x)  b = (n y, n z, d, inv1 x)
//           c = (inv1 y, z, inv2 x, y)  d = (inv2 z, -, -, -)
// The staged rows must be 16-byte aligned (row(sg, j) below).
#pragma once

#define ROW 16

__device__ __forceinline__ float jmin(float a, float b) {
  // NaN-propagating min, as jnp.minimum / torch.minimum
  return (a < b || a != a) ? a : b;
}
__device__ __forceinline__ float jmax(float a, float b) {
  return (a > b || a != a) ? a : b;
}
// The same in one instruction (sm_80+): differs from jmin / jmax only in the
// sign of a zero result, which the slab test never returns (a hit must
// exceed t_min > 0, and -0 and +0 compare equal).
__device__ __forceinline__ float nmin(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float nmax(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

struct Ray {
  float ox, oy, oz, dx, dy, dz, rt;
  float a, inv_a;        // |d|^2 and its reciprocal (spheres)
  float ix, iy, iz;      // 1 / d per axis (boxes)
};

// the per-ray terms the pair tests share, from an origin, a direction and a
// shutter time held in registers
__device__ __forceinline__ Ray make_ray(float ox, float oy, float oz, float dx,
                                        float dy, float dz, float rt) {
  Ray r;
  r.ox = ox; r.oy = oy; r.oz = oz;
  r.dx = dx; r.dy = dy; r.dz = dz;
  r.rt = rt;
  r.a = r.dx * r.dx + r.dy * r.dy + r.dz * r.dz;
  r.inv_a = 1.0f / r.a;
  r.ix = 1.0f / r.dx; r.iy = 1.0f / r.dy; r.iz = 1.0f / r.dz;
  return r;
}

__device__ __forceinline__ Ray load_ray(const float* __restrict__ rays,
                                        long long R, long long k) {
  return make_ray(rays[k], rays[R + k], rays[2 * R + k], rays[3 * R + k],
                  rays[4 * R + k], rays[5 * R + k], rays[6 * R + k]);
}

// float4 view of staged row j
__device__ __forceinline__ const float4* row(const float* sg, int j) {
  return reinterpret_cast<const float4*>(sg + j * ROW);
}

// half-b and discriminant of the sphere quadratic about (cx, cy, cz): the
// pair can hit only where disc > 0
__device__ __forceinline__ void sphere_bd(float cx, float cy, float cz,
                                          float r2, const Ray& r, float& b,
                                          float& disc) {
  const float ocx = r.ox - cx, ocy = r.oy - cy, ocz = r.oz - cz;
  b = ocx * r.dx + ocy * r.dy + ocz * r.dz;
  const float c = ocx * ocx + ocy * ocy + ocz * ocz - r2;
  disc = b * b - r.a * c;
}

// sphere quadratic about the center (cx, cy, cz)
__device__ __forceinline__ float sphere_t(float cx, float cy, float cz,
                                          float r2, const Ray& r,
                                          float t_min) {
  const float INF = __int_as_float(0x7f800000);
  float b, disc;
  sphere_bd(cx, cy, cz, r2, r, b, disc);
  float t = INF;
  if (disc > 0.0f) {
    const float sd = sqrtf(disc);
    const float t1 = (-b - sd) * r.inv_a;
    const float t2 = (-b + sd) * r.inv_a;
    if (t1 > t_min && t1 < INF) t = t1;
    else if (t2 > t_min && t2 < INF) t = t2;
  }
  return t;
}

// static sphere
__device__ __forceinline__ float hit_sphere(float4 a, float4 b, const Ray& r,
                                            float t_min) {
  return sphere_t(a.x, a.y, a.z, b.w, r, t_min);
}

// moving sphere: the center lerps by the ray's time
__device__ __forceinline__ float hit_moving(float4 a, float4 b, const Ray& r,
                                            float t_min) {
  const float dt = r.rt - b.z;
  return sphere_t(a.x + a.w * dt, a.y + b.x * dt, a.z + b.y * dt, b.w, r,
                  t_min);
}

// the discriminant alone of a static (MOVING false) or moving sphere
template <bool MOVING>
__device__ __forceinline__ float sphere_disc(float4 a, float4 b,
                                             const Ray& r) {
  float hb, disc;
  if (MOVING) {
    const float dt = r.rt - b.z;
    sphere_bd(a.x + a.w * dt, a.y + b.x * dt, a.z + b.y * dt, b.w, r, hb,
              disc);
  } else {
    sphere_bd(a.x, a.y, a.z, b.w, r, hb, disc);
  }
  return disc;
}

// Closest hits of RPT rays over the staged spheres [lo, hi) (moving where
// MOVING), prim ids offset by ``base``, into each ray's running (bt, bi).
// Two passes per group of 32 spheres: the first computes only each pair's
// discriminant and sets the ray's bit where it is > 0 (where a hit is
// possible: a few percent of the pairs); the second runs the whole test on
// the set bits alone, in ascending order with a strict '<'.  A pair whose
// discriminant is not > 0 returns +inf and cannot move the minimum, so the
// result is the plain loop's bit for bit, while the square root and the
// root tests run only where some lane needs them, not wherever any lane of
// the warp does.
template <int RPT, bool MOVING>
__device__ __forceinline__ void sphere_sweep(const float* sg, int lo, int hi,
                                             const Ray* r, float t_min,
                                             int base, float* bt, int* bi) {
  for (int j0 = lo; j0 < hi; j0 += 32) {
    const int n = min(32, hi - j0);
    unsigned m[RPT];
#pragma unroll
    for (int k = 0; k < RPT; ++k) m[k] = 0u;
    for (int q = 0; q < n; ++q) {
      const float4* g = row(sg, j0 + q);
      const float4 a = g[0], b = g[1];
#pragma unroll
      for (int k = 0; k < RPT; ++k)
        if (sphere_disc<MOVING>(a, b, r[k]) > 0.0f) m[k] |= 1u << q;
    }
#pragma unroll
    for (int k = 0; k < RPT; ++k) {
      while (m[k]) {
        const int q = __ffs(m[k]) - 1;
        m[k] &= m[k] - 1u;
        const float4* g = row(sg, j0 + q);
        const float t = MOVING ? hit_moving(g[0], g[1], r[k], t_min)
                               : hit_sphere(g[0], g[1], r[k], t_min);
        if (t < bt[k]) { bt[k] = t; bi[k] = base + j0 + q; }
      }
    }
  }
}

// solid axis-aligned box: slab test
__device__ __forceinline__ float hit_box(float4 a, float4 b, const Ray& r,
                                         float t_min) {
  const float INF = __int_as_float(0x7f800000);
  const float tax = (a.x - r.ox) * r.ix, tbx = (a.w - r.ox) * r.ix;
  const float tay = (a.y - r.oy) * r.iy, tby = (b.x - r.oy) * r.iy;
  const float taz = (a.z - r.oz) * r.iz, tbz = (b.y - r.oz) * r.iz;
  const float tn = nmax(nmax(nmin(tax, tbx), nmin(tay, tby)), nmin(taz, tbz));
  const float tf = nmin(nmin(nmax(tax, tbx), nmax(tay, tby)), nmax(taz, tbz));
  float t = INF;
  if (tf > tn) {
    if (tn > t_min && tn < INF) t = tn;
    else if (tf > t_min && tf < INF) t = tf;
  }
  return t;
}

// parallelogram: plane + (u, v) test
__device__ __forceinline__ float hit_quad(float4 a, float4 b, float4 c,
                                          float4 d, const Ray& r,
                                          float t_min) {
  const float INF = __int_as_float(0x7f800000);
  const float dn = r.dx * a.w + r.dy * b.x + r.dz * b.y;
  const float tq = (b.z - (r.ox * a.w + r.oy * b.x + r.oz * b.y)) / dn;
  const float xx = r.ox + tq * r.dx - a.x;
  const float xy = r.oy + tq * r.dy - a.y;
  const float xz = r.oz + tq * r.dz - a.z;
  const float uq = xx * b.w + xy * c.x + xz * c.y;
  const float vq = xx * c.z + xy * c.w + xz * d.x;
  const bool ok = (tq > t_min) && (tq < INF) && (uq >= 0.0f) &&
                  (uq <= 1.0f) && (vq >= 0.0f) && (vq <= 1.0f);
  return ok ? tq : INF;
}

// closest hits (lt, li) of RPT rays over ``rows`` staged prim rows of one
// kind (0 static sphere, 1 moving sphere, 2 box, 3 quad; table rows
// start..), each from +inf, in ascending row order with a strict '<': the
// first row of the minimum
template <int RPT>
__device__ __forceinline__ void block_sweep(const float* sg, int start,
                                            int rows, int kind, const Ray* r,
                                            float t_min, float* lt, int* li) {
#pragma unroll
  for (int k = 0; k < RPT; ++k) {
    lt[k] = __int_as_float(0x7f800000);
    li[k] = 0;
  }
  if (kind == 0) {
    sphere_sweep<RPT, false>(sg, 0, rows, r, t_min, start, lt, li);
  } else if (kind == 1) {
    sphere_sweep<RPT, true>(sg, 0, rows, r, t_min, start, lt, li);
  } else if (kind == 2) {
    for (int q = 0; q < rows; ++q) {
      const float4* g = row(sg, q);
      const float4 a = g[0], b = g[1];
#pragma unroll
      for (int k = 0; k < RPT; ++k) {
        const float t = hit_box(a, b, r[k], t_min);
        if (t < lt[k]) { lt[k] = t; li[k] = start + q; }
      }
    }
  } else {
    for (int q = 0; q < rows; ++q) {
      const float4* g = row(sg, q);
      const float4 a = g[0], b = g[1], c = g[2], d = g[3];
#pragma unroll
      for (int k = 0; k < RPT; ++k) {
        const float t = hit_quad(a, b, c, d, r[k], t_min);
        if (t < lt[k]) { lt[k] = t; li[k] = start + q; }
      }
    }
  }
}
