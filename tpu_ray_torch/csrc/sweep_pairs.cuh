// Per-(ray, prim) hit distances shared by the dense and the mask-gated sweep
// (sweep.cu), the compacted-list sweep (sweep_compact.cu) and the whole-wave
// megakernel (megakernel.cu): the kernels must return the same t bit for bit,
// so they run this one copy of the math.  Each function
// returns the hit distance of one prim row (16 floats, layout in
// tpu_ray_torch/ops/sweep.py) or +inf, with the operations and their order
// of tpu_ray_torch/ops/sweep.py::_block_t.  NaN fails every comparison,
// which needs IEEE arithmetic (no fast math, --fmad=false).
#pragma once

#define ROW 16

__device__ __forceinline__ float jmin(float a, float b) {
  // NaN-propagating min, as jnp.minimum / torch.minimum
  return (a < b || a != a) ? a : b;
}
__device__ __forceinline__ float jmax(float a, float b) {
  return (a > b || a != a) ? a : b;
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

// sphere quadratic; ``moving`` lerps the center by the ray's time
__device__ __forceinline__ float hit_sphere(const float* g, const Ray& r,
                                          bool moving, float t_min) {
  const float INF = __int_as_float(0x7f800000);
  float cx = g[0], cy = g[1], cz = g[2];
  if (moving) {
    const float dt = r.rt - g[6];
    cx = cx + g[3] * dt;
    cy = cy + g[4] * dt;
    cz = cz + g[5] * dt;
  }
  const float ocx = r.ox - cx, ocy = r.oy - cy, ocz = r.oz - cz;
  const float b = ocx * r.dx + ocy * r.dy + ocz * r.dz;
  const float c = ocx * ocx + ocy * ocy + ocz * ocz - g[7];
  const float disc = b * b - r.a * c;
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

// solid axis-aligned box: slab test
__device__ __forceinline__ float hit_box(const float* g, const Ray& r,
                                       float t_min) {
  const float INF = __int_as_float(0x7f800000);
  const float tax = (g[0] - r.ox) * r.ix, tbx = (g[3] - r.ox) * r.ix;
  const float tay = (g[1] - r.oy) * r.iy, tby = (g[4] - r.oy) * r.iy;
  const float taz = (g[2] - r.oz) * r.iz, tbz = (g[5] - r.oz) * r.iz;
  const float tn = jmax(jmax(jmin(tax, tbx), jmin(tay, tby)), jmin(taz, tbz));
  const float tf = jmin(jmin(jmax(tax, tbx), jmax(tay, tby)), jmax(taz, tbz));
  float t = INF;
  if (tf > tn) {
    if (tn > t_min && tn < INF) t = tn;
    else if (tf > t_min && tf < INF) t = tf;
  }
  return t;
}

// parallelogram: plane + (u, v) test
__device__ __forceinline__ float hit_quad(const float* g, const Ray& r,
                                        float t_min) {
  const float INF = __int_as_float(0x7f800000);
  const float dn = r.dx * g[3] + r.dy * g[4] + r.dz * g[5];
  const float tq = (g[6] - (r.ox * g[3] + r.oy * g[4] + r.oz * g[5])) / dn;
  const float xx = r.ox + tq * r.dx - g[0];
  const float xy = r.oy + tq * r.dy - g[1];
  const float xz = r.oz + tq * r.dz - g[2];
  const float uq = xx * g[7] + xy * g[8] + xz * g[9];
  const float vq = xx * g[10] + xy * g[11] + xz * g[12];
  const bool ok = (tq > t_min) && (tq < INF) && (uq >= 0.0f) &&
                  (uq <= 1.0f) && (vq >= 0.0f) && (vq <= 1.0f);
  return ok ? tq : INF;
}

// closest hit (lt, li) of a ray over ``rows`` staged prim rows of one kind
// (0 static sphere, 1 moving sphere, 2 box, 3 quad; table rows start..), in
// ascending row order with a strict '<': the first row of the minimum
__device__ __forceinline__ void block_min(const float* sg, const Ray& r,
                                          int start, int rows, int kind,
                                          float t_min, float& lt, int& li) {
  lt = __int_as_float(0x7f800000);
  li = 0;
  if (kind <= 1) {
    for (int k = 0; k < rows; ++k) {
      const float t = hit_sphere(sg + k * ROW, r, kind == 1, t_min);
      if (t < lt) { lt = t; li = start + k; }
    }
  } else if (kind == 2) {
    for (int k = 0; k < rows; ++k) {
      const float t = hit_box(sg + k * ROW, r, t_min);
      if (t < lt) { lt = t; li = start + k; }
    }
  } else {
    for (int k = 0; k < rows; ++k) {
      const float t = hit_quad(sg + k * ROW, r, t_min);
      if (t < lt) { lt = t; li = start + k; }
    }
  }
}
