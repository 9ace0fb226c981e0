// Free flight through one constant medium: the hit distance of a ray against
// one medium row of the (N, 40) prim table, or +inf.  The arithmetic and its
// order are those of tpu_ray_torch/ops/intersect.py::_media_t, which is the
// media section of tpu_ray/ops/megakernel.py::_kernel: the boundary is a
// sphere (center cols 2:5, radius col 9) or a box in its own frame (min cols
// 2:5, max cols 5:8, offset cols 10:13, rotation cols 30:39 row-major); the
// ray must stay inside for more than 1e-4; the flight length is
// -1/density (col 8) * log(u), with u the lane's uniform of column
// ``slot_col`` of the stream based at ``base_i`` = fmix(slot + ki0) ^ ki1
// (the intersect key's words).  Kept in a header of its own so the sweeps can
// take it in later.  logf may differ from the plain version's log by an ulp.
#pragma once

#include "shade_core.cuh"

#define MED_EPS 9.99999974737875164e-05f   // float32(1e-4)

__device__ __forceinline__ float media_t(const float* __restrict__ row,
                                         const Ray& r, float dlen,
                                         uint32_t base_i, int slot_col,
                                         bool any_transform, float t_min) {
  const float INF = __int_as_float(0x7f800000);
  float te, tx;
  bool exists;
  if ((int)row[0] == PRIM_MEDIUM_SPHERE) {
    const float ocx = r.ox - row[2], ocy = r.oy - row[3], ocz = r.oz - row[4];
    const float b = ocx * r.dx + ocy * r.dy + ocz * r.dz;
    const float cq = ocx * ocx + ocy * ocy + ocz * ocz - row[9] * row[9];
    const float disc = b * b - r.a * cq;
    const float sd = sqrtf(jmax(disc, 0.0f));
    te = (-b - sd) * r.inv_a;
    tx = (-b + sd) * r.inv_a;
    exists = disc > 0.0f;
  } else {
    float ox = r.ox, oy = r.oy, oz = r.oz, dx = r.dx, dy = r.dy, dz = r.dz;
    if (any_transform) {
      // object-frame ray: x_o = R^T (x_w - off)
      const float wx = r.ox - row[10], wy = r.oy - row[11], wz = r.oz - row[12];
      ox = row[30] * wx + row[33] * wy + row[36] * wz;
      oy = row[31] * wx + row[34] * wy + row[37] * wz;
      oz = row[32] * wx + row[35] * wy + row[38] * wz;
      dx = row[30] * r.dx + row[33] * r.dy + row[36] * r.dz;
      dy = row[31] * r.dx + row[34] * r.dy + row[37] * r.dz;
      dz = row[32] * r.dx + row[35] * r.dy + row[38] * r.dz;
    }
    const float ix = 1.0f / dx, iy = 1.0f / dy, iz = 1.0f / dz;
    const float tax = (row[2] - ox) * ix, tbx = (row[5] - ox) * ix;
    const float tay = (row[3] - oy) * iy, tby = (row[6] - oy) * iy;
    const float taz = (row[4] - oz) * iz, tbz = (row[7] - oz) * iz;
    te = jmax(jmax(jmin(tax, tbx), jmin(tay, tby)), jmin(taz, tbz));
    tx = jmin(jmin(jmax(tax, tbx), jmax(tay, tby)), jmax(taz, tbz));
    exists = tx > te;
  }
  exists = exists && (tx > te + MED_EPS);
  const float rec1 = jmax(te, t_min);
  const float dist_inside = (tx - rec1) * dlen;
  const float u = hash_col(base_i, (uint32_t)slot_col);
  const float hit_dist = row[8] * logf(jmax(u, 1e-12f));
  const bool ok = exists && (rec1 < tx) && (hit_dist <= dist_inside);
  return ok ? rec1 + hit_dist / dlen : INF;
}
