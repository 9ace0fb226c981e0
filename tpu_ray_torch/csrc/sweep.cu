// Closest-hit sweep over the solid primitives: one thread per ray.
//
// Replaces the TPU kernels tpu_ray/ops/intersect_pallas.py::_sphere_kernel,
// _box_kernel and _quad_kernel (launched per kind range by _sweep_range from
// intersect_solids_pallas), and stands in for the XLA sweep
// tpu_ray/ops/intersect.py::_chunk_t that the JAX main path runs for scenes
// of at most 512 prims.  One kernel serves every prim count.
//
// Design.  Each thread holds one ray and a running (t, prim) minimum in
// registers.  The prim table (n_solid rows of 16 floats, kind-sorted:
// static spheres | moving spheres | boxes | quads) is staged through shared
// memory CHUNK rows at a time; all threads of a block read the same row at
// once, which shared memory broadcasts.  Prims are visited in ascending
// order and the minimum moves only on a strict '<', which reproduces both
// the XLA chunk argmin (first index) and the Pallas per-block first-index /
// cross-block strict-'<' rule.  No prim padding exists, so the TPU kernels'
// padding hazards (r^2 = 0 spheres, degenerate boxes, n = 0 quads) do not
// arise; NaN still fails every comparison, which needs IEEE arithmetic
// (built without fast math, with --fmad=false).
//
// Bound.  Operations: about 21 flops per (ray, static sphere) pair, 27 per
// moving sphere, 24 per box and 31 per quad.  book1-final (485 spheres) at
// 1M rays is ~1e10 fp32 operations per sweep: compute-bound, ~0.15 ms at
// the card's 67 TFLOP/s.  cornell (13 prims) moves 36 B per ray (28 in,
// 8 out): ~11 us of memory time at 1M rays, so it is bound by its bytes and
// by the launch.  A faster kernel would keep several rays per thread and
// use the FMA units; this first kernel keeps the plain version's rounding.

#include <cuda_runtime.h>
#include <stdint.h>

#define CHUNK 256
#define ROW 16
#define THREADS 256

__device__ __forceinline__ float jmin(float a, float b) {
  // NaN-propagating min, as jnp.minimum / torch.minimum
  return (a < b || a != a) ? a : b;
}
__device__ __forceinline__ float jmax(float a, float b) {
  return (a > b || a != a) ? a : b;
}

__global__ void __launch_bounds__(THREADS)
sweep_kernel(const float* __restrict__ rays, long long R,
             const float* __restrict__ geo, int n_ss, int n_s, int n_sb,
             int n_solid, float t_min, float* __restrict__ out_t,
             int* __restrict__ out_i) {
  __shared__ float sg[CHUNK * ROW];
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < R;
  const long long k = live ? i : 0;
  const float ox = rays[k], oy = rays[R + k], oz = rays[2 * R + k];
  const float dx = rays[3 * R + k], dy = rays[4 * R + k], dz = rays[5 * R + k];
  const float rt = rays[6 * R + k];
  const float INF = __int_as_float(0x7f800000);
  const float a = dx * dx + dy * dy + dz * dz;
  const float inv_a = 1.0f / a;
  const float ix = 1.0f / dx, iy = 1.0f / dy, iz = 1.0f / dz;
  float bt = INF;
  int bi = 0;

  for (int base = 0; base < n_solid; base += CHUNK) {
    const int cnt = min(CHUNK, n_solid - base);
    __syncthreads();
    for (int q = threadIdx.x; q < cnt * ROW; q += blockDim.x)
      sg[q] = geo[(long long)base * ROW + q];
    __syncthreads();
    const int e_ss = max(0, min(cnt, n_ss - base));
    const int e_s = max(0, min(cnt, n_s - base));
    const int e_sb = max(0, min(cnt, n_sb - base));

    // spheres: static prefix, then the moving range (center lerp by ray time)
    for (int j = 0; j < e_s; ++j) {
      const float* g = sg + j * ROW;
      float cx = g[0], cy = g[1], cz = g[2];
      if (j >= e_ss) {
        const float dt = rt - g[6];
        cx = cx + g[3] * dt;
        cy = cy + g[4] * dt;
        cz = cz + g[5] * dt;
      }
      const float ocx = ox - cx, ocy = oy - cy, ocz = oz - cz;
      const float b = ocx * dx + ocy * dy + ocz * dz;
      const float c = ocx * ocx + ocy * ocy + ocz * ocz - g[7];
      const float disc = b * b - a * c;
      float t = INF;
      if (disc > 0.0f) {
        const float sd = sqrtf(disc);
        const float t1 = (-b - sd) * inv_a;
        const float t2 = (-b + sd) * inv_a;
        if (t1 > t_min && t1 < INF) t = t1;
        else if (t2 > t_min && t2 < INF) t = t2;
      }
      if (t < bt) { bt = t; bi = base + j; }
    }
    // solid axis-aligned boxes: slab test
    for (int j = e_s; j < e_sb; ++j) {
      const float* g = sg + j * ROW;
      const float tax = (g[0] - ox) * ix, tbx = (g[3] - ox) * ix;
      const float tay = (g[1] - oy) * iy, tby = (g[4] - oy) * iy;
      const float taz = (g[2] - oz) * iz, tbz = (g[5] - oz) * iz;
      const float tn = jmax(jmax(jmin(tax, tbx), jmin(tay, tby)), jmin(taz, tbz));
      const float tf = jmin(jmin(jmax(tax, tbx), jmax(tay, tby)), jmax(taz, tbz));
      float t = INF;
      if (tf > tn) {
        if (tn > t_min && tn < INF) t = tn;
        else if (tf > t_min && tf < INF) t = tf;
      }
      if (t < bt) { bt = t; bi = base + j; }
    }
    // quads: plane + (u, v) parallelogram test
    for (int j = e_sb; j < cnt; ++j) {
      const float* g = sg + j * ROW;
      const float dn = dx * g[3] + dy * g[4] + dz * g[5];
      const float tq = (g[6] - (ox * g[3] + oy * g[4] + oz * g[5])) / dn;
      const float xx = ox + tq * dx - g[0];
      const float xy = oy + tq * dy - g[1];
      const float xz = oz + tq * dz - g[2];
      const float uq = xx * g[7] + xy * g[8] + xz * g[9];
      const float vq = xx * g[10] + xy * g[11] + xz * g[12];
      const bool ok = (tq > t_min) && (tq < INF) && (uq >= 0.0f) &&
                      (uq <= 1.0f) && (vq >= 0.0f) && (vq <= 1.0f);
      const float t = ok ? tq : INF;
      if (t < bt) { bt = t; bi = base + j; }
    }
  }
  if (live) {
    out_t[i] = bt;
    out_i[i] = bi;
  }
}

// rays: (7, R) float32 rows ox, oy, oz, dx, dy, dz, time (row stride R).
// geo: (n_solid, 16) float32 (layout in tpu_ray_torch/ops/sweep.py).
// Returns the launch's cudaError_t (0 = launched).
extern "C" int tr_sweep(const float* rays, long long R, const float* geo,
                        int n_ss, int n_s, int n_sb, int n_solid, float t_min,
                        float* out_t, int* out_i, void* stream) {
  if (R <= 0) return 0;
  const long long blocks = (R + THREADS - 1) / THREADS;
  sweep_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      rays, R, geo, n_ss, n_s, n_sb, n_solid, t_min, out_t, out_i);
  return (int)cudaGetLastError();
}
