// Static-sphere sweep in the matrix-product form: one thread per ray.
//
// Replaces the TPU kernel tpu_ray/ops/intersect_pallas.py::
// _sphere_mxu_kernel (launched by _sweep_sphere_mxu under
// TPU_RAY_SWEEP_MXU=1).  The sphere quadratic oc = o - c, b = oc.d,
// c = |oc|^2 - r^2 is expanded around the range centroid m (o' = o - m,
// c' = c - m):
//
//     b  = o'.d - (c'.d)
//     cc = |o'|^2 + (-2 o'.c' + |c'|^2 - r^2)
//
// so that the terms mixing a ray with a sphere are two small matrix
// products: d @ [c'] and o' @ [-2c' ; k'], k' = |c'|^2 - r^2.  The TPU
// kernel packs them to depth 8 for its matrix unit: dm (R, 8) = [d, o'.d,
// 0...], om (R, 8) = [o', 1, |o'|^2, 0...], c1 (8, P) = [c' ; 0...], c2
// (8, P) = [-2c' ; k' ; 0...].  Of the sixteen products per pair seven are
// not zero; this kernel forms exactly those, in the packing's order, in
// scalar fp32 inside the sweep loop (no library product): cd = dx c'x +
// dy c'y + dz c'z, ccp = o'x (-2c'x) + o'y (-2c'y) + o'z (-2c'z) + k'.
// The per-ray terms o', o'.d and |o'|^2 are computed here from the ray
// instead of being read from (R, 8) arrays, and the per-sphere rows
// (c'x, c'y, c'z, k') are one (n, 4) table staged through shared memory
// CHUNK rows at a time.  Nothing is padded.  Prims are visited in ascending
// order and the minimum moves on a strict '<' (the first index of the
// minimum, as the TPU kernel's per-block argmin and cross-block '<').
//
// The expansion reassociates the arithmetic: t agrees with the classic
// sweep to about 1e-5 relative, grazing hits of large spheres to about
// 1e-3.  The plain twin, tpu_ray_torch/ops/sweep.py::
// sweep_sphere_mxu_plain, follows this kernel's operations in order.
//
// Bound.  Operations: about 24 flops per (ray, sphere) pair over 67 TFLOP/s
// (book1-final: 485 spheres x 1M rays = ~0.17 ms); 36 B per ray do not bind.
// A tensor-core version would use mma.sync m16n8k8 in TF32 split three ways
// to keep fp32 accuracy; the depth-8 products carry 7 useful terms of 16.

#include <cuda_runtime.h>
#include <stdint.h>

#define CHUNK 256
#define THREADS 256

__global__ void __launch_bounds__(THREADS)
sweep_mxu_kernel(const float* __restrict__ rays, long long R,
                 const float4* __restrict__ tab, int n, int lo, float mx,
                 float my, float mz, float t_min, float* __restrict__ out_t,
                 int* __restrict__ out_i) {
  __shared__ float4 sc[CHUNK];
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < R;
  const long long k = live ? i : 0;
  const float dx = rays[3 * R + k], dy = rays[4 * R + k], dz = rays[5 * R + k];
  const float ox = rays[k] - mx, oy = rays[R + k] - my,
              oz = rays[2 * R + k] - mz;
  const float a = dx * dx + dy * dy + dz * dz;
  const float inv_a = 1.0f / a;
  const float od = ox * dx + oy * dy + oz * dz;
  const float oo = ox * ox + oy * oy + oz * oz;
  const float INF = __int_as_float(0x7f800000);
  float bt = INF;
  int bi = 0;

  for (int base = 0; base < n; base += CHUNK) {
    const int cnt = min(CHUNK, n - base);
    __syncthreads();
    for (int q = threadIdx.x; q < cnt; q += blockDim.x) sc[q] = tab[base + q];
    __syncthreads();
    for (int j = 0; j < cnt; ++j) {
      const float4 c = sc[j];
      const float cd = dx * c.x + dy * c.y + dz * c.z;
      const float ccp = ox * (-2.0f * c.x) + oy * (-2.0f * c.y)
                        + oz * (-2.0f * c.z) + c.w;
      const float b = od - cd;
      const float cc = oo + ccp;
      const float disc = b * b - a * cc;
      if (disc > 0.0f) {
        const float sd = sqrtf(disc);
        const float t1 = (-b - sd) * inv_a;
        const float t2 = (-b + sd) * inv_a;
        float t = INF;
        if (t1 > t_min) t = t1;
        else if (t2 > t_min) t = t2;
        if (t < bt) { bt = t; bi = lo + base + j; }
      }
    }
  }
  if (live) {
    out_t[i] = bt;
    out_i[i] = bi;
  }
}

// rays (7, R) f32; tab (n, 4) f32 rows c'x, c'y, c'z, k' of prim rows
// [lo, lo + n); (mx, my, mz) the range centroid.  Returns the launch's
// cudaError_t (0 = launched).
extern "C" int tr_sweep_mxu(const float* rays, long long R, const float* tab,
                            int n, int lo, float mx, float my, float mz,
                            float t_min, float* out_t, int* out_i,
                            void* stream) {
  if (R <= 0) return 0;
  const long long blocks = (R + THREADS - 1) / THREADS;
  sweep_mxu_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      rays, R, (const float4*)tab, n, lo, mx, my, mz, t_min, out_t, out_i);
  return (int)cudaGetLastError();
}
