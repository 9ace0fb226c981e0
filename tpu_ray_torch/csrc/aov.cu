// First-hit AOV features, one thread per lane: albedo, shading normal and
// hit distance of each camera ray's closest hit.
//
// The JAX package computes these in XLA, with no Pallas kernel
// (tpu_ray/aov.py::_aov_step: intersect_scene's hit record, then
// texture_value / texture_value_packed at the hit); this kernel is the
// port's own.  Per lane it rebuilds the hit record from the sweep's
// (best_t, best_i) and evaluates the material's texture with the shade
// core's device functions (shade_core.cuh: hit_record, albedo - one copy
// of that code for the step, hit_scatter, the megakernel and this kernel),
// checkers with textured children included (the HAS_CHECKER_FANCY
// instantiation) and the strict mode's table-noise marble (STRICT).  The
// per-pixel sums over samples and the final normalisation stay in torch
// (tpu_ray_torch/aov.py).  Plain twin: tpu_ray_torch/aov.py::
// aov_features_plain.
//
// Output rows (8, R) float32: albedo rgb (the scene background on a miss),
// face-flipped normal xyz (0 on a miss), t * |rd| (0 on a miss), hit (1/0).
//
// Bound.  Memory: 36 B in (7 ray rows, best_t, best_i) and 32 B out per
// lane: 68 B, ~20 us per 1M lanes at 3.35 TB/s.  The prim and texture rows
// stay in L1/L2.  A lane does one hit record and one texture evaluation,
// so it is bytes-bound except on Perlin textures (7 octaves of 8 hashed
// corners).  Built like pool_step.cu: no fast math, --fmad=false.

#include "shade_core.cuh"

#define THREADS 256

template <bool STRICT_ON, bool FANCY_ON>
__global__ void __launch_bounds__(THREADS)
aov_kernel(const StepParams P, const Tables T, const float* __restrict__ rays,
           const float* __restrict__ best_t, const int* __restrict__ best_i,
           float* __restrict__ out, long long R) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= R) return;
  const V3 o = {rays[i], rays[R + i], rays[2 * R + i]};
  const V3 d = {rays[3 * R + i], rays[4 * R + i], rays[5 * R + i]};
  const float t = best_t[i];
  V3 alb = {P.bg[0], P.bg[1], P.bg[2]}, n = {0.0f, 0.0f, 0.0f};
  float dist = 0.0f, hit = 0.0f;
  if (isfinite(t)) {
    const int idx = best_i[i];
    const float* row = T.tab + (long long)idx * PRIM_COLS;
    const Hit h = hit_record(P, row, o, d, rays[6 * R + i], t);
    alb = albedo<STRICT_ON, FANCY_ON>(P, T, row, idx, h.p, h.u, h.v);
    n = h.n;
    dist = t * sqrtf(d.x * d.x + d.y * d.y + d.z * d.z);
    hit = 1.0f;
  }
  out[i] = alb.x; out[R + i] = alb.y; out[2 * R + i] = alb.z;
  out[3 * R + i] = n.x; out[4 * R + i] = n.y; out[5 * R + i] = n.z;
  out[6 * R + i] = dist;
  out[7 * R + i] = hit;
}

// rays (7, R) f32 rows origin, direction, time; best_t (R) f32, best_i (R)
// i32; tables, texture rows and params as tr_pool_step (t_min, bg, flags
// and the atlas dims are read; the STRICT and HAS_CHECKER_FANCY bits pick
// the instantiation); out (8, R) f32.  Returns the launch's cudaError_t.
extern "C" int tr_aov(const float* rays, const float* best_t,
                      const int* best_i, const float* tab,
                      const uint32_t* salt, const float* lights,
                      const uint32_t* atlas, const int* img_size,
                      const int* perlin_id, const int* perm,
                      const float* ranvec, const float* texrow,
                      const int* kids, const void* params, float* out,
                      long long R, void* stream) {
  if (R <= 0) return 0;
  StepParams P;
  memcpy(&P, params, sizeof(StepParams));
  const Tables T = {tab, salt, lights, atlas, img_size, perlin_id, perm,
                    ranvec, texrow, kids};
  const long long blocks = (R + THREADS - 1) / THREADS;
  const bool strict = (P.flags & STRICT) != 0;
  const bool fancy = (P.flags & HAS_CHECKER_FANCY) != 0;
  const auto kernel = strict ? (fancy ? aov_kernel<true, true>
                                      : aov_kernel<true, false>)
                             : (fancy ? aov_kernel<false, true>
                                      : aov_kernel<false, false>);
  kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      P, T, rays, best_t, best_i, out, R);
  return (int)cudaGetLastError();
}
