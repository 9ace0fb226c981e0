// Fused pool step and the shade-only kernel, one thread per lane.
//
// pool_step_kernel replaces the TPU kernel tpu_ray/ops/shade_pallas.py::
// _step_kernel (with its _shade_core), launched by pool_step_pallas.  Per
// lane: rebuild the hit record from the sweep's (best_t, best_i), evaluate
// constant / checker / hash-Perlin / image textures, scatter for the five
// materials with 50/50 light / cosine MIS, optional Russian roulette,
// accumulate the estimate, decide path death and regenerate the camera
// sample (hashed, or the scrambled Sobol' point of the TPU kernel's sobol
// branch).  The strict reference estimator, which the JAX package shades in
// XLA outside its kernels, runs through the same core behind the STRICT
// flag bit (table-noise Perlin, the no-light Lambertian mixture, the
// ball-radius isotropic phase), so the pool, queue and wave paths render
// it on the card.  Both kernels are templates on the flag bits, and the C
// entries launch the instantiation that P.flags names: the uniform, fixed
// instantiation carries no branch of them.  HAS_CHECKER_FANCY evaluates a
// checker's textured children by their texture rows (the JAX package's
// texture_value, which its fused kernels refuse); SAMPLER_B0, set by the
// work queue only, takes each lane's first-bounce light and cosine draws
// from Sobol' dims 7-10 of its (pixel, global sample) - the JAX XLA
// queue's sobol-b0 override (tpu_ray/integrator.py:707-735), which the
// JAX package runs only where its fused kernels do not.  The plain PyTorch twin is tpu_ray_torch/ops/shade.py::
// pool_step_plain; the two follow the same operations in the same order.
//
// hit_scatter_kernel replaces tpu_ray/ops/shade_pallas.py::_shade_kernel
// (launched by hit_scatter_pallas): the same shade core alone, writing the
// hit record and the scatter result for every lane.  Its plain twin is
// tpu_ray_torch/ops/hit_scatter.py::hit_scatter_plain.  Both kernels call
// the one __device__ shade_core of shade_core.cuh, and the step runs that
// header's pool_iteration; the whole-wave megakernel (megakernel.cu) runs the
// same two functions.
//
// Image textures are fetched inside the core (one packed-texel load per
// image lane): the TPU kernel deferred that albedo to its wrapper because
// Mosaic cannot gather from a texel table, which a GPU thread simply does.
//
// Design.  The Pallas kernel's blockwise (8, 128) gather of the prim table
// was a Mosaic workaround; here each lane reads its winner row of the
// row-major (N, 40) table with ordinary cached loads; every lane of a warp
// reads the same light rows (L, 25).  Camera and scalars arrive by value in
// one parameter block (constant bank).  Only the
// lane's own material branch is evaluated - every other branch's result is
// discarded by the JAX kernel's selects, so the outputs are the same.
// Inactive lanes copy their state through.  RNG is native uint32 murmur3,
// bit-identical to tpu_ray/ops/megakernel.py::_fmix/_hash_col.  Built
// without fast math and with --fmad=false so rounding follows the plain
// version op for op (sinf/cosf/logf may differ by an ulp).
//
// Bound (pool step).  Memory: per lane it reads 84 B (xy 8, slot 4, float state 52, int
// state 12, best_t 4, best_i 4) and writes 64 B (float state 52, int state
// 12): ~148 B, so ~46 us per 1M-lane iteration at 3.35 TB/s (the sobol-b0
// step reads 8 B more for each lane at bounce 0: its pixel and sample).
// The table rows (<= 512 x 160 B), the texture rows and the strict mode's
// noise tables stay in L1/L2 (the noise tables are 6 KB
// per Perlin instance: 6 permutation and 8 gradient-row loads per octave
// and lane hit cache, so they add no device-memory bytes per lane).  Lanes
// diverge on material and on Perlin textures (7 octaves x 8 corners of
// hashing); a faster version can sort lanes by material or split the Perlin
// lanes out.
//
// Bound (hit_scatter).  Memory: 40 B in (7 ray rows, best_t, best_i, lane
// id) and 75 B out (17 float rows, 3 flag bytes, the material index): 115 B
// per lane, ~34 us per 1M lanes at 3.35 TB/s; the arithmetic is the pool
// step's shade part.

#include "shade_core.cuh"

#define THREADS 256

// SOBOL_ON / STRICT_ON / FANCY_ON / B0_ON: the flag bits SAMPLER_SOBOL /
// STRICT / HAS_CHECKER_FANCY / SAMPLER_B0 of P.flags, which the C entries
// turn into the instantiation they launch; only B0_ON reads lane_b0.
// WORDS_ON: the C entry was given a render's word block (RenderWords), whose
// kd_scat and, under B0_ON, cam_salt replace P's key words and the salt of
// the first-bounce draws; only WORDS_ON reads words, so the instantiations
// launched without a block are the ones launched before there was one
template <bool SOBOL_ON, bool STRICT_ON, bool FANCY_ON, bool B0_ON,
          bool WORDS_ON>
__global__ void __launch_bounds__(THREADS)
pool_step_kernel(const StepParams P, const Tables T,
                 const float* __restrict__ xy,
                 const uint32_t* __restrict__ slot_ids,
                 const float* __restrict__ fin, const int* __restrict__ iin,
                 const float* __restrict__ best_t,
                 const int* __restrict__ best_i,
                 const uint32_t* __restrict__ lane_b0,
                 const RenderWords* __restrict__ words,
                 float* __restrict__ fout, int* __restrict__ iout,
                 long long R) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= R) return;
  const float xs = xy[i], ys = xy[R + i];
  const uint32_t slot = slot_ids[i];
  Lane L;
  L.o = {fin[i], fin[R + i], fin[2 * R + i]};
  L.d = {fin[3 * R + i], fin[4 * R + i], fin[5 * R + i]};
  L.tm = fin[6 * R + i];
  L.tp = {fin[7 * R + i], fin[8 * R + i], fin[9 * R + i]};
  L.ac = {fin[10 * R + i], fin[11 * R + i], fin[12 * R + i]};
  L.bounce = iin[i]; L.sample = iin[R + i]; L.active = iin[2 * R + i];
  float t = 0.0f;
  int idx = 0;
  uint32_t pix = 0u, gs = 0u;
  if (!P.init && L.active > 0) {
    t = best_t[i];
    idx = best_i[i];
    if (B0_ON && L.bounce == 0) {
      pix = lane_b0[i];
      gs = lane_b0[R + i];
    }
  }
  uint32_t kd0 = P.kd0, kd1 = P.kd1, b0_salt = P.cam_salt;
  if (WORDS_ON) {
    kd0 = words->kd_scat[0];
    kd1 = words->kd_scat[1];
    if (B0_ON) b0_salt = words->cam_salt;
  }
  pool_iteration<SOBOL_ON, STRICT_ON, FANCY_ON, B0_ON>(
      P, T, xs, ys, slot, kd0, kd1, P.init != 0, t, idx, L, pix, gs,
      b0_salt);
  const V3 o = L.o, d = L.d, tp = L.tp, ac = L.ac;
  const float tm = L.tm;
  const int bounce = L.bounce, sample = L.sample, active = L.active;

  fout[i] = o.x; fout[R + i] = o.y; fout[2 * R + i] = o.z;
  fout[3 * R + i] = d.x; fout[4 * R + i] = d.y; fout[5 * R + i] = d.z;
  fout[6 * R + i] = tm;
  fout[7 * R + i] = tp.x; fout[8 * R + i] = tp.y; fout[9 * R + i] = tp.z;
  fout[10 * R + i] = ac.x; fout[11 * R + i] = ac.y; fout[12 * R + i] = ac.z;
  iout[i] = bounce; iout[R + i] = sample; iout[2 * R + i] = active;
}

// hit record + scatter result of every lane: fout rows point xyz, normal
// xyz, u, v, direction xyz, weight xyz, emitted xyz; flags rows hit, front,
// scattered (one byte each, 0 or 1: torch.bool storage); mat the material
// index.  Direction and weight mean something only
// where the lane hit and scattered (an emissive lane keeps its incoming
// direction and weight 0).
template <bool STRICT_ON, bool FANCY_ON>
__global__ void __launch_bounds__(THREADS)
hit_scatter_kernel(const StepParams P, const Tables T,
                   const float* __restrict__ rays,
                   const float* __restrict__ best_t,
                   const int* __restrict__ best_i,
                   const uint32_t* __restrict__ lane_ids,
                   float* __restrict__ fout,
                   unsigned char* __restrict__ flags, int* __restrict__ mat,
                   long long R) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= R) return;
  const V3 o = {rays[i], rays[R + i], rays[2 * R + i]};
  const V3 d = {rays[3 * R + i], rays[4 * R + i], rays[5 * R + i]};
  const float t = best_t[i];
  const bool hit = isfinite(t);
  const Shade s = shade_core<STRICT_ON, FANCY_ON, false>(
      P, T, o, d, rays[6 * R + i], hit ? t : 1.0f, best_i[i], lane_ids[i],
      P.kd0, P.kd1, false, nullptr);
  fout[i] = s.p.x; fout[R + i] = s.p.y; fout[2 * R + i] = s.p.z;
  fout[3 * R + i] = s.n.x; fout[4 * R + i] = s.n.y; fout[5 * R + i] = s.n.z;
  fout[6 * R + i] = s.u; fout[7 * R + i] = s.v;
  fout[8 * R + i] = s.dir.x; fout[9 * R + i] = s.dir.y; fout[10 * R + i] = s.dir.z;
  fout[11 * R + i] = s.w.x; fout[12 * R + i] = s.w.y; fout[13 * R + i] = s.w.z;
  fout[14 * R + i] = s.emitted.x; fout[15 * R + i] = s.emitted.y;
  fout[16 * R + i] = s.emitted.z;
  flags[i] = hit ? 1 : 0; flags[R + i] = s.front ? 1 : 0;
  flags[2 * R + i] = s.scattered ? 1 : 0;
  mat[i] = s.mat;
}

typedef void (*StepKernel)(const StepParams, const Tables, const float*,
                           const uint32_t*, const float*, const int*,
                           const float*, const int*, const uint32_t*,
                           const RenderWords*, float*, int*, long long);

// the step's instantiation for P.flags: B0 only with the Sobol' camera (the
// queue's sobol-b0), so twelve in all, each with and without a word block
template <bool STRICT_ON, bool FANCY_ON, bool WORDS_ON>
static StepKernel step_for(bool sobol, bool b0) {
  if (b0) return pool_step_kernel<true, STRICT_ON, FANCY_ON, true, WORDS_ON>;
  return sobol
             ? pool_step_kernel<true, STRICT_ON, FANCY_ON, false, WORDS_ON>
             : pool_step_kernel<false, STRICT_ON, FANCY_ON, false, WORDS_ON>;
}

template <bool WORDS_ON>
static StepKernel step_kernel(bool strict, bool fancy, bool sobol, bool b0) {
  return strict ? (fancy ? step_for<true, true, WORDS_ON>(sobol, b0)
                         : step_for<true, false, WORDS_ON>(sobol, b0))
                : (fancy ? step_for<false, true, WORDS_ON>(sobol, b0)
                         : step_for<false, false, WORDS_ON>(sobol, b0));
}

// xy (2, R) f32, slot (R) u32, fin (13, R) f32, iin (3, R) i32, best_t (R)
// f32, best_i (R) i32, tab (N, 40) f32, salt (N) u32, lights (L, 25) f32,
// atlas (I, img_h, img_w) u32, img_size (I, 2) i32, perlin_id (N) i32, perm
// (P, 3, 256) i32, ranvec (P, 256, 3) f32, texrow (T, 8) f32, kids (M, 2)
// i32, lane_b0 (2, R) u32 each lane's pixel and global sample (read with
// SAMPLER_B0 only; may be null else), params: host pointer to the
// StepParams words; words: null, or a device RenderWords whose kd_scat and
// cam_salt replace the params' kd0, kd1 and, in the sobol-b0 step's
// first-bounce draws, cam_salt (a queue render replayed from a CUDA graph,
// whose step never regenerates a camera ray: n_samples = 0); fout/iout like
// fin/iin.  Returns the launch's
// cudaError_t (0 = launched; cudaErrorInvalidValue for SAMPLER_B0 without
// the Sobol' camera or lane_b0).
extern "C" int tr_pool_step(const float* xy, const uint32_t* slot,
                            const float* fin, const int* iin,
                            const float* best_t, const int* best_i,
                            const float* tab, const uint32_t* salt,
                            const float* lights, const uint32_t* atlas,
                            const int* img_size, const int* perlin_id,
                            const int* perm, const float* ranvec,
                            const float* texrow, const int* kids,
                            const uint32_t* lane_b0,
                            const void* params, const void* words,
                            float* fout, int* iout, long long R,
                            void* stream) {
  if (R <= 0) return 0;
  StepParams P;
  memcpy(&P, params, sizeof(StepParams));
  const Tables T = {tab, salt, lights, atlas, img_size, perlin_id, perm,
                    ranvec, texrow, kids};
  const long long blocks = (R + THREADS - 1) / THREADS;
  const bool sobol = (P.flags & SAMPLER_SOBOL) != 0;
  const bool strict = (P.flags & STRICT) != 0;
  const bool fancy = (P.flags & HAS_CHECKER_FANCY) != 0;
  const bool b0 = (P.flags & SAMPLER_B0) != 0;
  if (b0 && (!sobol || lane_b0 == nullptr)) return (int)cudaErrorInvalidValue;
  const StepKernel kernel =
      words != nullptr ? step_kernel<true>(strict, fancy, sobol, b0)
                       : step_kernel<false>(strict, fancy, sobol, b0);
  kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      P, T, xy, slot, fin, iin, best_t, best_i, lane_b0,
      static_cast<const RenderWords*>(words), fout, iout, R);
  return (int)cudaGetLastError();
}

// rays (7, R) f32 rows origin, direction, time; best_t (R) f32, best_i (R)
// i32, lane_ids (R) u32; tables and params as tr_pool_step (only the key
// words, t_min, n_lights, flags and the atlas dims are read; the STRICT and
// HAS_CHECKER_FANCY bits pick the instantiation); fout (17, R)
// f32, flags (3, R) bytes, mat (R) i32.  Returns the launch's cudaError_t.
extern "C" int tr_hit_scatter(const float* rays, const float* best_t,
                              const int* best_i, const uint32_t* lane_ids,
                              const float* tab, const uint32_t* salt,
                              const float* lights, const uint32_t* atlas,
                              const int* img_size, const int* perlin_id,
                              const int* perm, const float* ranvec,
                              const float* texrow, const int* kids,
                              const void* params, float* fout,
                              unsigned char* flags, int* mat,
                              long long R, void* stream) {
  if (R <= 0) return 0;
  StepParams P;
  memcpy(&P, params, sizeof(StepParams));
  const Tables T = {tab, salt, lights, atlas, img_size, perlin_id, perm,
                    ranvec, texrow, kids};
  const long long blocks = (R + THREADS - 1) / THREADS;
  const bool strict = (P.flags & STRICT) != 0;
  const bool fancy = (P.flags & HAS_CHECKER_FANCY) != 0;
  const auto kernel =
      strict ? (fancy ? hit_scatter_kernel<true, true>
                      : hit_scatter_kernel<true, false>)
             : (fancy ? hit_scatter_kernel<false, true>
                      : hit_scatter_kernel<false, false>);
  kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      P, T, rays, best_t, best_i, lane_ids, fout, flags, mat, R);
  return (int)cudaGetLastError();
}
