// Whole-wave megakernel: the entire ray-pool loop of one wave in one launch,
// one thread per lane.
//
// Replaces the TPU kernel tpu_ray/ops/megakernel.py::_kernel (launched by
// trace_pool_mega).  Per lane: regenerate the first camera sample, then loop
// { closest hit over all solid prims; free flight through the constant
// media; hit record; textures; scatter with light MIS; Russian roulette;
// accumulate; path death; regenerate } until the lane has finished its
// n_samples samples or the wave's iteration cap is reached; then write the
// lane's radiance sum and its sample count.  The plain PyTorch twin is
// tpu_ray_torch/ops/megakernel.py::trace_pool_mega_plain.
//
// Design.  Not the Pallas kernel block by block: that one works on (8, 128)
// vregs, carries twenty winner-row fields through its sweep because Mosaic
// cannot gather, and leaves its loop per 1024-lane tile.  Here the path state
// of a lane (16 words) stays in its thread's registers for the whole wave,
// the sweep keeps only (best t, best prim) and the shade core reads the
// winner's row by index.  A thread leaves the loop when its own lane is
// done; that changes no result, because an inactive lane's iteration changes
// nothing and every draw is keyed by (slot, sample) or (slot, iteration),
// never by position.  The iteration counter is the wave's (the same for all
// lanes, from 0), and indexes the (iter_cap, 4) key table: words 0:2 the
// scatter key, 2:4 the intersect key of that iteration.
//
// The sweep's (n_solid <= 512, 16) geometry rows are copied to shared memory
// once per block (32 KB static at most) and read from there in every
// iteration: all lanes of a warp sweep the same row at the same time, which
// shared memory broadcasts, and the rows never leave the SM while the loop
// runs, whatever the shade core's table and light loads do to L1.  The
// per-pair tests (sweep_pairs.cuh), the free flight (media.cuh), the shade
// core and the pool update (shade_core.cuh) are the very functions the
// wavefront kernels run, so a lane's discrete decisions are theirs.  The
// running radiance sum is one sum per lane, where the wavefront pool adds a
// slot's radiance across its compaction levels: the two agree to
// reassociation, not bit for bit.
//
// Bound.  Operations: each active lane-iteration sweeps every solid prim (21
// to 31 flops a pair) and runs one pool step (~400 flops); at 67 TFLOP/s.
// Memory does not bind: 12 B in and 16 B out per lane per wave.  What the
// bound leaves out is the cost of divergence: lanes of a warp sit in
// different material branches and at different samples, and a warp lasts as
// long as its slowest lane.  ``stats`` counts both sides of that: word 0
// sums the iterations of all lanes, word 1 the iterations of all warps (a
// warp's count is its longest lane's).

#include "media.cuh"

#ifndef MEGA_THREADS
#define MEGA_THREADS 256
#endif
#ifndef MEGA_MIN_BLOCKS
#define MEGA_MIN_BLOCKS 2
#endif
#define MAX_SOLID 512

__global__ void __launch_bounds__(MEGA_THREADS, MEGA_MIN_BLOCKS)
mega_kernel(const StepParams P, const Tables T,
            const float* __restrict__ geo, int n_ss, int n_s, int n_sb,
            int n_solid, int n_prims, const uint32_t* __restrict__ keys,
            int iter_cap, const float* __restrict__ xy,
            const uint32_t* __restrict__ slot_ids, float* __restrict__ acc,
            int* __restrict__ sample_out, unsigned long long* stats,
            long long R) {
  __shared__ float sg[MAX_SOLID * ROW];
  for (int q = threadIdx.x; q < n_solid * ROW; q += blockDim.x) sg[q] = geo[q];
  __syncthreads();

  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < R;
  const long long k = live ? i : 0;
  const float xs = xy[k], ys = xy[R + k];
  const uint32_t slot = slot_ids[k];
  const float INF = __int_as_float(0x7f800000);
  const bool any_transform = (P.flags & ANY_TRANSFORM) != 0;

  Lane L;
  L.o = {0.0f, 0.0f, 0.0f};
  L.d = {0.0f, 0.0f, 0.0f};
  L.tm = 0.0f;
  L.tp = {1.0f, 1.0f, 1.0f};
  L.ac = {0.0f, 0.0f, 0.0f};
  L.bounce = 0; L.sample = 0; L.active = 0;
  pool_iteration(P, T, xs, ys, slot, 0u, 0u, true, 0.0f, 0, L);
  if (!live) L.active = 0;

  int it = 0;
  while (L.active > 0 && it < iter_cap) {
    const uint32_t* kw = keys + 4 * (long long)it;
    const uint32_t kd0 = __ldg(kw), kd1 = __ldg(kw + 1);
    const Ray r = make_ray(L.o.x, L.o.y, L.o.z, L.d.x, L.d.y, L.d.z, L.tm);
    float bt = INF;
    int bi = 0;
    // solids in table order, strict '<': the dense sweep's winner
    for (int j = 0; j < n_s; ++j) {
      const float t = hit_sphere(sg + j * ROW, r, j >= n_ss, P.t_min);
      if (t < bt) { bt = t; bi = j; }
    }
    for (int j = n_s; j < n_sb; ++j) {
      const float t = hit_box(sg + j * ROW, r, P.t_min);
      if (t < bt) { bt = t; bi = j; }
    }
    for (int j = n_sb; j < n_solid; ++j) {
      const float t = hit_quad(sg + j * ROW, r, P.t_min);
      if (t < bt) { bt = t; bi = j; }
    }
    // then the media, each against the solids' best with a strict '<'
    if (n_prims > n_solid) {
      const uint32_t base_i = fmix(slot + __ldg(kw + 2)) ^ __ldg(kw + 3);
      const float dlen = sqrtf(r.a);
      for (int m = n_solid; m < n_prims; ++m) {
        const float t = media_t(T.tab + (long long)m * PRIM_COLS, r, dlen,
                                base_i, m - n_solid, any_transform, P.t_min);
        if (t < bt) { bt = t; bi = m; }
      }
    }
    pool_iteration(P, T, xs, ys, slot, kd0, kd1, false, bt, bi, L);
    ++it;
  }

  if (live) {
    acc[i] = L.ac.x; acc[R + i] = L.ac.y; acc[2 * R + i] = L.ac.z;
    sample_out[i] = L.sample;
  }

  // lane-iterations and warp-iterations of this warp (blockDim.x is a
  // multiple of 32, and no thread has returned)
  unsigned sum = (unsigned)it, most = (unsigned)it;
  for (int off = 16; off > 0; off >>= 1) {
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
    most = max(most, __shfl_xor_sync(0xffffffffu, most, off));
  }
  if ((threadIdx.x & 31) == 0) {
    atomicAdd(stats, (unsigned long long)sum);
    atomicAdd(stats + 1, (unsigned long long)most);
  }
}

// xy (2, R) f32, slot (R) u32, geo (n_solid, 16) f32 with its kind ranges,
// keys (iter_cap, 4) u32, tables and params as tr_pool_step (the key words
// and ``init`` of the block are not read), acc (3, R) f32, sample (R) i32,
// stats (2) u64 added to.  Returns the launch's cudaError_t (0 = launched);
// cudaErrorInvalidValue for more solid prims than the shared-memory table
// holds.
extern "C" int tr_megakernel(const float* xy, const uint32_t* slot,
                             const float* geo, int n_ss, int n_s, int n_sb,
                             int n_solid, int n_prims, const uint32_t* keys,
                             int iter_cap, const float* tab,
                             const uint32_t* salt, const float* lights,
                             const uint32_t* atlas, const int* img_size,
                             const void* params, float* acc, int* sample,
                             unsigned long long* stats, long long R,
                             void* stream) {
  if (R <= 0) return 0;
  if (n_solid > MAX_SOLID || n_solid < 0) return (int)cudaErrorInvalidValue;
  StepParams P;
  memcpy(&P, params, sizeof(StepParams));
  const Tables T = {tab, salt, lights, atlas, img_size};
  const long long blocks = (R + MEGA_THREADS - 1) / MEGA_THREADS;
  mega_kernel<<<(unsigned)blocks, MEGA_THREADS, 0, (cudaStream_t)stream>>>(
      P, T, geo, n_ss, n_s, n_sb, n_solid, n_prims, keys, iter_cap, xy, slot,
      acc, sample, stats, R);
  return (int)cudaGetLastError();
}
