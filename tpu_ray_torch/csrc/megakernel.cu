// Whole-wave megakernel: the entire ray-pool loop of one wave in one launch,
// persistent threads that take the wave's slots from a queue.
//
// Replaces the TPU kernel tpu_ray/ops/megakernel.py::_kernel (launched by
// trace_pool_mega).  Per slot: regenerate the first camera sample, then loop
// { closest hit over all solid prims; free flight through the constant
// media; hit record; textures; scatter with light MIS; Russian roulette;
// accumulate; path death; regenerate } until the slot has finished its
// n_samples samples or the wave's iteration cap is reached; then write the
// slot's radiance sum and its sample count.  The camera sample is hashed
// or, with the SAMPLER_SOBOL flag bit, the scrambled Sobol' point of the TPU
// kernel's sobol branch (qmc.cuh, through the shared pool_iteration); the
// strict estimator stays outside the megakernel, as in the JAX package.
// The plain PyTorch twin is
// tpu_ray_torch/ops/megakernel.py::trace_pool_mega_plain.
//
// Design.  Not the Pallas kernel block by block: that one works on (8, 128)
// vregs, carries twenty winner-row fields through its sweep because Mosaic
// cannot gather, and leaves its loop per 1024-lane tile.  Here the path state
// of a slot (16 words) stays in its thread's registers while the thread runs
// it, the sweep keeps only (best t, best prim) and the shade core reads the
// winner's row by index.
//
// Persistent threads over a slot queue.  The wrapper launches as many
// threads as the card holds at once (occupancy x SMs, ops/megakernel.py);
// each thread starts on the slot of its own index and, when that slot is
// done, writes its radiance and sample count at the slot's index and claims
// the next unclaimed slot from a per-launch device counter (zeroed by the
// wrapper), restarting the iteration count at 0.  The lanes of a warp that
// finish in the same trip claim together, with one atomicAdd.  So a warp's
// lanes stay busy until the queue runs dry, where one thread per slot kept a
// warp alive as long as its longest slot.  Any thread may run any slot with
// the same bits: every draw is keyed by (slot, sample) or (slot, iteration),
// never by position, and a slot's iteration count starts at 0 and indexes
// the (iter_cap, 4) key table (words 0:2 the scatter key, 2:4 the intersect
// key of that iteration).  Launched with one thread per slot (``threads`` >=
// R) the kernel runs the one-slot-per-thread schedule, and every claim past
// the first finds the queue empty.  The launch bound of 3 blocks of 256 per
// SM leaves ptxas 85 registers; it takes 78 without a spill, so 24 warps
// share an SM.
//
// The sweep's (n_solid <= 512, 16) geometry rows are copied to shared memory
// once per resident block (32 KB static at most) and read from there, as
// float4s, in every iteration, static and moving spheres in loops of their
// own: all lanes of a warp sweep the same row at the same time, which shared
// memory broadcasts, and the rows never leave the SM while the loop runs,
// whatever the shade core's table and light loads do to L1.  The per-pair
// tests (sweep_pairs.cuh), the free flight (media.cuh), the shade core and
// the pool update (shade_core.cuh) are the very functions the wavefront
// kernels run, so a slot's discrete decisions are theirs.  The running
// radiance sum is one sum per slot, where the wavefront pool adds a slot's
// radiance across its compaction levels: the two agree to reassociation,
// not bit for bit.
//
// Bound.  Operations: each active lane-iteration sweeps every solid prim (21
// to 31 flops a pair) and runs one pool step (~400 flops); at 67 TFLOP/s,
// which counts an FMA as two operations (built with --fmad=false, the
// kernel's own ceiling is twice that).  Memory does not bind: 12 B in and
// 16 B out per lane per wave.  What the bound leaves out is the cost of
// divergence: lanes of a warp sit in different material branches and at
// different samples.  ``stats`` counts what the warps did: word 0 sums the
// iterations of all slots, word 1 the loop trips of all warps (a trip in
// which any lane of the warp iterates); word 0 over 32 x word 1 is the
// working share of lane slots.

#include "media.cuh"

#ifndef MEGA_THREADS
#define MEGA_THREADS 256
#endif
#ifndef MEGA_MIN_BLOCKS
#define MEGA_MIN_BLOCKS 3
#endif
#define MAX_SOLID 512

// the closest hit of ray r over the staged solids, then the media, each
// against the running best with a strict '<' in table order: the dense
// sweep's winner, then intersect_ti's media merge
__device__ __forceinline__ void mega_sweep(
    const float* sg, const Ray& r, int n_ss, int n_s, int n_sb, int n_solid,
    int n_prims, const Tables& T, uint32_t slot, const uint32_t* kw,
    bool any_transform, float t_min, float& bt, int& bi) {
  bt = __int_as_float(0x7f800000);
  bi = 0;
  sphere_sweep<1, false>(sg, 0, n_ss, &r, t_min, 0, &bt, &bi);
  sphere_sweep<1, true>(sg, n_ss, n_s, &r, t_min, 0, &bt, &bi);
  for (int j = n_s; j < n_sb; ++j) {
    const float4* g = row(sg, j);
    const float t = hit_box(g[0], g[1], r, t_min);
    if (t < bt) { bt = t; bi = j; }
  }
  for (int j = n_sb; j < n_solid; ++j) {
    const float4* g = row(sg, j);
    const float t = hit_quad(g[0], g[1], g[2], g[3], r, t_min);
    if (t < bt) { bt = t; bi = j; }
  }
  if (n_prims > n_solid) {
    const uint32_t base_i = fmix(slot + __ldg(kw + 2)) ^ __ldg(kw + 3);
    const float dlen = sqrtf(r.a);
    for (int m = n_solid; m < n_prims; ++m) {
      const float t = media_t(T.tab + (long long)m * PRIM_COLS, r, dlen,
                              base_i, m - n_solid, any_transform, t_min);
      if (t < bt) { bt = t; bi = m; }
    }
  }
}

// SOBOL_ON: the SAMPLER_SOBOL bit of P.flags (the C entry launches the
// instantiation it names); strict scenes stay on the wavefront kernels, so
// the core is compiled without the strict branches
template <bool SOBOL_ON>
__global__ void __launch_bounds__(MEGA_THREADS, MEGA_MIN_BLOCKS)
mega_kernel(const StepParams P, const Tables T,
            const float* __restrict__ geo, int n_ss, int n_s, int n_sb,
            int n_solid, int n_prims, const uint32_t* __restrict__ keys,
            int iter_cap, const float* __restrict__ xy,
            const uint32_t* __restrict__ slot_ids, float* __restrict__ acc,
            int* __restrict__ sample_out, unsigned long long* stats,
            unsigned long long* next, long long R) {
  __shared__ __align__(16) float sg[MAX_SOLID * ROW];
  for (int q = threadIdx.x; q < n_solid * ROW; q += blockDim.x) sg[q] = geo[q];
  __syncthreads();

  const long long n_threads = (long long)gridDim.x * blockDim.x;
  const unsigned lane = threadIdx.x & 31u;
  const bool any_transform = (P.flags & ANY_TRANSFORM) != 0;
  long long s = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  float xs = 0.0f, ys = 0.0f;
  uint32_t slot = 0;
  int it = 0;
  Lane L;
  L.active = 0;
  bool started = false;          // L holds slot s
  unsigned alive = 0xffffffffu;  // lanes of this warp still in the loop
  unsigned lane_iters = 0, trips = 0;

  while (true) {
    const bool done = !(L.active > 0 && it < iter_cap);
    const unsigned need = __ballot_sync(alive, done);
    if (done) {
      if (started) {
        acc[s] = L.ac.x; acc[R + s] = L.ac.y; acc[2 * R + s] = L.ac.z;
        sample_out[s] = L.sample;
        // the next unclaimed slot: one atomicAdd for the lanes of ``need``
        const int leader = __ffs(need) - 1;
        unsigned long long got = 0;
        if ((int)lane == leader)
          got = atomicAdd(next, (unsigned long long)__popc(need));
        got = __shfl_sync(need, got, leader);
        s = n_threads + (long long)got + __popc(need & ((1u << lane) - 1u));
      }
      started = s < R;
      if (started) {
        xs = xy[s];
        ys = xy[R + s];
        slot = slot_ids[s];
        L.o = {0.0f, 0.0f, 0.0f};
        L.d = {0.0f, 0.0f, 0.0f};
        L.tm = 0.0f;
        L.tp = {1.0f, 1.0f, 1.0f};
        L.ac = {0.0f, 0.0f, 0.0f};
        L.bounce = 0; L.sample = 0; L.active = 0;
        pool_iteration<SOBOL_ON, false, false, false>(
            P, T, xs, ys, slot, 0u, 0u, true, 0.0f, 0, L, 0u, 0u, 0u);
        it = 0;
      }
    }
    alive = __ballot_sync(alive, started);
    if (!started) break;
    ++trips;
    if (L.active > 0 && it < iter_cap) {
      const uint32_t* kw = keys + 4 * (long long)it;
      const uint32_t kd0 = __ldg(kw), kd1 = __ldg(kw + 1);
      const Ray r = make_ray(L.o.x, L.o.y, L.o.z, L.d.x, L.d.y, L.d.z, L.tm);
      float bt;
      int bi;
      mega_sweep(sg, r, n_ss, n_s, n_sb, n_solid, n_prims, T, slot, kw,
                 any_transform, P.t_min, bt, bi);
      pool_iteration<SOBOL_ON, false, false, false>(
          P, T, xs, ys, slot, kd0, kd1, false, bt, bi, L, 0u, 0u, 0u);
      ++it;
      ++lane_iters;
    }
  }

  // slot-iterations and loop trips of this warp, once every lane has left
  // the loop (blockDim.x is a multiple of 32 and no thread has returned)
  unsigned sum = lane_iters, most = trips;
  for (int off = 16; off > 0; off >>= 1) {
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
    most = max(most, __shfl_xor_sync(0xffffffffu, most, off));
  }
  if (lane == 0) {
    atomicAdd(stats, (unsigned long long)sum);
    atomicAdd(stats + 1, (unsigned long long)most);
  }
}

// xy (2, R) f32, slot (R) u32, geo (n_solid, 16) f32 with its kind ranges,
// keys (iter_cap, 4) u32, tables and params as tr_pool_step (the key words
// and ``init`` of the block are not read), acc (3, R) f32, sample (R) i32,
// stats (2) u64 added to, next (1) u64 the slot queue's counter (0 at the
// launch), threads the threads to launch (rounded up to whole blocks, at
// most one per slot).  Returns the launch's cudaError_t (0 = launched);
// cudaErrorInvalidValue for more solid prims than the shared-memory table
// holds.
extern "C" int tr_megakernel(const float* xy, const uint32_t* slot,
                             const float* geo, int n_ss, int n_s, int n_sb,
                             int n_solid, int n_prims, const uint32_t* keys,
                             int iter_cap, const float* tab,
                             const uint32_t* salt, const float* lights,
                             const uint32_t* atlas, const int* img_size,
                             const int* perlin_id, const int* perm,
                             const float* ranvec, const void* params,
                             float* acc, int* sample,
                             unsigned long long* stats,
                             unsigned long long* next, long long R,
                             long long threads, void* stream) {
  if (R <= 0) return 0;
  if (n_solid > MAX_SOLID || n_solid < 0 || threads <= 0)
    return (int)cudaErrorInvalidValue;
  StepParams P;
  memcpy(&P, params, sizeof(StepParams));
  const Tables T = {tab, salt, lights, atlas, img_size, perlin_id, perm,
                    ranvec};
  const long long n = threads < R ? threads : R;
  const long long blocks = (n + MEGA_THREADS - 1) / MEGA_THREADS;
  const auto kernel = (P.flags & SAMPLER_SOBOL) ? mega_kernel<true>
                                                 : mega_kernel<false>;
  kernel<<<(unsigned)blocks, MEGA_THREADS, 0, (cudaStream_t)stream>>>(
      P, T, geo, n_ss, n_s, n_sb, n_solid, n_prims, keys, iter_cap, xy, slot,
      acc, sample, stats, next, R);
  return (int)cudaGetLastError();
}

// The persistent launch's thread count on the current device: the blocks of
// mega_kernel that fit on an SM at once (the fewer of its two
// instantiations'), times the SMs, times the block.
extern "C" long long tr_megakernel_threads(void) {
  int dev = 0, sms = 0, per_sm = 0, per_sm_sobol = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, mega_kernel<false>, MEGA_THREADS, 0) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm_sobol, mega_kernel<true>, MEGA_THREADS, 0) != cudaSuccess)
    return -1;
  if (per_sm_sobol < per_sm) per_sm = per_sm_sobol;
  return (long long)per_sm * sms * MEGA_THREADS;
}
