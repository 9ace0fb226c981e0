// The dense closest-hit sweep over the solid primitives, several rays per
// thread.  (The sorted sweeps, compacted-list and mask-gated, are in
// sweep_compact.cu.)
//
// Replaces the TPU kernels tpu_ray/ops/intersect_pallas.py::_sphere_kernel,
// _box_kernel and _quad_kernel (launched per kind range by _sweep_range from
// intersect_solids_pallas), and stands in for the XLA sweep
// tpu_ray/ops/intersect.py::_chunk_t that the JAX main path runs for scenes
// of at most 512 prims.  One kernel serves every prim count.
//
// Design.  The prim table (n_solid rows of 16 floats, kind-sorted: static
// spheres | moving spheres | boxes | quads) is staged through shared memory
// CHUNK rows at a time; all threads of a block read the same row at once,
// which shared memory broadcasts.  Each thread holds RPT rays (1, 2 or 4),
// each with its own running (t, prim) minimum in registers, so every row
// read from shared memory serves RPT pair tests and the RPT independent
// chains give the scheduler work between dependent instructions.  A row is
// read as float4s (2 for a sphere or a box, 4 for a quad) and the kind
// ranges are separate loops, static and moving spheres apart, so no kind
// test sits inside a loop.  Spheres go 32 rows at a time in two passes
// (sweep_pairs.cuh::sphere_sweep): the discriminant of every pair first,
// then the square root and the root tests only for the pairs it lets
// through, so a warp no longer runs them wherever any of its rays needs
// them.  The slab test's min and max are one min.NaN / max.NaN
// instruction each.  A block's rays are RPT runs of THREADS
// consecutive rays, so loads and stores stay coalesced.  Prims are visited
// in ascending order and each ray's minimum moves only on a strict '<',
// which reproduces both the XLA chunk argmin (first index) and the Pallas
// per-block first-index / cross-block strict-'<' rule, for every RPT: a
// ray's minimum is updated by its own tests alone.  No prim padding
// exists, so the TPU kernels' padding hazards (r^2 = 0 spheres, degenerate
// boxes, n = 0 quads) do not arise; NaN still fails every comparison, which
// needs IEEE arithmetic (built without fast math, with --fmad=false).  The
// per-pair math lives in sweep_pairs.cuh, shared with the sorted sweeps and
// the megakernel, which keeps them all bit-equal.  The wrapper
// (tpu_ray_torch/ops/sweep.py::pick_rpt) takes RPT > 1 only where the grid
// still fills every SM (the pool path launches most sweeps on partly
// filled pools, where one ray per thread keeps more warps in flight), and
// RPT = 4 only over 32 prims or more (below that a ray's bytes, not its
// pair tests, bind, and four rays' registers cost warps).
//
// Bound.  Operations: about 21 flops per (ray, static sphere) pair, 27 per
// moving sphere, 24 per box and 31 per quad.  book1-final (485 spheres) at
// 1M rays is ~1e10 fp32 operations per sweep: compute-bound, ~0.15 ms at
// the card's 67 TFLOP/s.  That rate counts an FMA as two operations; built
// with --fmad=false every multiply and add is an instruction of its own, so
// this kernel's own ceiling is twice the bound (~0.30 ms there).  The flag
// stays: the kernels' discrete decisions and their bit-equality rest on
// per-operation rounding.  cornell (13 prims) moves 36 B per ray (28 in,
// 8 out): ~11 us of memory time at 1M rays, so it is bound by its bytes and
// by the launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sweep_pairs.cuh"

#define CHUNK 256
#define THREADS 128

template <int RPT>
__global__ void __launch_bounds__(THREADS)
sweep_kernel(const float* __restrict__ rays, long long R,
             const float* __restrict__ geo, int n_ss, int n_s, int n_sb,
             int n_solid, float t_min, float* __restrict__ out_t,
             int* __restrict__ out_i) {
  __shared__ __align__(16) float sg[CHUNK * ROW];
  const long long first = (long long)blockIdx.x * (THREADS * RPT) + threadIdx.x;
  Ray r[RPT];
  float bt[RPT];
  int bi[RPT];
#pragma unroll
  for (int k = 0; k < RPT; ++k) {
    const long long i = first + (long long)k * THREADS;
    r[k] = load_ray(rays, R, i < R ? i : 0);
    bt[k] = __int_as_float(0x7f800000);
    bi[k] = 0;
  }

  for (int base = 0; base < n_solid; base += CHUNK) {
    const int cnt = min(CHUNK, n_solid - base);
    __syncthreads();
    for (int q = threadIdx.x; q < cnt * ROW; q += THREADS)
      sg[q] = geo[(long long)base * ROW + q];
    __syncthreads();
    const int e_ss = max(0, min(cnt, n_ss - base));
    const int e_s = max(0, min(cnt, n_s - base));
    const int e_sb = max(0, min(cnt, n_sb - base));

    sphere_sweep<RPT, false>(sg, 0, e_ss, r, t_min, base, bt, bi);
    sphere_sweep<RPT, true>(sg, e_ss, e_s, r, t_min, base, bt, bi);
    for (int j = e_s; j < e_sb; ++j) {        // solid axis-aligned boxes
      const float4* g = row(sg, j);
      const float4 a = g[0], b = g[1];
#pragma unroll
      for (int k = 0; k < RPT; ++k) {
        const float t = hit_box(a, b, r[k], t_min);
        if (t < bt[k]) { bt[k] = t; bi[k] = base + j; }
      }
    }
    for (int j = e_sb; j < cnt; ++j) {        // quads
      const float4* g = row(sg, j);
      const float4 a = g[0], b = g[1], c = g[2], d = g[3];
#pragma unroll
      for (int k = 0; k < RPT; ++k) {
        const float t = hit_quad(a, b, c, d, r[k], t_min);
        if (t < bt[k]) { bt[k] = t; bi[k] = base + j; }
      }
    }
  }
#pragma unroll
  for (int k = 0; k < RPT; ++k) {
    const long long i = first + (long long)k * THREADS;
    if (i < R) {
      out_t[i] = bt[k];
      out_i[i] = bi[k];
    }
  }
}

// rays: (7, R) float32 rows ox, oy, oz, dx, dy, dz, time (row stride R).
// geo: (n_solid, 16) float32 (layout in tpu_ray_torch/ops/sweep.py).
// rpt: rays per thread, 1, 2 or 4 (all give the same bits).
// Returns the launch's cudaError_t (0 = launched).
extern "C" int tr_sweep(const float* rays, long long R, const float* geo,
                        int n_ss, int n_s, int n_sb, int n_solid, float t_min,
                        float* out_t, int* out_i, int rpt, void* stream) {
  if (R <= 0) return 0;
  const long long per_block = (long long)THREADS * rpt;
  const unsigned blocks = (unsigned)((R + per_block - 1) / per_block);
  cudaStream_t st = (cudaStream_t)stream;
  if (rpt == 4)
    sweep_kernel<4><<<blocks, THREADS, 0, st>>>(
        rays, R, geo, n_ss, n_s, n_sb, n_solid, t_min, out_t, out_i);
  else if (rpt == 2)
    sweep_kernel<2><<<blocks, THREADS, 0, st>>>(
        rays, R, geo, n_ss, n_s, n_sb, n_solid, t_min, out_t, out_i);
  else if (rpt == 1)
    sweep_kernel<1><<<blocks, THREADS, 0, st>>>(
        rays, R, geo, n_ss, n_s, n_sb, n_solid, t_min, out_t, out_i);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
