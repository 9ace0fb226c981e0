// Closest hit by BVH traversal, one ray per thread.
//
// No TPU kernel is replaced: tpu_ray/ops/bvh.py::intersect_scene_bvh (:270)
// runs the traversal as one XLA lax.while_loop in lockstep over all rays.
// Written in torch that loop would be driven from the host, one sync and
// ~40 launches a node step; here each thread walks its own ray's tree with
// a 32-entry stack in local memory, which is the card's natural form of the
// same function.  The plain twin is tpu_ray_torch/ops/bvh.py::
// intersect_bvh_plain (the lockstep loop on tensors).
//
// What it computes, step for step as the JAX loop (bvh.py:296-339): the
// current node's slab test (1/d per axis, min / max per axis, their max /
// min across axes) clipped to (t_min, best_t), with the NaN-propagating
// min.NaN / max.NaN of sweep_pairs.cuh: for an axis-parallel ray whose
// origin lies on a node's face (min - o) * inf is NaN, and, as with
// jnp.minimum, that node is missed.  A leaf that passes tests its prims in
// ``order``; an internal node that passes pushes its right child (at
// min(sp, 31), as JAX clips) and descends into the left; every other step
// pops, or ends the ray on an empty stack.  A pair's distance is the
// sweeps' device function on the prim's row of the (n_solid, 16) sweep
// table (hit_sphere, hit_moving, hit_box, hit_quad), or media.cuh::media_t
// on the medium's row of the (N, 40) prim table with the lane's free-flight
// draw (base fmix(lane + kd0) ^ kd1, column = medium index: the stream of
// ops/intersect.py and the megakernel), so each pair has the bits the
// brute-force sweep gives it.  The closer hit is kept by a strict '<' in
// visit order.  Needs IEEE arithmetic: no fast math, --fmad=false.
//
// Nodes are packed (M, 8) floats: min xyz, max xyz, then the bits of
// (child_l, child_r) for an internal node or (first, -count) for a leaf,
// so a node is two 16-byte loads through the read-only cache.
//
// Bound.  The work depends on the rays: per ray ~25 fp32 operations a node
// visit and the pair math of each leaf prim tested (21-31 for a solid, ~40
// for a medium), against 40 bytes (7 floats and the lane id in, t and id
// out).  The tree and the prim rows are small and stay in L1/L2.  At the
// visit and pair counts of the main path's rays (chip_smoke.py phase 3
// counts them with the twin) it is operation-bound on paper, but a thread
// per ray walks its own path through the tree: the warp diverges in depth
// and in which leaves it tests, and the node loads are dependent, so
// latency, not either rate, is what a simple kernel meets first.

#include "media.cuh"

#define BVH_THREADS 128
#define STACK_DEPTH 32

__global__ void __launch_bounds__(BVH_THREADS)
bvh_kernel(const float* __restrict__ rays, long long R,
           const float4* __restrict__ nodes, const int* __restrict__ order,
           const float4* __restrict__ geo, const float* __restrict__ tab,
           int n_ss, int n_s, int n_sb, int n_solid, float t_min,
           uint32_t kd0, uint32_t kd1, const uint32_t* __restrict__ lane_ids,
           int any_transform, int leaf_size, float* __restrict__ out_t,
           int* __restrict__ out_i) {
  const long long i = (long long)blockIdx.x * BVH_THREADS + threadIdx.x;
  if (i >= R) return;
  const float INF = __int_as_float(0x7f800000);
  const Ray r = load_ray(rays, R, i);
  float dlen = 0.0f;
  uint32_t base_i = 0u;
  if (tab != nullptr) {
    dlen = sqrtf(r.a);
    base_i = fmix(__ldg(lane_ids + i) + kd0) ^ kd1;
  }
  int stack[STACK_DEPTH];
  int sp = 0, node = 0;
  float bt = INF;
  int bi = 0;
  while (true) {
    const float4 n0 = __ldg(nodes + 2 * node);
    const float4 n1 = __ldg(nodes + 2 * node + 1);
    const float tax = (n0.x - r.ox) * r.ix, tbx = (n0.w - r.ox) * r.ix;
    const float tay = (n0.y - r.oy) * r.iy, tby = (n1.x - r.oy) * r.iy;
    const float taz = (n0.z - r.oz) * r.iz, tbz = (n1.y - r.oz) * r.iz;
    const float tn = nmax(nmax(nmin(tax, tbx), nmin(tay, tby)),
                          nmin(taz, tbz));
    const float tf = nmin(nmin(nmax(tax, tbx), nmax(tay, tby)),
                          nmax(taz, tbz));
    const bool hit = nmin(tf, bt) > nmax(tn, t_min);
    const int a = __float_as_int(n1.z), b = __float_as_int(n1.w);
    const bool leaf = b < 0;
    if (hit && leaf) {
      const int cnt = min(-b, leaf_size);
      for (int k = 0; k < cnt; ++k) {
        const int pid = __ldg(order + a + k);
        float t;
        if (pid < n_solid) {
          const float4* g = geo + 4 * (long long)pid;
          const float4 g0 = __ldg(g), g1 = __ldg(g + 1);
          if (pid < n_ss) {
            t = hit_sphere(g0, g1, r, t_min);
          } else if (pid < n_s) {
            t = hit_moving(g0, g1, r, t_min);
          } else if (pid < n_sb) {
            t = hit_box(g0, g1, r, t_min);
          } else {
            t = hit_quad(g0, g1, __ldg(g + 2), __ldg(g + 3), r, t_min);
          }
        } else {
          t = media_t(tab + (long long)pid * PRIM_COLS, r, dlen, base_i,
                      pid - n_solid, any_transform != 0, t_min);
        }
        if (t < bt) { bt = t; bi = pid; }
      }
    }
    if (hit && !leaf) {
      stack[min(sp, STACK_DEPTH - 1)] = b;   // the right child
      ++sp;
      node = a;                              // the left child
    } else if (sp > 0) {
      --sp;
      node = stack[min(sp, STACK_DEPTH - 1)];
    } else {
      break;
    }
  }
  out_t[i] = bt;
  out_i[i] = bi;
}

// rays: (7, R) float32 rows ox, oy, oz, dx, dy, dz, time (row stride R).
// nodes: (M, 8) float32 packed nodes (above); order: (N,) int32.
// geo: (n_solid, 16) float32 sweep table (ops/sweep.py; may be null without
// solids).  tab: (N, 40) float32 prim table (ops/shade.py::build_tables),
// read for media rows only; null when the scene has no media.
// kd0, kd1: the intersect key's words; lane_ids: (R,) uint32 bits.
// Returns the launch's cudaError_t (0 = launched).
extern "C" int tr_bvh(const float* rays, long long R, const float* nodes,
                      const int* order, const float* geo, const float* tab,
                      int n_ss, int n_s, int n_sb, int n_solid, float t_min,
                      unsigned kd0, unsigned kd1, const int* lane_ids,
                      int any_transform, int leaf_size, float* out_t,
                      int* out_i, void* stream) {
  if (R <= 0) return 0;
  const unsigned blocks = (unsigned)((R + BVH_THREADS - 1) / BVH_THREADS);
  bvh_kernel<<<blocks, BVH_THREADS, 0, (cudaStream_t)stream>>>(
      rays, R, reinterpret_cast<const float4*>(nodes), order,
      reinterpret_cast<const float4*>(geo), tab, n_ss, n_s, n_sb, n_solid,
      t_min, kd0, kd1, reinterpret_cast<const uint32_t*>(lane_ids),
      any_transform, leaf_size, out_t, out_i);
  return (int)cudaGetLastError();
}
