// Closest-hit sweep over per-tile compacted block lists: one thread block per
// 256-ray tile, one thread per ray.
//
// Replaces the TPU kernel tpu_ray/ops/intersect_pallas.py::_compact_kernel
// (launched per kind range by _sweep_range_compact when
// intersect_solids_pallas runs with sort=True).  Rays arrive sorted by
// direction octant and origin Morton code, so the rays of a tile are
// coherent and most 128-prim blocks can be culled for the whole tile.  The
// cull decision is made outside (tpu_ray_torch/ops/sweep.py::tile_lists, a
// slab test of every ray against every block's AABB): cnt[tile] block ids in
// lst[tile, :] are the blocks some ray of the tile can enter, front to back.
//
// Design.  The block table is the dense sweep's own (n_solid, 16) prim
// table plus a (B, 3) descriptor per block: first row, row count (<= 128),
// kind (0 static sphere, 1 moving sphere, 2 box, 3 quad).  Blocks never
// cross a kind range and carry their true row count, so nothing is padded
// and the TPU kernel's padding hazards (r^2 = 0 spheres, degenerate boxes,
// n = 0 quads) cannot arise.  One launch covers all four kinds.  For each
// listed block the thread block stages its rows in shared memory (8 KB;
// all threads then read the same row, a broadcast), and every thread runs
// the dense sweep's per-pair math (sweep_pairs.cuh) with a strict '<' in
// ascending row order.  Blocks are merged with the lower-prim-id tie-break
// closer = (t < best) | (t == best & i < best_i), which makes the result
// independent of the list order and equal to the dense sweep's: bit-equal
// (t, i) on every ray.  With ``perm`` the results are written to
// out[perm[ray]], which un-permutes the sorted rays in the same pass.
//
// Bound.  The function is the dense sweep's, so its bound is the dense
// sweep's for the same rays and prims; the work actually done is the listed
// share of the (tile, block) pairs.  Tiles with long lists run longest, so
// the tail of the grid is uneven; a faster kernel would split long lists.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sweep_pairs.cuh"

#define PBLK 128
#define TILE_R 256

__global__ void __launch_bounds__(TILE_R)
sweep_compact_kernel(const float* __restrict__ rays, long long R,
                     const float* __restrict__ geo,
                     const int* __restrict__ desc,
                     const int* __restrict__ cnt,
                     const int* __restrict__ lst, int n_blocks, float t_min,
                     const long long* __restrict__ perm,
                     float* __restrict__ out_t, int* __restrict__ out_i) {
  __shared__ __align__(16) float sg[PBLK * ROW];
  const long long tile = blockIdx.x;
  const long long i = tile * TILE_R + threadIdx.x;
  const bool live = i < R;
  const Ray r = load_ray(rays, R, live ? i : 0);
  const float INF = __int_as_float(0x7f800000);
  float bt = INF;
  int bi = 0;

  const int n = cnt[tile];
  const int* mine = lst + tile * n_blocks;
  for (int j = 0; j < n; ++j) {
    const int b = mine[j];
    const int start = desc[3 * b], rows = desc[3 * b + 1];
    const int kind = desc[3 * b + 2];
    __syncthreads();
    for (int q = threadIdx.x; q < rows * ROW; q += TILE_R)
      sg[q] = geo[(long long)start * ROW + q];
    __syncthreads();
    float lt;
    int li;
    block_min(sg, r, start, rows, kind, t_min, lt, li);
    if (lt < bt || (lt == bt && li < bi)) { bt = lt; bi = li; }
  }
  if (live) {
    const long long o = perm ? perm[i] : i;
    out_t[o] = bt;
    out_i[o] = bi;
  }
}

// rays (7, R) f32 (sorted), geo (n_solid, 16) f32, desc (B, 3) i32, cnt (T)
// i32 with T = ceil(R / 256), lst (T, B) i32, perm (R) i64 or null, out_t /
// out_i (R).  Returns the launch's cudaError_t (0 = launched).
extern "C" int tr_sweep_compact(const float* rays, long long R,
                                const float* geo, const int* desc,
                                const int* cnt, const int* lst, int n_blocks,
                                float t_min, const long long* perm,
                                float* out_t, int* out_i, void* stream) {
  if (R <= 0) return 0;
  const long long tiles = (R + TILE_R - 1) / TILE_R;
  sweep_compact_kernel<<<(unsigned)tiles, TILE_R, 0, (cudaStream_t)stream>>>(
      rays, R, geo, desc, cnt, lst, n_blocks, t_min, perm, out_t, out_i);
  return (int)cudaGetLastError();
}
