// The sorted sweeps: the tile-list pass, and one sweep over a per-tile list
// of blocks that serves both the compacted-list sweep and the mask-gated
// sweep, one thread block per 256-ray tile of sorted rays.
//
// Replaces the TPU kernel tpu_ray/ops/intersect_pallas.py::_compact_kernel
// (launched per kind range by _sweep_range_compact when
// intersect_solids_pallas runs with sort=True) and the XLA block lists it
// takes (_tile_lists), and the cull=True mode of _sphere_kernel, _box_kernel
// and _quad_kernel (wired in _sweep_range) with the (T, B) needed mask of
// _needed_mask, which the same list pass writes.  Rays arrive sorted by
// direction octant and origin Morton code, so the rays of a tile are coherent
// and most 128-prim blocks can be culled for the whole tile.
//
// The list pass (tile_lists_kernel).  One thread per ray slab-tests its ray
// against every block box with tpu_ray_torch/ops/sweep.py::_slab_need's rule
// operation for operation (zero direction components nudged to +-1e-30, the
// slack 1e-4 * (1 + |tn|), t_min; built with --fmad=false, so every ``need``
// bit is torch's); the rays of a short last tile are the pad rays from the
// origin along (1, 1, 1), as there.  A warp ORs ``need`` (__ballot_sync) and
// takes the minimum clamped entry distance of the rays that need a block
// (__reduce_min_sync on the bits: the keys are >= +0, where the bit order is
// the float order); one shared atomic per warp and block merges the eight
// warps.  Then thread b ranks block b by (key, block id) - the order of
// torch.argsort(stable=True) over keys that are +inf for unneeded blocks -
// and writes lst[tile, rank] = b or, in mask mode, mask[tile, b], and
// cnt[tile].  The block that finishes last (one atomic counter) also writes
// the tile order: the tiles by descending cnt.  The sweeps run them in that
// order, so the tiles with long lists start first and the grid's tail stays
// short.
//
// The sweep (sweep_tiles_kernel<RPT, MASKED>).  The tile's list, with each
// listed block's descriptor (first row, row count <= 128, kind) and box, is
// read into shared memory once: for the compacted sweep lst[tile, :cnt], near
// to far; for the mask-gated sweep the blocks of the tile's mask row, in
// table order (a block-wide scan of warp ballots).  Each thread holds RPT of
// the tile's rays (1 or 2: runs of 256 / RPT consecutive rays, coalesced),
// each with its own running (t, prim).  Listed blocks are staged
// double-buffered: the rows of block j + 1 are copied with cp.async while
// block j is tested.  Before testing a block the tile votes
// (__syncthreads_or): a live ray wants the block only where its own slab test
// needs it and its entry distance, less the slack, is <= its best t so far.
// A hit inside the block lies past tn - slack, so a block no ray wants can
// neither win nor tie: blocks of a tile whose rays have all hit something
// nearer are skipped without changing a bit (near-to-far lists skip more of
// them than table order does).  Pair tests are the dense sweep's
// (sweep_pairs.cuh: the two-pass sphere sweep, the slab and quad tests), in
// ascending row order with a strict '<'; blocks merge with the lower-prim-id
// tie-break closer = (t < best) | (t == best & i < best_i), which makes (t, i)
// independent of the list order and bit-equal to the dense sweep.  With
// ``perm`` the results go to out[perm[ray]], which un-permutes the sorted
// rays in the same pass.
//
// Bound.  The dense sweep's operations over the (tile, block) pairs the
// lists or the mask name (next-week-final, 1M sorted bounce-1 rays: 27% of
// the pairs, 0.134 ms at 67 TFLOP/s; chip_smoke.py::listed_flops); the list
// pass is bound by its bytes (24 in per ray, the lists out: 0.007 ms there)
// and does ~20 operations per (ray, block).

#include <cuda_runtime.h>
#include <stdint.h>

#include "sweep_pairs.cuh"

#define PBLK 128
#define TILE_R 256

// _slab_need's nudge of a zero direction component
__device__ __forceinline__ float slab_safe(float d) {
  return fabsf(d) < 1e-30f ? (d < 0.0f ? -1e-30f : 1e-30f) : d;
}

// _slab_need's test of one ray (origin o, nudged inverse direction v)
// against one box: whether the ray can enter it past t_min, its entry
// distance tn, and tn less the slack (no hit in the box lies before it)
__device__ __forceinline__ bool slab_need(const float* lo, const float* hi,
                                          const float o[3], const float v[3],
                                          float t_min, float& tn,
                                          float& near) {
  const float INF = __int_as_float(0x7f800000);
  tn = -INF;
  float tf = INF;
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    const float t0 = (lo[ax] - o[ax]) * v[ax];
    const float t1 = (hi[ax] - o[ax]) * v[ax];
    tn = nmax(tn, nmin(t0, t1));
    tf = nmin(tf, nmax(t0, t1));
  }
  const float slack = 1e-4f * (1.0f + fabsf(tn));
  near = tn - slack;
  return (near <= tf) && (tf > t_min);
}

__device__ __forceinline__ void ray_slab(const float* __restrict__ rays,
                                         long long R, long long i, bool live,
                                         float o[3], float v[3]) {
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    o[ax] = live ? rays[ax * R + i] : 0.0f;      // pad rays: origin,
    v[ax] = 1.0f / slab_safe(live ? rays[(3 + ax) * R + i] : 1.0f);  // (1,1,1)
  }
}

__global__ void __launch_bounds__(TILE_R)
tile_lists_kernel(const float* __restrict__ rays, long long R,
                  const float* __restrict__ blo, const float* __restrict__ bhi,
                  int n_blocks, float t_min, int* __restrict__ cnt,
                  int* __restrict__ lst, int* __restrict__ mask,
                  int* __restrict__ order, unsigned* __restrict__ done) {
  extern __shared__ float s_box[];                     // (B, 6) lo, hi
  unsigned* s_need = (unsigned*)(s_box + 6 * n_blocks);
  unsigned* s_key = s_need + n_blocks;
  int* s_hist = (int*)(s_key + n_blocks);              // (B + 1)
  __shared__ int s_cnt;
  __shared__ bool s_last;
  const long long tile = blockIdx.x;
  for (int b = threadIdx.x; b < n_blocks; b += TILE_R) {
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) {
      s_box[6 * b + ax] = blo[3 * b + ax];
      s_box[6 * b + 3 + ax] = bhi[3 * b + ax];
    }
    s_need[b] = 0u;
    s_key[b] = 0x7f800000u;                            // +inf
  }
  if (threadIdx.x == 0) s_cnt = 0;
  __syncthreads();

  const long long i = tile * TILE_R + threadIdx.x;
  float o[3], v[3];
  ray_slab(rays, R, i, i < R, o, v);
  const int lane = threadIdx.x & 31;
  for (int b = 0; b < n_blocks; ++b) {
    float tn, near;
    const bool need = slab_need(s_box + 6 * b, s_box + 6 * b + 3, o, v,
                                t_min, tn, near);
    // torch.clamp(tn, min=0); a needed block's tn is finite or -inf
    const unsigned key = need ? __float_as_uint(tn > 0.0f ? tn : 0.0f)
                              : 0x7f800000u;
    const unsigned any = __ballot_sync(0xffffffffu, need);
    const unsigned kmin = __reduce_min_sync(0xffffffffu, key);
    if (lane == 0 && any) {
      atomicOr(&s_need[b], 1u);
      atomicMin(&s_key[b], kmin);
    }
  }
  __syncthreads();

  for (int b = threadIdx.x; b < n_blocks; b += TILE_R) {
    if (lst) {
      const unsigned kb = s_need[b] ? s_key[b] : 0x7f800000u;
      int rank = 0;
      for (int j = 0; j < n_blocks; ++j) {
        const unsigned kj = s_need[j] ? s_key[j] : 0x7f800000u;
        rank += (kj < kb) || (kj == kb && j < b);
      }
      lst[tile * n_blocks + rank] = b;
    }
    if (mask) mask[tile * n_blocks + b] = (int)s_need[b];
    if (s_need[b]) atomicAdd(&s_cnt, 1);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    cnt[tile] = s_cnt;
    __threadfence();                     // cnt[tile] before the count
    s_last = atomicAdd(done, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!s_last) return;
  // the last block orders the tiles by descending list length (a counting
  // sort; equal lengths in any order), so that the sweep starts the longest
  // tiles first and its grid's tail is short
  __threadfence();
  const int T = gridDim.x;
  for (int c = threadIdx.x; c <= n_blocks; c += TILE_R) s_hist[c] = 0;
  __syncthreads();
  for (int t = threadIdx.x; t < T; t += TILE_R)
    atomicAdd(&s_hist[n_blocks - __ldcg(cnt + t)], 1);
  __syncthreads();
  if (threadIdx.x == 0) {
    int run = 0;
    for (int c = 0; c <= n_blocks; ++c) {
      const int h = s_hist[c];
      s_hist[c] = run;
      run += h;
    }
  }
  __syncthreads();
  for (int t = threadIdx.x; t < T; t += TILE_R)
    order[atomicAdd(&s_hist[n_blocks - __ldcg(cnt + t)], 1)] = t;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// start copying ``rows`` prim rows from table row ``start`` into ``dst``
template <int NT>
__device__ __forceinline__ void stage_rows(float* dst,
                                           const float* __restrict__ geo,
                                           int start, int rows) {
  const float4* src = reinterpret_cast<const float4*>(geo + (long long)start
                                                      * ROW);
  float4* d4 = reinterpret_cast<float4*>(dst);
  for (int q = threadIdx.x; q < rows * (ROW / 4); q += NT)
    cp_async16(d4 + q, src + q);
  cp_async_commit();
}

// list entry j <- block b: its descriptor and box
__device__ __forceinline__ void list_block(int j, int b,
                                           const int* __restrict__ desc,
                                           const float* __restrict__ blo,
                                           const float* __restrict__ bhi,
                                           int* s_desc, float* s_box) {
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    s_desc[3 * j + q] = desc[3 * b + q];
    s_box[6 * j + q] = blo[3 * b + q];
    s_box[6 * j + 3 + q] = bhi[3 * b + q];
  }
}

// The tile's list of blocks in shared memory, returning its length.  From
// the list pass's lists (MASKED false): lst[tile, :cnt[tile]], near to far.
// From the needed mask (MASKED true): the blocks whose mask word is set, in
// table order, by a block-wide scan of warp ballots (NT / 32 counts in
// s_wc).
template <int NT, bool MASKED>
__device__ __forceinline__ int tile_list(long long tile,
                                         const int* __restrict__ cnt,
                                         const int* __restrict__ sel,
                                         int n_blocks,
                                         const int* __restrict__ desc,
                                         const float* __restrict__ blo,
                                         const float* __restrict__ bhi,
                                         int* s_desc, float* s_box,
                                         int* s_wc) {
  const int* mine = sel + tile * n_blocks;
  if (!MASKED) {
    const int n = cnt[tile];
    for (int j = threadIdx.x; j < n; j += NT)
      list_block(j, mine[j], desc, blo, bhi, s_desc, s_box);
    return n;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int n = 0;
  for (int b0 = 0; b0 < n_blocks; b0 += NT) {
    const int b = b0 + threadIdx.x;
    const bool on = b < n_blocks && mine[b] != 0;
    const unsigned bal = __ballot_sync(0xffffffffu, on);
    if (lane == 0) s_wc[warp] = __popc(bal);
    __syncthreads();
    int j = n + __popc(bal & ((1u << lane) - 1u));
    int total = 0;
#pragma unroll
    for (int w = 0; w < NT / 32; ++w) {
      j += w < warp ? s_wc[w] : 0;
      total += s_wc[w];
    }
    if (on) list_block(j, b, desc, blo, bhi, s_desc, s_box);
    n += total;
    __syncthreads();                           // s_wc is written again
  }
  return n;
}

// One thread block per 256-ray tile of sorted rays, in ``order``, RPT rays
// a thread: the compacted-list sweep (MASKED false, sel = lst) and the
// mask-gated sweep (MASKED true, sel = mask) share this loop and differ only
// in where the tile's list comes from.
template <int RPT, bool MASKED>
__global__ void __launch_bounds__(TILE_R / RPT)
sweep_tiles_kernel(const float* __restrict__ rays, long long R,
                   const float* __restrict__ geo,
                   const int* __restrict__ desc,
                   const float* __restrict__ blo,
                   const float* __restrict__ bhi,
                   const int* __restrict__ cnt,
                   const int* __restrict__ sel, int n_blocks, float t_min,
                   const long long* __restrict__ perm,
                   float* __restrict__ out_t, int* __restrict__ out_i,
                   unsigned long long* __restrict__ stats,
                   const int* __restrict__ order) {
  constexpr int NT = TILE_R / RPT;
  extern __shared__ float4 smem4[];
  __shared__ int s_wc[NT / 32];
  float* smem = reinterpret_cast<float*>(smem4);        // 2 row buffers
  int* s_desc = (int*)(smem + 2 * PBLK * ROW);          // (n, 3) listed
  float* s_box = (float*)(s_desc + 3 * n_blocks);       // (n, 6) listed
  const long long tile = order[blockIdx.x];
  const int n = tile_list<NT, MASKED>(tile, cnt, sel, n_blocks, desc, blo,
                                      bhi, s_desc, s_box, s_wc);

  Ray r[RPT];
  float o[RPT][3], v[RPT][3];
  float bt[RPT];
  int bi[RPT];
  bool live[RPT];
#pragma unroll
  for (int k = 0; k < RPT; ++k) {
    const long long i = tile * TILE_R + threadIdx.x + k * NT;
    live[k] = i < R;
    r[k] = load_ray(rays, R, live[k] ? i : 0);
    ray_slab(rays, R, i, live[k], o[k], v[k]);
    bt[k] = __int_as_float(0x7f800000);
    bi[k] = 0;
  }
  __syncthreads();                                       // the list is read

  int tested = 0;
  if (n > 0) stage_rows<NT>(smem, geo, s_desc[0], s_desc[1]);
  for (int j = 0; j < n; ++j) {
    if (j + 1 < n) {
      stage_rows<NT>(smem + ((j + 1) & 1) * PBLK * ROW, geo,
                     s_desc[3 * (j + 1)], s_desc[3 * (j + 1) + 1]);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    // the cull: does any live ray still want block j?
    int want = 0;
#pragma unroll
    for (int k = 0; k < RPT; ++k) {
      float tn, near;
      const bool need = slab_need(s_box + 6 * j, s_box + 6 * j + 3, o[k],
                                  v[k], t_min, tn, near);
      want |= live[k] && need && (near <= bt[k]);
    }
    // (the barrier also makes every thread's copy of block j visible)
    if (__syncthreads_or(want)) {
      ++tested;
      float lt[RPT];
      int li[RPT];
      block_sweep<RPT>(smem + (j & 1) * PBLK * ROW, s_desc[3 * j],
                       s_desc[3 * j + 1], s_desc[3 * j + 2], r, t_min, lt, li);
#pragma unroll
      for (int k = 0; k < RPT; ++k)
        if (lt[k] < bt[k] || (lt[k] == bt[k] && li[k] < bi[k])) {
          bt[k] = lt[k];
          bi[k] = li[k];
        }
    }
    __syncthreads();          // block j's buffer is free for block j + 2
  }
#pragma unroll
  for (int k = 0; k < RPT; ++k) {
    const long long i = tile * TILE_R + threadIdx.x + k * NT;
    if (live[k]) {
      const long long dst = perm ? perm[i] : i;
      out_t[dst] = bt[k];
      out_i[dst] = bi[k];
    }
  }
  if (stats && threadIdx.x == 0) {
    atomicAdd(stats, (unsigned long long)n);
    atomicAdd(stats + 1, (unsigned long long)(n - tested));
  }
}

static size_t list_smem(int n_blocks) {
  return (size_t)n_blocks * 36 + 4;
}
static size_t sweep_smem(int n_blocks) {
  return (size_t)2 * PBLK * ROW * 4 + (size_t)n_blocks * 36;
}

template <typename K>
static int allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// rays (7, R) f32 (sorted); blo / bhi (B, 3) f32 block boxes.  Writes cnt
// (T) with T = ceil(R / 256), order (T), the tiles by descending cnt, and
// lst (T, B) or mask (T, B), whichever is not null; ``done`` is one zeroed
// u32.  Returns the launch's cudaError_t.
extern "C" int tr_tile_lists(const float* rays, long long R, const float* blo,
                             const float* bhi, int n_blocks, float t_min,
                             int* cnt, int* lst, int* mask, int* order,
                             unsigned* done, void* stream) {
  if (R <= 0 || n_blocks <= 0) return 0;
  if (!order || !done || !lst == !mask) return (int)cudaErrorInvalidValue;
  const long long tiles = (R + TILE_R - 1) / TILE_R;
  const size_t bytes = list_smem(n_blocks);
  int err = allow_smem(tile_lists_kernel, bytes);
  if (err) return err;
  tile_lists_kernel<<<(unsigned)tiles, TILE_R, bytes, (cudaStream_t)stream>>>(
      rays, R, blo, bhi, n_blocks, t_min, cnt, lst, mask, order, done);
  return (int)cudaGetLastError();
}

template <int RPT, bool MASKED>
static int launch_tiles(const float* rays, long long R, const float* geo,
                        const int* desc, const float* blo, const float* bhi,
                        const int* cnt, const int* sel, int n_blocks,
                        float t_min, const long long* perm, float* out_t,
                        int* out_i, unsigned long long* stats,
                        const int* order, cudaStream_t st) {
  const long long tiles = (R + TILE_R - 1) / TILE_R;
  const size_t bytes = sweep_smem(n_blocks);
  int err = allow_smem(sweep_tiles_kernel<RPT, MASKED>, bytes);
  if (err) return err;
  sweep_tiles_kernel<RPT, MASKED><<<(unsigned)tiles, TILE_R / RPT, bytes,
                                    st>>>(
      rays, R, geo, desc, blo, bhi, cnt, sel, n_blocks, t_min, perm, out_t,
      out_i, stats, order);
  return (int)cudaGetLastError();
}

// rays (7, R) f32 (sorted), geo (n_solid, 16) f32 (16-byte aligned), desc
// (B, 3) i32, blo / bhi (B, 3) f32; with ``masked`` 0 the lists: cnt (T) i32
// with T = ceil(R / 256) and sel = lst (T, B) i32; with ``masked`` 1 sel =
// the needed mask (T, B) i32 (cnt unread, may be null).  order (T) i32: the
// tiles in launch order, a permutation (all give the same bits); perm (R)
// i64 or null, out_t / out_i (R), rpt 1 or 2 (both give the same bits),
// stats (2) u64 or null: listed (needed) and skipped (tile, block) pairs
// are added to it.  Returns the launch's cudaError_t.
extern "C" int tr_sweep_tiles(const float* rays, long long R, const float* geo,
                              const int* desc, const float* blo,
                              const float* bhi, const int* cnt, const int* sel,
                              const int* order, int n_blocks, float t_min,
                              const long long* perm, float* out_t, int* out_i,
                              int rpt, int masked, unsigned long long* stats,
                              void* stream) {
  if (R <= 0) return 0;
  if (!order || (!masked && !cnt)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define TR_LAUNCH(K, M)                                                    \
  return launch_tiles<K, M>(rays, R, geo, desc, blo, bhi, cnt, sel,         \
                            n_blocks, t_min, perm, out_t, out_i, stats,     \
                            order, st)
  if (rpt == 2 && masked) TR_LAUNCH(2, true);
  if (rpt == 1 && masked) TR_LAUNCH(1, true);
  if (rpt == 2) TR_LAUNCH(2, false);
  if (rpt == 1) TR_LAUNCH(1, false);
#undef TR_LAUNCH
  return (int)cudaErrorInvalidValue;
}
