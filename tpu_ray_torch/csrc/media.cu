// The media free flight of the wavefront closest hit: one launch that
// min-combines the solids' (best_t, best_i) with every constant medium's
// free-flight distance, one lane a thread.
//
// No TPU kernel is replaced: tpu_ray/ops/intersect.py:172-230 (the media
// branch of _chunk_t) runs inside the XLA program of intersect_ti.  The
// plain twin is tpu_ray_torch/ops/intersect.py::merge_media_plain, ~110-150
// small torch operations a medium, each a launch on the card.  Here a lane
// keeps its ray in registers and runs media.cuh::media_t (the megakernel's
// and the BVH kernel's free flight, the arithmetic of _media_t) on each
// medium row in row order, replacing (best_t, best_i) with (t_j, n_solid +
// j) where t_j < best_t: the strict '<' of the twin, so a solid wins a tie
// and an earlier medium wins over a later one.  |d|^2, its reciprocal and
// dlen = sqrtf(|d|^2) are the twin's a, inv_a and sqrt_rn(a): sqrtf without
// fast math is correctly rounded.  The free-flight draw of medium j is
// column medium_slot[j] of the lane's stream based at fmix(lane + kd0) ^
// kd1 (rng.lane_base).  Needs IEEE arithmetic: no fast math, --fmad=false.
//
// The medium rows (their (N, 40) prim-table rows, media_t's layout) and
// their slots are staged in shared memory once a block; every lane of a
// warp reads the same row, which shared memory broadcasts.
//
// Bound.  Bytes: 48 B a lane - the ray's 7 floats (28 B), the lane id
// (4 B), best_t and best_i read (8 B) and written (8 B) - over 3.35 TB/s,
// 0.0143 ms at 1M lanes.  Operations (ops/intersect.py MEDIA_LANE_OPS,
// MEDIA_OPS): 17 a lane (|d|^2, 1/|d|^2, the root, the stream base) and a
// medium 61 (sphere), 63 (box) or 96 (box under a transform), counting
// the hash's integer operations and the logf as one each; at two media
// ~0.2 G operations at 1M lanes, 0.003 ms at 67 TFLOP/s.  So the kernel is
// bound by its bytes: it reads each input once, coalesced (rows of the
// (7, R) ray layout), and writes each output once; nothing is staged
// through device memory.

#include "media.cuh"

#define MEDIA_THREADS 256

__global__ void __launch_bounds__(MEDIA_THREADS)
media_kernel(const float* __restrict__ rays, long long R,
             const uint32_t* __restrict__ lane_ids, uint32_t kd0,
             uint32_t kd1, const float* __restrict__ rows,
             const int* __restrict__ slots, int n_media, int n_solid,
             int any_transform, float t_min,
             const float* __restrict__ best_t, const int* __restrict__ best_i,
             float* __restrict__ out_t, int* __restrict__ out_i) {
  extern __shared__ float s_rows[];   // n_media rows of PRIM_COLS floats
  int* s_slot = reinterpret_cast<int*>(s_rows + n_media * PRIM_COLS);
  for (int k = threadIdx.x; k < n_media * PRIM_COLS; k += MEDIA_THREADS)
    s_rows[k] = rows[k];
  for (int k = threadIdx.x; k < n_media; k += MEDIA_THREADS)
    s_slot[k] = slots[k];
  __syncthreads();
  const long long i = (long long)blockIdx.x * MEDIA_THREADS + threadIdx.x;
  if (i >= R) return;
  const Ray r = load_ray(rays, R, i);
  const float dlen = sqrtf(r.a);
  const uint32_t base_i = fmix(lane_ids[i] + kd0) ^ kd1;
  float bt = best_t[i];
  int bi = best_i[i];
  for (int j = 0; j < n_media; ++j) {
    const float t = media_t(s_rows + j * PRIM_COLS, r, dlen, base_i,
                            s_slot[j], any_transform != 0, t_min);
    if (t < bt) {
      bt = t;
      bi = n_solid + j;
    }
  }
  out_t[i] = bt;
  out_i[i] = bi;
}

// rays: (7, R) float32 rows ox, oy, oz, dx, dy, dz, time (row stride R).
// lane_ids: (R,) uint32 bits keying the draws; kd0, kd1: the intersect
// key's words.  rows: (n_media, 40) float32, the media rows of the prim
// table; slots: (n_media,) int32 draw columns.  best_t, best_i: (R,) the
// solids' closest hits; out_t, out_i: (R,) the merged ones (other
// buffers).  Returns the launch's cudaError_t (0 = launched).
extern "C" int tr_media(const float* rays, long long R, const int* lane_ids,
                        unsigned kd0, unsigned kd1, const float* rows,
                        const int* slots, int n_media, int n_solid,
                        int any_transform, float t_min, const float* best_t,
                        const int* best_i, float* out_t, int* out_i,
                        void* stream) {
  if (R <= 0) return 0;
  const unsigned blocks = (unsigned)((R + MEDIA_THREADS - 1) / MEDIA_THREADS);
  const size_t smem =
      (size_t)n_media * (PRIM_COLS * sizeof(float) + sizeof(int));
  media_kernel<<<blocks, MEDIA_THREADS, smem, (cudaStream_t)stream>>>(
      rays, R, reinterpret_cast<const uint32_t*>(lane_ids), kd0, kd1, rows,
      slots, n_media, n_solid, any_transform, t_min, best_t, best_i, out_t,
      out_i);
  return (int)cudaGetLastError();
}
