// The work queue's bookkeeping around the sweep and the step: the draw ids
// of (work item, bounce), the flush of the lanes that died and the inject
// of fresh work into the free lanes, as three kernels.
//
// No TPU kernel is replaced: tpu_ray/integrator.py::_queue_body (:663-849;
// path_ids at :686, the flush at :764, the inject from :794, the camera
// draw hash_uniforms2 at :818) runs inside the lax.while_loop of
// _queue_epoch_impl, fused by XLA.  The plain twins are
// tpu_ray_torch/ops/queue.py::path_ids_plain and queue_inject_plain, the
// port's int64 torch code: ~380 small operations an iteration with the
// hashed camera, ~1300 with Sobol', each a launch on the card.
//
// path_ids_kernel: one lane a thread, sid = hash2_base(work + id0, bounce)
//   in uint32 (the low 32 bits of the int64 work + id0, as JAX's uint32 add
//   wraps), stored as int32 bits.
// count_kernel: the free lanes (inactive after the step) of each block of
//   QUEUE_THREADS lanes.
// inject_kernel: each block sums the counts of the blocks before it (its
//   offset among the free lanes) and of all blocks (the new frontier, which
//   block 0 writes into a second buffer: no lane reads a frontier another
//   lane wrote); a strided loop over the counts, so any pool size takes one
//   pass.  It then ranks its own free lanes with a warp ballot, __popc and
//   a scan of the 32 warp counts in shared memory.  A free lane's rank is
//   the number of free lanes before it in lane order, cumsum(free) - 1 of
//   the twin exactly: that order decides which lane takes which work item,
//   and so the bits of the image.  Per lane, then:
//   - flush: a lane that was active before the step and is not after it
//     writes its radiance f[10:13] into plane column work.  Each work item
//     dies once, so the writes are unique; the twin's trash column (lanes
//     that did not die) is not written.
//   - inject: a free lane whose work item w = frontier + rank is below
//     total takes it: the work map (pixel w % P, global sample
//     (work_base / P + w / P) mod 2^32, or the worklist's packed entry),
//     the five camera uniforms (the murmur3 pair hash of (pixel, sample ^
//     salt), or qmc.cuh's sobol_camera of (pixel, plain sample)), the camera
//     ray, throughput 1, radiance 0, bounce 0, active; with sobol-b0 the
//     lane's (pixel, sample) record.
//   Block 0's first thread also writes the new frontier and adds the lanes
//   left active (the lanes that stay active, and the free lanes that take
//   an item: min(free, total - frontier)) to the census cell, the next
//   iteration's rays; one thread writes it, and no lane reads it.
//   The camera ray is the queue's, not the pool regen's of shade_core.cuh:
//   sx = ((pix % W) + u0) * inv_w and sy = ((H - 1 - pix / W) + u1) * inv_h,
//   which round otherwise than the pool's xs + u0 * inv_w, then the
//   operations of ops/queue.py one for one (the lens offset from
//   r = cam[18] * sqrtf(u2) and cosf / sinf of 2 pi u3, the direction summed
//   left to right, t = cam[19] + (cam[20] - cam[19]) * u4).  Needs IEEE
//   arithmetic: no fast math, --fmad=false.
//
// Bound: bytes (the hash and the ray are ~150 operations a refilled lane,
// far below).  path_ids: 16 B a lane (work 8 and bounce 4 in, sid 4 out),
// 0.005 ms at 1M lanes over 3.35 TB/s.  Flush and inject, counted from the
// kernels' loads and stores: 24 B a lane (the active flags before and
// after the step 4 + 4 in, the work item 8 in and 8 out), 24 B a lane that
// died (radiance 12 in, plane 12 out), 60 B a lane refilled (ray,
// throughput and radiance 52 out, bounce and active 8 out), 8 B more a
// refilled lane with a worklist (its entry), 16 B more a lane with
// sobol-b0 (the record 8 in, 8 out); 108 B a lane where every lane dies
// and is refilled, 0.032 ms at 1M lanes.  The count pass reads the active
// flags again (4 B a lane, counted once).  Every array is read and written
// in lane order, coalesced, but the plane, whose columns the dying lanes'
// work items scatter.

#include "shade_core.cuh"

#define QUEUE_THREADS 1024
#define WL_SAMP_BITS 14
#define WL_SAMP_MASK ((1LL << WL_SAMP_BITS) - 1)

__global__ void __launch_bounds__(256)
path_ids_kernel(const long long* __restrict__ work,
                const int* __restrict__ bounce, uint32_t id0,
                const RenderWords* __restrict__ words, long long m,
                int* __restrict__ sid) {
  const long long l = (long long)blockIdx.x * 256 + threadIdx.x;
  if (l >= m) return;
  if (words != nullptr) id0 = words->id0;
  const uint32_t a = (uint32_t)work[l] + id0;
  const uint32_t b = (uint32_t)bounce[l];
  sid[l] = (int)(fmix(a + 0x9E3779B9u) ^ (b * 0x85EBCA6Bu));
}

__global__ void __launch_bounds__(QUEUE_THREADS)
count_kernel(const int* __restrict__ active, long long m,
             int* __restrict__ counts) {
  const long long l = (long long)blockIdx.x * QUEUE_THREADS + threadIdx.x;
  const int n = __syncthreads_count(l < m && active[l] == 0);
  if (threadIdx.x == 0) counts[blockIdx.x] = n;
}

struct InjectArgs {
  const int* active0;       // (m,) active before the step
  float* f;                 // (13, m) the step's float state, in place
  int* i;                   // (3, m) bounce, sample, active, in place
  const long long* work;    // (m,)
  const long long* frontier;
  float* plane;             // (3, plane_cols)
  const int* lane;          // (2, m) sobol-b0 record, or null
  const long long* worklist;
  const int* counts;        // free lanes a block
  long long* work_out;
  long long* frontier_out;
  int* lane_out;
  long long* census;        // () path vertices, or null
  const RenderWords* words; // null, or the render's block (cam_salt, gs0)
  float cam[21];
  float inv_w, inv_h;
  long long total, gs0, P, m, plane_cols, n_blocks;
  int width, height, sobol, b0;
  uint32_t cam_salt;
};

__device__ __forceinline__ long long warp_sum(long long x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__global__ void __launch_bounds__(QUEUE_THREADS) inject_kernel(InjectArgs A) {
  __shared__ long long s_before[32], s_all[32], s_tot[2];
  __shared__ int s_warp[32];
  const int tid = threadIdx.x, wid = tid >> 5, ln = tid & 31;
  const long long blk = blockIdx.x;

  // this block's offset among the free lanes, and their number
  long long before = 0, all = 0;
  for (long long k = tid; k < A.n_blocks; k += QUEUE_THREADS) {
    const long long c = A.counts[k];
    all += c;
    if (k < blk) before += c;
  }
  before = warp_sum(before);
  all = warp_sum(all);

  // the rank of each free lane within the block
  const long long l = blk * QUEUE_THREADS + tid;
  const bool in = l < A.m;
  const bool free_ = in && A.i[2 * A.m + l] == 0;
  const unsigned ball = __ballot_sync(0xffffffffu, free_);
  if (ln == 0) {
    s_before[wid] = before;
    s_all[wid] = all;
    s_warp[wid] = __popc(ball);
  }
  __syncthreads();
  if (wid == 0) {
    const long long b = warp_sum(s_before[ln]);
    const long long t = warp_sum(s_all[ln]);
    const int own = s_warp[ln];
    int v = own;                        // inclusive scan of the warp counts
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, v, o);
      if (ln >= o) v += u;
    }
    s_warp[ln] = v - own;               // exclusive
    if (ln == 0) {
      s_tot[0] = b;
      s_tot[1] = t;
    }
  }
  __syncthreads();
  const long long fr = A.frontier[0];
  if (blk == 0 && tid == 0) {
    const long long nf = fr + s_tot[1];
    A.frontier_out[0] = nf < A.total ? nf : A.total;
    if (A.census != nullptr) {
      const long long left = A.total > fr ? A.total - fr : 0;
      A.census[0] += A.m - s_tot[1] + (s_tot[1] < left ? s_tot[1] : left);
    }
  }
  if (!in) return;
  const long long m = A.m;
  const long long w_old = A.work[l];

  // flush: a lane that died this iteration writes its radiance
  if (free_ && A.active0[l] > 0) {
    for (int c = 0; c < 3; ++c)
      A.plane[c * A.plane_cols + w_old] = A.f[(10 + c) * m + l];
  }

  long long w_out = w_old;
  bool valid = false;
  long long pix = 0, gs = 0;
  if (free_) {
    const long long rank = s_tot[0] + s_warp[wid] +
                           __popc(ball & ((1u << ln) - 1u));
    const long long w = fr + rank;
    valid = w < A.total;
    if (valid) {
      uint32_t cam_salt = A.cam_salt;
      long long gs0 = A.gs0;
      if (A.words != nullptr) {
        cam_salt = A.words->cam_salt;
        gs0 = A.words->gs0;
      }
      if (A.worklist == nullptr) {
        pix = w % A.P;
        gs = (gs0 + w / A.P) & 0xFFFFFFFFLL;
      } else {
        const long long packed = A.worklist[w];
        pix = packed >> WL_SAMP_BITS;
        gs = packed & WL_SAMP_MASK;
      }
      float u[5];
      if (A.sobol) {
        sobol_camera((uint32_t)pix, (uint32_t)gs, cam_salt, u);
      } else {
        const uint32_t cb = fmix((uint32_t)pix + 0x9E3779B9u) ^
                            (((uint32_t)gs ^ cam_salt) * 0x85EBCA6Bu);
        for (int k = 0; k < 5; ++k) u[k] = hash_col(cb, (uint32_t)k);
      }
      const float* c = A.cam;
      const float sx = ((float)(pix % A.width) + u[0]) * A.inv_w;
      const float sy = ((float)(A.height - 1 - pix / A.width) + u[1]) * A.inv_h;
      const float r = c[18] * sqrtf(u[2]);
      const float phi = TWO_PI * u[3];
      const float rc = r * cosf(phi), rs = r * sinf(phi);
      const float off[3] = {rc * c[12] + rs * c[15], rc * c[13] + rs * c[16],
                            rc * c[14] + rs * c[17]};
      float* f = A.f;
      for (int a = 0; a < 3; ++a) {
        f[a * m + l] = c[a] + off[a];
        f[(3 + a) * m + l] =
            c[3 + a] + sx * c[6 + a] + sy * c[9 + a] - c[a] - off[a];
        f[(7 + a) * m + l] = 1.0f;
        f[(10 + a) * m + l] = 0.0f;
      }
      f[6 * m + l] = c[19] + (c[20] - c[19]) * u[4];
      A.i[l] = 0;
      A.i[2 * m + l] = 1;
      w_out = w;
    }
  }
  A.work_out[l] = w_out;
  if (A.b0) {
    A.lane_out[l] = valid ? (int)(uint32_t)pix : A.lane[l];
    A.lane_out[m + l] = valid ? (int)(uint32_t)gs : A.lane[m + l];
  }
}

// work: (m,) int64 work items; bounce: (m,) int32; id0: the first global
// work id's low 32 bits; words: null, or a device RenderWords whose id0
// replaces id0 (a queue render replayed from a CUDA graph); sid: (m,) int32
// out.  Returns the launch's cudaError_t (0 = launched).
extern "C" int tr_path_ids(const long long* work, const int* bounce,
                           unsigned id0, const void* words, long long m,
                           int* sid, void* stream) {
  if (m <= 0) return 0;
  path_ids_kernel<<<(unsigned)((m + 255) / 256), 256, 0,
                    (cudaStream_t)stream>>>(
      work, bounce, id0, static_cast<const RenderWords*>(words), m, sid);
  return (int)cudaGetLastError();
}

// active0: (m,) int32 active flags before the step; f: (13, m) float32 and
// i: (3, m) int32, the step's outputs, updated in place; work: (m,) and
// frontier: () int64; plane: (3, plane_cols) float32, written in place;
// lane: (2, m) int32 (sobol-b0) or null; worklist: (Wl,) int64 packed
// entries or null; counts: (ceil(m / 1024),) int32 scratch; work_out,
// frontier_out, lane_out: the new work items, frontier and record; census:
// () int64 path vertices, in place, or null; cam: host pointer to the 21
// camera floats (Camera.vec); words: null, or a device RenderWords whose
// cam_salt and gs0 replace cam_salt and work_base / (W * H) (a queue render
// replayed from a CUDA graph).  Returns the first failed launch's
// cudaError_t (0 = both launched).
extern "C" int tr_queue_inject(
    const int* active0, float* f, int* i, const long long* work,
    const long long* frontier, float* plane, const int* lane,
    const long long* worklist, int* counts, long long* work_out,
    long long* frontier_out, int* lane_out, long long* census,
    const float* cam, float inv_w,
    float inv_h, long long total, long long work_base, int width, int height,
    unsigned cam_salt, int sobol, int b0, long long m, long long plane_cols,
    const void* words, void* stream) {
  if (m <= 0) return 0;
  const long long n_blocks = (m + QUEUE_THREADS - 1) / QUEUE_THREADS;
  cudaStream_t s = (cudaStream_t)stream;
  count_kernel<<<(unsigned)n_blocks, QUEUE_THREADS, 0, s>>>(i + 2 * m, m,
                                                            counts);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  InjectArgs A;
  A.active0 = active0; A.f = f; A.i = i; A.work = work;
  A.frontier = frontier; A.plane = plane; A.lane = lane;
  A.worklist = worklist; A.counts = counts; A.work_out = work_out;
  A.frontier_out = frontier_out; A.lane_out = lane_out; A.census = census;
  memcpy(A.cam, cam, sizeof(A.cam));
  A.inv_w = inv_w; A.inv_h = inv_h;
  const long long P = (long long)width * height;
  A.total = total; A.gs0 = work_base / P; A.P = P; A.m = m;
  A.plane_cols = plane_cols; A.n_blocks = n_blocks;
  A.width = width; A.height = height; A.sobol = sobol; A.b0 = b0;
  A.cam_salt = cam_salt;
  A.words = static_cast<const RenderWords*>(words);
  inject_kernel<<<(unsigned)n_blocks, QUEUE_THREADS, 0, s>>>(A);
  return (int)cudaGetLastError();
}
