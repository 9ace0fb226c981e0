// Static-sphere sweep in the matrix-product form, its cross terms on the
// tensor cores.
//
// Replaces the TPU kernel tpu_ray/ops/intersect_pallas.py::
// _sphere_mxu_kernel (launched by _sweep_sphere_mxu under
// TPU_RAY_SWEEP_MXU=1).  The sphere quadratic oc = o - c, b = oc.d,
// c = |oc|^2 - r^2 is expanded around the range centroid m (o' = o - m,
// c' = c - m):
//
//     b  = o'.d - (c'.d)
//     cc = |o'|^2 + (-2 o'.c' + |c'|^2 - r^2)
//
// so that the terms mixing a ray with a sphere are two small matrix
// products, d @ [c'] and [o', 1] @ [-2c' ; k'] with k' = |c'|^2 - r^2; the
// TPU kernel runs them on its matrix unit at HIGHEST precision.
//
// Design.  A warp takes 32 rays as two 16-row tiles and the spheres eight at
// a time (one n8 tile), and forms the products with mma.sync in TF32 split
// three ways, Hopper's counterpart of HIGHEST: x = hi + lo with hi =
// tf32(x), lo = tf32(x - hi), and x.y ~ hi.hi + hi.lo + lo.hi in fp32
// accumulation.  Two products per pair, each folding in what the pair test
// needs next:
//
//     -b      = [d, o'.d] . [c', -1]                 (m16n8k8 + m16n8k4)
//     a cc - M = [a o', a, a|o'|^2, a|o'|] . [-2c', k' - g (U^2 + W),
//                1 - g, -2 g U]                       (two m16n8k8)
//
// where M = g a ((|o'| + U)^2 + W) is the margin below (g = 2^-13, U = |c'|,
// W = |k'|); its small terms take the hi parts only.  The ray side is split
// once per ray into registers; the sphere side comes split and laid out per
// lane from tpu_ray_torch/ops/sweep.py::mxu_pack (two float4 per lane and
// n8 tile, staged through shared memory 128 spheres at a time).  Each
// thread owns two rays x two spheres of every tile (the accumulator
// fragment); per pair it keeps one multiply and one compare: b^2 > a cc - M.
// Eight tiles at a time, the same products against the tiles' bounding
// spheres (pack's frag2, whose margin also holds the slack of the plain
// twin's rounding) and a warp-wide vote pick the tiles some ray of each
// 16-ray tile can hit; the others are skipped (about half of them on
// book1-final's bounce-1 rays).
//
// Bit-equality with the plain twin.  The expanded form cancels: the terms
// are ~|o'||c'| and the result ~r^2, so any rounding other than the plain
// twin's (sweep.py::sweep_sphere_mxu_plain: fp32 products and sums in a
// fixed order) moves t by more than 2e-5 on several percent of the hits,
// even with exact products (tpu_ray_torch/utils/mxu_split_study.py).  So the
// tensor cores only decide where a hit is possible: disc + M > 0, M a bound
// on the distance of this discriminant from the plain twin's.  The pairs
// that pass - under one percent on book1-final's rays, set as bits per ray
// over 16 tiles - are tested again in scalar fp32 with the plain twin's
// operations in its order (--fmad=false), -2c' and k' read from the pack;
// every other pair has a plain discriminant <= 0 and no hit.  So (t, i)
// equal the plain twin's bit for bit.  The margin: with e the products'
// relative error (3 * 2^-22 for the split, ~2^-20 for the accumulation,
// 2^-22 for the plain twin's own rounding; e < 2^-16 is assumed) and u =
// 2^-24, Cauchy-Schwarz gives |disc - disc_plain| <= a (3e + 16u)
// ((|o'| + U)^2 + W); g = 2^-13 is over twice that.  Each ray keeps its
// running (t, i) in ascending sphere order with a strict '<'; the four
// threads of a quad then merge by (t, lower i): the first index of the
// minimum, as the plain twin's torch.min.
//
// Bound.  The function's own work per pair, with its products on the
// tensor cores: the 7 products of the cross terms (c'.d and o'.(-2c') +
// k'), each split three ways, are 21 multiply-adds (42 flops over 495
// TFLOP/s, dense TF32); b, cc, disc and the compare are 6 flops over 67
// TFLOP/s on the CUDA cores.  The larger of the two is the bound: book1-
// final, 960k rays x 485 spheres, 0.042 ms (the CUDA cores' share).  This
// design's MMAs do more than that (28 k-slots a pair, with the margin's
// columns, the folded o'.d and the padding), and the retest of the passing
// pairs and the tile test come on top, the skipped tiles off.  The scalar
// form's bound (24 flops a pair over 67 TFLOP/s) was 0.167 ms.  mma.sync
// is not the card's fastest path to its tensor cores (wgmma is), and the
// products take most of this kernel's time.

#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 256                 // 8 warps x 32 rays
#define RAYS (THREADS)              // rays per block
#define CHUNK_G 16                  // n8 tiles staged at a time (128 spheres)
#define NF 10                       // exact per-ray fields in shared memory

__device__ __forceinline__ unsigned tf32(float x) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo (+ what tf32 cannot hold of the rest)
__device__ __forceinline__ void split(float x, unsigned& hi, unsigned& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_k8(float d[4], unsigned a0, unsigned a1,
                                       unsigned a2, unsigned a3, float b0,
                                       float b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(__float_as_uint(b0)),
        "r"(__float_as_uint(b1)));
}

__device__ __forceinline__ void mma_k4(float d[4], unsigned a0, unsigned a1,
                                       float b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k4.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(__float_as_uint(b0)));
}

__global__ void __launch_bounds__(THREADS)
sweep_mxu_kernel(const float* __restrict__ rays, long long R,
                 const float4* __restrict__ tab,     // (n, 2) float4 rows
                 const float4* __restrict__ frag,    // (G, 32, 2) per lane
                 const float4* __restrict__ frag2,   // (G / 8, 32, 2) tiles
                 int n, int lo, float mx, float my, float mz, float t_min,
                 float* __restrict__ out_t, int* __restrict__ out_i,
                 unsigned long long* __restrict__ stats) {
  __shared__ float4 s_frag[CHUNK_G * 32 * 2];
  __shared__ float4 s_frag2[CHUNK_G / 8 * 32 * 2];
  __shared__ float s_ray[NF][RAYS];
  const float INF = __int_as_float(0x7f800000);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const long long base = (long long)blockIdx.x * RAYS;

  // the thread's rays: rows gid and gid + 8 of the warp's two 16-row tiles;
  // per row component tig of D = (d, o'.d) and of A = a (o', 1), split, and
  // X: (a |o'|^2 hi, its lo, a |o'|^2 hi, a |o'| hi)[tig]
  unsigned dh[2][2], dl[2][2], ah[2][2], al[2][2], xs[2][2];
  float bt[2][2];
  int bi[2][2];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int slot = warp * 32 + m * 16 + h * 8 + gid;
      const long long i = base + slot;
      const long long k = i < R ? i : 0;
      const float dx = rays[3 * R + k], dy = rays[4 * R + k],
                  dz = rays[5 * R + k];
      const float ox = rays[k] - mx, oy = rays[R + k] - my,
                  oz = rays[2 * R + k] - mz;
      const float a = dx * dx + dy * dy + dz * dz;
      const float od = ox * dx + oy * dy + oz * dz;
      const float oo = ox * ox + oy * oy + oz * oz;
      split(tig == 0 ? dx : tig == 1 ? dy : tig == 2 ? dz : od, dh[m][h],
            dl[m][h]);
      split(a * (tig == 0 ? ox : tig == 1 ? oy : tig == 2 ? oz : 1.0f),
            ah[m][h], al[m][h]);
      unsigned xh, xl;
      split(a * oo, xh, xl);
      xs[m][h] = tig == 1 ? xl : tig == 3 ? tf32(a * sqrtf(oo)) : xh;
      if (tig == 0) {
        s_ray[0][slot] = ox; s_ray[1][slot] = oy; s_ray[2][slot] = oz;
        s_ray[3][slot] = dx; s_ray[4][slot] = dy; s_ray[5][slot] = dz;
        s_ray[6][slot] = a; s_ray[7][slot] = 1.0f / a;
        s_ray[8][slot] = od; s_ray[9][slot] = oo;
      }
      bt[m][h] = INF;
      bi[m][h] = 0;
    }

  const int G = (n + 7) >> 3;
  unsigned long long cands = 0;
  for (int c0 = 0; c0 < G; c0 += CHUNK_G) {
    const int cg = min(CHUNK_G, G - c0);
    __syncthreads();
    for (int q = threadIdx.x; q < cg * 64; q += THREADS)
      s_frag[q] = frag[(long long)c0 * 64 + q];
    for (int q = threadIdx.x; q < (cg + 7) / 8 * 64; q += THREADS)
      s_frag2[q] = frag2[(long long)c0 / 8 * 64 + q];
    __syncthreads();
    // the bits (2 gi + e) of spheres that exist: only a last, short tile
    // has others
    unsigned valid = 0xffffffffu;
    if ((c0 + cg) * 8 > n) {
      valid = 0u;
      for (int gi = 0; gi < cg; ++gi)
        for (int e = 0; e < 2; ++e)
          if ((c0 + gi) * 8 + 2 * tig + e < n) valid |= 1u << (2 * gi + e);
    }
    unsigned cm[2][2] = {{0u, 0u}, {0u, 0u}};
    __syncwarp();                // mma.sync: the whole warp, converged
    // pass 1, per 8 tiles: the tile spheres' test picks the tiles some ray
    // of each 16-ray tile may hit (a warp-wide vote), then b and a cc - M
    // from the split products of every pair of those tiles
    for (int s0 = 0; s0 < cg; s0 += 8) {
      unsigned need[2];
      {
        const float4 tq = s_frag2[((s0 >> 3) * 32 + lane) * 2];
        const float4 tc = s_frag2[((s0 >> 3) * 32 + lane) * 2 + 1];
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          float nb[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          mma_k8(acc, ah[m][0], ah[m][1], ah[m][0], ah[m][1], tq.x, tq.y);
          mma_k8(acc, al[m][0], al[m][1], xs[m][0], xs[m][1], tq.x, tq.z);
          mma_k8(nb, dh[m][0], dh[m][1], dh[m][0], dh[m][1], tc.x, tc.y);
          mma_k4(nb, dl[m][0], dl[m][1], tc.x);
          // columns 2 tig + e of the 8 tiles, rows gid and gid + 8
          const unsigned v0 = __ballot_sync(
              0xffffffffu, nb[0] * nb[0] > acc[0] || nb[2] * nb[2] > acc[2]);
          const unsigned v1 = __ballot_sync(
              0xffffffffu, nb[1] * nb[1] > acc[1] || nb[3] * nb[3] > acc[3]);
          unsigned bits = 0u;
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            const unsigned lanes = 0x11111111u << t;
            bits |= ((v0 & lanes) ? 1u : 0u) << (2 * t);
            bits |= ((v1 & lanes) ? 1u : 0u) << (2 * t + 1);
          }
          need[m] = bits;
        }
      }
#pragma unroll 1
      for (int gi = s0; gi < min(s0 + 8, cg); ++gi) {
        if (!((need[0] | need[1]) >> (gi - s0) & 1u)) continue;
        const float4 bq = s_frag[(gi * 32 + lane) * 2];       // Bh, Bl, Y, -
        const float4 bc = s_frag[(gi * 32 + lane) * 2 + 1];   // Ch, Cl, -, -
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          if (!(need[m] >> (gi - s0) & 1u)) continue;
          float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          float nb[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          mma_k8(acc, ah[m][0], ah[m][1], ah[m][0], ah[m][1], bq.x, bq.y);
          mma_k8(acc, al[m][0], al[m][1], xs[m][0], xs[m][1], bq.x, bq.z);
          mma_k8(nb, dh[m][0], dh[m][1], dh[m][0], dh[m][1], bc.x, bc.y);
          mma_k4(nb, dl[m][0], dl[m][1], bc.x);
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              if (nb[2 * h + e] * nb[2 * h + e] > acc[2 * h + e])
                cm[m][h] |= 1u << (2 * gi + e);
        }
      }
    }
    // pass 2: the plain twin's operations on the pairs that passed
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        unsigned bits = cm[m][h] & valid;
        if (!bits) continue;
        cands += __popc(bits);
        const int slot = warp * 32 + m * 16 + h * 8 + gid;
        const float ox = s_ray[0][slot], oy = s_ray[1][slot],
                    oz = s_ray[2][slot], dx = s_ray[3][slot],
                    dy = s_ray[4][slot], dz = s_ray[5][slot],
                    a = s_ray[6][slot], inv_a = s_ray[7][slot],
                    od = s_ray[8][slot], oo = s_ray[9][slot];
        while (bits) {
          const int q = __ffs(bits) - 1;
          bits &= bits - 1u;
          const int j = (c0 + (q >> 1)) * 8 + 2 * tig + (q & 1);
          const float4 c = __ldg(tab + 2 * j);            // c', k'
          const float4 w = __ldg(tab + 2 * j + 1);        // -2c'
          const float cd = dx * c.x + dy * c.y + dz * c.z;
          const float ccp = ox * w.x + oy * w.y + oz * w.z + c.w;
          const float b = od - cd;
          const float cc = oo + ccp;
          const float disc = b * b - a * cc;
          if (disc > 0.0f) {
            const float sd = sqrtf(disc);
            const float t1 = (-b - sd) * inv_a;
            const float t2 = (-b + sd) * inv_a;
            float t = INF;
            if (t1 > t_min) t = t1;
            else if (t2 > t_min) t = t2;
            if (t < bt[m][h]) { bt[m][h] = t; bi[m][h] = lo + j; }
          }
        }
      }
  }
  // the quad's four threads hold disjoint spheres of each ray: merge by
  // (t, lower prim id)
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float t = bt[m][h];
      int i = bi[m][h];
#pragma unroll
      for (int x = 1; x < 4; x <<= 1) {
        const float ot = __shfl_xor_sync(0xffffffffu, t, x);
        const int oi = __shfl_xor_sync(0xffffffffu, i, x);
        if (ot < t || (ot == t && oi < i)) { t = ot; i = oi; }
      }
      const long long r = base + warp * 32 + m * 16 + h * 8 + gid;
      if (tig == 0 && r < R) {
        out_t[r] = t;
        out_i[r] = i;
      }
    }
  if (stats) {
    const unsigned w = __reduce_add_sync(0xffffffffu, (unsigned)cands);
    if (lane == 0) atomicAdd(stats, (unsigned long long)w);
  }
}

// rays (7, R) f32; tab (n, 8) f32 rows c'x, c'y, c'z, k', -2c'x, -2c'y,
// -2c'z, 0 of prim rows [lo, lo + n); frag (ceil(n / 8), 32, 8) f32 from
// mxu_pack; (mx, my, mz) the range centroid; stats (1) u64 or null: the
// pairs retested in scalar are added to it.  Returns the launch's
// cudaError_t (0 = launched).
extern "C" int tr_sweep_mxu(const float* rays, long long R, const float* tab,
                            const float* frag, const float* frag2, int n,
                            int lo, float mx,
                            float my, float mz, float t_min, float* out_t,
                            int* out_i, unsigned long long* stats,
                            void* stream) {
  if (R <= 0) return 0;
  const long long blocks = (R + RAYS - 1) / RAYS;
  sweep_mxu_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      rays, R, (const float4*)tab, (const float4*)frag, (const float4*)frag2,
      n, lo, mx, my, mz, t_min, out_t, out_i, stats);
  return (int)cudaGetLastError();
}
