// Closest hit by BVH traversal, with two tie rules.
//
// No TPU kernel is replaced: tpu_ray/ops/bvh.py::intersect_scene_bvh (:270)
// runs the traversal as one XLA lax.while_loop in lockstep over all rays.
// Written in torch that loop would be driven from the host, one sync and
// ~40 launches a node step; here each lane walks its own ray's tree.  The
// wrapper is tpu_ray_torch/ops/bvh.py::intersect_bvh.
//
// The tie rule is a template parameter:
// - VISIT (bvh=True): the JAX loop's function (bvh.py:296-339), step for
//   step in its decisions.  A node is visited when its slab interval (1/d
//   per axis, min / max per axis, their max / min across axes, with the
//   NaN-propagating min.NaN / max.NaN of sweep_pairs.cuh: an axis-parallel
//   ray whose origin lies on a face plane gives NaN, and the node is
//   missed, as with jnp.minimum) clipped to (t_min, best_t) is non-empty;
//   left child first; hits kept by a strict '<' in visit order.  Plain
//   twin: ops/bvh.py::intersect_bvh_plain (the lockstep loop on tensors).
// - INDEX: the dense sweep's function (ops/intersect.py::intersect_ti, the
//   sweep then the media merge): the lowest prim id among the least t,
//   media ids after the solids.  It must test every prim the sweep could
//   keep, so its node test is conservative: a NaN slab visits the node,
//   the cull is non-strict in best_t (a node is culled only when
//   min(tf, nextafter(best_t, +inf)) <= max(tn, t_min)), and each box is
//   widened by ops/bvh.py::index_margins' static pad and, per ray, by
//   m = l (A l + B), l = max_i |o_i - c_i| + h (the rounding by which a
//   prim's reported hit can lie outside its box grows with the origin's
//   distance).  The nearer child goes first.  Plain twin: intersect_ti.
// A pair's distance is the sweeps' device functions on the prim's row of
// the (n_solid, 16) sweep table (sphere_t, hit_box, hit_quad; static and
// moving spheres share one path: a static row's velocity is zero and its
// dt is held at 0, so its centre keeps its bits), or media.cuh::media_t on
// the medium's row of the (N, 40) prim table with the lane's free-flight
// draw (base fmix(lane + kd0) ^ kd1, column = medium index: the stream of
// ops/intersect.py), so each pair has the bits the sweep gives it.  Needs
// IEEE arithmetic: no fast math, --fmad=false.
//
// Design.  The tree is packed per rule (ops/bvh.py::pack_nodes); a child
// is three float4s - (min xyz, ref), (max xyz, A), (c xyz, h) - and a ref
// is a record index (> 0), ~(first << 3 | count) for a leaf (< 0), or 0
// for an empty slot.
// - VISIT: pair records, both children of an internal node in one record
//   of 96 B, of which it reads 64 (the boxes).  An internal node that
//   passes pushes the child it does not enter with its (max(tn, t_min),
//   tf); when the entry is popped the rule's test runs on those stored
//   floats against the best_t of that moment, which is exactly the test
//   the JAX loop makes when it visits the node then.  A child that fails
//   at once is never pushed (best_t only falls, so it would fail when
//   popped).  The stack holds at most one entry per internal ancestor, the
//   tree's depth (~10 here); the tree must be at most 32 internal nodes
//   deep, so the JAX loop's clip at 31 never acts.  A lane descends to its
//   next leaf apart from the leaf's step, so a warp runs its lanes' leaves
//   together.
// - INDEX: wide records of 192 B, four slots (ops/bvh.py::wide_children):
//   a record starts from its node's two children and, while it has fewer
//   than four and one is internal, replaces the internal child of largest
//   surface area by that child's two children.  So a record holds 2-4 of
//   its node's descendants, which cover its subtree; empty slots (ref 0,
//   only ever the last two) are skipped before any slab test (a NaN slab
//   visits under INDEX, so no box is a safe filler).  A step tests the
//   record's live children, four independent slab tests, keys each that
//   passes by its entry max(tn, t_min) (t_min for a NaN slab, whose tf is
//   NaN too), pushes the others that pass far-first through a sorting
//   network, so that the next nearest is popped first, and enters the
//   nearest.  An entry is (ref, key) alone: it passed, so tf > key holds
//   for good and its test when popped, min(tf, nb) > key, is nb > key,
//   against the best_t of that moment.  Leaves - the one entered, or
//   popped - run in the same step, until the lane enters a record or its
//   stack runs out, so that a step is one record and the leaves under it.
//   The order changes no bit: INDEX keeps the least (t, prim id) over
//   every prim its conservative tests let through.  A record pushes at
//   most three entries, and each record on a path is another internal node
//   of the build on it, so the stack holds at most 3 x 32 entries for a
//   tree the route takes (ops/bvh.py::wide_stack_bound, 19 at
//   next-week-final's 1409 prims).
// Past a budget of the build's internal nodes (a wide record counts the
// ones it covers, its children less one) an INDEX lane runs the sweep's
// loop instead (sweep_all).  One ray a thread over a grid of 128-thread
// blocks, the stack in local memory, cached in L1 and L2 like any local
// data: a lane touches only its top entries, a few a ray (chip_smoke.py
// phase 3 counts the pops), not the whole frame (384 B under VISIT, 768
// under INDEX), which at 2048 threads an SM could not stay in the SM's
// 256 KB of L1.  On one H100 (PERF.md section 6) the pair walk beat a
// stack in shared memory (it takes L1's room from the records and rows),
// persistent warps claiming rays from a counter (a claimed ray is loaded
// by one lane, uncoalesced) and the tree staged in shared memory.  The
// wide walk halves a warp's steps against the pair walk, but a step tests
// twice the boxes: what it saves is the steps' fixed work and the leaves
// run apart (PERF.md section 6).  The STATS form, which counts the
// kernel's work, is a separate instantiation: the counters stay off the
// hot loop of the render's launches.
//
// Bound.  The work depends on the rays: per ray ~25 fp32 operations a
// child box tested (~40 under INDEX), 2 a stack entry popped, and the pair
// math of each leaf prim tested (21-31 for a solid, ~40 for a medium),
// against 40 bytes (7 floats and the lane id in, t and id out).  The
// STATS form counts that work; chip_smoke.py reads the bound from those
// counts.  The tree and the prim rows are small and stay in L1/L2.  What
// it meets first is instruction issue under divergence: a warp runs as
// many steps as its longest lane, and each step issues every branch its
// lanes take (records, the leaves' prim kinds, pops) beside the counted
// operations.

#include <type_traits>

#include "media.cuh"

#define STACK_DEPTH 32       // the JAX traversal's stack
#define WIDTH 4              // children a rule-INDEX record holds
#define INDEX_STACK ((WIDTH - 1) * STACK_DEPTH)
#define REC 6                // float4s a pair record (VISIT)
#define WREC (3 * WIDTH)     // float4s a wide record (INDEX)
#define BVH_THREADS 128
#define VISIT 0
#define INDEX 1
#define N_STATS 12           // ops/bvh.py::STAT_KEYS

struct Args {
  const float* rays;
  long long R;
  const float4* nodes;
  const int* order;
  int n_prims;
  const float4* geo;
  const float* med;          // the media rows of the (N, 40) prim table
  int n_ss, n_s, n_sb, n_solid;
  float t_min;
  uint32_t kd0, kd1;
  const RenderWords* words;  // null, or the render's block (its kd_isect)
  const uint32_t* lane_ids;
  int any_transform;
  float margin_b;
  int budget;
  unsigned long long* stats;
  float* out_t;
  int* out_i;
};

struct Walker {
  Ray r;
  float dlen;
  uint32_t base_i;
  float bt, nb;              // best t and, under INDEX, nextafter(bt, inf)
  int bi;
  int ref, sp;
  int left;                  // INDEX: internal nodes the lane may expand
};

// the STATS form's counts (ops/bvh.py::STAT_KEYS); the other form never
// touches them
struct Counts {
  int rec, root, pop, pair[5], brute, child, warp_steps, lane_steps;
};

// the stacks, in local memory.  VISIT: JAX's 32 entries of (ref, lo, tf).
// INDEX: INDEX_STACK entries of (ref, lo).  An entry is pushed only when
// it passed, min(tf, nb) > lo (or tf and lo are NaN, stored as lo =
// t_min), so tf > lo holds for good and the test when it is popped,
// min(tf, nb) > lo, is nb > lo alone (every nb passes a NaN entry's t_min).
struct PairStack {
  int ref[STACK_DEPTH];
  float lo[STACK_DEPTH], tf[STACK_DEPTH];
};

struct WideStack {
  int2 e[INDEX_STACK];       // (ref, the bits of lo): one 8-byte access
};

// the rule's test of a clipped slab interval (lo = max(tn, t_min), tf)
// against the lane's best hit so far
template <int RULE>
__device__ __forceinline__ bool pass(const Walker& L, float lo, float tf) {
  if (RULE == VISIT) return nmin(tf, L.bt) > lo;
  return !(nmin(tf, L.nb) <= lo);        // NaN visits
}

// one child box (mn: min xyz, ref; mx: max xyz, A; ch: centre xyz, h)
// tested under the rule; its clipped interval in (lo, tf)
template <int RULE>
__device__ __forceinline__ bool child(float4 mn, float4 mx, float4 ch,
                                      const Walker& L, float t_min, float B,
                                      float& lo, float& tf) {
  float x0 = mn.x, y0 = mn.y, z0 = mn.z, x1 = mx.x, y1 = mx.y, z1 = mx.z;
  if (RULE == INDEX) {
    const float l = fmaxf(fmaxf(fabsf(L.r.ox - ch.x), fabsf(L.r.oy - ch.y)),
                          fabsf(L.r.oz - ch.z)) + ch.w;
    const float m = l * (mx.w * l + B);
    x0 = x0 - m; y0 = y0 - m; z0 = z0 - m;
    x1 = x1 + m; y1 = y1 + m; z1 = z1 + m;
  }
  const float tax = (x0 - L.r.ox) * L.r.ix, tbx = (x1 - L.r.ox) * L.r.ix;
  const float tay = (y0 - L.r.oy) * L.r.iy, tby = (y1 - L.r.oy) * L.r.iy;
  const float taz = (z0 - L.r.oz) * L.r.iz, tbz = (z1 - L.r.oz) * L.r.iz;
  const float tn = nmax(nmax(nmin(tax, tbx), nmin(tay, tby)),
                        nmin(taz, tbz));
  tf = nmin(nmin(nmax(tax, tbx), nmax(tay, tby)), nmax(taz, tbz));
  // INDEX: a NaN tn comes with a NaN tf, which passes whatever lo is, so
  // lo may take t_min there (the key step_wide sorts and stacks)
  lo = RULE == INDEX ? fmaxf(tn, t_min) : nmax(tn, t_min);
  return pass<RULE>(L, lo, tf);
}

template <int RULE>
__device__ __forceinline__ void keep(Walker& L, float t, int pid) {
  if (RULE == VISIT) {
    if (t < L.bt) { L.bt = t; L.bi = pid; }
  } else if (t < L.bt || (t == L.bt && pid < L.bi)) {
    L.bt = t;                                 // finite and > 0 here
    L.bi = pid;
    L.nb = __int_as_float(__float_as_int(t) + 1);
  }
}

// a new ray in the lane, and its root test (record 0's first child);
// false if the root misses
template <int RULE, bool STATS>
__device__ __forceinline__ bool start(Walker& L, const Args& a, long long i,
                                      Counts& C) {
  const float INF = __int_as_float(0x7f800000);
  L.r = load_ray(a.rays, a.R, i);
  L.dlen = 0.0f;
  L.base_i = 0u;
  if (a.med != nullptr) {
    L.dlen = sqrtf(L.r.a);
    uint32_t kd0 = a.kd0, kd1 = a.kd1;
    if (a.words != nullptr) {
      kd0 = __ldg(a.words->kd_isect);
      kd1 = __ldg(a.words->kd_isect + 1);
    }
    L.base_i = fmix(__ldg(a.lane_ids + i) + kd0) ^ kd1;
  }
  L.bt = INF;
  L.nb = INF;
  L.bi = 0;
  L.sp = 0;
  L.left = a.budget;
  if (STATS) {
    ++C.root;
    ++C.child;
  }
  // a NaN in the origin or the direction makes every pair's test fail (the
  // quadratic's disc, the slabs and the plane distance all turn NaN), so
  // the sweep gives (inf, 0); INDEX would visit every node (NaN visits),
  // VISIT misses the root
  if (RULE == INDEX && (L.r.ox != L.r.ox || L.r.oy != L.r.oy ||
                        L.r.oz != L.r.oz || L.r.dx != L.r.dx ||
                        L.r.dy != L.r.dy || L.r.dz != L.r.dz))
    return false;
  const float4 l0 = __ldg(a.nodes), l1 = __ldg(a.nodes + 1);
  const float4 lc = RULE == INDEX ? __ldg(a.nodes + 2)
                                  : make_float4(0.f, 0.f, 0.f, 0.f);
  L.ref = __float_as_int(l0.w);
  float lo, tf;
  return child<RULE>(l0, l1, lc, L, a.t_min, a.margin_b, lo, tf);
}

// the hit distance of prim ``pid`` (the sweep's bits)
template <bool STATS>
__device__ __forceinline__ float prim_t(const Walker& L, const Args& a,
                                        int pid, Counts& C) {
  if (pid < a.n_sb) {
    const float4* g = a.geo + 4 * (long long)pid;
    const float4 g0 = __ldg(g), g1 = __ldg(g + 1);
    if (pid < a.n_s) {                         // static or moving sphere
      const float dt = pid >= a.n_ss ? L.r.rt - g1.z : 0.0f;
      if (STATS) ++C.pair[pid >= a.n_ss ? 1 : 0];
      return sphere_t(g0.x + g0.w * dt, g0.y + g1.x * dt, g0.z + g1.y * dt,
                      g1.w, L.r, a.t_min);
    }
    if (STATS) ++C.pair[2];
    return hit_box(g0, g1, L.r, a.t_min);
  }
  if (pid < a.n_solid) {
    const float4* g = a.geo + 4 * (long long)pid;
    if (STATS) ++C.pair[3];
    return hit_quad(__ldg(g), __ldg(g + 1), __ldg(g + 2), __ldg(g + 3), L.r,
                    a.t_min);
  }
  const int j = pid - a.n_solid;
  if (STATS) ++C.pair[4];
  return media_t(a.med + (long long)j * PRIM_COLS, L.r, L.dlen, L.base_i, j,
                 a.any_transform != 0, a.t_min);
}

// a leaf's prims in order
template <int RULE, bool STATS>
__device__ __forceinline__ void leaf(Walker& L, const Args& a, Counts& C) {
  const int v = ~L.ref;
  const int first = v >> 3, cnt = v & 7;
  for (int k = 0; k < cnt; ++k) {
    const int pid = __ldg(a.order + first + k);
    keep<RULE>(L, prim_t<STATS>(L, a, pid, C), pid);
  }
}

// Far from a ray's origin INDEX's margins grow with the distance squared:
// a ray inside book1-final's r = 1000 ground sphere widens every small
// sphere's box past its neighbours' and would walk the whole tree.  Past
// its budget of records a lane drops what it found and runs the dense
// sweep's loop for its ray alone - every solid in index order (the spheres
// two-pass, sweep_pairs.cuh::sphere_sweep), then the media, each by a
// strict '<' - which is intersect_ti's answer by construction.  Out of
// line, so that the walk's own loop keeps its registers.
struct Best {
  float t;
  int i;
};

__device__ __noinline__ Best sweep_all(const Ray r, float dlen,
                                       uint32_t base_i, const float4* geo,
                                       const float* med, int n_ss, int n_s,
                                       int n_sb, int n_solid, int n_prims,
                                       int any_transform, float t_min) {
  float bt = __int_as_float(0x7f800000);
  int bi = 0;
  const float* g = reinterpret_cast<const float*>(geo);
  sphere_sweep<1, false>(g, 0, n_ss, &r, t_min, 0, &bt, &bi);
  sphere_sweep<1, true>(g, n_ss, n_s, &r, t_min, 0, &bt, &bi);
  for (int j = n_s; j < n_sb; ++j) {
    const float4* q = geo + 4 * (long long)j;
    const float t = hit_box(q[0], q[1], r, t_min);
    if (t < bt) { bt = t; bi = j; }
  }
  for (int j = n_sb; j < n_solid; ++j) {
    const float4* q = geo + 4 * (long long)j;
    const float t = hit_quad(q[0], q[1], q[2], q[3], r, t_min);
    if (t < bt) { bt = t; bi = j; }
  }
  for (int j = 0; j < n_prims - n_solid; ++j) {
    const float t = media_t(med + (long long)j * PRIM_COLS, r, dlen, base_i,
                            j, any_transform != 0, t_min);
    if (t < bt) { bt = t; bi = n_solid + j; }
  }
  return Best{bt, bi};
}

// pop until an entry passes the rule's test against the best hit of this
// moment; false when the stack runs out
template <bool STATS>
__device__ __forceinline__ bool pop(Walker& L, PairStack& S, Counts& C) {
  while (L.sp > 0) {
    --L.sp;
    if (STATS) ++C.pop;
    if (pass<VISIT>(L, S.lo[L.sp], S.tf[L.sp])) {
      L.ref = S.ref[L.sp];
      return true;
    }
  }
  return false;
}

template <bool STATS>
__device__ __forceinline__ bool pop(Walker& L, WideStack& S, Counts& C) {
  while (L.sp > 0) {
    --L.sp;
    if (STATS) ++C.pop;
    const int2 e = S.e[L.sp];
    if (!(L.nb <= __int_as_float(e.y))) {
      L.ref = e.x;
      return true;
    }
  }
  return false;
}

// one step of the lane's VISIT walk: expand a pair record or run a leaf,
// then pop until an entry passes; false when the ray is done
template <bool STATS>
__device__ __forceinline__ bool step_pair(Walker& L, PairStack& S,
                                          const Args& a, Counts& C) {
  if (L.ref > 0) {
    const float4* rc = a.nodes + (long long)L.ref * REC;
    const float4 l0 = __ldg(rc), l1 = __ldg(rc + 1);
    const float4 r0 = __ldg(rc + 2), r1 = __ldg(rc + 3);
    const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
    float loL, tfL, loR, tfR;
    const bool pL = child<VISIT>(l0, l1, z, L, a.t_min, a.margin_b, loL, tfL);
    const bool pR = child<VISIT>(r0, r1, z, L, a.t_min, a.margin_b, loR, tfR);
    if (STATS) {
      ++C.rec;
      C.child += 2;
    }
    if (pL) {
      if (pR) {
        S.ref[L.sp] = __float_as_int(r0.w);
        S.lo[L.sp] = loR;
        S.tf[L.sp] = tfR;
        ++L.sp;
      }
      L.ref = __float_as_int(l0.w);
      return true;
    }
    if (pR) {
      L.ref = __float_as_int(r0.w);
      return true;
    }
  } else {
    leaf<VISIT, STATS>(L, a, C);
  }
  return pop<STATS>(L, S, C);
}

// order slots i < j of a wide record's children by their entry
template <int I, int J>
__device__ __forceinline__ void sort2(float (&lo)[WIDTH], int (&ref)[WIDTH]) {
  if (lo[J] < lo[I]) {
    const float l = lo[I];
    const int r = ref[I];
    lo[I] = lo[J];
    ref[I] = ref[J];
    lo[J] = l;
    ref[J] = r;
  }
}

// one step of the lane's INDEX walk: expand a wide record - test its live
// children, push the others that pass far first, enter the nearest that
// passes - then run leaves and pop until a record is entered; false when
// the ray is done
template <bool STATS>
__device__ __forceinline__ bool step_wide(Walker& L, WideStack& S,
                                          const Args& a, Counts& C) {
  if (L.ref > 0) {
    const float INF = __int_as_float(0x7f800000);
    const float4* rc = a.nodes + (long long)L.ref * WREC;
    float4 mn[WIDTH];
    int ref[WIDTH];
#pragma unroll
    for (int k = 0; k < WIDTH; ++k) {
      mn[k] = __ldg(rc + 3 * k);
      ref[k] = __float_as_int(mn[k].w);
    }
    // the build's internal nodes the record covers: its children less one
    // (the first two slots are always live)
    L.left -= 1 + (ref[2] != 0) + (ref[3] != 0);
    if (L.left < 0) {
      const Best b = sweep_all(L.r, L.dlen, L.base_i, a.geo, a.med, a.n_ss,
                               a.n_s, a.n_sb, a.n_solid, a.n_prims,
                               a.any_transform, a.t_min);
      L.bt = b.t;
      L.bi = b.i;
      if (STATS) {
        ++C.brute;
        C.pair[0] += a.n_ss;
        C.pair[1] += a.n_s - a.n_ss;
        C.pair[2] += a.n_sb - a.n_s;
        C.pair[3] += a.n_solid - a.n_sb;
        C.pair[4] += a.n_prims - a.n_solid;
      }
      return false;
    }
    // each child that passes keys by its entry, max(tn, t_min) (t_min for
    // a NaN entry); one that fails or is empty by +inf
    float lo[WIDTH];
#pragma unroll
    for (int k = 0; k < WIDTH; ++k) {
      lo[k] = INF;
      if (k < 2 || ref[k] != 0) {
        float l, f;
        if (child<INDEX>(mn[k], __ldg(rc + 3 * k + 1), __ldg(rc + 3 * k + 2),
                         L, a.t_min, a.margin_b, l, f))
          lo[k] = l;
        if (STATS) ++C.child;
      }
    }
    if (STATS) ++C.rec;
    sort2<0, 1>(lo, ref);        // a sorting network of four
    sort2<2, 3>(lo, ref);
    sort2<0, 2>(lo, ref);
    sort2<1, 3>(lo, ref);
    sort2<1, 2>(lo, ref);
    L.ref = 0;
    if (lo[0] < INF) {
#pragma unroll
      for (int k = WIDTH - 1; k > 0; --k) {
        if (lo[k] < INF)
          S.e[L.sp++] = make_int2(ref[k], __float_as_int(lo[k]));
      }
      L.ref = ref[0];
    }
  }
  // run leaves - the one entered, or started at, or popped - until a
  // record is entered or the stack runs out
  for (;;) {
    if (L.ref > 0) return true;
    if (L.ref < 0) leaf<INDEX, STATS>(L, a, C);
    if (!pop<STATS>(L, S, C)) return false;
  }
}

// the STATS form's count of one loop trip: each lane's, and the warp's
// once for the lanes that run it together
template <bool STATS>
__device__ __forceinline__ void trip(Counts& C) {
  if (STATS) {
    ++C.lane_steps;
    if ((threadIdx.x & 31u) == (unsigned)(__ffs(__activemask()) - 1))
      ++C.warp_steps;
  }
}

template <int RULE, bool STATS>
__global__ void __launch_bounds__(BVH_THREADS) bvh_kernel(const Args a) {
  typename std::conditional<RULE == INDEX, WideStack, PairStack>::type S;
  Counts C = {0, 0, 0, {0, 0, 0, 0, 0}, 0, 0, 0, 0};
  Walker L;
  const long long i = (long long)blockIdx.x * BVH_THREADS + threadIdx.x;
  if (i < a.R) {
    bool live = start<RULE, STATS>(L, a, i, C);
    while (live) {
      if constexpr (RULE == INDEX) {
        trip<STATS>(C);
        live = step_wide<STATS>(L, S, a, C);
      } else {
        // descend to a leaf before the leaf's step, so that a warp runs
        // its lanes' leaves together, not one iteration's mix
        while (live && L.ref > 0) {
          trip<STATS>(C);
          live = step_pair<STATS>(L, S, a, C);
        }
        if (live) {
          trip<STATS>(C);
          live = step_pair<STATS>(L, S, a, C);
        }
      }
    }
    a.out_t[i] = L.bt;
    a.out_i[i] = L.bi;
  }
  if (STATS) {
    int v[N_STATS] = {C.rec, C.root, C.pop, C.pair[0], C.pair[1], C.pair[2],
                      C.pair[3], C.pair[4], C.brute, C.child, C.warp_steps,
                      C.lane_steps};
#pragma unroll
    for (int k = 0; k < N_STATS; ++k) {
      int s = v[k];
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if ((threadIdx.x & 31u) == 0u && s)
        atomicAdd(a.stats + k, (unsigned long long)s);
    }
  }
}

template <int RULE>
static int launch(const Args& a, cudaStream_t st) {
  const unsigned blocks = (unsigned)((a.R + BVH_THREADS - 1) / BVH_THREADS);
  if (a.stats != nullptr)
    bvh_kernel<RULE, true><<<blocks, BVH_THREADS, 0, st>>>(a);
  else
    bvh_kernel<RULE, false><<<blocks, BVH_THREADS, 0, st>>>(a);
  return (int)cudaGetLastError();
}

// rays: (7, R) float32 rows ox, oy, oz, dx, dy, dz, time (row stride R).
// nodes: the rule's records (ops/bvh.py::pack_nodes): (n_rec, 24) float32
// pair records for VISIT, (n_rec, 48) wide records for INDEX; order:
// (n_prims,) int32.  geo: (n_solid, 16) float32 sweep table
// (may be null without solids).  tab: (N, 40) float32 prim table
// (ops/shade.py::build_tables), read for media rows only; null when the
// scene has no media.  kd0, kd1: the intersect key's words; lane_ids: (R,)
// uint32 bits.  margin_b: INDEX's linear margin term; stack: the most
// entries the rule's walk can hold (VISIT: the tree's internal depth, <=
// 32; INDEX: ops/bvh.py::wide_stack_bound, <= 96); budget: the build's
// internal nodes an INDEX lane expands before it tests every prim.  rule:
// 0 VISIT, 1 INDEX.  stats: null, or 12 uint64 counters to add to (the
// counting instantiation).  words: null, or a device RenderWords whose
// kd_isect replace kd0, kd1 (a queue render replayed from a CUDA graph).
// Returns the launch's cudaError_t (0 = launched).
extern "C" int tr_bvh(const float* rays, long long R, const float* nodes,
                      const int* order, int n_prims, const float* geo,
                      const float* tab, int n_ss, int n_s, int n_sb,
                      int n_solid, float t_min, unsigned kd0, unsigned kd1,
                      const int* lane_ids, int any_transform, float margin_b,
                      int stack, int budget, int rule,
                      unsigned long long* stats, const void* words,
                      float* out_t, int* out_i, void* stream) {
  if (R <= 0) return 0;
  if (R >= (1LL << 31) - (1LL << 24) || stack < 1 ||
      stack > (rule == INDEX ? INDEX_STACK : STACK_DEPTH))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.rays = rays;
  a.R = R;
  a.nodes = reinterpret_cast<const float4*>(nodes);
  a.order = order;
  a.n_prims = n_prims;
  a.geo = reinterpret_cast<const float4*>(geo);
  a.med = tab != nullptr ? tab + (long long)n_solid * PRIM_COLS : nullptr;
  a.n_ss = n_ss;
  a.n_s = n_s;
  a.n_sb = n_sb;
  a.n_solid = n_solid;
  a.t_min = t_min;
  a.kd0 = kd0;
  a.kd1 = kd1;
  a.words = static_cast<const RenderWords*>(words);
  a.lane_ids = reinterpret_cast<const uint32_t*>(lane_ids);
  a.any_transform = any_transform;
  a.margin_b = margin_b;
  a.budget = budget;
  a.stats = stats;
  a.out_t = out_t;
  a.out_i = out_i;
  cudaStream_t st = (cudaStream_t)stream;
  return rule == INDEX ? launch<INDEX>(a, st) : launch<VISIT>(a, st);
}
