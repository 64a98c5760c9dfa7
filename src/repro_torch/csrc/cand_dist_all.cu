// cand_dist_all: K4's all-rows form on the valid-bin distance handoff -- the
// reverse-RWMD masked (min,+) reduction or the LC-ICT full-ladder pour of
// every corpus row against a query batch, for sm_90a.
//
// Replaces, with cand_dist_valid.cu (the candidate form) and cand_dist.cu
// (the stacked handoff), the TPU kernel
// src/repro/kernels/cand_pour.py::cand_dist_pallas (body _cand_dist_kernel)
// where the JAX engines reduce every row (core/lc.py's
// lc_rwmd_scores_rev_batched, the symmetric LC-RWMD and
// lc_ict_scores_batched). The plain PyTorch versions are
// repro_torch/kernels/cand_pour.py::cand_rev_min_valid_plain and
// cand_ict_valid_plain with cand None.
//
// Inputs: the corpus, ids (n, hmax) int32 and w (n, hmax) f32; the
// valid-bin handoff of core/lc.py::phase1_valid_dist, Dv (v, P) f32 or bf16
// at a row stride ld that is a multiple of 4, query q owning columns
// [qoff[q], qoff[q+1]), and qwv (P,) their weights; the column groups of
// kernels/cand_pour.py::column_groups. The function is cand_dist_valid.cu's
// at cand[q] = every row, and the output is BITWISE that kernel's there:
//   rev_min: each lane gl < G of the candidate kernel's warp sums its
//       columns in Query::col order, part = fadd(part, fmul(cmin, qw)), and
//       the 32 lanes add by an xor tree; G is the least power of two with
//       8 G quads >= the query's quads. Minima are exact in any order, so
//       this kernel keeps per-column minima and replays that sum.
//   ict: an entry's float64 pour (ict_entry) depends on the entry alone;
//       entry e of a 256-slot pass's queue falls to group e mod (32 / G),
//       each group sums its entries in order across the passes, and the
//       groups' sums add by the xor tree, then one rounding to float32.
//       This kernel computes each entry's pour once and adds it to the
//       (query, group) sum it belongs to, in queue order, then replays
//       the tree.
// A row with no live entry scores sum(big * qw) (rev_min) or 0 (ict); an
// empty query scores 0.
//
// Bound on an H100: bytes. The inputs are 0.203 GB at 20 Newsgroups width
// (nq = 16, 18,828 rows, 564 valid bins): every weight once, the live ids,
// the used rows of Dv. What a per-entry design cannot avoid is the gather
// of every live entry's costs for every query: 1.766 M entries x 564
// columns x 4 B = 3.98 GB, from the L2 where the rows repeat.
//
// Design.
// * Rows outer, queries inside. The host cuts the batch into column groups:
//   runs of whole queries, in order, at most QG of them, whose columns span
//   at most GQ aligned quads (C = 1,024 columns: a query of MAX_LEN = 1,020
//   columns fits alone at any alignment). A work item is a (group, row)
//   pair, numbered group-major; the warps take items from a counter in
//   the plan until none is left (a grid of as many blocks as the card
//   holds), so the rows' lengths (4 to 500 live slots at 20 Newsgroups
//   width) hold up no warp but the last. A warp reads its row's weights
//   and live ids once for the whole group (256 slots a pass, compacted
//   into a queue as in the candidate kernel: the passes and the queue
//   order are what the ict sums replay).
// * One gather per entry for the group: the entry's Dv[id, group's quads]
//   is copied into a 4-entry cp.async ring in shared memory, lane k
//   copying quads k, k + 32, ... (16-byte vectors, 8-byte for bf16).
//   Blocks in flight read one group's columns of Dv.
// * rev_min: lane k keeps the running minima of quads k + 32 j in
//   registers (at most 8 quads), reading only what it copied, with 3
//   entries in flight. At the row's end the minima go to shared memory
//   and the candidate kernel's sums are replayed per query.
// * ict, two entries a step (one step in flight):
//   A. the group's columns are cut into at most 32 chunks of at most clen
//      columns (clen odd, ~ total / 32), each inside one query, once per
//      group; lane c scans chunk c of both entries, the same clen steps
//      for every lane and no branch, keeping the two least costs (the
//      first column of equal ones) and the max finite cost: one partial
//      per (entry, chunk).
//   B. lane (entry, query) merges the query's partials and runs the first
//      two rounds of ict_entry's pour in its arithmetic, where most pairs
//      end at 20 Newsgroups width (an entry's weight against the query
//      bins' capacities).
//   C. the whole warp takes the other pairs, one at a time, from their
//      state after two rounds: each lane sorts the keys of its columns in
//      registers, and a round is a warp minimum of the lanes' heads (two
//      32-bit reductions) and a pop, the next round's taken while this
//      round's float64 arithmetic runs.
//   Each pair's pour is added to its (query, group) sum in queue order.
//
// Constants, not knobs: GQ (C) and QG decide the column groups, the ring's
// 4 entries, the ict step of 2 entries and the top-2 partials the
// pipeline; none changes a bit of the output. GQ = 256 quads is the least
// that holds a MAX_LEN query; a group's slice of Dv at 20 Newsgroups width
// is 69,682 x 1,024 x 4 B = 285 MB (143 MB bf16), larger than the 50 MB
// L2, but the rows an entry reads follow the corpus's word counts, so the
// frequent rows can stay there; the 16-query batch is one group of 141
// quads (157 MB of used rows). A narrower group would re-read the rows and
// re-build their queues once more per group. The ring puts 4 x 2.3 KB of
// that batch's gathers in flight a warp (4 x 4 KB at most). The tile knob
// is the family's macro, -DCAND_DIST_VALID_WARPS (block_n): warps a block,
// at most 4, each taking rows on its own.
#include <cuda_runtime.h>
#include <math_constants.h>

#include <algorithm>
#include <climits>
#include <cstdint>

namespace {

#ifndef CAND_DIST_VALID_WARPS
#define CAND_DIST_VALID_WARPS 4
#endif
// Warps a block (rows in flight), at most 4: each takes rows on its own.
constexpr int WARPS = CAND_DIST_VALID_WARPS < 4 ? CAND_DIST_VALID_WARPS : 4;
constexpr int THREADS = 32 * WARPS;
constexpr int GQ = 256;        // aligned quads a column group spans at most
constexpr int QG = 16;         // queries a column group holds at most
constexpr int MODE_REV_MIN = 0;
constexpr int MODE_ICT = 1;
// Entries a step, steps in flight: a step's entries are worked on
// together (ict: a lane per (entry, query) pair, 2 x 16 = 32).
template <int MODE> constexpr int BATCH = MODE == MODE_ICT ? 2 : 1;
template <int MODE> constexpr int NSTEP = MODE == MODE_ICT ? 2 : 4;
constexpr int STAGES = 4;      // entries in flight a warp (the ring)
constexpr int CH = 8;          // slots of the row a lane reads at once
constexpr int SLOTS = 32 * CH; // slots a pass (the candidate kernel's)
constexpr int KQ = GQ / 32;    // quads a lane holds at most (rev_min)
constexpr int NPART = 32;      // ict: partials (chunks of a group), one a lane
constexpr int TABLE = 4 * QG + 4;   // a warp's group table, ints
constexpr unsigned FULL = 0xffffffffu;
static_assert(CAND_DIST_VALID_WARPS >= 1 && CAND_DIST_VALID_WARPS <= 32,
              "");
static_assert(BATCH<MODE_ICT> * QG == 32, "a lane per (entry, query) pair");
static_assert(BATCH<MODE_ICT> * NSTEP<MODE_ICT> == STAGES &&
              BATCH<MODE_REV_MIN> * NSTEP<MODE_REV_MIN> == STAGES, "");

template <typename F>
__device__ __forceinline__ F warp_sum(F x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(FULL, x, off);
  return x;
}

// cand_dist_valid.cu's (cost, column) key: its unsigned order is the
// lexicographic order (costs >= +0 or +inf; c + 0 turns -0 into +0).
__device__ __forceinline__ unsigned long long cost_key(float c, int j) {
  return (unsigned long long)__float_as_uint(c + 0.f) << 32 | (unsigned)j;
}

// The least key of the warp, as two 32-bit reductions.
__device__ __forceinline__ unsigned long long warp_min(unsigned long long k) {
  const unsigned hi = __reduce_min_sync(FULL, (unsigned)(k >> 32));
  const unsigned lo =
      __reduce_min_sync(FULL, (unsigned)(k >> 32) == hi ? (unsigned)k : FULL);
  return (unsigned long long)hi << 32 | lo;
}

// One aligned quad of shared memory as four floats.
__device__ __forceinline__ void smem_quad(const float* p, float* c) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  c[0] = v.x;
  c[1] = v.y;
  c[2] = v.z;
  c[3] = v.w;
}
__device__ __forceinline__ void smem_quad(const uint16_t* p, float* c) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  c[0] = __uint_as_float(v.x << 16);   // bf16 -> f32 is exact
  c[1] = __uint_as_float(v.x & 0xffff0000u);
  c[2] = __uint_as_float(v.y << 16);
  c[3] = __uint_as_float(v.y & 0xffff0000u);
}
__device__ __forceinline__ float smem_cost(const float* p) { return *p; }
__device__ __forceinline__ float smem_cost(const uint16_t* p) {
  return __uint_as_float((unsigned)*p << 16);
}

// One quad global -> shared, asynchronously: 16 bytes (f32, L2 only) or 8
// (bf16).
__device__ __forceinline__ void cp_quad(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_quad(uint16_t* dst, const uint16_t* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The candidate kernel's lane split of a query of len columns from lo:
// G lanes a group, QPL = 8 quads a lane.
__device__ __forceinline__ int lanes_of(int lo, int len) {
  const int nquad = ((lo + len - 1) >> 2) - (lo >> 2) + 1;
  int G = 1;
  while (G < 32 && G * 8 < nquad) G <<= 1;
  return G;
}

// Byte offsets of a block's dynamic shared memory (all of it is dynamic);
// kernels/ops.py::_cand_dist_layout mirrors them.
struct Layout {
  int accs, cont, ring, table, sid, sx, pbest, parg, pmax, total;
};
__host__ __device__ inline Layout layout_of(int mode, int tbytes, int wmax) {
  const bool ict = mode == MODE_ICT;
  const int batch = ict ? BATCH<MODE_ICT> : BATCH<MODE_REV_MIN>;
  Layout L;
  int off = 0;
  L.accs = off;   // ict: (warp, query, group) float64 sums
  off += ict ? WARPS * QG * 32 * 8 : 0;
  L.cont = off;   // ict: (warp, entry of the step, query) float64 pours
  off += ict ? WARPS * batch * QG * 8 : 0;
  L.ring = off;   // (warp, stage, 4 wmax) costs; 16-byte aligned
  off += WARPS * STAGES * 4 * wmax * tbytes;
  L.table = off;  // (warp) its group's table
  off += WARPS * TABLE * 4;
  L.sid = off;    // (warp, slot) the queue's ids
  off += WARPS * SLOTS * 4;
  L.sx = off;     // ict: (warp, slot) the queue's weights
  off += ict ? WARPS * SLOTS * 4 : 0;
  L.pbest = off;  // ict: (warp, entry, partial) the two least costs,
  off += ict ? WARPS * batch * NPART * 2 * 4 : 0;   // their columns and
  L.parg = off;                                     // the max finite cost
  off += ict ? WARPS * batch * NPART * 2 * 4 : 0;
  L.pmax = off;
  off += ict ? WARPS * batch * NPART * 4 : 0;
  L.total = off;
  return L;
}

// ict_entry of cand_dist_valid.cu for one (entry, query) pair, by the whole
// warp, from the state after its first rounds (cum, acc, rsum and the key
// to pour next from, next; mx its max finite cost): the candidate kernel's
// rounds and arithmetic on the query's len columns cq (capacities qwq).
// Each lane sorts the keys of its columns j = lane + 32 t in registers, so
// a round is a warp minimum of the lanes' heads and a pop; a query wider
// than 32 KPL columns scans its columns every round.
template <int KPL, typename T>
__device__ double ict_rest(const T* cq, int len, float x, const float* qwq,
                           float big, double cum, double acc, double rsum,
                           unsigned long long next, float mx) {
  const int lane = threadIdx.x % 32;
  unsigned long long k[KPL];
#pragma unroll
  for (int t = 0; t < KPL; ++t) {
    const int j = lane + 32 * t;
    k[t] = ~0ull;
    if (j < len) {
      const unsigned long long kk = cost_key(smem_cost(cq + j), j);
      if (kk >= next) k[t] = kk;
    }
  }
  // Odd-even transposition sort of the lane's keys, ascending.
#pragma unroll
  for (int pass = 0; pass < KPL; ++pass)
#pragma unroll
    for (int t = pass & 1; t + 1 < KPL; t += 2) {
      const unsigned long long a = k[t], b = k[t + 1];
      k[t] = a < b ? a : b;
      k[t + 1] = a < b ? b : a;
    }
  const bool scan = len > 32 * KPL;
  // The least key left (the lane that held it pops it: keys are unique).
  auto take = [&]() {
    unsigned long long best = k[0];
    if (scan) {
      best = ~0ull;
#pragma unroll 1
      for (int j = lane; j < len; j += 32) {
        const unsigned long long kk = cost_key(smem_cost(cq + j), j);
        best = kk >= next && kk < best ? kk : best;
      }
    }
    best = warp_min(best);
    if (k[0] == best) {
#pragma unroll
      for (int t = 0; t + 1 < KPL; ++t) k[t] = k[t + 1];
      k[KPL - 1] = ~0ull;
    }
    return best;
  };
  unsigned long long best = take();
#pragma unroll 1
  while (true) {
    const float bc = __uint_as_float((unsigned)(best >> 32));
    const int bj = (int)(unsigned)best;
    if (!(bc < big)) break;   // no column left
    const double cap = qwq[bj];
    // The next round's key, taken while this round's arithmetic runs.
    next = best + 1;
    const unsigned long long after = take();
    cum += cap;
    const double r = fmin(fmax(x - (cum - cap), 0.0), cap);
    acc += r * bc;
    rsum += r;
    if (cum >= x) break;      // x is poured
    best = after;
  }
  return acc + fmax(x - rsum, 0.0) * mx;
}

template <typename T, int MODE>
__global__ void __launch_bounds__(THREADS)
cand_dist_all_kernel(const int* __restrict__ ids, const float* __restrict__ w,
                     const T* __restrict__ dv, const int* __restrict__ qoff,
                     const float* __restrict__ qwv, int* __restrict__ groups,
                     float* __restrict__ t, int n, int hmax, int ld,
                     int ngroups, int wmax, float big) {
  constexpr int B = BATCH<MODE>, NS = NSTEP<MODE>;
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout_of(MODE, (int)sizeof(T), wmax);
  // Every array is the warp's own: the warps of a block share nothing.
  const int wib = threadIdx.x / 32, lane = threadIdx.x % 32;
  int* s_lo = reinterpret_cast<int*>(smem + L.table) + wib * TABLE;
  int* s_len = s_lo + QG;
  int* s_ng = s_lo + 2 * QG;      // groups of the candidate kernel's warp
  int* s_slot = s_lo + 3 * QG;    // ict: first chunk of each query, + end
  const int stage = 4 * wmax;
  T* ring = reinterpret_cast<T*>(smem + L.ring) + (size_t)wib * STAGES * stage;
  int* sid = reinterpret_cast<int*>(smem + L.sid) + wib * SLOTS;
  float* sx = reinterpret_cast<float*>(smem + L.sx) + wib * SLOTS;
  double* accs = reinterpret_cast<double*>(smem + L.accs) + wib * QG * 32;
  double* cont = reinterpret_cast<double*>(smem + L.cont) + wib * B * QG;
  float* pbest =
      reinterpret_cast<float*>(smem + L.pbest) + wib * B * NPART * 2;
  int* parg = reinterpret_cast<int*>(smem + L.parg) + wib * B * NPART * 2;
  float* pmax = reinterpret_cast<float*>(smem + L.pmax) + wib * B * NPART;
  const unsigned below = (1u << lane) - 1u;
  const int pr = lane / QG, pq = lane % QG;   // ict: this lane's pair

  // Work items (column group, row), group-major, taken in turn by the
  // warps from a counter, so a long row holds up no other.
  const int items = ngroups * n;
  int* work = groups + ngroups + 1;   // [taken, warps done]
  int grp = -1, qa = 0, nqg = 0, g0 = 0, wq = 0, c00 = 0;
  int clen = 0, cs = 0, cn = 0, cj = 0, my_ngm = 0;
#pragma unroll 1
  while (true) {
    int item = 0;
    if (lane == 0) item = atomicAdd(work, 1);
    item = __shfl_sync(FULL, item, 0);
    if (item >= items) break;
    const int g = item / n, row = item - g * n;
    if (g != grp) {   // the group's table (uniform)
      grp = g;
      __syncwarp();
      qa = groups[g];
      nqg = groups[g + 1] - qa;
      if (lane < nqg) {
        const int lo = qoff[qa + lane], len = qoff[qa + lane + 1] - lo;
        s_lo[lane] = lo;
        s_len[lane] = len;
        s_ng[lane] = len > 0 ? 32 / lanes_of(lo, len) : 0;
      }
      __syncwarp();
      int first = -1, last = -1;
#pragma unroll 1
      for (int q = 0; q < nqg; ++q)
        if (s_len[q] > 0) {
          if (first < 0) first = s_lo[q] >> 2;
          last = (s_lo[q] + s_len[q] - 1) >> 2;
        }
      g0 = first < 0 ? 0 : first;
      wq = first < 0 ? 0 : last - first + 1;
      c00 = 4 * g0;   // the group's first column of Dv
      // ict: the group's columns cut into at most 32 chunks of at most
      // clen columns, each inside one query, in order; lane c takes chunk
      // c: columns [cs, cs + cn) of the group, cj the first's column in
      // its query. Query q's chunks are s_slot[q] .. s_slot[q + 1] - 1. An
      // odd clen keeps the lanes of a long query on distinct banks.
      int total = 0;
#pragma unroll 1
      for (int q = 0; q < nqg; ++q) total += s_len[q];
      clen = max(1, (total + 31) / 32);
#pragma unroll 1
      while (true) {
        int chunks = 0;
        for (int q = 0; q < nqg; ++q) chunks += (s_len[q] + clen - 1) / clen;
        if (chunks <= 32) break;
        ++clen;
      }
      clen |= 1;
      cs = cn = cj = 0;
      {
        int chunk = 0;
#pragma unroll 1
        for (int q = 0; q < nqg; ++q) {
          const int nc = (s_len[q] + clen - 1) / clen;
          if (lane == 0) s_slot[q] = chunk;
          if (lane >= chunk && lane < chunk + nc) {
            cj = (lane - chunk) * clen;
            cs = s_lo[q] - c00 + cj;
            cn = min(clen, s_len[q] - cj);
          }
          chunk += nc;
        }
        if (lane == 0) s_slot[nqg] = chunk;
      }
      my_ngm = pq < nqg ? s_ng[pq] - 1 : 0;
      __syncwarp();
    }

    const float* xr = w + (size_t)row * hmax;
    const int* ir = ids + (size_t)row * hmax;
    const T* dvg = dv + c00;

    float cmin[MODE == MODE_REV_MIN ? 4 * KQ : 1];   // running minima
#pragma unroll
    for (int i = 0; i < (MODE == MODE_REV_MIN ? 4 * KQ : 1); ++i) cmin[i] = big;
    // ict: the sums of group g of query q (the candidate kernel's itotal),
    // in queue order.
    if (MODE == MODE_ICT)
#pragma unroll 1
      for (int q = 0; q < nqg; ++q) accs[q * 32 + lane] = 0.0;

    for (int s0 = 0; s0 < hmax && wq > 0; s0 += SLOTS) {
      // The candidate kernel's queue: the weights of 256 slots, then the
      // ids of the live ones, compacted in slot order.
      float xs[CH];
      int is[CH];
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        const int s = s0 + 32 * c + lane;
        xs[c] = s < hmax ? __ldcs(xr + s) : 0.f;
      }
#pragma unroll
      for (int c = 0; c < CH; ++c)
        is[c] = xs[c] > 0.f ? __ldcs(ir + s0 + 32 * c + lane) : 0;
      int cnt = 0;
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        const unsigned live = __ballot_sync(FULL, xs[c] > 0.f);
        if (xs[c] > 0.f) {
          const int r = cnt + __popc(live & below);
          sid[r] = is[c];
          if (MODE == MODE_ICT) sx[r] = xs[c];
        }
        cnt += __popc(live);
      }
      if (cnt == 0) continue;   // uniform
      __syncwarp();

      // The ring: step s's B entries go to stages (s % NS) B + r, one
      // commit a step (empty past the queue), NS - 1 steps ahead.
      auto issue = [&](int step) {
#pragma unroll
        for (int r = 0; r < B; ++r) {
          const int e = step * B + r;
          if (e < cnt) {
            const T* src = dvg + (size_t)sid[e] * ld;
            T* dst = ring + (e % STAGES) * stage;
            for (int q4 = lane; q4 < wq; q4 += 32)
              cp_quad(dst + 4 * q4, src + 4 * q4);
          }
        }
        cp_commit();
      };
      const int steps = (cnt + B - 1) / B;
#pragma unroll
      for (int st = 0; st < NS - 1; ++st) issue(st);
      for (int st = 0; st < steps; ++st) {
        issue(st + NS - 1);
        cp_wait<NS - 1>();
        __syncwarp();
        const int e0 = st * B;
        if constexpr (MODE == MODE_REV_MIN) {
          const T* sq = ring + (e0 % STAGES) * stage;
#pragma unroll
          for (int j = 0; j < KQ; ++j) {
            const int q4 = lane + 32 * j;
            if (q4 < wq) {
              float c[4];
              smem_quad(sq + 4 * q4, c);
#pragma unroll
              for (int i = 0; i < 4; ++i)
                cmin[4 * j + i] = fminf(cmin[4 * j + i], c[i]);
            }
          }
        } else {
          const T* sq[B];
#pragma unroll
          for (int r = 0; r < B; ++r)
            sq[r] = ring + ((e0 + r) % STAGES) * stage;
          // Partials: for this lane's chunk and each entry of the step, the
          // two least costs (the first column of equal ones: the lane goes
          // up its columns) and the max finite cost. clen steps for every
          // lane, no branch.
          {
            float b0[B], b1[B], mx[B];
            int j0[B], j1[B];
#pragma unroll
            for (int r = 0; r < B; ++r) {
              b0[r] = b1[r] = CUDART_INF_F;
              j0[r] = j1[r] = -1;
              mx[r] = 0.f;
            }
#pragma unroll 4
            for (int i = 0; i < clen; ++i) {
              const bool in = i < cn;
              const int col = in ? cs + i : 0, jj = cj + i;
#pragma unroll
              for (int r = 0; r < B; ++r) {
                // Past the chunk a column costs +inf: it enters nothing.
                const float v = in ? smem_cost(sq[r] + col) : CUDART_INF_F;
                const bool lt0 = v < b0[r], lt1 = v < b1[r];
                b1[r] = lt0 ? b0[r] : (lt1 ? v : b1[r]);
                j1[r] = lt0 ? j0[r] : (lt1 ? jj : j1[r]);
                b0[r] = lt0 ? v : b0[r];
                j0[r] = lt0 ? jj : j0[r];
                mx[r] = v < big ? fmaxf(mx[r], v) : mx[r];
              }
            }
            if (cn > 0)
#pragma unroll
              for (int r = 0; r < B; ++r) {
                const int o = (r * NPART + lane) * 2;
                pbest[o] = b0[r];
                pbest[o + 1] = b1[r];
                parg[o] = j0[r];
                parg[o + 1] = j1[r];
                pmax[r * NPART + lane] = mx[r];
              }
          }
          __syncwarp();
          // Lane (r, q): pair (entry e0 + r, query q). Its first two rounds
          // of ict_entry, from the two least keys of the query's partials;
          // the pairs that pour on are flagged, with their state.
          const int e = e0 + pr;
          const bool live = pq < nqg && e < cnt && s_len[pq] > 0;
          bool pour_on = false;
          double cum = 0.0, acc1 = 0.0, rsum = 0.0;
          unsigned long long next = 0;
          float mq = 0.f;
          if (live) {
            float k0 = CUDART_INF_F, k1 = CUDART_INF_F;
            int i0 = -1, i1 = -1;
#pragma unroll 1
            for (int p = s_slot[pq]; p < s_slot[pq + 1]; ++p) {
              const int o = (pr * NPART + p) * 2;
#pragma unroll
              for (int u = 0; u < 2; ++u) {   // the partials go up the columns
                const float v = pbest[o + u];
                const int jj = parg[o + u];
                const bool lt0 = v < k0, lt1 = v < k1;
                k1 = lt0 ? k0 : (lt1 ? v : k1);
                i1 = lt0 ? i0 : (lt1 ? jj : i1);
                k0 = lt0 ? v : k0;
                i0 = lt0 ? jj : i0;
              }
              mq = fmaxf(mq, pmax[pr * NPART + p]);
            }
            const float x = sx[e];
            const float* qwq = qwv + s_lo[pq];
            bool done = true;
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              const float bc = u ? k1 : k0;
              const int bj = u ? i1 : i0;
              if (!(bc < big)) break;   // no column left
              const double cap = qwq[bj];
              cum += cap;
              const double r = fmin(fmax(x - (cum - cap), 0.0), cap);
              acc1 += r * bc;
              rsum += r;
              if (cum >= x) break;      // x is poured
              if (u == 1) {
                done = false;
                next = cost_key(bc, bj) + 1;
              }
            }
            if (done)
              cont[pr * QG + pq] = acc1 + fmax(x - rsum, 0.0) * mq;
            pour_on = !done;
          }
          // The pairs that pour on: the whole warp, one pair at a time.
          unsigned flags = __ballot_sync(FULL, pour_on);
#pragma unroll 1
          while (flags) {
            const int f = __ffs(flags) - 1;
            flags &= flags - 1;
            const int r = f / QG, q = f % QG, cq = s_lo[q] - c00;
            const T* cc = ring + ((e0 + r) % STAGES) * stage + cq;
            const int len = s_len[q];
            const float x = sx[e0 + r];
            const double cum_f = __shfl_sync(FULL, cum, f),
                         acc_f = __shfl_sync(FULL, acc1, f),
                         rsum_f = __shfl_sync(FULL, rsum, f);
            const unsigned long long next_f = __shfl_sync(FULL, next, f);
            const float mq_f = __shfl_sync(FULL, mq, f);
            // 4 keys a lane hold a query of 128 columns, 8 of 256.
            const double v =
                len <= 128
                    ? ict_rest<4>(cc, len, x, qwv + s_lo[q], big, cum_f,
                                  acc_f, rsum_f, next_f, mq_f)
                    : ict_rest<8>(cc, len, x, qwv + s_lo[q], big, cum_f,
                                  acc_f, rsum_f, next_f, mq_f);
            if (lane == f) cont[r * QG + q] = v;
          }
          __syncwarp();
          // Lane q adds the step's pours of query q to its groups' sums,
          // in queue order.
          if (lane < QG && pq < nqg && s_len[pq] > 0)
#pragma unroll
            for (int r = 0; r < B; ++r)
              if (e0 + r < cnt)
                accs[pq * 32 + ((e0 + r) & my_ngm)] += cont[r * QG + pq];
        }
        __syncwarp();   // the step's stages are read before their refill
      }
    }

    if constexpr (MODE == MODE_REV_MIN) {
      // The minima into the drained ring (4 wmax floats fit in the
      // STAGES * 4 wmax elements of any T), then the candidate kernel's
      // sums, query by query.
      float* mins = reinterpret_cast<float*>(ring);
#pragma unroll
      for (int j = 0; j < KQ; ++j) {
        const int q4 = lane + 32 * j;
        if (q4 < wq)
#pragma unroll
          for (int i = 0; i < 4; ++i) mins[4 * q4 + i] = cmin[4 * j + i];
      }
      __syncwarp();
      for (int q = 0; q < nqg; ++q) {
        const int lo = s_lo[q], len = s_len[q];
        float part = 0.f;
        if (len > 0) {
          const int q0 = lo >> 2;
          const int nquad = ((lo + len - 1) >> 2) - q0 + 1;
          const int G = 32 / s_ng[q], tmax = (nquad + G - 1) / G;
          if (lane < G)
            for (int tq = 0; tq < tmax; ++tq) {
              const int quad = q0 + lane + G * tq;
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                const int j = 4 * quad + i - lo;
                if (j >= 0 && j < len)
                  part = __fadd_rn(part, __fmul_rn(mins[4 * (quad - g0) + i],
                                                   qwv[lo + j]));
              }
            }
        }
        const float total = warp_sum(part);   // every lane takes part
        if (lane == 0) t[(size_t)(qa + q) * n + row] = total;
      }
      __syncwarp();   // the minima are read before the next row's ring
    } else {
      __syncwarp();
#pragma unroll 1
      for (int q = 0; q < nqg; ++q) {
        const double total =
            warp_sum(lane < s_ng[q] ? accs[q * 32 + lane] : 0.0);
        if (lane == 0) t[(size_t)(qa + q) * n + row] = (float)total;
      }
      __syncwarp();   // the sums are read before the next row zeroes them
    }
  }
  // The last warp out resets the counters for the plan's next launch.
  if (lane == 0 && atomicAdd(work + 1, 1) == (int)gridDim.x * WARPS - 1) {
    work[0] = 0;
    work[1] = 0;
  }
}

template <typename T>
cudaError_t launch(const int* ids, const float* w, const void* dv,
                   const int* qoff, const float* qwv, int* groups, float* t,
                   int n, int hmax, int ld, int ngroups, int wmax, float big,
                   int mode, cudaStream_t stream) {
  const int bytes = layout_of(mode, (int)sizeof(T), wmax).total;
  auto kern = mode == MODE_ICT ? cand_dist_all_kernel<T, MODE_ICT>
                               : cand_dist_all_kernel<T, MODE_REV_MIN>;
  cudaError_t err;
  if (bytes > 48 * 1024) {
    err = cudaFuncSetAttribute(kern,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    if (err != cudaSuccess) return err;
  }
  // As many blocks as the card holds at once, at most a warp a row.
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kern, THREADS, bytes)) != cudaSuccess)
    return err;
  const long long items = (long long)ngroups * n;
  const unsigned blocks = (unsigned)std::max(
      1LL, std::min((items + WARPS - 1) / WARPS, (long long)sms * per_sm));
  kern<<<blocks, THREADS, bytes, stream>>>(
      ids, w, static_cast<const T*>(dv), qoff, qwv, groups, t, n, hmax, ld,
      ngroups, wmax, big);
  return cudaGetLastError();
}

}  // namespace

// ids (n, hmax) int32 with ids in [0, v), w (n, hmax) f32, qoff (nq + 1,)
// int32 rising from 0 to P, qwv (P,) f32, groups (ngroups + 3,) int32: the
// first query of each column group, then nq (cand_pour.py::column_groups:
// at most QG = 16 queries and GQ = 256 aligned quads a group), then two
// counters that are 0 before the launch and after it; all contiguous; dv
// (v, P) f32 or bf16 (bf16 = 1) with rows of stride ld, ld % 4 == 0,
// 16-byte aligned; wmax = quads of the widest group. big = the f32
// sentinel (pad_dist_for(float32)). mode 0 = rev_min, 1 = ict. Writes t
// (nq, n) f32. Returns the cudaError_t of the launch (0 on success).
extern "C" int cand_dist_all_launch(const void* ids, const void* w,
                                    const void* dv, const void* qoff,
                                    const void* qwv, const void* groups,
                                    void* t, int n, int hmax, int ld,
                                    int ngroups, int wmax, float big,
                                    int mode, int bf16, void* stream) {
  const int* i = static_cast<const int*>(ids);
  const float* x = static_cast<const float*>(w);
  const int* o = static_cast<const int*>(qoff);
  const float* qw = static_cast<const float*>(qwv);
  int* g = static_cast<int*>(const_cast<void*>(groups));
  float* tf = static_cast<float*>(t);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<uint16_t>(i, x, dv, o, qw, g, tf, n, hmax, ld, ngroups,
                            wmax, big, mode, st);
  return launch<float>(i, x, dv, o, qw, g, tf, n, hmax, ld, ngroups, wmax,
                       big, mode, st);
}

// The compiler's figures for the kernel that cand_dist_all_launch runs in
// this mode (0 rev_min, 1 ict) at this widest group (wmax quads): out =
// {static shared bytes, dynamic shared bytes the launch requests,
// registers a thread, local (spill) bytes a thread, most threads a block}.
// Returns the cudaError_t (0 on success).
extern "C" int cand_dist_all_attrs(int mode, int bf16, int wmax, int* out) {
  cudaFuncAttributes a;
  cudaError_t err;
  if (bf16 && mode == MODE_ICT)
    err = cudaFuncGetAttributes(&a, cand_dist_all_kernel<uint16_t, MODE_ICT>);
  else if (bf16)
    err = cudaFuncGetAttributes(&a,
                                cand_dist_all_kernel<uint16_t, MODE_REV_MIN>);
  else if (mode == MODE_ICT)
    err = cudaFuncGetAttributes(&a, cand_dist_all_kernel<float, MODE_ICT>);
  else
    err = cudaFuncGetAttributes(&a, cand_dist_all_kernel<float, MODE_REV_MIN>);
  if (err != cudaSuccess) return err;
  out[0] = (int)a.sharedSizeBytes;
  out[1] = layout_of(mode, bf16 ? 2 : 4, wmax).total;
  out[2] = a.numRegs;
  out[3] = (int)a.localSizeBytes;
  out[4] = a.maxThreadsPerBlock;
  return 0;
}

extern "C" const char* cand_dist_all_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
