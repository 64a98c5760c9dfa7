// cand_dist_valid: K4 on the valid-bin distance handoff -- the cascade's
// candidate gather of cost rows fused with the reverse-RWMD masked (min,+)
// reduction or the LC-ICT full-ladder pour, for a query batch, for sm_90a.
//
// Replaces, with cand_dist.cu, the TPU kernel
// src/repro/kernels/cand_pour.py::cand_dist_pallas (body _cand_dist_kernel):
// the same function on another layout of its distance input. The plain
// PyTorch versions are repro_torch/kernels/cand_pour.py::
// cand_rev_min_valid_plain and cand_ict_valid_plain.
//
// Inputs. The corpus, ids (n, hmax) int32 and w (n, hmax) f32; the
// candidate rows cand (nq, b) int64 (every corpus row is cand_dist_all.cu's
// form, which gives this kernel's bits at cand[q] = every row); the
// valid-bin handoff of core/lc.py::phase1_valid_dist: Dv (v, P) f32 or bf16 with a row stride
// ld that is a multiple of 4, the distances of every vocabulary row to the
// batch's P valid query bins, query q owning columns [qoff[q], qoff[q+1])
// in the order of its bins, and qwv (P,) their query weights. For query q,
// candidate row u = cand[q, c] and each slot s of u with x_s = w[u, s] > 0,
// the entry's cost row is C_s = Dv[ids[u, s], qoff[q] : qoff[q+1]]
// (len_q values):
//   mode rev_min: cmin_j = min over the entries of C_s[j] (big if u has
//       none); t = sum_j cmin_j * qw_j, a multiply then a sum;
//   mode ict: lc.ict_pour per entry: pour x_s through the query bins in
//       ascending (cost, bin) order with capacities qw,
//       r_i = clip(x_s - prefix_i, 0, qw_i), prefix_i = (sum_{p<=i} qw_p)
//       - qw_i; dump the remainder max(x_s - sum_i r_i, 0) at the max
//       FINITE cost of C_s (strict < big); t = sum_s (sum_i r_i c_i + dump);
// in float32 whatever Dv's type (rev_min), the ict pour and its sums in
// float64 (below). An empty query (len_q = 0) scores 0. On the stacked
// (nq, v, h) handoff of cand_dist.cu the padded query bins carry the
// sentinel and weight 0 and add exactly 0, so both kernels compute the
// same function; cand_dist.cu pours in float32.
//
// Bound on an H100: bytes. Per entry with x > 0 the kernel reads len_q
// costs (4 to 134 at 20 Newsgroups width, against h = 500 on the stacked
// handoff) and does a few flops per cost; the rows of the distinct
// (query, id) pairs come from device memory once and from the L2 after.
// What holds it back is latency: each warp walks a chain of dependent
// steps (weights, ids, costs, and for ict one shuffle round per column
// poured into), longest for the longest queries.
//
// Design.
// * Only valid bins are read. A query's columns are cut into aligned
//   quads (4 columns at absolute multiples of 4, so each is one 16-byte
//   f32 or 8-byte bf16 vector load, given ld % 4 == 0); the first and
//   last quad are masked to the query's columns.
// * The lane group is sized to the query. One warp per (query, candidate
//   row); its lanes split into groups of G = 1..32 lanes, G the smallest
//   power of two whose lanes hold the query's quads at QPL = 8 quads a
//   lane. A query whose columns touch at most 8 quads (26 to 32 bins)
//   gets G = 1, so 32 entries are in flight at once; a 134-bin one G = 8,
//   four entries at once with up to 8 vector loads a lane in flight.
// * Few dependent steps per warp: a warp reads the weights of 256 slots
//   of its row at once (8 a lane), then the ids of those with x > 0, and
//   compacts the entries through shared memory into one queue that the
//   groups take in rounds; a round is one wait on the cost loads, all
//   issued before any is used. For ict, whose pour rounds are long enough
//   to hide a load, the next round's costs are loaded before this round's
//   pour.
// * The candidate rows are gathered in the kernel: cand, ids and w are
//   read directly (ids only at slots with x > 0), streamed past with
//   evict-first loads, so no (nq, b, hmax) tensor exists.
// * One launch per stage and batch, warps numbered query-major, so the
//   warps in flight read one or two queries' columns of Dv, which stay in
//   the L2 (the 20 Newsgroups batch's longest query, 134 columns, touches
//   ~37 MB of it).
// * rev_min keeps a running min per lane-held column and combines the
//   groups with shuffles at the end. ict pours without a sort: each round
//   the group extracts the lexicographically next (cost, column) -- the
//   least 64-bit key (cost bits, column) above the last one, by a short
//   tree of minima and a shuffle min -- pours into it, and stops once the
//   capacity prefix reaches x or the costs run out; rounds = columns
//   poured into. The loop runs while any group of the warp is pouring, so
//   shuffles always have the full warp.
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

namespace {

// The tile knob: warps (rows) per block, built with
// -DCAND_DIST_VALID_WARPS=... (kernels/_build.py). A warp scores one output
// whatever the block, so every variant is bitwise the default; QPL and CH
// are not knobs: they decide which lanes sum which columns and entries.
#ifndef CAND_DIST_VALID_WARPS
#define CAND_DIST_VALID_WARPS 4
#endif
constexpr int WARPS = CAND_DIST_VALID_WARPS;
constexpr int THREADS = 32 * WARPS;
constexpr int QPL = 8;         // aligned quads of an entry a lane holds
constexpr int K = 4 * QPL;     // costs of an entry a lane holds
constexpr int CH = 8;          // slots of the row a lane reads at once
constexpr int MODE_REV_MIN = 0;
constexpr int MODE_ICT = 1;
constexpr unsigned FULL = 0xffffffffu;
static_assert(WARPS >= 1 && THREADS <= 1024, "");

template <typename F>
__device__ __forceinline__ F warp_sum(F x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(FULL, x, off);
  return x;
}

// Reductions within aligned groups of G lanes (G a power of two <= 32);
// every lane of the warp takes part.
__device__ __forceinline__ float group_max(float x, int G) {
  for (int off = G >> 1; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(FULL, x, off));
  return x;
}

// A (cost, column) pair as one 64-bit key whose unsigned order is the
// lexicographic order: costs are >= +0 (or +inf), whose bits order as the
// values do, and columns are >= 0 wherever the cost is finite.
__device__ __forceinline__ unsigned long long cost_key(float c, int j) {
  // c + 0 turns a -0 into +0, which it equals.
  return (unsigned long long)__float_as_uint(c + 0.f) << 32 | (unsigned)j;
}

__device__ __forceinline__ unsigned long long group_min(unsigned long long k,
                                                        int G) {
  for (int off = G >> 1; off > 0; off >>= 1) {
    const unsigned long long o = __shfl_xor_sync(FULL, k, off);
    k = o < k ? o : k;
  }
  return k;
}

// One aligned quad of costs, 4 consecutive columns from p (16-byte
// aligned for f32, 8-byte for bf16).
__device__ __forceinline__ void load_quad(const float* p, float* c) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  c[0] = v.x;
  c[1] = v.y;
  c[2] = v.z;
  c[3] = v.w;
}
__device__ __forceinline__ void load_quad(const uint16_t* p, float* c) {
  const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
  c[0] = __uint_as_float(v.x << 16);   // bf16 -> f32 is exact
  c[1] = __uint_as_float(v.x & 0xffff0000u);
  c[2] = __uint_as_float(v.y << 16);
  c[3] = __uint_as_float(v.y & 0xffff0000u);
}

// The query's view of one warp: its columns [lo, lo + len) of Dv, cut
// into quads from q0; this lane holds quads q0 + gl + G * t, t < QPL.
struct Query {
  int lo, len, q0, G, gl, tmax;   // tmax: quads a lane of the warp holds
  // Column (0-based within the query) of element i of this lane's costs;
  // outside [0, len) for padding.
  __device__ __forceinline__ int col(int i) const {
    return 4 * (q0 + gl + G * (i >> 2)) + (i & 3) - lo;
  }
};

// This lane's costs of one entry (vocabulary row id; id < 0: no entry),
// +inf outside the query's columns. The loads come first, all of them, and
// only then the masking, so they are in flight together: quads past the
// query's last are clamped to it (a cached line) instead of branched
// around, and the quads no lane of the warp holds (t >= the warp-uniform
// tmax) are not loaded.
template <typename T>
__device__ __forceinline__ void load_entry(const T* __restrict__ dv,
                                           size_t ld, int id, const Query& qy,
                                           float (&c)[K]) {
  const T* row = dv + (size_t)(id < 0 ? 0 : id) * ld;
  const int last = (qy.lo + qy.len - 1) >> 2;
#pragma unroll
  for (int t = 0; t < QPL; ++t)
    if (t < qy.tmax)
      load_quad(row + 4 * (size_t)min(qy.q0 + qy.gl + qy.G * t, last),
                c + 4 * t);
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const int j = qy.col(i);
    if (id < 0 || i / 4 >= qy.tmax || j < 0 || j >= qy.len)
      c[i] = CUDART_INF_F;
  }
}

// lc.ict_pour of one entry (weight x, this lane's costs c; x = 0 and all
// costs +inf for a group without an entry, which scores exactly 0). The
// running prefix, the pour and the sums are float64: a dense image's
// ladder has up to 784 near-equal capacities and its row 784 near-equal
// entries, whose float32 running sums drift by correlated roundings (on an
// H100, 1.3e-4 from the float64 value at a dense 256-image chunk, against
// 3.8e-6 for the plain version's tree-ordered float32 sums).
__device__ __forceinline__ double ict_entry(const float (&c)[K], float x,
                                           const Query& qy,
                                           const float* __restrict__ qwq,
                                           float big) {
  float mx = 0.f;
#pragma unroll
  for (int i = 0; i < K; ++i)
    if (c[i] < big) mx = fmaxf(mx, c[i]);
  mx = group_max(mx, qy.G);
  double cum = 0.0, acc = 0.0, rsum = 0.0;
  unsigned long long next = 0;   // the least key not yet poured into
  bool pouring = true;
  while (__any_sync(FULL, pouring)) {
    // The least key >= next: four at a time, then across them, so the
    // dependent chain is short.
    unsigned long long best = ~0ull;
#pragma unroll
    for (int i = 0; i < K; i += 4) {
      unsigned long long m = ~0ull;
#pragma unroll
      for (int e = i; e < i + 4; ++e) {
        const unsigned long long k = cost_key(c[e], qy.col(e));
        m = k >= next && k < m ? k : m;
      }
      best = m < best ? m : best;
    }
    best = group_min(best, qy.G);
    const float bc = __uint_as_float((unsigned)(best >> 32));
    const int bj = (int)(unsigned)best;
    if (!pouring) continue;
    if (!(bc < big)) {        // no column left
      pouring = false;
      continue;
    }
    const double cap = qwq[bj];
    cum += cap;
    const double r = fmin(fmax(x - (cum - cap), 0.0), cap);
    acc += r * bc;
    rsum += r;
    if (cum >= x) pouring = false;   // x is poured: every later r is 0
    next = best + 1;
  }
  return acc + fmax(x - rsum, 0.0) * mx;
}

template <typename T, int MODE>
__global__ void __launch_bounds__(THREADS)
cand_dist_valid_kernel(const int* __restrict__ ids,
                       const float* __restrict__ w,
                       const long long* __restrict__ cand,
                       const T* __restrict__ dv, const int* __restrict__ qoff,
                       const float* __restrict__ qwv, float* __restrict__ t,
                       long long rows, int b, int hmax, int ld, float big) {
  __shared__ float sx[WARPS][32 * CH];
  __shared__ int sid[WARPS][32 * CH];
  const int wib = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long warp = (long long)blockIdx.x * WARPS + wib;
  if (warp >= rows) return;   // uniform across the warp
  const int q = (int)(warp / b);
  Query qy;
  qy.lo = qoff[q];
  qy.len = qoff[q + 1] - qy.lo;
  if (qy.len == 0) {          // an empty query scores 0
    if (lane == 0) t[warp] = 0.f;
    return;
  }
  qy.q0 = qy.lo >> 2;
  const int nquad = ((qy.lo + qy.len - 1) >> 2) - qy.q0 + 1;
  qy.G = 1;
  while (qy.G < 32 && qy.G * QPL < nquad) qy.G <<= 1;
  qy.gl = lane & (qy.G - 1);
  qy.tmax = (nquad + qy.G - 1) / qy.G;
  const int ng = 32 / qy.G, g = lane / qy.G;
  const float* qwq = qwv + qy.lo;
  const size_t row = (size_t)__ldcs(cand + warp);
  const float* xr = w + row * hmax;
  const int* ir = ids + row * hmax;
  const unsigned below = (1u << lane) - 1u;

  float cmin[MODE == MODE_REV_MIN ? K : 1];   // running min per column
#pragma unroll
  for (int i = 0; i < (MODE == MODE_REV_MIN ? K : 1); ++i) cmin[i] = big;
  double itotal = 0.0;   // ict: this group's sum over its entries

  for (int s0 = 0; s0 < hmax; s0 += 32 * CH) {
    // The weights of 32 * CH slots, then the ids of the live ones, all in
    // flight at once; the live entries queue up in slot order.
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
        sx[wib][r] = xs[c];
        sid[wib][r] = is[c];
      }
      cnt += __popc(live);
    }
    if (cnt == 0) continue;   // uniform
    __syncwarp();
    const int rounds = (cnt + ng - 1) / ng;
    if (MODE == MODE_REV_MIN) {
      for (int r = 0, e = g; r < rounds; ++r, e += ng) {
        float c[K];
        load_entry<T>(dv, ld, e < cnt ? sid[wib][e] : -1, qy, c);
#pragma unroll
        for (int i = 0; i < K; ++i) cmin[i] = fminf(cmin[i], c[i]);
      }
    } else {
      int e = g;
      float xn = e < cnt ? sx[wib][e] : 0.f;
      float cn[K];
      load_entry<T>(dv, ld, e < cnt ? sid[wib][e] : -1, qy, cn);
      for (int r = 0; r < rounds; ++r) {
        float c[K];
#pragma unroll
        for (int i = 0; i < K; ++i) c[i] = cn[i];
        const float x = xn;
        e += ng;
        if (r + 1 < rounds) {   // the next round's loads, before the pour
          xn = e < cnt ? sx[wib][e] : 0.f;
          load_entry<T>(dv, ld, e < cnt ? sid[wib][e] : -1, qy, cn);
        }
        itotal += ict_entry(c, x, qy, qwq, big);
      }
    }
    __syncwarp();   // the queue is read before the next pass writes it
  }

  if (MODE == MODE_REV_MIN) {
    for (int off = qy.G; off < 32; off <<= 1) {
#pragma unroll
      for (int i = 0; i < K; ++i)
        cmin[i] = fminf(cmin[i], __shfl_xor_sync(FULL, cmin[i], off));
    }
    float part = 0.f;
    if (lane < qy.G) {
#pragma unroll
      for (int i = 0; i < K; ++i) {
        const int j = qy.col(i);
        if (j >= 0 && j < qy.len)
          part = __fadd_rn(part, __fmul_rn(cmin[i], qwq[j]));
      }
    }
    const float total = warp_sum(part);   // every lane takes part
    if (lane == 0) t[warp] = total;
  } else {
    const double total = warp_sum(qy.gl == 0 ? itotal : 0.0);
    if (lane == 0) t[warp] = (float)total;
  }
}

template <typename T>
cudaError_t launch(const int* ids, const float* w, const long long* cand,
                   const void* dv, const int* qoff, const float* qwv,
                   float* t, int nq, int b, int hmax, int ld, float big,
                   int mode, cudaStream_t stream) {
  const long long rows = (long long)nq * b;
  const unsigned blocks = (unsigned)((rows + WARPS - 1) / WARPS);
  const T* d = static_cast<const T*>(dv);
  if (mode == MODE_ICT)
    cand_dist_valid_kernel<T, MODE_ICT><<<blocks, THREADS, 0, stream>>>(
        ids, w, cand, d, qoff, qwv, t, rows, b, hmax, ld, big);
  else
    cand_dist_valid_kernel<T, MODE_REV_MIN><<<blocks, THREADS, 0, stream>>>(
        ids, w, cand, d, qoff, qwv, t, rows, b, hmax, ld, big);
  return cudaGetLastError();
}

}  // namespace

// ids (n, hmax) int32 with ids in [0, v), w (n, hmax) f32, cand (nq, b)
// int64 in [0, n), qoff (nq + 1,) int32 rising from 0 to P, qwv (P,) f32,
// all contiguous; dv (v, P) f32 or bf16 (bf16 = 1) with rows of stride
// ld, ld % 4 == 0, 16-byte aligned; no query's columns may touch more than
// 32 * QPL = 256 aligned quads (1,020 columns always fit). big = the f32
// sentinel (pad_dist_for(float32)). mode 0 = rev_min,
// 1 = ict. Writes t (nq, b) f32. Returns the cudaError_t of the launch
// (0 on success).
extern "C" int cand_dist_valid_launch(const void* ids, const void* w,
                                      const void* cand, const void* dv,
                                      const void* qoff, const void* qwv,
                                      void* t, int nq, int b, int hmax,
                                      int ld, float big, int mode, int bf16,
                                      void* stream) {
  const int* i = static_cast<const int*>(ids);
  const float* x = static_cast<const float*>(w);
  const long long* c = static_cast<const long long*>(cand);
  const int* o = static_cast<const int*>(qoff);
  const float* qw = static_cast<const float*>(qwv);
  float* tf = static_cast<float*>(t);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<uint16_t>(i, x, c, dv, o, qw, tf, nq, b, hmax, ld, big,
                            mode, st);
  return launch<float>(i, x, c, dv, o, qw, tf, nq, b, hmax, ld, big, mode,
                       st);
}

// The compiler's figures for the kernel that cand_dist_valid_launch runs in
// this mode (0 rev_min, 1 ict): out = {static shared bytes, dynamic shared
// bytes the launch requests, registers a thread, local (spill) bytes a
// thread, most threads a block}. Returns the cudaError_t (0 on success).
extern "C" int cand_dist_valid_attrs(int mode, int bf16, int* out) {
  cudaFuncAttributes a;
  cudaError_t err;
  if (bf16 && mode == MODE_ICT)
    err = cudaFuncGetAttributes(&a,
                                cand_dist_valid_kernel<uint16_t, MODE_ICT>);
  else if (bf16)
    err = cudaFuncGetAttributes(
        &a, cand_dist_valid_kernel<uint16_t, MODE_REV_MIN>);
  else if (mode == MODE_ICT)
    err = cudaFuncGetAttributes(&a, cand_dist_valid_kernel<float, MODE_ICT>);
  else
    err = cudaFuncGetAttributes(&a,
                                cand_dist_valid_kernel<float, MODE_REV_MIN>);
  if (err != cudaSuccess) return err;
  out[0] = (int)a.sharedSizeBytes;
  out[1] = 0;
  out[2] = a.numRegs;
  out[3] = (int)a.localSizeBytes;
  out[4] = a.maxThreadsPerBlock;
  return 0;
}

extern "C" const char* cand_dist_valid_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
