// cand_pour_rows: K3 with the candidate rows read from the corpus -- the
// cascade's candidate gather fused with the LC-ACT / LC-RWMD pour or the
// LC-OMR reduction, for a query batch, and the dump and the reduction on
// every corpus row at once (the full-corpus LC-RWMD dump and LC-OMR), for
// sm_90a.
//
// Replaces, with cand_pour.cu, the TPU kernel
// src/repro/kernels/cand_pour.py::cand_pour_pallas (body _cand_pour_kernel):
// the same function, with the candidate rows gathered in the kernel. The
// plain PyTorch versions are repro_torch/kernels/cand_pour.py::
// cand_pour_rows_plain and cand_omr_rows_plain.
//
// Inputs. The corpus, ids (n, hmax) int32 and w (n, hmax) f32; either the
// candidate rows cand (nq, b) int64 (the candidate form, t (nq, b)) or no
// cand, every row (the all-rows form, t (nq, n), in modes pour0 and omr);
// the ladders z and w (f32 or bf16), element (q, id, l) at q * sq + id * sv
// + l, so that the wrapper hands the all-rows form a vocabulary-major
// (v, nq, k) copy.
// For query q, row u and each slot s of u with x = w[u, s] > 0, with the
// ladder rows Z = z(q, ids[u, s], .) and W = w(q, ids[u, s], .):
//   mode pour0 (pour at iters = 0):  entry = x * Z0
//   mode pour, iters >= 1: lc.pour, the capacity prefix cap_l = sum_{p<=l}
//       W_p, r_l = clip(x - (cap_l - W_l), 0, W_l), entry = sum_l r_l Z_l
//       + max(x - cap_{iters-1}, 0) * Z_iters (the remainder from the
//       capacities, as the port's lc.pour takes it)
//   mode omr:  entry = Z0 == 0 ? (x - min(x, W0)) * Z1 : x * Z0
// and t = the sum of the entries, in float32 whatever the ladders' type.
// The arithmetic per entry is cand_pour.cu's; only the order of the final
// sums differs. An entry with x == 0 contributes exactly 0 (the ladders are
// finite: invalid query bins carry a finite sentinel), so it is not read.
//
// Bound on an H100: bytes. The all-rows form must read every corpus weight
// (18,828 x 500 x 4 B = 37.7 MB at 20 Newsgroups width), the ids of the
// live slots, the ladder rows of the distinct (query, id) pairs those name
// (the L2 holds them: 4.5 MB for a k = 1 ladder of 16 queries) and write t;
// the candidate form the same for the candidate rows.
//
// Design.
// * Row scan (cand_dist_valid.cu's): a warp reads the weights of 512 slots
//   of its row at once (16 a lane, evict-first: the corpus streams past
//   and the ladders stay in the L2), then the ids of the live ones, and
//   compacts the live entries into a queue in shared memory. The lanes
//   then take the queue's entries in steps, U steps' ladder loads in
//   flight at once (each entry's loads issued before any is used). A warp
//   waits on three loads per 512 slots plus one per U steps, not three
//   per slot.
// * Candidate form: one warp per (query, candidate row), warps numbered
//   query-major, a lane per entry, one launch per stage and batch; the
//   rows come from the corpus at cand, so no (nq, b, hmax) tensor exists.
// * All-rows form: one warp per (corpus row, chunk of 16 queries), so the
//   corpus is read once per 16 queries, not once per query. A lane pours
//   one query of the chunk (lane % 16) for every other entry (lane / 16),
//   so one load instruction reads one id's ladder values for 16 queries
//   and two entries: on the vocabulary-major (v, nq, k) copy of the
//   ladders that is two 64-byte lines for k = 1. One shuffle adds the two
//   halves of the warp.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

// The tile knob: warps (rows) per block, built with
// -DCAND_POUR_ROWS_WARPS=... (kernels/_build.py). A warp scores one output
// whatever the block, so every variant is bitwise the default; CH and QB_ALL
// are not knobs: they decide which lane sums which entries.
#ifndef CAND_POUR_ROWS_WARPS
#define CAND_POUR_ROWS_WARPS 4
#endif
constexpr int WARPS = CAND_POUR_ROWS_WARPS;
constexpr int THREADS = 32 * WARPS;
constexpr int CH = 16;         // slots of the row a lane reads at once
constexpr int MAXL = 16;       // most ladder columns a pour reads (iters+1)
constexpr int MODE_POUR = 0;   // iters >= 1
constexpr int MODE_OMR = 1;
constexpr int MODE_POUR0 = 2;  // pour at iters == 0
constexpr int QB_ALL = 16;     // queries of a warp in the all-rows form
constexpr unsigned FULL = 0xffffffffu;
static_assert(WARPS >= 1 && THREADS <= 1024, "");

__device__ __forceinline__ float ld(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ld(const uint16_t* p) {
  return __uint_as_float((unsigned)__ldg(p) << 16);   // bf16 -> f32, exact
}

// One entry's value: weight x, ladder rows zj (>= iters + 1 values, 2 for
// omr) and wj (>= iters, 1 for omr). Every load is issued before any value
// is used.
template <typename T, int MODE>
__device__ __forceinline__ float entry(float x, const T* __restrict__ zj,
                                       const T* __restrict__ wj, int iters) {
  if (MODE == MODE_POUR0) return __fmul_rn(x, ld(zj));
  if (MODE == MODE_OMR) {
    const float z0 = ld(zj), z1 = ld(zj + 1), w0 = ld(wj);
    const float rest = __fsub_rn(x, fminf(x, w0));
    return z0 == 0.f ? __fmul_rn(rest, z1) : __fmul_rn(x, z0);
  }
  float zl[MAXL], wl[MAXL - 1];
#pragma unroll
  for (int l = 0; l < MAXL; ++l) zl[l] = l <= iters ? ld(zj + l) : 0.f;
#pragma unroll
  for (int l = 0; l < MAXL - 1; ++l) wl[l] = l < iters ? ld(wj + l) : 0.f;
  float acc = 0.f, cap = 0.f, last = zl[0];
#pragma unroll
  for (int l = 0; l < MAXL - 1; ++l) {
    if (l < iters) {
      cap = __fadd_rn(cap, wl[l]);
      const float r = fminf(fmaxf(__fsub_rn(x, __fsub_rn(cap, wl[l])), 0.f),
                            wl[l]);
      acc = __fadd_rn(acc, __fmul_rn(r, zl[l]));
      last = zl[l + 1];
    }
  }
  const float rem = fmaxf(__fsub_rn(x, cap), 0.f);
  return __fadd_rn(acc, __fmul_rn(rem, last));
}

template <typename T>
struct Ladders {
  const T* z;
  const T* w;
  long long zq, zv, wq, wv;   // element strides of query and vocabulary id
};

template <typename T, int MODE, int QB>
__global__ void __launch_bounds__(THREADS)
cand_pour_rows_kernel(const int* __restrict__ ids,
                      const float* __restrict__ w,
                      const long long* __restrict__ cand, Ladders<T> lad,
                      float* __restrict__ t, long long total, int nq,
                      int cols, int hmax, int iters) {
  constexpr int G = 32 / QB;   // entries a warp takes at once
  constexpr int U = MODE == MODE_POUR ? 2 : 8;   // of those, in flight
  __shared__ float sx[WARPS][32 * CH];
  __shared__ int sid[WARPS][32 * CH];
  const int wib = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long warp = (long long)blockIdx.x * WARPS + wib;
  if (warp >= total) return;   // uniform across the warp
  // Candidate form (QB == 1): warp = q * cols + c, row cand[warp], output
  // t[warp]. All-rows form: warp = chunk * cols + u, the chunk's queries
  // q0 .. q0 + nqc - 1, outputs t[q * cols + u].
  const int chunk = (int)(warp / cols), c = (int)(warp % cols);
  const int q0 = cand ? chunk : chunk * QB;
  const int nqc = cand ? 1 : min(QB, nq - q0);
  const size_t row = cand ? (size_t)__ldcs(cand + warp) : (size_t)c;
  const float* xr = w + row * hmax;
  const int* ir = ids + row * hmax;
  const unsigned below = (1u << lane) - 1u;
  // This lane pours entries g, g + G, ... of the queue for query q0 + qi
  // (a lane past the chunk's last query reads query q0's ladders and
  // writes nothing).
  const int g = lane / QB, qi = lane % QB;
  const int q = q0 + (qi < nqc ? qi : 0);
  const T* zl = lad.z + (size_t)q * lad.zq;
  const T* wl = lad.w ? lad.w + (size_t)q * lad.wq : nullptr;

  float acc = 0.f;
  for (int s0 = 0; s0 < hmax; s0 += 32 * CH) {
    // The weights of 32 * CH slots, then the ids of the live ones, all in
    // flight at once; the live entries queue up in slot order.
    float xs[CH];
    int is[CH];
#pragma unroll
    for (int k = 0; k < CH; ++k) {
      const int s = s0 + 32 * k + lane;
      xs[k] = s < hmax ? __ldcs(xr + s) : 0.f;
    }
#pragma unroll
    for (int k = 0; k < CH; ++k)
      is[k] = xs[k] > 0.f ? __ldcs(ir + s0 + 32 * k + lane) : 0;
    int cnt = 0;
#pragma unroll
    for (int k = 0; k < CH; ++k) {
      const unsigned live = __ballot_sync(FULL, xs[k] > 0.f);
      if (xs[k] > 0.f) {
        const int r = cnt + __popc(live & below);
        sx[wib][r] = xs[k];
        sid[wib][r] = is[k];
      }
      cnt += __popc(live);
    }
    if (cnt == 0) continue;   // uniform
    __syncwarp();
#pragma unroll U
    for (int e = g; e < cnt; e += G) {
      const size_t id = (size_t)sid[wib][e];
      acc += entry<T, MODE>(sx[wib][e], zl + id * lad.zv,
                            wl ? wl + id * lad.wv : nullptr, iters);
    }
    __syncwarp();   // the queue is read before the next pass writes it
  }

  // The G lanes of a query hold its partial sums.
#pragma unroll
  for (int off = 16; off >= QB; off >>= 1)
    acc += __shfl_xor_sync(FULL, acc, off);
  if (g == 0 && qi < nqc) {
    if (cand)
      t[warp] = acc;
    else
      t[(size_t)(q0 + qi) * cols + c] = acc;
  }
}

template <typename T, int MODE, int QB>
cudaError_t launch_mode(const int* ids, const float* w, const long long* cand,
                        const Ladders<T>& lad, float* t, int nq, int cols,
                        int hmax, int iters, cudaStream_t stream) {
  const long long chunks = cand ? nq : (nq + QB - 1) / QB;
  const long long total = chunks * cols;
  const unsigned blocks = (unsigned)((total + WARPS - 1) / WARPS);
  cand_pour_rows_kernel<T, MODE, QB><<<blocks, THREADS, 0, stream>>>(
      ids, w, cand, lad, t, total, nq, cols, hmax, iters);
  return cudaGetLastError();
}

// The all-rows form exists for pour0 and omr only: the engines send a pour
// at iters >= 1 over the whole corpus to act_phase2.cu.
template <typename T, int MODE>
cudaError_t launch_form(const int* ids, const float* w, const long long* cand,
                        const Ladders<T>& lad, float* t, int nq, int cols,
                        int hmax, int iters, cudaStream_t stream) {
  if (cand)
    return launch_mode<T, MODE, 1>(ids, w, cand, lad, t, nq, cols, hmax,
                                   iters, stream);
  if constexpr (MODE == MODE_POUR) {
    return cudaErrorInvalidValue;
  } else {
    return launch_mode<T, MODE, QB_ALL>(ids, w, cand, lad, t, nq, cols,
                                        hmax, iters, stream);
  }
}

template <typename T>
cudaError_t launch(const int* ids, const float* w, const long long* cand,
                   const void* z, const void* wl, long long zq, long long zv,
                   long long wq, long long wv, float* t, int nq, int cols,
                   int hmax, int iters, int mode, cudaStream_t stream) {
  const Ladders<T> lad{static_cast<const T*>(z), static_cast<const T*>(wl),
                       zq, zv, wq, wv};
  if (mode == MODE_OMR)
    return launch_form<T, MODE_OMR>(ids, w, cand, lad, t, nq, cols, hmax,
                                    iters, stream);
  if (iters == 0)
    return launch_form<T, MODE_POUR0>(ids, w, cand, lad, t, nq, cols, hmax,
                                      iters, stream);
  return launch_form<T, MODE_POUR>(ids, w, cand, lad, t, nq, cols, hmax,
                                   iters, stream);
}

}  // namespace

// ids (n, hmax) int32 with ids in [0, v), w (n, hmax) f32, both
// contiguous; cand (nq, b) int64 in [0, n), contiguous, or null (every
// row: cols = n; pour at iters == 0 and omr only); z and wl f32 or bf16 (bf16 = 1), element (q, id, l) at
// q * zq + id * zv + l (wl likewise; null when iters == 0 in mode pour).
// mode 0 = pour (iters + 1 <= 16 ladder columns readable in z, iters in
// wl), 1 = omr (2 columns in z, 1 in wl: W0). Writes t (nq, cols) f32.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int cand_pour_rows_launch(const void* ids, const void* w,
                                     const void* cand, const void* z,
                                     const void* wl, long long zq,
                                     long long zv, long long wq, long long wv,
                                     void* t, int nq, int cols, int hmax,
                                     int iters, int mode, int bf16,
                                     void* stream) {
  const int* i = static_cast<const int*>(ids);
  const float* x = static_cast<const float*>(w);
  const long long* c = static_cast<const long long*>(cand);
  float* tf = static_cast<float*>(t);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<uint16_t>(i, x, c, z, wl, zq, zv, wq, wv, tf, nq, cols,
                            hmax, iters, mode, st);
  return launch<float>(i, x, c, z, wl, zq, zv, wq, wv, tf, nq, cols, hmax,
                       iters, mode, st);
}

// The compiler's figures for the kernel that cand_pour_rows_launch runs in
// this mode (0 pour, 1 omr) at this iters, in the candidate form or, with
// all_rows, the all-rows form: out = {static shared bytes, dynamic shared
// bytes the launch requests, registers a thread, local (spill) bytes a
// thread, most threads a block}. Returns the cudaError_t (0 on success).
template <typename T, int MODE>
int rows_attrs(int all_rows, cudaFuncAttributes* a) {
  if (all_rows) {
    if constexpr (MODE == MODE_POUR)
      return cudaErrorInvalidValue;
    else
      return cudaFuncGetAttributes(a, cand_pour_rows_kernel<T, MODE, QB_ALL>);
  }
  return cudaFuncGetAttributes(a, cand_pour_rows_kernel<T, MODE, 1>);
}

template <typename T>
int rows_attrs_mode(int mode, int iters, int all_rows, cudaFuncAttributes* a) {
  if (mode == MODE_OMR) return rows_attrs<T, MODE_OMR>(all_rows, a);
  if (iters == 0) return rows_attrs<T, MODE_POUR0>(all_rows, a);
  return rows_attrs<T, MODE_POUR>(all_rows, a);
}

extern "C" int cand_pour_rows_attrs(int mode, int iters, int all_rows,
                                    int bf16, int* out) {
  cudaFuncAttributes a;
  const int err = bf16 ? rows_attrs_mode<uint16_t>(mode, iters, all_rows, &a)
                       : rows_attrs_mode<float>(mode, iters, all_rows, &a);
  if (err) return err;
  out[0] = (int)a.sharedSizeBytes;
  out[1] = 0;
  out[2] = a.numRegs;
  out[3] = (int)a.localSizeBytes;
  out[4] = a.maxThreadsPerBlock;
  return 0;
}

extern "C" const char* cand_pour_rows_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
