// act_phase2: the LC-ACT Phase-2/3 water-filling pour for a query batch,
// for sm_90a: over pre-gathered ladders, or gathering them itself.
//
// Replaces the TPU kernel src/repro/kernels/act_phase2.py::act_phase2_pallas
// (body _act_phase2_kernel, per-entry pour pour_entry_costs). The plain
// PyTorch version is repro_torch/kernels/act_phase2.py::act_phase2_plain.
//
// The same kernel is K5, act_phase2_cand: it replaces
// src/repro/kernels/act_phase2.py::act_phase2_cand_pallas, whose x is per
// query (xg (nq, b, hmax), one candidate sub-corpus per query); its plain
// version is act_phase2_cand_plain. The only difference is the row of x a
// warp reads: x[u] for K2, xg[q, u] for K5.
//
// And it is act_phase2_gather, the entry the engine calls: the TPU kernel
// cannot gather, so the JAX engine materializes zg = Z[:, ids] and
// wg = W[:, ids, :iters] and hands them to it. Here a lane reads the
// ladder rows Z[q, ids[u, j], :] and W[q, ids[u, j], :iters] of its slot
// itself, from the (nq, v, iters+1) and (nq, v, >= iters) Phase-1 ladders;
// the (nq, n, hmax, k) tensors never exist. Only the source of the ladder
// values differs from K2 -- the lane striding, the per-entry arithmetic
// and the shuffle reduction are the same code -- so the fused output is
// bitwise equal to K2's on the gathered ladders.
//
// For query q and database row u:
//   t[q, u] = sum_j  sum_{l<iters} r_l * zg[q,u,j,l]
//                    + max(x[u,j] - sum_l wg[q,u,j,l], 0) * zg[q,u,j,iters]
//   r_l = clip(x[u,j] - sum_{p<l} wg[q,u,j,p], 0, wg[q,u,j,l])
// with every product and sum in float32, whatever the ladders' type. The
// remainder is taken from the capacities: it equals the TPU kernel's
// x - sum_l r_l in exact arithmetic, but is never left at one ulp, which a
// query with fewer valid bins than iters+1 would dump at the sentinel cost.
//
// Bound on an H100: bytes. Each entry is a handful of flops against
// (2*iters+1) ladder values. On pre-gathered ladders those values are the
// entry's own; gathering, the ladder rows of the distinct (query, id) pairs
// are read from device memory once and again from the L2 for every slot
// that names them.
//
// Design. One warp per (query, row); each lane walks a strided share of
// the row's hmax entries, runs the iters-round pour in registers and the
// lanes reduce with shuffles. An entry with x == 0 pours nothing and dumps
// nothing (the ladders are finite: invalid bins carry a finite sentinel),
// so its ids and ladders are not read at all -- the padding slots cost no
// bytes. The gathering entry numbers its warps query-major, as K2 does:
// the warps in flight then gather from one query's ladders (v rows of
// 2*iters+1 values, 4.5 MB in float32 at 20 Newsgroups width), which stay
// in the L2, while x and ids stream past them with evict-first loads. Each
// lane's ladder rows lie at ids of its own, so every load of a warp touches
// up to 32 lines; where k = iters+1 is 2, 4, 8 or 16 and W's rows are k
// wide, a lane reads each row in 16-byte (or narrower) vectors instead of
// value by value. Every variant pours through the same pour_entry, so its
// output is bitwise the same.
//
// Row lengths. The gathering entry takes lens (n,), each row's length: one
// past its last slot with x != 0 (kernels/act_phase2.py row_lens, computed
// once per corpus by the wrapper), and a warp walks its row only up to it.
// The slots past it have x == 0, which the pour skips, so they change no
// bit; they are the padding of short rows, about 81 % of the slots of the
// 20 Newsgroups-shaped corpus (1.77 M of 9.41 M slots lie before the rows'
// ends). Without the stop every lane read its whole strided share of x:
// about 16 slots at hmax 500 for about 3 live ones. chip_smoke.py times
// the entry against itself with every length set to hmax (no stop): phase
// 9 (b) at nq = 1, phase 4 on the batch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>
#include <type_traits>

namespace {

constexpr int THREADS = 256;       // K2 and K5
constexpr int WARPS = THREADS / 32;

// The fused-gather entry's tile knob: warps (rows) per block, built with
// -DACT_PHASE2_GATHER_WARPS=... (kernels/_build.py). A warp pours one
// (query, row) whatever the block, so every variant is bitwise the
// default; the lane stride over hmax (32) is not a knob, it orders the sum.
#ifndef ACT_PHASE2_GATHER_WARPS
#define ACT_PHASE2_GATHER_WARPS 8
#endif
constexpr int GATHER_WARPS = ACT_PHASE2_GATHER_WARPS;
constexpr int GATHER_THREADS = 32 * GATHER_WARPS;
static_assert(GATHER_WARPS >= 1 && GATHER_THREADS <= 1024, "");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Ladder rows of entry j: pre-gathered (zg (nq, n, hmax, iters+1) and
// wg (nq, n, hmax, iters) at warp (q, u)), or gathered from Z (nq, v, zs)
// and W (nq, v, ws) at ids[u, j].
template <typename T, bool GATHER>
struct Ladders {
  const T* z;
  const T* w;
  const int* ids;                  // row u of ids (GATHER)
  int zs, ws;                      // row strides of Z and W (GATHER)
  __device__ __forceinline__ float x(const float* xr, int j) const {
    if (GATHER) return __ldcs(xr + j);   // streamed past the ladders
    return xr[j];
  }
  // The cost and capacity rows of entry j.
  __device__ __forceinline__ void rows(int j, int iters, const T*& zj,
                                       const T*& wj) const {
    if (GATHER) {
      const size_t id = (size_t)__ldcs(ids + j);
      zj = z + id * zs;
      wj = w + id * ws;
    } else {
      zj = z + (size_t)j * (iters + 1);
      wj = w + (size_t)j * iters;
    }
  }
};

// One entry's pour: iters rounds against costs zl(l) and capacities wl(l),
// then the remainder at cost zl(iters). Unrolled when iters is a constant.
template <typename ZL, typename WL>
__device__ __forceinline__ float pour_entry(float xv, int iters, ZL zl,
                                            WL wl) {
  float acc = 0.f, prefix = 0.f;
#pragma unroll
  for (int l = 0; l < iters; ++l) {
    const float w = wl(l);
    const float r = fminf(fmaxf(xv - prefix, 0.f), w);
    acc = __fmaf_rn(r, zl(l), acc);
    prefix = __fadd_rn(prefix, w);
  }
  const float rem = fmaxf(xv - prefix, 0.f);
  return __fmaf_rn(rem, zl(iters), acc);
}

__device__ __forceinline__ float warp_sum(float sum) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    sum += __shfl_down_sync(0xffffffffu, sum, off);
  return sum;
}

// The pour of one (query, row): lane-strided over hmax, shuffle-reduced.
// Returns the sum on lane 0.
template <typename T, bool GATHER>
__device__ __forceinline__ float pour_row(const float* __restrict__ xr,
                                          const Ladders<T, GATHER>& lad,
                                          int hmax, int iters, int lane) {
  float sum = 0.f;
  for (int j = lane; j < hmax; j += 32) {
    const float xv = lad.x(xr, j);
    if (xv == 0.f) continue;
    const T *zj, *wj;
    lad.rows(j, iters, zj, wj);
    sum = __fadd_rn(sum, pour_entry(
                             xv, iters, [&](int l) { return to_f32(zj[l]); },
                             [&](int l) { return to_f32(wj[l]); }));
  }
  return warp_sum(sum);
}

// A ladder row of K values (K * sizeof(T) bytes, aligned to that or to 16),
// read in 16-byte (or one narrower) vector loads and widened to float32.
template <typename T, int K>
__device__ __forceinline__ void load_row(const T* __restrict__ p,
                                         float (&out)[K]) {
  constexpr int BYTES = K * (int)sizeof(T);
  using V = typename std::conditional<
      (BYTES >= 16), uint4,
      typename std::conditional<(BYTES == 8), uint2, uint32_t>::type>::type;
  constexpr int PER = (int)(sizeof(V) / sizeof(T));
#pragma unroll
  for (int i = 0; i < K / PER; ++i) {
    const V u = reinterpret_cast<const V*>(p)[i];
    T e[PER];
    memcpy(e, &u, sizeof(V));
#pragma unroll
    for (int c = 0; c < PER; ++c) out[i * PER + c] = to_f32(e[c]);
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
act_phase2_kernel(const float* __restrict__ x, const T* __restrict__ zg,
                  const T* __restrict__ wg, float* __restrict__ t, int nq,
                  int n, int hmax, int iters, int x_per_query) {
  const long long warp = (long long)blockIdx.x * WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (warp >= (long long)nq * n) return;   // uniform across the warp
  const int u = (int)(warp % n);
  const float* xr = x + (size_t)(x_per_query ? warp : u) * hmax;
  const Ladders<T, false> lad{zg + (size_t)warp * hmax * (iters + 1),
                              wg + (size_t)warp * hmax * iters, nullptr, 0,
                              0};
  const float sum = pour_row(xr, lad, hmax, iters, lane);
  if (lane == 0) t[warp] = sum;
}

template <typename T>
__global__ void __launch_bounds__(GATHER_THREADS)
act_phase2_gather_kernel(const float* __restrict__ x,
                         const int* __restrict__ ids,
                         const int* __restrict__ lens,
                         const T* __restrict__ Z, const T* __restrict__ W,
                         float* __restrict__ t, int nq, int n, int v,
                         int hmax, int iters, int ws) {
  const long long warp =
      (long long)blockIdx.x * GATHER_WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (warp >= (long long)nq * n) return;   // uniform across the warp
  const int q = (int)(warp / n), u = (int)(warp % n);
  const Ladders<T, true> lad{Z + (size_t)q * v * (iters + 1),
                             W + (size_t)q * v * ws,
                             ids + (size_t)u * hmax, iters + 1, ws};
  const float sum =
      pour_row(x + (size_t)u * hmax, lad, __ldg(lens + u), iters, lane);
  if (lane == 0) t[warp] = sum;
}

// The fused entry for k = iters + 1 = K with W's rows K wide: each ladder
// row in vector loads; the arithmetic of pour_row.
template <typename T, int K>
__global__ void __launch_bounds__(GATHER_THREADS)
act_phase2_gather_vec_kernel(const float* __restrict__ x,
                             const int* __restrict__ ids,
                             const int* __restrict__ lens,
                             const T* __restrict__ Z, const T* __restrict__ W,
                             float* __restrict__ t, int nq, int n, int v,
                             int hmax) {
  const long long warp =
      (long long)blockIdx.x * GATHER_WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (warp >= (long long)nq * n) return;   // uniform across the warp
  const int q = (int)(warp / n), u = (int)(warp % n);
  const float* xr = x + (size_t)u * hmax;
  const int* ir = ids + (size_t)u * hmax;
  const T* Zq = Z + (size_t)q * v * K;
  const T* Wq = W + (size_t)q * v * K;
  const int len = __ldg(lens + u);
  float sum = 0.f;
  for (int j = lane; j < len; j += 32) {
    const float xv = __ldcs(xr + j);
    if (xv == 0.f) continue;
    const size_t id = (size_t)__ldcs(ir + j);
    float zv[K], wv[K];
    load_row<T, K>(Zq + id * K, zv);
    load_row<T, K>(Wq + id * K, wv);
    sum = __fadd_rn(sum, pour_entry(
                             xv, K - 1, [&](int l) { return zv[l]; },
                             [&](int l) { return wv[l]; }));
  }
  sum = warp_sum(sum);
  if (lane == 0) t[warp] = sum;
}

template <typename T>
cudaError_t launch(const float* x, const void* zg, const void* wg, float* t,
                   int nq, int n, int hmax, int iters, int x_per_query,
                   cudaStream_t stream) {
  const long long warps = (long long)nq * n;
  const unsigned blocks = (unsigned)((warps + WARPS - 1) / WARPS);
  act_phase2_kernel<T><<<blocks, THREADS, 0, stream>>>(
      x, static_cast<const T*>(zg), static_cast<const T*>(wg), t, nq, n, hmax,
      iters, x_per_query);
  return cudaGetLastError();
}

template <typename T, int K>
bool launch_gather_vec(const float* x, const int* ids, const int* lens,
                       const void* Z, const void* W, float* t, int nq, int n,
                       int v, int hmax, int iters, int ws, unsigned blocks,
                       cudaStream_t stream) {
  constexpr uintptr_t ALIGN = K * sizeof(T) < 16 ? K * sizeof(T) : 16;
  if (iters + 1 != K || ws != K ||
      reinterpret_cast<uintptr_t>(Z) % ALIGN ||
      reinterpret_cast<uintptr_t>(W) % ALIGN)
    return false;
  act_phase2_gather_vec_kernel<T, K><<<blocks, GATHER_THREADS, 0, stream>>>(
      x, ids, lens, static_cast<const T*>(Z), static_cast<const T*>(W), t,
      nq, n, v, hmax);
  return true;
}

template <typename T>
cudaError_t launch_gather(const float* x, const int* ids, const int* lens,
                          const void* Z, const void* W, float* t, int nq,
                          int n, int v, int hmax, int iters, int ws,
                          cudaStream_t stream) {
  const long long warps = (long long)nq * n;
  const unsigned blocks =
      (unsigned)((warps + GATHER_WARPS - 1) / GATHER_WARPS);
  if (launch_gather_vec<T, 2>(x, ids, lens, Z, W, t, nq, n, v, hmax, iters,
                              ws, blocks, stream) ||
      launch_gather_vec<T, 4>(x, ids, lens, Z, W, t, nq, n, v, hmax, iters,
                              ws, blocks, stream) ||
      launch_gather_vec<T, 8>(x, ids, lens, Z, W, t, nq, n, v, hmax, iters,
                              ws, blocks, stream) ||
      launch_gather_vec<T, 16>(x, ids, lens, Z, W, t, nq, n, v, hmax, iters,
                               ws, blocks, stream))
    return cudaGetLastError();
  act_phase2_gather_kernel<T><<<blocks, GATHER_THREADS, 0, stream>>>(
      x, ids, lens, static_cast<const T*>(Z), static_cast<const T*>(W), t,
      nq, n, v, hmax, iters, ws);
  return cudaGetLastError();
}

}  // namespace

// x (n, hmax) f32; zg (nq, n, hmax, iters+1) and wg (nq, n, hmax, iters),
// both f32 or both bf16; all contiguous. Writes t (nq, n) f32. iters >= 1.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int act_phase2_launch(const void* x, const void* zg, const void* wg,
                                 void* t, int nq, int n, int hmax, int iters,
                                 int bf16, void* stream) {
  const float* xf = static_cast<const float*>(x);
  float* tf = static_cast<float*>(t);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<__nv_bfloat16>(xf, zg, wg, tf, nq, n, hmax, iters, 0, st);
  return launch<float>(xf, zg, wg, tf, nq, n, hmax, iters, 0, st);
}

// K5: xg (nq, b, hmax) f32; zg (nq, b, hmax, iters+1) and wg (nq, b, hmax,
// iters), both f32 or both bf16; all contiguous. Writes t (nq, b) f32.
// iters >= 1. Returns the cudaError_t of the launch (0 on success).
extern "C" int act_phase2_cand_launch(const void* xg, const void* zg,
                                      const void* wg, void* t, int nq, int b,
                                      int hmax, int iters, int bf16,
                                      void* stream) {
  const float* xf = static_cast<const float*>(xg);
  float* tf = static_cast<float*>(t);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<__nv_bfloat16>(xf, zg, wg, tf, nq, b, hmax, iters, 1, st);
  return launch<float>(xf, zg, wg, tf, nq, b, hmax, iters, 1, st);
}

// The fused entry: x (n, hmax) f32, ids (n, hmax) int32 in [0, v) wherever
// x > 0, lens (n,) int32 in [0, hmax] with x[u, j] == 0 for every
// j >= lens[u]; Z (nq, v, iters+1) and W (nq, v, ws >= iters), both f32 or
// both bf16; all contiguous. Writes t (nq, n) f32. iters >= 1. Returns the
// cudaError_t of the launch (0 on success).
extern "C" int act_phase2_gather_launch(const void* x, const void* ids,
                                        const void* lens, const void* Z,
                                        const void* W, void* t, int nq, int n,
                                        int v, int hmax, int iters, int ws,
                                        int bf16, void* stream) {
  const float* xf = static_cast<const float*>(x);
  const int* id = static_cast<const int*>(ids);
  const int* ln = static_cast<const int*>(lens);
  float* tf = static_cast<float*>(t);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch_gather<__nv_bfloat16>(xf, id, ln, Z, W, tf, nq, n, v, hmax,
                                        iters, ws, st);
  return launch_gather<float>(xf, id, ln, Z, W, tf, nq, n, v, hmax, iters,
                              ws, st);
}

// The compiler's figures for the fused-gather kernel that
// act_phase2_gather_launch runs at k = iters + 1 with W rows ws wide (the
// vector form where k is 2, 4, 8 or 16 and ws == k, given aligned
// ladders): out = {static shared bytes, dynamic shared bytes the launch
// requests, registers a thread, local (spill) bytes a thread, most threads
// a block}. Returns the cudaError_t (0 on success).
template <typename T>
int gather_attrs(int k, int ws, int* out) {
  cudaFuncAttributes a;
  cudaError_t err;
  if (ws == k && k == 2)
    err = cudaFuncGetAttributes(&a, act_phase2_gather_vec_kernel<T, 2>);
  else if (ws == k && k == 4)
    err = cudaFuncGetAttributes(&a, act_phase2_gather_vec_kernel<T, 4>);
  else if (ws == k && k == 8)
    err = cudaFuncGetAttributes(&a, act_phase2_gather_vec_kernel<T, 8>);
  else if (ws == k && k == 16)
    err = cudaFuncGetAttributes(&a, act_phase2_gather_vec_kernel<T, 16>);
  else
    err = cudaFuncGetAttributes(&a, act_phase2_gather_kernel<T>);
  if (err != cudaSuccess) return err;
  out[0] = (int)a.sharedSizeBytes;
  out[1] = 0;
  out[2] = a.numRegs;
  out[3] = (int)a.localSizeBytes;
  out[4] = a.maxThreadsPerBlock;
  return 0;
}

extern "C" int act_phase2_gather_attrs(int k, int ws, int bf16, int* out) {
  return bf16 ? gather_attrs<__nv_bfloat16>(k, ws, out)
              : gather_attrs<float>(k, ws, out);
}

extern "C" const char* act_phase2_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
