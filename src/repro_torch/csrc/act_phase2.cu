// act_phase2: the LC-ACT Phase-2/3 water-filling pour over pre-gathered
// ladders, for a query batch, for sm_90a.
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
// (2*iters+1) ladder values read once. At 20 Newsgroups width one launch of
// 8 queries receives 4.5 GB of ladders, most of them at padding slots.
//
// Design. One warp per (query, row); each lane walks a strided share of
// the row's hmax entries, runs the iters-round pour in registers and the
// lanes reduce with shuffles. An entry with x == 0 pours nothing and dumps
// nothing (the ladders are finite: invalid bins carry a finite sentinel),
// so its ladders are not read at all -- the padding slots cost no bytes.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
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
  const T* zr = zg + (size_t)warp * hmax * (iters + 1);
  const T* wr = wg + (size_t)warp * hmax * iters;

  float sum = 0.f;
  for (int j = lane; j < hmax; j += 32) {
    const float xv = xr[j];
    if (xv == 0.f) continue;
    const T* zj = zr + (size_t)j * (iters + 1);
    const T* wj = wr + (size_t)j * iters;
    float acc = 0.f, prefix = 0.f;
    for (int l = 0; l < iters; ++l) {
      const float w = to_f32(wj[l]);
      const float r = fminf(fmaxf(xv - prefix, 0.f), w);
      acc = acc + r * to_f32(zj[l]);
      prefix = prefix + w;
    }
    const float rem = fmaxf(xv - prefix, 0.f);
    sum += acc + rem * to_f32(zj[iters]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    sum += __shfl_down_sync(0xffffffffu, sum, off);
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

extern "C" const char* act_phase2_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
