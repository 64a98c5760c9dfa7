// cand_pour: the cascade's candidate gather fused with the LC-ACT / LC-RWMD
// pour or the LC-OMR reduction, for a query batch, for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/cand_pour.py::cand_pour_pallas
// (body _cand_pour_kernel, gather _gather_rows). The plain PyTorch versions
// are repro_torch/kernels/cand_pour.py::cand_pour_plain and cand_omr_plain.
//
// For query q and candidate row c (its entries ids = idsg[q, c, :], weights
// x = xg[q, c, :]), with the ladder rows Z[q, id, :] and W[q, id, :]:
//   mode pour, iters = 0:  t = sum_j x_j * Z0
//   mode pour, iters >= 1: lc.pour, the capacity prefix cap_l = sum_{p<=l} w_p,
//       r_l = clip(x - (cap_l - w_l), 0, w_l), t = sum_j sum_l r_l z_l
//       + max(x - cap_{iters-1}, 0) * z_iters (the remainder from the
//       capacities, as the port's lc.pour takes it)
//   mode omr:  overlap = Z0 == 0, rest = x - min(x, W0),
//              t = sum_j (overlap ? rest * Z1 : x * Z0)
// in float32 whatever the ladders' type. Z and W are separate tensors with
// their own row widths kz, kw (the TPU kernel's Z|W table concatenation is
// a VMEM layout the card does not need).
//
// Bound on an H100: bytes. Each entry with x > 0 reads one ladder row of
// (k + iters) values and does a handful of flops. At 20 Newsgroups width a
// stage of 16 queries x 941 candidates reads some 1.4 M such rows, most of
// them in the L2-resident part of the (nq, v, k) ladders.
//
// Design. One warp per (query, candidate row); each lane walks a strided
// share of the row's hmax entries, gathers its ladder values with direct
// loads (bitwise: a load is the TPU kernel's one-hot matmul gather without
// the arithmetic) and reduces in registers; the lanes sum with shuffles. An
// entry with x == 0 contributes exactly 0 (the ladders are finite: invalid
// query bins carry a finite sentinel), so its ladders are not read.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MODE_POUR = 0;
constexpr int MODE_OMR = 1;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T, int MODE>
__global__ void __launch_bounds__(THREADS)
cand_pour_kernel(const int* __restrict__ idsg, const float* __restrict__ xg,
                 const T* __restrict__ z, const T* __restrict__ w,
                 float* __restrict__ t, long long rows, int b, int hmax,
                 int v, int kz, int kw, int iters) {
  const long long warp = (long long)blockIdx.x * WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (warp >= rows) return;   // uniform across the warp
  const int q = (int)(warp / b);
  const int* ids = idsg + (size_t)warp * hmax;
  const float* xr = xg + (size_t)warp * hmax;
  const T* zq = z + (size_t)q * v * kz;
  const T* wq = kw ? w + (size_t)q * v * kw : nullptr;

  float sum = 0.f;
  for (int j = lane; j < hmax; j += 32) {
    const float x = xr[j];
    if (x == 0.f) continue;
    const size_t id = (size_t)ids[j];
    const T* zj = zq + id * kz;
    float entry;
    if (MODE == MODE_OMR) {
      const float z0 = to_f32(zj[0]);
      const float rest = __fsub_rn(x, fminf(x, to_f32(wq[id * kw])));
      entry = z0 == 0.f ? __fmul_rn(rest, to_f32(zj[1])) : __fmul_rn(x, z0);
    } else if (iters == 0) {
      entry = __fmul_rn(x, to_f32(zj[0]));
    } else {
      const T* wj = wq + id * kw;
      float acc = 0.f, cap = 0.f;
      for (int l = 0; l < iters; ++l) {
        const float wl = to_f32(wj[l]);
        cap = __fadd_rn(cap, wl);
        const float r = fminf(fmaxf(__fsub_rn(x, __fsub_rn(cap, wl)), 0.f),
                              wl);
        acc = __fadd_rn(acc, __fmul_rn(r, to_f32(zj[l])));
      }
      const float rem = fmaxf(__fsub_rn(x, cap), 0.f);
      entry = __fadd_rn(acc, __fmul_rn(rem, to_f32(zj[iters])));
    }
    sum += entry;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    sum += __shfl_down_sync(0xffffffffu, sum, off);
  if (lane == 0) t[warp] = sum;
}

template <typename T>
cudaError_t launch(const int* idsg, const float* xg, const void* z,
                   const void* w, float* t, int nq, int b, int hmax, int v,
                   int kz, int kw, int iters, int mode, cudaStream_t stream) {
  const long long rows = (long long)nq * b;
  const unsigned blocks = (unsigned)((rows + WARPS - 1) / WARPS);
  const T* zt = static_cast<const T*>(z);
  const T* wt = static_cast<const T*>(w);
  if (mode == MODE_OMR)
    cand_pour_kernel<T, MODE_OMR><<<blocks, THREADS, 0, stream>>>(
        idsg, xg, zt, wt, t, rows, b, hmax, v, kz, kw, iters);
  else
    cand_pour_kernel<T, MODE_POUR><<<blocks, THREADS, 0, stream>>>(
        idsg, xg, zt, wt, t, rows, b, hmax, v, kz, kw, iters);
  return cudaGetLastError();
}

}  // namespace

// idsg (nq, b, hmax) int32 with ids in [0, v), xg (nq, b, hmax) f32;
// z (nq, v, kz) and w (nq, v, kw), both f32 or both bf16 (w may be null
// when kw == 0, mode pour with iters == 0); all contiguous. mode 0 = pour
// (kz >= iters + 1, kw >= iters), mode 1 = omr (kz >= 2, kw = 1: W0).
// Writes t (nq, b) f32. Returns the cudaError_t of the launch (0 on
// success).
extern "C" int cand_pour_launch(const void* idsg, const void* xg,
                                const void* z, const void* w, void* t, int nq,
                                int b, int hmax, int v, int kz, int kw,
                                int iters, int mode, int bf16, void* stream) {
  const int* ids = static_cast<const int*>(idsg);
  const float* x = static_cast<const float*>(xg);
  float* tf = static_cast<float*>(t);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<__nv_bfloat16>(ids, x, z, w, tf, nq, b, hmax, v, kz, kw,
                                 iters, mode, st);
  return launch<float>(ids, x, z, w, tf, nq, b, hmax, v, kz, kw, iters, mode,
                       st);
}

extern "C" const char* cand_pour_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
