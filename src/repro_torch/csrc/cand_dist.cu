// cand_dist: the cascade's candidate gather of (hmax, h) cost rows from the
// query-major distance handoff, fused with the reverse-RWMD masked (min,+)
// reduction or the LC-ICT full-ladder pour, for a query batch, for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/cand_pour.py::cand_dist_pallas
// (body _cand_dist_kernel). The plain PyTorch versions are
// repro_torch/kernels/cand_pour.py::cand_rev_min_plain and cand_ict_plain.
//
// For query q and candidate row c (entry ids = idsg[q, c, :], weights
// x = xg[q, c, :]), with the cost row C_s = Dq[q, ids_s, :] (h values, the
// f32 sentinel `big` or above at padded query bins) and qw = qw[q, :]:
//   mode rev_min: cmin_j = min over slots s with x_s > 0 of C_s[j] (big if
//       there is none); t = sum_j cmin_j * qw_j, a multiply then a sum;
//   mode ict: lc.ict_pour per entry s with x_s > 0: pour x_s through the
//       query bins in ascending cost (ties to the lower bin, as a stable
//       argsort orders them) with capacities qw, r_i = clip(x_s - prefix_i,
//       0, qw_i), prefix_i = (sum_{p<=i} qw_p) - qw_i; dump the remainder
//       max(x_s - sum_i r_i, 0) at the max FINITE cost of C_s (strict < big;
//       0 if none), never at the sentinel; t = sum_s (sum_i r_i c_i + dump).
// in float32 whatever the handoff's type.
//
// Bound on an H100: bytes. Each entry with x > 0 reads one h-wide cost row
// (2 KB at h = 500 in f32); at 20 Newsgroups width a stage of 16 queries x
// 941 candidates reads ~1.4 M rows, a few GB, much of it repeated ids that
// the L2 serves. The ict pour adds per entry a few warp-wide selection
// rounds (one per query bin poured into), which compute does not bound.
//
// Design. One warp per (query, candidate row). The lanes split the h query
// bins, HPL = ceil(h / 32) per lane, held in registers. The warp walks the
// row's slots 32 at a time: each lane loads one (x, id), a ballot marks the
// slots with x > 0, and the warp visits those in order, reading each cost
// row with coalesced direct loads (bitwise: the TPU kernel's one-hot matmul
// gather without the arithmetic). Nothing carries between blocks: the TPU
// kernel streamed vocabulary slabs through VMEM and accumulated the gather
// across grid steps, which the card does not need.
//   rev_min: a running min per lane-held bin, then the products and a
//   shuffle sum.
//   ict: no sort. Padded query bins carry the sentinel and zero capacity,
//   so they come last and pour nothing. Each round the warp extracts the
//   lexicographically next (cost, bin) after the previous one with a
//   shuffle argmin, pours into it, and stops once the inclusive capacity
//   prefix reaches x (every later r is 0) or the costs reach the sentinel.
//   This is the sorted pour without a full sort: rounds = bins poured into.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <climits>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MODE_REV_MIN = 0;
constexpr int MODE_ICT = 1;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(FULL, x, off);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(FULL, x, off));
  return x;
}

// Lexicographic (cost, bin) argmin over the warp; every lane gets it.
__device__ __forceinline__ void warp_argmin(float& c, int& j) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float oc = __shfl_xor_sync(FULL, c, off);
    const int oj = __shfl_xor_sync(FULL, j, off);
    if (oc < c || (oc == c && oj < j)) {
      c = oc;
      j = oj;
    }
  }
}

template <typename T, int HPL, int MODE>
__global__ void __launch_bounds__(THREADS)
cand_dist_kernel(const int* __restrict__ idsg, const float* __restrict__ xg,
                 const T* __restrict__ dq, const float* __restrict__ qw,
                 float* __restrict__ t, long long rows, int b, int hmax,
                 int v, int h, float big) {
  const long long warp = (long long)blockIdx.x * WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (warp >= rows) return;   // uniform across the warp
  const int q = (int)(warp / b);
  const int* ids = idsg + (size_t)warp * hmax;
  const float* xr = xg + (size_t)warp * hmax;
  const T* dqq = dq + (size_t)q * v * h;
  const float* qwq = qw + (size_t)q * h;

  float cmin[HPL];   // rev_min: running min of each lane-held bin
#pragma unroll
  for (int i = 0; i < HPL; ++i) cmin[i] = big;
  float total = 0.f;   // ict: sum over entries (uniform across the warp)

  for (int s0 = 0; s0 < hmax; s0 += 32) {
    const int s = s0 + lane;
    const float xs = s < hmax ? xr[s] : 0.f;
    const int ids_s = s < hmax ? ids[s] : 0;
    unsigned valid = __ballot_sync(FULL, xs > 0.f);
    while (valid) {
      const int src = __ffs(valid) - 1;
      valid &= valid - 1;
      const float x = __shfl_sync(FULL, xs, src);
      const T* row = dqq + (size_t)__shfl_sync(FULL, ids_s, src) * h;
      float c[HPL];
#pragma unroll
      for (int i = 0; i < HPL; ++i) {
        const int j = lane + 32 * i;
        c[i] = j < h ? to_f32(row[j]) : CUDART_INF_F;
      }
      if (MODE == MODE_REV_MIN) {
#pragma unroll
        for (int i = 0; i < HPL; ++i) cmin[i] = fminf(cmin[i], c[i]);
        continue;
      }
      // ict: the dump cost, then the pour rounds.
      float mx = 0.f;
#pragma unroll
      for (int i = 0; i < HPL; ++i)
        if (c[i] < big) mx = fmaxf(mx, c[i]);
      mx = warp_max(mx);
      float pc = -CUDART_INF_F, cum = 0.f, acc = 0.f, rsum = 0.f;
      int pj = -1;
      while (true) {
        float bc = CUDART_INF_F;
        int bj = INT_MAX;
#pragma unroll
        for (int i = 0; i < HPL; ++i) {
          const int j = lane + 32 * i;
          const bool after = c[i] > pc || (c[i] == pc && j > pj);
          if (after && (c[i] < bc || (c[i] == bc && j < bj))) {
            bc = c[i];
            bj = j;
          }
        }
        warp_argmin(bc, bj);
        if (!(bc < big)) break;   // only padded query bins remain
        const float cap = qwq[bj];
        cum = __fadd_rn(cum, cap);
        const float r = fminf(fmaxf(__fsub_rn(x, __fsub_rn(cum, cap)), 0.f),
                              cap);
        acc = __fadd_rn(acc, __fmul_rn(r, bc));
        rsum = __fadd_rn(rsum, r);
        if (cum >= x) break;      // x is poured: every later r is 0
        pc = bc;
        pj = bj;
      }
      const float rem = fmaxf(__fsub_rn(x, rsum), 0.f);
      total = __fadd_rn(total, __fadd_rn(acc, __fmul_rn(rem, mx)));
    }
  }

  if (MODE == MODE_REV_MIN) {
    float part = 0.f;
#pragma unroll
    for (int i = 0; i < HPL; ++i) {
      const int j = lane + 32 * i;
      if (j < h) part = __fadd_rn(part, __fmul_rn(cmin[i], qwq[j]));
    }
    total = warp_sum(part);
  }
  if (lane == 0) t[warp] = total;
}

template <typename T, int HPL>
void launch_h(const int* idsg, const float* xg, const T* dq, const float* qw,
              float* t, long long rows, int b, int hmax, int v, int h,
              float big, int mode, cudaStream_t stream) {
  const unsigned blocks = (unsigned)((rows + WARPS - 1) / WARPS);
  if (mode == MODE_ICT)
    cand_dist_kernel<T, HPL, MODE_ICT><<<blocks, THREADS, 0, stream>>>(
        idsg, xg, dq, qw, t, rows, b, hmax, v, h, big);
  else
    cand_dist_kernel<T, HPL, MODE_REV_MIN><<<blocks, THREADS, 0, stream>>>(
        idsg, xg, dq, qw, t, rows, b, hmax, v, h, big);
}

template <typename T>
cudaError_t launch(const int* idsg, const float* xg, const void* dq,
                   const float* qw, float* t, int nq, int b, int hmax, int v,
                   int h, float big, int mode, cudaStream_t stream) {
  const long long rows = (long long)nq * b;
  const T* d = static_cast<const T*>(dq);
  if (h <= 128)
    launch_h<T, 4>(idsg, xg, d, qw, t, rows, b, hmax, v, h, big, mode, stream);
  else if (h <= 512)
    launch_h<T, 16>(idsg, xg, d, qw, t, rows, b, hmax, v, h, big, mode,
                    stream);
  else
    launch_h<T, 32>(idsg, xg, d, qw, t, rows, b, hmax, v, h, big, mode,
                    stream);
  return cudaGetLastError();
}

}  // namespace

// idsg (nq, b, hmax) int32 with ids in [0, v), xg (nq, b, hmax) f32,
// dq (nq, v, h) f32 or bf16, qw (nq, h) f32, all contiguous; 1 <= h <= 1024.
// big = the f32 sentinel (pad_dist_for(float32)). mode 0 = rev_min,
// 1 = ict. Writes t (nq, b) f32. Returns the cudaError_t of the launch
// (0 on success).
extern "C" int cand_dist_launch(const void* idsg, const void* xg,
                                const void* dq, const void* qw, void* t,
                                int nq, int b, int hmax, int v, int h,
                                float big, int mode, int bf16, void* stream) {
  const int* ids = static_cast<const int*>(idsg);
  const float* x = static_cast<const float*>(xg);
  const float* w = static_cast<const float*>(qw);
  float* tf = static_cast<float*>(t);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<__nv_bfloat16>(ids, x, dq, w, tf, nq, b, hmax, v, h, big,
                                 mode, st);
  return launch<float>(ids, x, dq, w, tf, nq, b, hmax, v, h, big, mode, st);
}

extern "C" const char* cand_dist_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
