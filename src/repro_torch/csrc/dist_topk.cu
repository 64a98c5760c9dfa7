// dist_topk: fused Euclidean distance + row-top-k over a query batch
// (Phase 1 of batched LC-ACT / LC-RWMD), for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/dist_topk.py::dist_topk_pallas
// (body _dist_topk_kernel, selection _rowmin_extract). The plain PyTorch
// version is repro_torch/kernels/dist_topk.py::dist_topk_plain.
//
// Bound on an H100: float32 operations. The work is v*m multiply-adds
// (2*v*m operations) per valid query bin -- 334 GFLOP if all 16 x 500 bins
// of a 20 Newsgroups-width batch were valid -- against 67 TFLOP/s of
// float32 outside the tensor cores. TF32 is ruled out: it drops mantissa
// bits, and identical coordinates must still snap to an exact zero. Bytes
// are small (coords once, Z/S once). This kernel computes every bin, valid
// or not; skipping the invalid ones is left to a later change.
//
// Design. One block per (tile of BV vocabulary rows, query). The query's h
// bins stream through in tiles of BH; for each tile a plain shared-memory
// SGEMM stages the embedding dimension m in chunks of BK and every thread
// accumulates a TM x TN micro-tile in float32 FMA. The squared norms are
// summed from the same staged tiles, so identical coordinates produce
// bitwise-equal |a|^2, |b|^2 and a.b and their distance is exactly 0. The
// tile's distances go to shared memory, and thread r (r < BV) then scans
// row r's columns in ascending order, inserting into KMAX running
// (value, column) registers with a strict '<', so the lowest column wins
// ties. The TPU kernel's sequential grid axis over h blocks is the loop
// over h tiles inside the block. Selection is float32; Z is cast to the
// storage type only on the store.
//
// Degenerate rows (fewer than k valid bins): slots past the valid bins get
// the sentinel `big` (passed in from pad_dist_for(out_dtype)) and the
// column min(lowest invalid column, lowest taken column) -- what the TPU
// kernel's masked-min rounds produce, since they mask both invalid and
// taken columns to the same sentinel.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <climits>

namespace {

constexpr int BV = 128;            // vocabulary rows per block
constexpr int BH = 64;             // query bins per tile
constexpr int BK = 16;             // embedding dims staged per step
constexpr int THREADS = 256;
constexpr int TM = BV / 16;        // rows per thread (stride 16)
constexpr int TN = BH / 16;        // columns per thread (stride 16)

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// Insert (d, c) into the ascending register list; strict '<' keeps an
// earlier (lower) column ahead of an equal value.
template <int KMAX>
__device__ __forceinline__ void insert(float (&z)[KMAX], int (&s)[KMAX],
                                       float d, int c) {
  if (d < z[KMAX - 1]) {
    z[KMAX - 1] = d;
    s[KMAX - 1] = c;
#pragma unroll
    for (int i = KMAX - 1; i > 0; --i) {
      if (z[i] < z[i - 1]) {
        float tz = z[i]; z[i] = z[i - 1]; z[i - 1] = tz;
        int ts = s[i]; s[i] = s[i - 1]; s[i - 1] = ts;
      }
    }
  }
}

template <int KMAX, typename OutT>
__global__ void __launch_bounds__(THREADS)
dist_topk_kernel(const float* __restrict__ coords,
                 const float* __restrict__ qc,
                 const bool* __restrict__ qmask, OutT* __restrict__ z,
                 int* __restrict__ s, int v, int h, int m, int k, float big) {
  __shared__ float As[BK][BV + 1];   // coords tile, dims-major (+1: banks)
  __shared__ float Bs[BK][BH + 1];   // query-bin tile, dims-major
  __shared__ float Ds[BV][BH + 1];   // the tile's distances
  __shared__ float sa2[BV];
  __shared__ float sb2[BH];
  __shared__ bool svalid[BH];

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int q = blockIdx.y;
  const int row0 = blockIdx.x * BV;
  const float* qcq = qc + (size_t)q * h * m;
  const bool* mq = qmask + (size_t)q * h;

  // Selection state of row row0 + tid (threads tid < BV).
  float zr[KMAX];
  int sr[KMAX];
#pragma unroll
  for (int i = 0; i < KMAX; ++i) { zr[i] = CUDART_INF_F; sr[i] = INT_MAX; }
  int nvalid = 0;
  int first_invalid = INT_MAX;

  for (int h0 = 0; h0 < h; h0 += BH) {
    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
    float nrm = 0.f;   // |row|^2 (tid < BV) or |bin|^2 (BV <= tid < BV+BH)

    for (int k0 = 0; k0 < m; k0 += BK) {
      for (int e = tid; e < BV * BK; e += THREADS) {
        const int r = e / BK, kk = e % BK;
        const int gr = row0 + r, gk = k0 + kk;
        As[kk][r] = (gr < v && gk < m) ? coords[(size_t)gr * m + gk] : 0.f;
      }
      for (int e = tid; e < BH * BK; e += THREADS) {
        const int c = e / BK, kk = e % BK;
        const int gc = h0 + c, gk = k0 + kk;
        Bs[kk][c] = (gc < h && gk < m) ? qcq[(size_t)gc * m + gk] : 0.f;
      }
      __syncthreads();
      if (tid < BV) {
#pragma unroll
        for (int kk = 0; kk < BK; ++kk)
          nrm = fmaf(As[kk][tid], As[kk][tid], nrm);
      } else if (tid < BV + BH) {
#pragma unroll
        for (int kk = 0; kk < BK; ++kk)
          nrm = fmaf(Bs[kk][tid - BV], Bs[kk][tid - BV], nrm);
      }
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        float a[TM], b[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < TN; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }

    if (tid < BV) {
      sa2[tid] = nrm;
    } else if (tid < BV + BH) {
      const int c = tid - BV;
      sb2[c] = nrm;
      svalid[c] = (h0 + c < h) && mq[h0 + c];
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < TM; ++i) {
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j;
        const float n2 = __fadd_rn(sa2[r], sb2[c]);
        float d = __fsub_rn(n2, __fmul_rn(2.f, acc[i][j]));
        d = fmaxf(d, 0.f);
        if (d < __fmul_rn(1e-6f, n2)) d = 0.f;   // relative ZERO_SNAP
        Ds[r][c] = sqrtf(d);
      }
    }
    __syncthreads();

    if (tid < BV) {
      const int ncol = min(BH, h - h0);
      for (int c = 0; c < ncol; ++c) {
        if (svalid[c]) {
          ++nvalid;
          insert<KMAX>(zr, sr, Ds[tid][c], h0 + c);
        } else {
          first_invalid = min(first_invalid, h0 + c);
        }
      }
    }
    __syncthreads();
  }

  const int row = row0 + tid;
  if (tid < BV && row < v) {
    const int taken = min(nvalid, k);
    int fill = first_invalid;
#pragma unroll
    for (int i = 0; i < KMAX; ++i)
      if (i < taken) fill = min(fill, sr[i]);
    const size_t base = ((size_t)q * v + row) * k;
#pragma unroll
    for (int i = 0; i < KMAX; ++i) {
      if (i < k) {
        store(z + base + i, i < taken ? zr[i] : big);
        s[base + i] = i < taken ? sr[i] : fill;
      }
    }
  }
}

template <int KMAX>
cudaError_t launch(const float* coords, const float* qc, const bool* qmask,
                   void* z, int* s, int nq, int v, int h, int m, int k,
                   float big, int out_bf16, cudaStream_t stream) {
  const dim3 grid((v + BV - 1) / BV, nq);
  if (out_bf16) {
    dist_topk_kernel<KMAX, __nv_bfloat16><<<grid, THREADS, 0, stream>>>(
        coords, qc, qmask, static_cast<__nv_bfloat16*>(z), s, v, h, m, k, big);
  } else {
    dist_topk_kernel<KMAX, float><<<grid, THREADS, 0, stream>>>(
        coords, qc, qmask, static_cast<float*>(z), s, v, h, m, k, big);
  }
  return cudaGetLastError();
}

}  // namespace

// coords (v, m) f32, qc (nq, h, m) f32, qmask (nq, h) bool, all contiguous;
// writes z (nq, v, k) f32 or bf16 and s (nq, v, k) int32. 1 <= k <= 16.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int dist_topk_launch(const void* coords, const void* qc,
                                const void* qmask, void* z, void* s, int nq,
                                int v, int h, int m, int k, float big,
                                int out_bf16, void* stream) {
  const float* c = static_cast<const float*>(coords);
  const float* q = static_cast<const float*>(qc);
  const bool* mk = static_cast<const bool*>(qmask);
  int* si = static_cast<int*>(s);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int bf = out_bf16;
  if (k <= 1) return launch<1>(c, q, mk, z, si, nq, v, h, m, k, big, bf, st);
  if (k <= 2) return launch<2>(c, q, mk, z, si, nq, v, h, m, k, big, bf, st);
  if (k <= 4) return launch<4>(c, q, mk, z, si, nq, v, h, m, k, big, bf, st);
  if (k <= 8) return launch<8>(c, q, mk, z, si, nq, v, h, m, k, big, bf, st);
  return launch<16>(c, q, mk, z, si, nq, v, h, m, k, big, bf, st);
}

extern "C" const char* dist_topk_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
