// dist_topk: fused Euclidean distance + row-top-k over a query batch
// (Phase 1 of batched LC-ACT / LC-RWMD), for sm_90a.
//
// Replaces the TPU kernel src/repro/kernels/dist_topk.py::dist_topk_pallas
// (body _dist_topk_kernel, selection _rowmin_extract). The plain PyTorch
// version is repro_torch/kernels/dist_topk.py::dist_topk_plain.
//
// Bound on an H100: float32 operations. The work is v*m multiply-adds
// (2*v*m operations) per VALID query bin -- 23.6 GFLOP for the 564 valid
// bins of a 16-query 20 Newsgroups batch, 334 GFLOP if all 16 x 500 were
// valid -- against 67 TFLOP/s of float32 outside the tensor cores. TF32 is
// ruled out: it drops mantissa bits, and identical coordinates must still
// snap to an exact zero. Bytes are small (coords once, Z/S once).
//
// Design. Two launches on one stream, no host sync.
//
// 1. compact_kernel (one block) lists the flat indices p = q*h + c of the
//    valid bins, ascending, their count C and their squared norms.
// 2. dist_topk_kernel: one block per tile of BV vocabulary rows and group
//    of queries. It walks its queries' stretch of the packed list (found by
//    binary search) in tiles of BH valid bins, so the bins of short
//    queries share a tile with those of the next query and no invalid bin
//    is computed (only the last tile is padded, with zero columns it never
//    selects). The queries are split into groups only as far as needed to
//    fill one wave of MIN_BLOCKS (3) blocks per SM: at 20 Newsgroups width
//    the 545 vocabulary tiles do that alone (one group), at MNIST width
//    (v = 784) the 7 tiles do not, and the query axis must fill the card.
//    A query's slots come out the same whatever its group (a one-query
//    launch is always one group). Each tile is a register-tiled SGEMM: the
//    embedding dimension streams through shared memory in chunks of BK, by
//    cp.async STAGES - 1 chunks ahead of the arithmetic and on across tile
//    boundaries (the next tile's copies overlap this tile's selection),
//    and every thread accumulates an 8 x BH/8 micro-tile (8 x 8 by
//    default) in float32 FMA, in ascending order of the dimension. The
//    squared norms (|a|^2 once per block, |b|^2 once per launch) are
//    summed by the same fmaf chain in the same order, so identical
//    coordinates produce bitwise-equal |a|^2, |b|^2 and a.b and their
//    distance is exactly 0. The tile's distances
//    go to shared memory; thread r then scans row r's columns in packed
//    order, inserting into KMAX running (value, column) registers with a
//    strict '<' -- the packed order is ascending within a query, so the
//    lowest column wins ties -- and, where the query changes, writes the
//    finished query's k slots and starts the next one. The TPU kernel's
//    sequential grid axis over h blocks is this loop over tiles. Selection
//    is float32; Z is cast to the storage type only on the store.
//
// Coordinates in bfloat16 (the bf16_agg policy; the JAX package casts
// coords and the query coordinates to bfloat16 before its kernel, which
// upcasts them): the same kernel reads 2-byte values, half the bytes, and
// upcasts each to float32 as it stages it in shared memory, so the norms,
// products, snap and selection are float32 on the rounded values and
// identical coordinates still give exactly 0. cp.async copies 4 bytes at
// least, so the bfloat16 chunks go through registers instead: each call
// of copy_next writes the chunk it loaded at the call before to shared
// memory and loads the next one, whose loads are then in flight during
// one chunk's arithmetic (the chunk ring holds the rest: a chunk is
// written two chunks before its turn).
//
// Degenerate rows (fewer than k valid bins, among them a query with none):
// slots past the valid bins get the sentinel `big` (passed in from
// pad_dist_for(out_dtype)) and the column min(lowest invalid column,
// lowest taken column) -- what the TPU kernel's masked-min rounds produce,
// since they mask both invalid and taken columns to the same sentinel. The
// lowest invalid column is at most the number of valid bins, so the block
// finds it by reading at most k + 1 entries of the query's mask.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <climits>

namespace {

// The tile knobs: a variant is built with -DDIST_TOPK_BV=... and
// -DDIST_TOPK_BH=... (kernels/_build.py); kernels/ops.py models each
// variant's shared memory and register cap. Neither changes the order of
// any sum: a.b runs over the dimension in ascending order in every micro-
// tile, and the selection scans the packed columns in order whatever the
// tile edges, so every variant's output is bitwise the default's.
#ifndef DIST_TOPK_BV
#define DIST_TOPK_BV 128
#endif
#ifndef DIST_TOPK_BH
#define DIST_TOPK_BH 64
#endif
constexpr int BV = DIST_TOPK_BV;   // vocabulary rows per block
constexpr int BH = DIST_TOPK_BH;   // packed valid bins per tile
constexpr int BK = 8;              // embedding dims staged per chunk
constexpr int STAGES = 4;          // chunks in flight (cp.async ring)
constexpr int THREADS = BV;        // (BV/8) x 8 threads, 8 x TN outputs each
constexpr int TN = BH / 8;         // micro-tile columns
// Blocks an SM should hold (__launch_bounds__): 384 threads, 3 blocks of
// the default 128, so the register cap stays at 168 a thread down to BV=64.
constexpr int MIN_BLOCKS = 384 / THREADS > 1 ? 384 / THREADS : 1;
constexpr int AP = BV + 4;         // padded strides: conflict-free stores,
constexpr int BP = BH + 4;         // 16-byte aligned float4 loads
constexpr int DP = BH + 1;
constexpr int RS = THREADS / BK;        // rows (columns) staged per pass
constexpr int LA = BV / RS;             // coords elements a thread stages
constexpr int LB = BH / RS;             // bin elements a thread stages
constexpr int COMPACT_THREADS = 1024;

static_assert(THREADS == BV, "thread r selects for row r");
static_assert(BV % 32 == 0 && BV <= 1024, "whole warps, at most 1024");
static_assert(BH % 32 == 0, "float4 column groups 32 apart");
static_assert(THREADS % BK == 0 && BV % RS == 0 && BH % RS == 0, "");

struct Smem {
  float a[STAGES][BK][AP];         // coords chunks, dims-major
  float b[STAGES][BK][BP];         // packed-bin chunks, dims-major
  float d[BV][DP];                 // the tile's distances
  float sa2[BV];                   // |row|^2
  float sb2[BH];                   // |bin|^2
  int tq[BH];                      // each tile column's query
  int tc[BH];                      // and its column within the query
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// 4-byte asynchronous copy global -> shared; zero-fills when !pred.
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool pred) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(pred ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The flat indices p = q*h + c of the true entries of qmask (total
// entries), ascending, into packed; their number into *count; and each
// listed bin's squared norm, summed with fmaf in ascending order of the
// dimension as the distance tiles sum a.b, into bnorm. One block.
template <typename TIn>
__global__ void __launch_bounds__(COMPACT_THREADS)
compact_kernel(const bool* __restrict__ qmask, const TIn* __restrict__ qc,
               int total, int m, int* __restrict__ packed,
               int* __restrict__ count, float* __restrict__ bnorm) {
  __shared__ int warp_base[COMPACT_THREADS / 32];
  __shared__ int chunk_total;
  const int tid = threadIdx.x, lane = tid % 32, w = tid / 32;
  int base = 0;
  for (int start = 0; start < total; start += COMPACT_THREADS) {
    const int i = start + tid;
    const bool f = i < total && qmask[i];
    const unsigned bal = __ballot_sync(0xffffffffu, f);
    if (lane == 0) warp_base[w] = __popc(bal);
    __syncthreads();
    if (w == 0) {
      const int n = warp_base[lane];
      int incl = n;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += y;
      }
      warp_base[lane] = incl - n;
      if (lane == 31) chunk_total = incl;
    }
    __syncthreads();
    if (f)
      packed[base + warp_base[w] + __popc(bal & ((1u << lane) - 1u))] = i;
    base += chunk_total;
    __syncthreads();               // warp_base and chunk_total reused
  }
  if (tid == 0) *count = base;
  for (int j = tid; j < base; j += COMPACT_THREADS) {
    const TIn* b = qc + (size_t)packed[j] * m;
    float nrm = 0.f;
    for (int kk = 0; kk < m; ++kk) {
      const float x = to_f(b[kk]);
      nrm = fmaf(x, x, nrm);
    }
    bnorm[j] = nrm;
  }
}

// The first index j in [0, n) with a[j] >= x (a ascending), else n.
__device__ __forceinline__ int lower_bound(const int* __restrict__ a, int n,
                                           int x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < x) lo = mid + 1; else hi = mid;
  }
  return lo;
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

// Write query q's k slots of row `row` (row < v) from the selection state,
// then reset it. `taken` valid bins were inserted; the degenerate-row rule
// fills the slots past them. Uniform across the block.
template <int KMAX, typename OutT>
__device__ __forceinline__ void flush(float (&zr)[KMAX], int (&sr)[KMAX],
                                      int taken, int q, int row,
                                      const bool* __restrict__ qmask,
                                      OutT* __restrict__ z,
                                      int* __restrict__ s, int v, int h,
                                      int k, float big) {
  int fill = INT_MAX;
  if (taken < k) {
    // The lowest invalid column: among the first taken + 1 (or it is none).
    const bool* mq = qmask + (size_t)q * h;
    for (int c = 0; c <= taken && c < h; ++c) {
      if (!mq[c]) { fill = c; break; }
    }
  }
  taken = min(taken, k);
#pragma unroll
  for (int i = 0; i < KMAX; ++i)
    if (i < taken) fill = min(fill, sr[i]);
  if (row < v) {
    const size_t base = ((size_t)q * v + row) * k;
#pragma unroll
    for (int i = 0; i < KMAX; ++i) {
      if (i < k) {
        store(z + base + i, i < taken ? zr[i] : big);
        s[base + i] = i < taken ? sr[i] : fill;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < KMAX; ++i) { zr[i] = CUDART_INF_F; sr[i] = INT_MAX; }
}

// MIN_BLOCKS blocks on an SM: 168 registers a thread at most by default.
template <int KMAX, typename TIn, typename OutT>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
dist_topk_kernel(const TIn* __restrict__ coords,
                 const TIn* __restrict__ qc,
                 const bool* __restrict__ qmask,
                 const int* __restrict__ packed,
                 const int* __restrict__ count,
                 const float* __restrict__ bnorm, OutT* __restrict__ z,
                 int* __restrict__ s, int nq, int v, int h, int m, int k,
                 int qpb, float big) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);

  const int tid = threadIdx.x;
  const int tx = tid % 8, ty = tid / 8;
  const int row0 = blockIdx.x * BV;
  // This block's queries [q_lo, q_hi) and their valid bins, the packed
  // entries [jlo, jlo + nvalid) (uniform across the block).
  const int q_lo = blockIdx.y * qpb, q_hi = min(nq, q_lo + qpb);
  const int jlo = lower_bound(packed, *count, q_lo * h);
  const int nvalid = lower_bound(packed, *count, q_hi * h) - jlo;
  packed += jlo;
  bnorm += jlo;
  const int nchunks = (m + BK - 1) / BK;
  const int ntiles = (nvalid + BH - 1) / BH;

  // The block's work is one stream of chunks, tile after tile; the copies
  // run STAGES - 1 chunks ahead of the arithmetic, across tile boundaries.
  // Thread tid copies dim tid % BK of rows tid/BK + RS i and of tile
  // columns tid/BK + RS i.
  const int skk = tid % BK, sr0 = tid / BK;
  int it = 0, ic = 0, ib = 0;      // the next chunk to copy: tile, chunk, slot
  int ptile = -1;                  // the tile whose packed ids are in pk
  int pk[LB];
  constexpr bool kBf16 = sizeof(TIn) == 2;
  // bfloat16: the chunk loaded at the last call, bound for slot pib.
  TIn ra[kBf16 ? LA : 1], rb[kBf16 ? LB : 1];
  int pib = -1;
  auto copy_next = [&]() {
    if constexpr (kBf16) {
      if (pib >= 0) {
#pragma unroll
        for (int i = 0; i < LA; ++i)
          sm.a[pib][skk][sr0 + RS * i] = to_f(ra[i]);
#pragma unroll
        for (int i = 0; i < LB; ++i)
          sm.b[pib][skk][sr0 + RS * i] = to_f(rb[i]);
        pib = -1;
      }
    }
    if (it < ntiles) {
      const int gk = ic * BK + skk;
      if (it != ptile) {
        ptile = it;
#pragma unroll
        for (int i = 0; i < LB; ++i) {
          const int j = it * BH + sr0 + RS * i;
          pk[i] = j < nvalid ? packed[j] : -1;
        }
      }
      if constexpr (kBf16) {
        const TIn zero = __float2bfloat16_rn(0.f);
#pragma unroll
        for (int i = 0; i < LA; ++i) {
          const int gr = row0 + sr0 + RS * i;
          ra[i] = gr < v && gk < m ? coords[(size_t)gr * m + gk] : zero;
        }
#pragma unroll
        for (int i = 0; i < LB; ++i)
          rb[i] = pk[i] >= 0 && gk < m ? qc[(size_t)pk[i] * m + gk] : zero;
        pib = ib;
      } else {
#pragma unroll
        for (int i = 0; i < LA; ++i) {
          const int gr = row0 + sr0 + RS * i;
          const bool ok = gr < v && gk < m;
          cp_async4(&sm.a[ib][skk][sr0 + RS * i],
                    ok ? coords + (size_t)gr * m + gk : coords, ok);
        }
#pragma unroll
        for (int i = 0; i < LB; ++i) {
          const bool ok = pk[i] >= 0 && gk < m;
          cp_async4(&sm.b[ib][skk][sr0 + RS * i],
                    ok ? qc + (size_t)pk[i] * m + gk : qc, ok);
        }
      }
      if (++ic == nchunks) { ic = 0; ++it; }
      ib = ib + 1 == STAGES ? 0 : ib + 1;
    }
    cp_async_commit();             // a group per chunk, empty or not
  };

  // Selection state of row row0 + tid, for query cur_q.
  float zr[KMAX];
  int sr[KMAX];
#pragma unroll
  for (int i = 0; i < KMAX; ++i) { zr[i] = CUDART_INF_F; sr[i] = INT_MAX; }
  int cur_q = q_lo, taken = 0;

  float acc[8][TN];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) copy_next();
  {
    // |row|^2 of row row0 + tid, in the order of the tiles' a.b sums.
    const int row = row0 + tid;
    float na = 0.f;
    if (row < v) {
      const TIn* a = coords + (size_t)row * m;
      for (int kk = 0; kk < m; ++kk) {
        const float x = to_f(a[kk]);
        na = fmaf(x, x, na);
      }
    }
    sm.sa2[tid] = na;              // read after the loop's first barrier
  }
  int buf = 0;
  for (int tile = 0; tile < ntiles; ++tile) {
    for (int ch = 0; ch < nchunks; ++ch) {
      cp_async_wait<STAGES - 2>();   // this thread's copies of this chunk
      __syncthreads();               // everyone's; the last chunk's slot free
      copy_next();
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        // Rows ty*4.. and BV/2 + ty*4..; columns g*32 + tx*4.. per group g.
        float a[8], b[TN];
        const float4 a0 =
            *reinterpret_cast<const float4*>(&sm.a[buf][kk][ty * 4]);
        const float4 a1 =
            *reinterpret_cast<const float4*>(&sm.a[buf][kk][BV / 2 + ty * 4]);
        a[0] = a0.x; a[1] = a0.y; a[2] = a0.z; a[3] = a0.w;
        a[4] = a1.x; a[5] = a1.y; a[6] = a1.z; a[7] = a1.w;
#pragma unroll
        for (int g = 0; g < TN / 4; ++g) {
          const float4 bg = *reinterpret_cast<const float4*>(
              &sm.b[buf][kk][g * 32 + tx * 4]);
          b[4 * g] = bg.x; b[4 * g + 1] = bg.y;
          b[4 * g + 2] = bg.z; b[4 * g + 3] = bg.w;
        }
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      buf = buf + 1 == STAGES ? 0 : buf + 1;
    }

    // The tile is complete (the next tile's chunks are in flight).
    const int t0 = tile * BH;
    for (int c = tid; c < BH; c += THREADS) {
      const int j = t0 + c;
      const int p = j < nvalid ? packed[j] : 0;
      sm.sb2[c] = j < nvalid ? bnorm[j] : 0.f;
      sm.tq[c] = p / h;
      sm.tc[c] = p - (p / h) * h;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = (i < 4 ? 0 : BV / 2) + ty * 4 + (i % 4);
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int c = (j / 4) * 32 + tx * 4 + (j % 4);
        const float n2 = __fadd_rn(sm.sa2[r], sm.sb2[c]);
        float d = __fsub_rn(n2, __fmul_rn(2.f, acc[i][j]));
        d = fmaxf(d, 0.f);
        if (d < __fmul_rn(1e-6f, n2)) d = 0.f;   // relative ZERO_SNAP
        sm.d[r][c] = sqrtf(d);
        acc[i][j] = 0.f;
      }
    }
    __syncthreads();

    // Selection of row row0 + tid over the tile's columns, in packed order.
    // (sm.d, sb2, tq, tc are next written after a later barrier.)
    const int ncol = min(BH, nvalid - t0);
    const int row = row0 + tid;
    for (int c = 0; c < ncol; ++c) {
      const int q = sm.tq[c];
      while (cur_q < q) {          // the query changes: write it out
        flush<KMAX>(zr, sr, taken, cur_q, row, qmask, z, s, v, h, k, big);
        ++cur_q;
        taken = 0;
      }
      insert<KMAX>(zr, sr, sm.d[tid][c], sm.tc[c]);
      ++taken;
    }
  }
  cp_async_wait<0>();
  // The group's last query with valid bins, and every query after it.
  for (; cur_q < q_hi; ++cur_q, taken = 0)
    flush<KMAX>(zr, sr, taken, cur_q, row0 + tid, qmask, z, s, v, h, k, big);
}

template <int KMAX, typename TIn, typename OutT>
cudaError_t launch_main(const TIn* coords, const TIn* qc,
                        const bool* qmask, const int* packed,
                        const int* count, const float* bnorm, OutT* z,
                        int* s, int nq, int v, int h, int m, int k, float big,
                        cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      dist_topk_kernel<KMAX, TIn, OutT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sizeof(Smem));
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device)) != cudaSuccess)
    return err;
  // Query groups: as few as fill one wave of MIN_BLOCKS blocks per SM with the
  // vocabulary tiles, at most one per query. (Two groups of the 16-query
  // 20 Newsgroups batch, 2.75 waves, took 7% longer than one group, 1.4
  // waves, on an H100.)
  const int gx = (v + BV - 1) / BV;
  const int groups = min(nq, max(1, (MIN_BLOCKS * sms + gx - 1) / gx));
  const int qpb = (nq + groups - 1) / groups;
  const dim3 grid(gx, (nq + qpb - 1) / qpb);
  dist_topk_kernel<KMAX, TIn, OutT><<<grid, THREADS, sizeof(Smem), stream>>>(
      coords, qc, qmask, packed, count, bnorm, z, s, nq, v, h, m, k, qpb,
      big);
  return cudaGetLastError();
}

template <int KMAX, typename TIn>
cudaError_t launch(const TIn* coords, const TIn* qc, const bool* qmask,
                   int* packed, int* count, float* bnorm, void* z, int* s,
                   int nq, int v, int h, int m, int k, float big,
                   int out_bf16, cudaStream_t stream) {
  compact_kernel<TIn><<<1, COMPACT_THREADS, 0, stream>>>(
      qmask, qc, nq * h, m, packed, count, bnorm);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (out_bf16)
    return launch_main<KMAX>(coords, qc, qmask, packed, count, bnorm,
                             static_cast<__nv_bfloat16*>(z), s, nq, v, h, m,
                             k, big, stream);
  return launch_main<KMAX>(coords, qc, qmask, packed, count, bnorm,
                           static_cast<float*>(z), s, nq, v, h, m, k, big,
                           stream);
}

}  // namespace

// coords (v, m) and qc (nq, h, m) both f32 or both bf16 (in_bf16), qmask
// (nq, h) bool, all contiguous;
// scratch packed (nq*h) int32, count (1) int32 and bnorm (nq*h) f32;
// writes z (nq, v, k) f32 or bf16 and s (nq, v, k) int32. 1 <= k <= 16,
// nq*h < 2^31, nq <= 65535. Returns the cudaError_t of the launches (0 on
// success).
extern "C" int dist_topk_launch(const void* coords, const void* qc,
                                const void* qmask, void* packed, void* count,
                                void* bnorm, void* z, void* s, int nq, int v,
                                int h, int m, int k, float big, int in_bf16,
                                int out_bf16, void* stream) {
  const bool* mk = static_cast<const bool*>(qmask);
  int* pk = static_cast<int*>(packed);
  int* cn = static_cast<int*>(count);
  float* bn = static_cast<float*>(bnorm);
  int* si = static_cast<int*>(s);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int bf = out_bf16;
#define DIST_TOPK_LAUNCH(KM, T)                                             \
  launch<KM>(static_cast<const T*>(coords), static_cast<const T*>(qc), mk, \
             pk, cn, bn, z, si, nq, v, h, m, k, big, bf, st)
#define DIST_TOPK_BY_K(T)                      \
  if (k <= 1) return DIST_TOPK_LAUNCH(1, T);   \
  if (k <= 2) return DIST_TOPK_LAUNCH(2, T);   \
  if (k <= 4) return DIST_TOPK_LAUNCH(4, T);   \
  if (k <= 8) return DIST_TOPK_LAUNCH(8, T);   \
  return DIST_TOPK_LAUNCH(16, T);
  if (in_bf16) {
    DIST_TOPK_BY_K(__nv_bfloat16)
  }
  DIST_TOPK_BY_K(float)
#undef DIST_TOPK_BY_K
#undef DIST_TOPK_LAUNCH
}

// The compiler's figures for the kernel that dist_topk_launch runs at this
// k and these dtypes: out = {static shared bytes, dynamic shared bytes the
// launch requests, registers a thread, local (spill) bytes a thread, most
// threads a block}. Returns the cudaError_t (0 on success).
template <int KMAX, typename TIn, typename OutT>
int attrs_of(int* out) {
  cudaFuncAttributes a;
  const cudaError_t err =
      cudaFuncGetAttributes(&a, dist_topk_kernel<KMAX, TIn, OutT>);
  if (err != cudaSuccess) return err;
  out[0] = (int)a.sharedSizeBytes;
  out[1] = (int)sizeof(Smem);
  out[2] = a.numRegs;
  out[3] = (int)a.localSizeBytes;
  out[4] = a.maxThreadsPerBlock;
  return 0;
}

template <int KMAX>
int attrs_k(int in_bf16, int out_bf16, int* out) {
  if (in_bf16)
    return out_bf16 ? attrs_of<KMAX, __nv_bfloat16, __nv_bfloat16>(out)
                    : attrs_of<KMAX, __nv_bfloat16, float>(out);
  return out_bf16 ? attrs_of<KMAX, float, __nv_bfloat16>(out)
                  : attrs_of<KMAX, float, float>(out);
}

extern "C" int dist_topk_attrs(int k, int in_bf16, int out_bf16, int* out) {
  if (k <= 1) return attrs_k<1>(in_bf16, out_bf16, out);
  if (k <= 2) return attrs_k<2>(in_bf16, out_bf16, out);
  if (k <= 4) return attrs_k<4>(in_bf16, out_bf16, out);
  if (k <= 8) return attrs_k<8>(in_bf16, out_bf16, out);
  return attrs_k<16>(in_bf16, out_bf16, out);
}

extern "C" const char* dist_topk_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
