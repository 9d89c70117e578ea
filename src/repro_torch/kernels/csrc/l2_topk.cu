// Fused L2 scan + exact top-k for Hopper (sm_90a).
//
// For each query q and corpus row j: score = 2 q.d_j - dsq_j (float32, one
// fmaf per term in increasing dimension order; dsq_j = |d_j|^2, or a large
// penalty for rows that must never win, is computed once per corpus by the
// caller). Returns, per query, the k best pairs of the multiset
//   {(score_j, j) : j < N}  U  {k copies of (NEG_INF, -1)}
// under the total order (score descending, id ascending). The k pad pairs
// give k > N its (NEG_INF, -1) tail, and make a penalised row (score about
// -1e30) lose to a pad, as the TPU kernel's running merge does.
//
// Replaces the TPU kernel l2_topk_pallas (src/repro/kernels/l2_topk/
// kernel.py), whose per-tile k sweeps of max/argmax/mask carry a running
// top-k across a sequential grid. Blocks on the card run in parallel, so:
//   pass 1: block (query tile, corpus chunk) scores its chunk tile by tile
//           and keeps, per query, a candidate buffer in shared memory with a
//           threshold (the current k-th best pair). A score that beats the
//           threshold is appended; when a buffer could overflow on the next
//           tile, all buffers of the block are bitonic-sorted, cut to k, and
//           the thresholds rise. Each (query, chunk) writes its k best.
//   pass 2: one block per query merges the chunk lists with the same
//           buffered selection (skipped when there is a single chunk).
// Bound: at the port's shapes (d = 64, Q = 256) the scan does 2*Q*N*d FLOPs
// against 4*N*d bytes of corpus, far above the float32 ridge, so it is bound
// by float32 operations; the selection is mostly one compare a score, since
// after the first tiles few scores beat the threshold.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;
constexpr int kDK = 32;           // dimension slice staged in shared memory
constexpr float kNegInf = -1e30f; // NEG_INF of kernels/common.py
constexpr int kPadId = -1;
constexpr int kEmptyId = 0x7fffffff;

__device__ __forceinline__ bool better(float v1, int i1, float v2, int i2) {
  return v1 > v2 || (v1 == v2 && i1 < i2);
}

// Sort each of the nq buffers of cap pairs (best first), cut it to k pairs
// and set its threshold to the k-th pair. Every buffer holds >= k pairs.
__device__ void flush_all(float* bv, int* bi, int* cnt, float* tv, int* ti,
                          int nq, int cap, int k) {
  const int tid = threadIdx.x;
  for (int p = tid; p < nq * cap; p += kThreads) {
    if (p % cap >= cnt[p / cap]) {
      bv[p] = -CUDART_INF_F;
      bi[p] = kEmptyId;
    }
  }
  __syncthreads();
  const int half = cap / 2;
  for (int size = 2; size <= cap; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = tid; t < nq * half; t += kThreads) {
        const int base = (t / half) * cap;
        const int u = t % half;
        const int i = 2 * u - (u & (stride - 1));
        const int j = i + stride;
        const bool best_first = (i & size) == 0;
        const float vi = bv[base + i], vj = bv[base + j];
        const int ii = bi[base + i], ij = bi[base + j];
        const bool swap = best_first ? better(vj, ij, vi, ii)
                                     : better(vi, ii, vj, ij);
        if (swap) {
          bv[base + i] = vj; bv[base + j] = vi;
          bi[base + i] = ij; bi[base + j] = ii;
        }
      }
      __syncthreads();
    }
  }
  for (int q = tid; q < nq; q += kThreads) {
    cnt[q] = k;
    tv[q] = bv[q * cap + k - 1];
    ti[q] = bi[q * cap + k - 1];
  }
  __syncthreads();
}

__device__ void init_buffers(float* bv, int* bi, int* cnt, float* tv, int* ti,
                             int nq, int cap, int k) {
  for (int p = threadIdx.x; p < nq * cap; p += kThreads) {
    const bool pad = p % cap < k;
    bv[p] = pad ? kNegInf : -CUDART_INF_F;
    bi[p] = pad ? kPadId : kEmptyId;
  }
  for (int q = threadIdx.x; q < nq; q += kThreads) {
    cnt[q] = k;
    tv[q] = kNegInf;
    ti[q] = kPadId;
  }
  __syncthreads();
}

// Pass 1. Block (blockIdx.x, blockIdx.y) = (query tile of BQ, corpus chunk
// of `chunk` rows). Threads form TY x TX with TY = BQ / TQ; thread (ty, tx)
// scores queries ty + TY*a (a < TQ) against tile rows tx + TX*b (b < TR).
// Writes k pairs per (query, chunk) at out[q * out_stride + chunk * k].
template <int BQ, int TQ, int TR>
__global__ void __launch_bounds__(kThreads)
l2_topk_scan_kernel(const float* __restrict__ q, const float* __restrict__ db,
                    const float* __restrict__ dsq, int nq_total, int n_rows,
                    int d, int k, int cap, int chunk, long long out_stride,
                    float* __restrict__ out_v, int* __restrict__ out_i) {
  constexpr int TY = BQ / TQ;
  constexpr int TX = kThreads / TY;
  constexpr int BN = TX * TR;
  extern __shared__ unsigned char smem[];
  float* bv = reinterpret_cast<float*>(smem);
  int* bi = reinterpret_cast<int*>(bv + BQ * cap);
  __shared__ float qs[BQ][kDK + 1];
  __shared__ float ds[kDK][BN + 1];
  __shared__ int cnt[BQ];
  __shared__ float tv[BQ];
  __shared__ int ti[BQ];
  __shared__ int need_flush;

  const int tid = threadIdx.x;
  const int ty = tid / TX;
  const int tx = tid % TX;
  const int q0 = blockIdx.x * BQ;
  const long long r_begin = (long long)blockIdx.y * chunk;
  const long long r_end = min((long long)n_rows, r_begin + chunk);

  init_buffers(bv, bi, cnt, tv, ti, BQ, cap, k);
  if (tid == 0) need_flush = 0;
  __syncthreads();

  for (long long r0 = r_begin; r0 < r_end; r0 += BN) {
    float acc[TQ][TR];
#pragma unroll
    for (int a = 0; a < TQ; ++a)
#pragma unroll
      for (int b = 0; b < TR; ++b) acc[a][b] = 0.0f;

    for (int k0 = 0; k0 < d; k0 += kDK) {
      for (int p = tid; p < BQ * kDK; p += kThreads) {
        const int a = p / kDK, kk = p % kDK;
        const int gq = q0 + a, gk = k0 + kk;
        qs[a][kk] = (gq < nq_total && gk < d) ? q[(long long)gq * d + gk] : 0.f;
      }
      for (int p = tid; p < BN * kDK; p += kThreads) {
        const int r = p / kDK, kk = p % kDK;
        const long long gr = r0 + r;
        const int gk = k0 + kk;
        ds[kk][r] = (gr < r_end && gk < d) ? db[gr * d + gk] : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < kDK; ++kk) {
        float av[TQ], bw[TR];
#pragma unroll
        for (int a = 0; a < TQ; ++a) av[a] = qs[ty + TY * a][kk];
#pragma unroll
        for (int b = 0; b < TR; ++b) bw[b] = ds[kk][tx + TX * b];
#pragma unroll
        for (int a = 0; a < TQ; ++a)
#pragma unroll
          for (int b = 0; b < TR; ++b) acc[a][b] = fmaf(av[a], bw[b], acc[a][b]);
      }
      __syncthreads();
    }

#pragma unroll
    for (int a = 0; a < TQ; ++a) {
      const int qa = ty + TY * a;
      if (q0 + qa >= nq_total) continue;
      const float t_v = tv[qa];
      const int t_i = ti[qa];
#pragma unroll
      for (int b = 0; b < TR; ++b) {
        const long long gr = r0 + tx + TX * b;
        if (gr >= r_end) continue;
        const float s = 2.0f * acc[a][b] - dsq[gr];
        if (better(s, (int)gr, t_v, t_i)) {
          const int pos = atomicAdd(&cnt[qa], 1);
          bv[qa * cap + pos] = s;
          bi[qa * cap + pos] = (int)gr;
        }
      }
    }
    __syncthreads();
    // a buffer that could not take a whole next tile is flushed (all are)
    if (tid < BQ && cnt[tid] + BN > cap) need_flush = 1;
    __syncthreads();
    if (need_flush) {
      flush_all(bv, bi, cnt, tv, ti, BQ, cap, k);
      if (tid == 0) need_flush = 0;
      __syncthreads();
    }
  }

  flush_all(bv, bi, cnt, tv, ti, BQ, cap, k);
  for (int p = tid; p < BQ * k; p += kThreads) {
    const int a = p / k, s = p % k;
    if (q0 + a >= nq_total) continue;
    const long long o = (long long)(q0 + a) * out_stride +
                        (long long)blockIdx.y * k + s;
    out_v[o] = bv[a * cap + s];
    out_i[o] = bi[a * cap + s];
  }
}

// Pass 2: block q merges its L = chunks * k candidate pairs into k.
__global__ void __launch_bounds__(kThreads)
l2_topk_merge_kernel(const float* __restrict__ in_v,
                     const int* __restrict__ in_i, long long len, int k,
                     int cap, float* __restrict__ out_v,
                     int* __restrict__ out_i) {
  extern __shared__ unsigned char smem[];
  float* bv = reinterpret_cast<float*>(smem);
  int* bi = reinterpret_cast<int*>(bv + cap);
  __shared__ int cnt[1];
  __shared__ float tv[1];
  __shared__ int ti[1];
  const long long qb = (long long)blockIdx.x;
  const float* iv = in_v + qb * len;
  const int* ii = in_i + qb * len;

  init_buffers(bv, bi, cnt, tv, ti, 1, cap, k);
  for (long long j0 = 0; j0 < len; j0 += kThreads) {
    const long long j = j0 + threadIdx.x;
    const float t_v = tv[0];
    const int t_i = ti[0];
    if (j < len) {
      const float v = iv[j];
      const int id = ii[j];
      if (better(v, id, t_v, t_i)) {
        const int pos = atomicAdd(&cnt[0], 1);
        bv[pos] = v;
        bi[pos] = id;
      }
    }
    __syncthreads();
    const bool full = cnt[0] + kThreads > cap;
    __syncthreads();  // every thread has read cnt before it can change
    if (full) flush_all(bv, bi, cnt, tv, ti, 1, cap, k);
  }
  flush_all(bv, bi, cnt, tv, ti, 1, cap, k);
  for (int s = threadIdx.x; s < k; s += kThreads) {
    out_v[qb * k + s] = bv[s];
    out_i[qb * k + s] = bi[s];
  }
}

int next_pow2(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

template <int BQ, int TQ, int TR>
int launch_scan(const float* q, const float* db, const float* dsq, int nq,
                int n, int d, int k, int cap, int chunk, int chunks,
                long long out_stride, float* out_v, int* out_i,
                cudaStream_t stream) {
  auto kern = l2_topk_scan_kernel<BQ, TQ, TR>;
  const int smem = BQ * cap * 8;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((nq + BQ - 1) / BQ, chunks);
  kern<<<grid, kThreads, smem, stream>>>(q, db, dsq, nq, n, d, k, cap, chunk,
                                         out_stride, out_v, out_i);
  return (int)cudaGetLastError();
}

}  // namespace

// Tile geometry for k: which configuration runs, its query tile, its
// candidate-buffer size. Returns 0, or -1 when k is above kMaxK.
// Configurations (BQ, TQ, TR), all with a 64-row corpus tile:
//   0: (32, 2, 4) for cap <= 256;  1: (8, 1, 2) for cap <= 2048;
//   2: (4, 1, 1) for cap <= 4096.
extern "C" int l2_topk_plan(int k, int* config, int* bq, int* cap) {
  const int bn = 64;
  int c = next_pow2(k + bn);
  if (c <= 256) { *config = 0; *bq = 32; *cap = 256; return 0; }
  if (c <= 2048) { *config = 1; *bq = 8; *cap = c; return 0; }
  if (c <= 4096) { *config = 2; *bq = 4; *cap = c; return 0; }
  return -1;
}

extern "C" int l2_topk_max_k() { return 4096 - 64; }

// Pass 1 (and, when chunks > 1, pass 2 into out). part_v/part_i hold
// nq * chunks * k pairs of scratch when chunks > 1 (unused otherwise).
// Returns the first cudaError_t met, -1 for an unsupported k.
extern "C" int l2_topk_launch(const float* q, const float* db,
                              const float* dsq, int nq, int n, int d, int k,
                              int chunk, int chunks, float* part_v,
                              int* part_i, float* out_v, int* out_i,
                              void* stream) {
  if (nq == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  int config, bq, cap;
  if (l2_topk_plan(k, &config, &bq, &cap) != 0) return -1;
  const bool merge = chunks > 1;
  float* pv = merge ? part_v : out_v;
  int* pi = merge ? part_i : out_i;
  const long long stride = (long long)chunks * k;
  int e;
  if (config == 0)
    e = launch_scan<32, 2, 4>(q, db, dsq, nq, n, d, k, cap, chunk, chunks,
                              stride, pv, pi, s);
  else if (config == 1)
    e = launch_scan<8, 1, 2>(q, db, dsq, nq, n, d, k, cap, chunk, chunks,
                             stride, pv, pi, s);
  else
    e = launch_scan<4, 1, 1>(q, db, dsq, nq, n, d, k, cap, chunk, chunks,
                             stride, pv, pi, s);
  if (e != 0 || !merge) return e;
  const int cap2 = next_pow2(k + kThreads);
  const int smem2 = cap2 * 8;
  cudaError_t ce = cudaFuncSetAttribute(
      l2_topk_merge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem2);
  if (ce != cudaSuccess) return (int)ce;
  l2_topk_merge_kernel<<<nq, kThreads, smem2, s>>>(part_v, part_i, stride, k,
                                                   cap2, out_v, out_i);
  return (int)cudaGetLastError();
}
