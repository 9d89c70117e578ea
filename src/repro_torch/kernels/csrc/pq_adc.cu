// PQ ADC scan + exact top-k for Hopper (sm_90a).
//
// For each query q (d = m * dsub floats) and stored code row j (m uint8
// codes, one per subspace):
//   lut[q, mm, c] = (|q_mm|^2 - 2 q_mm.cb[mm, c]) + |cb[mm, c]|^2
//   score[q, j]   = -(sum over mm of lut[q, mm, codes[j, mm]])
// and per query the k best pairs (score, j) under the total order (score
// descending, id ascending), k <= N. Every sum (over dsub in the LUT, over
// m in the score) is the balanced pairwise tree of the plain version's
// pairwise_sum, with __fmul_rn / __fadd_rn so nvcc contracts nothing into
// an FMA: the kernel and its plain version (kernels/pq_adc/ref.py, through
// search/quantize.py:adc_lut) agree bit for bit.
//
// Replaces the TPU kernel pq_adc_pallas (src/repro/kernels/pq_adc/kernel.py:
// 71), which builds the LUT once per query block in VMEM, gathers it by a
// one-hot [bn, m*ksub] matmul on the MXU (a TPU has no fast gather) and
// carries l2_topk's k sweeps of max/argmax/mask across a sequential grid.
// On the card:
//   pass 0: one block per query writes its LUT (m*ksub floats, 8 KB at
//           PQ8x8) to a scratch buffer;
//   pass 1: block (query tile of BQ, code chunk) holds the tile's LUTs in
//           shared memory and looks entries up by plain indexed reads. It
//           stages each tile of BN code rows in shared memory; thread t of
//           1024 scores row t % BN against queries t / BN, t / BN + 1024 /
//           BN, ... (a PQ8 row's codes held in registers) and keeps, per
//           query, l2_topk's threshold-filtered candidate buffer with a
//           bitonic flush. The LUTs and buffers take 64-200 KB, so one block
//           fills an SM: 1024 threads give it 32 warps to hide the
//           shared-memory latency. Each (query, chunk) writes its k best.
//   pass 2: one block per query merges the chunk lists with the same
//           buffered selection (skipped when there is a single chunk).
// Empty slots are (-inf, INT_MAX): they lose to every real row, even one
// that scores -inf, and never reach the output since k <= N.
// Bound: at the main path's shapes (Q = 256, N = 1M, m = 8) the scan reads
// 8 MB of codes and does Q*N*m adds; the operations bound it. The adds are
// LUT lookups in shared memory, random by construction, so bank conflicts
// and the selection set the pace, not the adds.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;      // the LUT and merge passes
constexpr int kScanThreads = 1024; // the scan: 32 warps, as 1 block fills an SM
constexpr int kMaxBQ = 8;
constexpr int kEmptyId = 0x7fffffff;
constexpr int kMaxLevels = 20;  // log2 of the widest tree + 1
constexpr int kMaxCap = 4096;   // candidate buffer: k + BN pairs, pow2

__device__ __forceinline__ bool better(float v1, int i1, float v2, int i2) {
  return v1 > v2 || (v1 == v2 && i1 < i2);
}

// Balanced pairwise tree of a[i] * b[i] over i < n, zero-padded to a power
// of two (pairwise_sum's tree), by a cascade: level l of `part` holds the
// sum of the last complete aligned run of 2^l products.
__device__ float tree_dot(const float* a, const float* b, int n) {
  int p = 1;
  while (p < n) p <<= 1;
  float part[kMaxLevels];
  for (int t = 0; t < p; ++t) {
    float v = t < n ? __fmul_rn(a[t], b[t]) : 0.0f;
    int level = 0;
    for (int s = t; s & 1; s >>= 1) v = __fadd_rn(part[level++], v);
    part[level] = v;
  }
  return part[31 - __clz(p)];
}

// The distance of a PQ8 code row held in registers (byte mm of the pair
// is subspace mm): the pairwise tree over its 8 looked-up entries.
__device__ __forceinline__ float tree_lut8(const float* lut, uint2 c,
                                           int ksub) {
  const float a0 = lut[c.x & 0xff], a1 = lut[ksub + ((c.x >> 8) & 0xff)];
  const float a2 = lut[2 * ksub + ((c.x >> 16) & 0xff)];
  const float a3 = lut[3 * ksub + (c.x >> 24)];
  const float a4 = lut[4 * ksub + (c.y & 0xff)];
  const float a5 = lut[5 * ksub + ((c.y >> 8) & 0xff)];
  const float a6 = lut[6 * ksub + ((c.y >> 16) & 0xff)];
  const float a7 = lut[7 * ksub + (c.y >> 24)];
  return __fadd_rn(__fadd_rn(__fadd_rn(a0, a1), __fadd_rn(a2, a3)),
                   __fadd_rn(__fadd_rn(a4, a5), __fadd_rn(a6, a7)));
}

// The distance of one code row: pairwise tree over the m looked-up entries.
__device__ __forceinline__ float tree_lut(const float* lut,
                                          const unsigned char* c, int m,
                                          int ksub) {
  int p = 1;
  while (p < m) p <<= 1;
  float part[kMaxLevels];
  for (int t = 0; t < p; ++t) {
    float v = t < m ? lut[t * ksub + c[t]] : 0.0f;
    int level = 0;
    for (int s = t; s & 1; s >>= 1) v = __fadd_rn(part[level++], v);
    part[level] = v;
  }
  return part[31 - __clz(p)];
}

// Pass 0: block r writes lut[r, mm * ksub + j] for every (mm, j).
__global__ void __launch_bounds__(kThreads)
pq_lut_kernel(const float* __restrict__ q, const float* __restrict__ cb,
              int m, int ksub, int dsub, float* __restrict__ lut) {
  const int r = blockIdx.x;
  const int width = m * ksub;
  const float* qrow = q + (size_t)r * m * dsub;
  for (int e = threadIdx.x; e < width; e += kThreads) {
    const int mm = e / ksub;
    const float* qs = qrow + (size_t)mm * dsub;
    const float* c = cb + (size_t)e * dsub;
    const float qq = tree_dot(qs, qs, dsub);
    const float qc = tree_dot(qs, c, dsub);
    const float cc = tree_dot(c, c, dsub);
    lut[(size_t)r * width + e] =
        __fadd_rn(__fsub_rn(qq, __fmul_rn(2.0f, qc)), cc);
  }
}

// Sort each of the nq buffers of cap pairs (best first), cut it to k pairs
// and set its threshold to the k-th pair. Every buffer holds >= k pairs.
__device__ void flush_all(float* bv, int* bi, int* cnt, float* tv, int* ti,
                          int nq, int cap, int k) {
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int p = tid; p < nq * cap; p += nt) {
    if (p % cap >= cnt[p / cap]) {
      bv[p] = -CUDART_INF_F;
      bi[p] = kEmptyId;
    }
  }
  __syncthreads();
  const int half = cap / 2;
  for (int size = 2; size <= cap; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = tid; t < nq * half; t += nt) {
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
  for (int q = tid; q < nq; q += nt) {
    cnt[q] = k;
    tv[q] = bv[q * cap + k - 1];
    ti[q] = bi[q * cap + k - 1];
  }
  __syncthreads();
}

// Every buffer starts with k empty pairs and its threshold at one.
__device__ void init_buffers(float* bv, int* bi, int* cnt, float* tv, int* ti,
                             int nq, int cap, int k) {
  for (int p = threadIdx.x; p < nq * cap; p += blockDim.x) {
    bv[p] = -CUDART_INF_F;
    bi[p] = kEmptyId;
  }
  for (int q = threadIdx.x; q < nq; q += blockDim.x) {
    cnt[q] = k;
    tv[q] = -CUDART_INF_F;
    ti[q] = kEmptyId;
  }
  __syncthreads();
}

// Pass 1. Block (blockIdx.x, blockIdx.y) = (query tile of bq, code chunk of
// `chunk` rows). Dynamic shared memory: the tile's LUTs [bq][m*ksub], the
// candidate buffers [bq][cap] (values, then ids), the code tile [bn][m].
// Writes k pairs per (query, chunk) at out[q * out_stride + chunk * k].
__global__ void __launch_bounds__(kScanThreads)
pq_scan_kernel(const float* __restrict__ lut, const unsigned char* __restrict__
               codes, int nq_total, int n_rows, int m, int ksub, int k,
               int bq, int bn, int cap, int chunk, long long out_stride,
               float* __restrict__ out_v, int* __restrict__ out_i) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int width = m * ksub;
  float* luts = reinterpret_cast<float*>(smem);
  float* bv = luts + (size_t)bq * width;
  int* bi = reinterpret_cast<int*>(bv + (size_t)bq * cap);
  unsigned char* cs = reinterpret_cast<unsigned char*>(bi + (size_t)bq * cap);
  __shared__ int cnt[kMaxBQ];
  __shared__ float tv[kMaxBQ];
  __shared__ int ti[kMaxBQ];
  __shared__ int need_flush;

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * bq;
  const int groups = kScanThreads / bn;   // query groups per tile
  const int lrow = tid % bn;
  const int qgroup = tid / bn;
  const long long r_begin = (long long)blockIdx.y * chunk;
  const long long r_end = min((long long)n_rows, r_begin + chunk);

  for (int p = tid; p < bq * width; p += kScanThreads) {
    const int a = p / width;
    luts[p] = q0 + a < nq_total ? lut[(size_t)(q0 + a) * width + p % width]
                                : 0.0f;
  }
  init_buffers(bv, bi, cnt, tv, ti, bq, cap, k);
  if (tid == 0) need_flush = 0;
  __syncthreads();

  for (long long r0 = r_begin; r0 < r_end; r0 += bn) {
    const int rows = (int)min((long long)bn, r_end - r0);
    const unsigned char* src = codes + r0 * m;
    for (int p = tid; p < rows * m; p += kScanThreads) cs[p] = src[p];
    __syncthreads();
    if (lrow < rows) {
      const int row = (int)(r0 + lrow);
      const unsigned char* c = cs + lrow * m;
      // PQ8: the row's codes once into registers (the tile is 8-aligned)
      const uint2 c8 = m == 8 ? *reinterpret_cast<const uint2*>(c)
                              : make_uint2(0, 0);
      for (int a = qgroup; a < bq && q0 + a < nq_total; a += groups) {
        const float* la = luts + (size_t)a * width;
        const float s = -(m == 8 ? tree_lut8(la, c8, ksub)
                                 : tree_lut(la, c, m, ksub));
        if (better(s, row, tv[a], ti[a])) {
          const int pos = atomicAdd(&cnt[a], 1);
          bv[a * cap + pos] = s;
          bi[a * cap + pos] = row;
        }
      }
    }
    __syncthreads();
    // a buffer that could not take a whole next tile is flushed (all are)
    if (tid < bq && cnt[tid] + bn > cap) need_flush = 1;
    __syncthreads();
    if (need_flush) {
      flush_all(bv, bi, cnt, tv, ti, bq, cap, k);
      if (tid == 0) need_flush = 0;
      __syncthreads();
    }
  }

  flush_all(bv, bi, cnt, tv, ti, bq, cap, k);
  for (int p = tid; p < bq * k; p += kScanThreads) {
    const int a = p / k, s = p % k;
    if (q0 + a >= nq_total) continue;
    const long long o = (long long)(q0 + a) * out_stride +
                        (long long)blockIdx.y * k + s;
    out_v[o] = bv[a * cap + s];
    out_i[o] = bi[a * cap + s];
  }
}

// Pass 2: block q merges its len = chunks * k candidate pairs into k.
__global__ void __launch_bounds__(kThreads)
pq_merge_kernel(const float* __restrict__ in_v, const int* __restrict__ in_i,
                long long len, int k, int cap, float* __restrict__ out_v,
                int* __restrict__ out_i) {
  extern __shared__ __align__(16) unsigned char smem[];
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

size_t scan_smem(int bq, int bn, int cap, int m, int ksub) {
  const size_t codes = ((size_t)bn * m + 15) / 16 * 16;
  return (size_t)bq * ((size_t)m * ksub * 4 + (size_t)cap * 8) + codes;
}

}  // namespace

extern "C" int pq_adc_max_k() { return kMaxCap - 64; }

// Tile geometry: the code tile bn (256 rows, or 64 when k is too large for
// a 256-row tile), the candidate buffer cap = next_pow2(k + bn), and the
// widest query tile bq in {8, 4, 2, 1} whose shared memory fits smem_limit.
// Returns 0, -1 when k is above pq_adc_max_k(), -2 when one query's LUT
// and buffer do not fit.
extern "C" int pq_adc_plan(int k, int m, int ksub, long long smem_limit,
                           int* bq, int* bn, int* cap, long long* smem) {
  if (k < 1 || k > pq_adc_max_k()) return -1;
  *bn = k + 256 <= kMaxCap ? 256 : 64;
  *cap = next_pow2(k + *bn);
  for (int b = kMaxBQ; b >= 1; b >>= 1) {
    const size_t s = scan_smem(b, *bn, *cap, m, ksub);
    if ((long long)s <= smem_limit) {
      *bq = b;
      *smem = (long long)s;
      return 0;
    }
  }
  return -2;
}

// Passes 0-2. lut holds nq * m * ksub floats of scratch; part_v/part_i hold
// nq * chunks * k pairs of scratch when chunks > 1 (unused otherwise).
// Returns 0, -1 for arguments out of range, or the first cudaError_t met.
extern "C" int pq_adc_launch(const float* q, const float* cb,
                             const unsigned char* codes, int nq, int n,
                             int m, int ksub, int dsub, int k, int chunk,
                             int chunks, long long smem_limit, float* lut,
                             float* part_v, int* part_i, float* out_v,
                             int* out_i, void* stream) {
  if (nq == 0) return 0;
  if (m < 1 || ksub < 1 || dsub < 1 || n < 1 || k > n || chunks < 1)
    return -1;
  cudaStream_t s = (cudaStream_t)stream;
  int bq, bn, cap;
  long long smem;
  if (pq_adc_plan(k, m, ksub, smem_limit, &bq, &bn, &cap, &smem) != 0)
    return -1;
  pq_lut_kernel<<<nq, kThreads, 0, s>>>(q, cb, m, ksub, dsub, lut);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  const bool merge = chunks > 1;
  float* pv = merge ? part_v : out_v;
  int* pi = merge ? part_i : out_i;
  const long long stride = (long long)chunks * k;
  e = cudaFuncSetAttribute(pq_scan_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((nq + bq - 1) / bq, chunks);
  pq_scan_kernel<<<grid, kScanThreads, smem, s>>>(lut, codes, nq, n, m, ksub,
                                                  k, bq, bn, cap, chunk,
                                                  stride, pv, pi);
  e = cudaGetLastError();
  if (e != cudaSuccess || !merge) return (int)e;

  const int cap2 = next_pow2(k + kThreads);
  const int smem2 = cap2 * 8;
  e = cudaFuncSetAttribute(pq_merge_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem2);
  if (e != cudaSuccess) return (int)e;
  pq_merge_kernel<<<nq, kThreads, smem2, s>>>(part_v, part_i, stride, k,
                                              cap2, out_v, out_i);
  return (int)cudaGetLastError();
}
