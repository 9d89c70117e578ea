// One quantized HNSW traversal hop for Hopper (sm_90a): gather code rows,
// score, beam merge.
//
// For each query row r: gather the code rows named by nbr_ids[r, :W] (id < 0
// = masked slot) and score each
//   s = contract(q_op[r], codes[id]) + q_bias[r] - node_bias[id]
// where contract is, by mode,
//   sq8: sum over t < C of codes[id, t] * q_op[r, t]      (Dop = C = d)
//   pq:  sum over t < C of q_op[r, t * ksub + codes[id, t]] (Dop = C * ksub)
// (the caller passes 2 q * step, 2 q.vmin - |q|^2 and |decode(c)|^2 for
// SQ8, or the negated ADC LUT and zero biases for PQ). The W (score, id)
// pairs merge into the running beam (beam_v, beam_i) [ef], sorted
// descending, as the first ef entries of a stable descending sort of
// [beam, candidates]: ties go to the beam entry, then to the lower slot.
// Masked slots score NEG_INF and keep id -1; every slot with id < 0 comes
// out as (NEG_INF, -1).
//
// Replaces the TPU kernel graph_beam_q_pallas
// (src/repro/kernels/graph_beam_q/kernel.py:78), whose grid runs in order
// over (query, slot), DMAs one int32-widened code row a step into VMEM,
// contracts a PQ row through a one-hot [m, ksub] expansion on the MXU, and
// merges by ef sweeps of max/argmax/mask. This kernel is csrc/graph_beam.cu
// with another gather and score:
//   1. q_op (d floats for SQ8, the m * ksub LUT for PQ: 8 KB at PQ8x8) and
//      the beam's values are staged in shared memory;
//   2. each code row of width C is scored by G = min(next_pow2(C), 32)
//      lanes, 32 / G rows a warp at once and four such groups in flight:
//      lane j of a group sums the aligned block [j*c, j*c + c) of the row
//      (c = next_pow2(C) / G), zero-padded past C, and a shuffle-down tree
//      inside the group finishes the sum. That is the balanced pairwise
//      tree of pairwise_sum over the row, so kernel and plain version agree
//      bit for bit. Codes stay uint8: a lane reads its c bytes;
//   3. the rank sort of the W scores and the co-rank merge with the beam
//      are graph_beam.cu's.
//
// Bound: bytes. A hop reads Q*W*(C + 8) bytes of gathered codes, biases
// and ids (C = 64 at SQ8 d=64, 8 at PQ8x8) and 16*Q*ef bytes of beam in
// and out, against about 2*Q*W*C operations. The rows are gathered at
// random, so each row costs a DRAM latency; several rows are in flight per
// warp to hide it. Ids must be < N: an id >= N is treated as masked. A PQ
// code must be < ksub; a larger one reads 0 in the last subspace and the
// next subspace's entry in the others (the plain version then raises or
// reads the same entry).
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;         // row groups in flight per warp
constexpr float kNegInf = -1e30f;  // NEG_INF of kernels/common.py
constexpr int kMaxW = 1024;
constexpr int kMaxEf = 4096;
constexpr int kMaxLevels = 20;     // log2 of the largest per-lane block + 1

__device__ __forceinline__ int count_gt(const float* a, int len, float x) {
  int lo = 0, hi = len;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] > x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ int count_ge(const float* a, int len, float x) {
  int lo = 0, hi = len;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] >= x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// One term of the contraction: the t-th element of the row's sum.
template <bool kPq>
__device__ __forceinline__ float term(const float* qop,
                                      const unsigned char* row, int t,
                                      int ksub, int dop) {
  if (kPq) {
    const int e = t * ksub + row[t];
    return e < dop ? qop[e] : 0.0f;
  }
  return __fmul_rn((float)row[t], qop[t]);
}

// A lane's block sum: the balanced tree of the terms of [first, first +
// chunk), zero past the width c (chunk is a power of two).
template <bool kPq>
__device__ __forceinline__ float lane_sum(const float* qop,
                                          const unsigned char* row, int c,
                                          int ksub, int dop, int first,
                                          int chunk) {
  if (chunk == 1) return first < c ? term<kPq>(qop, row, first, ksub, dop)
                                   : 0.0f;
  float part[kMaxLevels];
  for (int t = 0; t < chunk; ++t) {
    const int k = first + t;
    float v = k < c ? term<kPq>(qop, row, k, ksub, dop) : 0.0f;
    int level = 0;
    for (int s = t; s & 1; s >>= 1) v = __fadd_rn(part[level++], v);
    part[level] = v;
  }
  return part[31 - __clz(chunk)];
}

template <bool kPq>
__global__ void __launch_bounds__(kThreads)
graph_beam_q_kernel(const float* __restrict__ q_op,
                    const float* __restrict__ q_bias,
                    const unsigned char* __restrict__ codes,
                    const float* __restrict__ node_bias,
                    const int* __restrict__ nbr, const float* __restrict__ bv,
                    const int* __restrict__ bi, float* __restrict__ out_v,
                    int* __restrict__ out_i, int n, int c, int dop, int ksub,
                    int w, int ef) {
  extern __shared__ float smem[];
  float* qs = smem;              // [dop]
  float* bvs = qs + dop;         // [ef] beam values, pads read as NEG_INF
  float* cv = bvs + ef;          // [w] candidate scores, slot order
  int* ci = (int*)(cv + w);      // [w] candidate ids, slot order
  float* sv = (float*)(ci + w);  // [w] scores, sorted
  int* si = (int*)(sv + w);      // [w] ids, sorted

  const int r = blockIdx.x;
  const int tid = threadIdx.x;
  int width = 1;                 // next_pow2(c)
  while (width < c) width <<= 1;
  const int g = width < 32 ? width : 32;  // lanes per row
  const int chunk = width / g;            // terms per lane
  const int per_warp = 32 / g;            // rows a warp scores at once
  const int lane = tid & 31, warp = tid >> 5;
  const int sub = lane % g, grp = lane / g;
  const float* qrow = q_op + (size_t)r * dop;
  const int* ids_row = nbr + (size_t)r * w;
  const float* bv_row = bv + (size_t)r * ef;
  const int* bi_row = bi + (size_t)r * ef;

  for (int k = tid; k < dop; k += kThreads) qs[k] = qrow[k];
  for (int i = tid; i < ef; i += kThreads)
    bvs[i] = bi_row[i] < 0 ? kNegInf : bv_row[i];
  __syncthreads();

  const float qb = q_bias[r];
  const int span = kUnroll * per_warp;    // slots a warp takes per pass
  for (int base = warp * span; base < w; base += kWarps * span) {
    int id[kUnroll];
    float acc[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int slot = base + u * per_warp + grp;
      const int v = slot < w ? ids_row[slot] : -1;
      id[u] = (v >= 0 && v < n) ? v : -1;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      acc[u] = id[u] >= 0
                   ? lane_sum<kPq>(qs, codes + (size_t)id[u] * c, c, ksub,
                                   dop, sub * chunk, chunk)
                   : 0.0f;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      for (int off = 1; off < g; off <<= 1)
        acc[u] = __fadd_rn(acc[u], __shfl_down_sync(0xffffffffu, acc[u], off));
    if (sub == 0) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int slot = base + u * per_warp + grp;
        if (slot >= w) continue;
        if (id[u] >= 0) {
          // the plain version's order: (contract + q_bias) - node_bias
          cv[slot] = __fsub_rn(__fadd_rn(acc[u], qb), node_bias[id[u]]);
          ci[slot] = id[u];
        } else {
          cv[slot] = kNegInf;
          ci[slot] = -1;
        }
      }
    }
  }
  __syncthreads();

  // stable rank sort of the candidates: (score desc, slot asc)
  for (int j = tid; j < w; j += kThreads) {
    const float v = cv[j];
    int rank = 0;
    for (int i = 0; i < w; ++i) {
      const float u = cv[i];
      rank += (u > v) || (u == v && i < j);
    }
    sv[rank] = v;
    si[rank] = ci[j];
  }
  __syncthreads();

  float* ov = out_v + (size_t)r * ef;
  int* oi = out_i + (size_t)r * ef;
  for (int i = tid; i < ef; i += kThreads) {
    const float b = bvs[i];
    const int p = i + count_gt(sv, w, b);
    if (p < ef) {
      const int id = bi_row[i];
      ov[p] = id < 0 ? kNegInf : b;
      oi[p] = id;
    }
  }
  for (int j = tid; j < w; j += kThreads) {
    const float v = sv[j];
    const int p = j + count_ge(bvs, ef, v);
    if (p < ef) {
      const int id = si[j];
      ov[p] = id < 0 ? kNegInf : v;
      oi[p] = id;
    }
  }
}

size_t smem_bytes(int dop, int w, int ef) {
  return sizeof(float) * ((size_t)dop + ef + 4 * (size_t)w);
}

template <bool kPq>
int launch(const float* q_op, const float* q_bias, const unsigned char* codes,
           const float* node_bias, const int* nbr, const float* bv,
           const int* bi, float* out_v, int* out_i, int nq, int n, int c,
           int dop, int ksub, int w, int ef, cudaStream_t stream) {
  const size_t smem = smem_bytes(dop, w, ef);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        graph_beam_q_kernel<kPq>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  graph_beam_q_kernel<kPq><<<nq, kThreads, smem, stream>>>(
      q_op, q_bias, codes, node_bias, nbr, bv, bi, out_v, out_i, n, c, dop,
      ksub, w, ef);
  return (int)cudaGetLastError();
}

}  // namespace

// Shared memory a launch needs, in bytes (the wrapper checks it against the
// card's per-block limit).
extern "C" long long graph_beam_q_smem(int dop, int w, int ef) {
  return (long long)smem_bytes(dop, w, ef);
}

// mode 0 = sq8 (dop == c), 1 = pq (dop == c * ksub). Returns 0, -1 for
// arguments out of range, or a cudaError_t code.
extern "C" int graph_beam_q_launch(const float* q_op, const float* q_bias,
                                   const unsigned char* codes,
                                   const float* node_bias, const int* nbr,
                                   const float* bv, const int* bi,
                                   float* out_v, int* out_i, int nq, int n,
                                   int c, int dop, int ksub, int w, int ef,
                                   int mode, void* stream) {
  if (nq == 0) return 0;
  if (c < 1 || w < 1 || w > kMaxW || ef < 1 || ef > kMaxEf) return -1;
  cudaStream_t s = (cudaStream_t)stream;
  if (mode == 0) {
    if (dop != c) return -1;
    return launch<false>(q_op, q_bias, codes, node_bias, nbr, bv, bi, out_v,
                         out_i, nq, n, c, dop, 0, w, ef, s);
  }
  if (mode != 1 || ksub < 1 || (long long)c * ksub != dop) return -1;
  return launch<true>(q_op, q_bias, codes, node_bias, nbr, bv, bi, out_v,
                      out_i, nq, n, c, dop, ksub, w, ef, s);
}
