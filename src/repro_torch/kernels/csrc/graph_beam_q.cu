// The quantized HNSW traversal for Hopper (sm_90a): one hop (gather code
// rows, score, beam merge), and the whole search of one query a block.
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
// merges by ef sweeps of max/argmax/mask; and the reference's one-dispatch
// _traverse_impl around it (src/repro/search/hnsw.py:932). This file is
// csrc/graph_beam.cu with another gather and score:
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
//      are graph_traverse.cuh's, as in graph_beam.cu.
// graph_traverse_kernel (graph_traverse.cuh) runs the whole search with
// score_slots_q as its payload's score: one launch a search, the f32
// graph's traversal step for step, with code rows in place of float32
// rows, and no host in the loop.
//
// Bound: bytes. A hop reads Q*W*(C + 8) bytes of gathered codes, biases
// and ids (C = 64 at SQ8 d=64, 8 at PQ8x8) and 16*Q*ef bytes of beam in
// and out, against about 2*Q*W*C operations; a search reads evals * (C + 4)
// bytes of codes and biases, the neighbour rows of its hops and its beam.
// The rows are gathered at random, so each row costs a DRAM latency;
// several rows are in flight per warp to hide it. Ids must be < N: an id >=
// N is treated as masked. A PQ code must be < ksub; a larger one reads 0 in
// the last subspace and the next subspace's entry in the others (the plain
// version then raises or reads the same entry).
#include "graph_traverse.cuh"

namespace {

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

// Score the w candidate slots whose ids are at ids[0, w) (id < 0 or >= n:
// masked) against the staged operand qs: cv[slot] = (contract + qb) -
// node_bias[id] in the plain version's order, or NEG_INF and id -1 for a
// masked slot. The code payloads' score_slots.
template <bool kPq>
__device__ __forceinline__ void score_slots_q(
    const float* qs, const unsigned char* __restrict__ codes,
    const float* __restrict__ node_bias, float qb, const int* ids, int w,
    int n, int c, int dop, int ksub, float* cv, int* ci) {
  int width = 1;                 // next_pow2(c)
  while (width < c) width <<= 1;
  const int g = width < 32 ? width : 32;  // lanes per row
  const int chunk = width / g;            // terms per lane
  const int per_warp = 32 / g;            // rows a warp scores at once
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int sub = lane % g, grp = lane / g;
  const int span = kUnroll * per_warp;    // slots a warp takes per pass
  for (int base = warp * span; base < w; base += kWarps * span) {
    int id[kUnroll];
    float acc[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int slot = base + u * per_warp + grp;
      const int v = slot < w ? ids[slot] : -1;
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
  const float* qrow = q_op + (size_t)r * dop;
  const int* bi_row = bi + (size_t)r * ef;
  const float* bv_row = bv + (size_t)r * ef;

  for (int k = tid; k < dop; k += kThreads) qs[k] = qrow[k];
  for (int i = tid; i < ef; i += kThreads)
    bvs[i] = bi_row[i] < 0 ? kNegInf : bv_row[i];
  __syncthreads();
  score_slots_q<kPq>(qs, codes, node_bias, q_bias[r], nbr + (size_t)r * w, w,
                     n, c, dop, ksub, cv, ci);
  __syncthreads();
  rank_sort(cv, ci, w, sv, si);
  __syncthreads();
  co_rank_merge(sv, si, w, bvs, bi_row, nullptr, ef, out_v + (size_t)r * ef,
                out_i + (size_t)r * ef, nullptr);
}

// The code payload of the traversal: q_op [Q, dop] staged, q_bias the
// bias, score_slots_q over the code rows.
template <bool kPq>
struct CodeRows {
  const float* q_op;
  const float* q_bias;
  const unsigned char* codes;
  const float* node_bias;
  int dop, c, ksub;
  __device__ const float* operand(int r) const {
    return q_op + (size_t)r * dop;
  }
  __device__ float bias(int r) const { return q_bias[r]; }
  __device__ void score(const float* qs, float qb, const int* ids, int w,
                        int n, float* cv, int* ci) const {
    score_slots_q<kPq>(qs, codes, node_bias, qb, ids, w, n, c, dop, ksub, cv,
                       ci);
  }
};

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

// The operand width a mode takes: 0 = sq8 (dop == c), 1 = pq (dop == c *
// ksub). False for a mode or width out of range.
bool mode_ok(int mode, int c, int dop, int ksub) {
  if (c < 1) return false;
  if (mode == 0) return dop == c;
  return mode == 1 && ksub >= 1 && (long long)c * ksub == dop;
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
  if (!mode_ok(mode, c, dop, ksub) || w < 1 || w > kMaxW || ef < 1 ||
      ef > kMaxEf)
    return -1;
  cudaStream_t s = (cudaStream_t)stream;
  if (mode == 0)
    return launch<false>(q_op, q_bias, codes, node_bias, nbr, bv, bi, out_v,
                         out_i, nq, n, c, dop, 0, w, ef, s);
  return launch<true>(q_op, q_bias, codes, node_bias, nbr, bv, bi, out_v,
                      out_i, nq, n, c, dop, ksub, w, ef, s);
}

// Shared memory of a traversal launch, in bytes; smem_words: words of the
// visited set kept in shared memory (0 when it is a global matrix).
extern "C" long long graph_traverse_q_smem(int dop, int w0, int m, int ef,
                                           int smem_words) {
  return (long long)traverse_smem(dop, w0, m, ef, smem_words);
}

// The quantized traversal of nq queries, one block each (mode as for the
// hop). vis_g: null (the visited bits in shared memory) or a zeroed [nq,
// words] matrix. alive: null or [n] uint8. Returns 0, -1 for arguments out
// of range, or a cudaError_t.
extern "C" int graph_traverse_q_launch(
    const float* q_op, const float* q_bias, const unsigned char* codes,
    const float* node_bias, const int* nbrs0, const int* upper,
    const unsigned char* alive, int nq, int n, int c, int dop, int ksub,
    int mode, int w0, int m, int levels, int entry, int ef, unsigned* vis_g,
    float* out_v, int* out_i, long long* evals, int* hops, void* stream) {
  if (nq == 0) return 0;
  if (!mode_ok(mode, c, dop, ksub)) return -1;
  cudaStream_t s = (cudaStream_t)stream;
  if (mode == 0) {
    const CodeRows<false> pay{q_op, q_bias, codes, node_bias, dop, c, 0};
    return traverse_launch(pay, nbrs0, upper, alive, nq, n, w0, m, levels,
                           entry, ef, vis_g, out_v, out_i, evals, hops, s);
  }
  const CodeRows<true> pay{q_op, q_bias, codes, node_bias, dop, c, ksub};
  return traverse_launch(pay, nbrs0, upper, alive, nq, n, w0, m, levels,
                         entry, ef, vis_g, out_v, out_i, evals, hops, s);
}
