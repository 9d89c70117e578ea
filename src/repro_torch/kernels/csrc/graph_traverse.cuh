// The HNSW traversal shared by the float32 graph (graph_beam.cu) and the
// quantized graphs (graph_beam_q.cu): the hop's rank sort and co-rank merge,
// and the whole search of one query a block, templated on the payload that
// scores a row. Included by both sources; each defines its payload's
// score_slots and instantiates the kernel once per payload.
//
// A payload P provides
//   int dop;                                   floats staged per query
//   const float* operand(int r) const;         query r's [dop] operand
//   float bias(int r) const;                   query r's scalar term
//   void score(const float* qs, float qb, const int* ids, int w, int n,
//              float* cv, int* ci) const;      the hop's score_slots
// where score writes cv[slot] (the row's score, or NEG_INF) and ci[slot]
// (its id, or -1 for a masked slot: id < 0 or >= n) for slot < w, reading
// the staged operand qs in shared memory. The traversal calls nothing else
// of the payload, so every step of a search scores exactly as one hop of
// that payload does, bit for bit.
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;         // candidate rows in flight per warp
constexpr float kNegInf = -1e30f;  // NEG_INF of kernels/common.py
constexpr int kMaxW = 1024;
constexpr int kMaxEf = 4096;
constexpr int kMaxLevels = 20;     // log2 of the largest per-lane block + 1

// #{i : a[i] > x} for a sorted descending
__device__ __forceinline__ int count_gt(const float* a, int len, float x) {
  int lo = 0, hi = len;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] > x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// #{i : a[i] >= x} for a sorted descending
__device__ __forceinline__ int count_ge(const float* a, int len, float x) {
  int lo = 0, hi = len;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] >= x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// Stable rank sort of the w candidates: (score desc, slot asc) into sv, si.
__device__ __forceinline__ void rank_sort(const float* cv, const int* ci,
                                          int w, float* sv, int* si) {
  for (int j = threadIdx.x; j < w; j += kThreads) {
    const float v = cv[j];
    int rank = 0;
    for (int i = 0; i < w; ++i) {
      const float u = cv[i];
      rank += (u > v) || (u == v && i < j);
    }
    sv[rank] = v;
    si[rank] = ci[j];
  }
}

// Co-rank merge of the sorted candidates (sv, si) [w] and the beam (bvs:
// values with pads read as NEG_INF, bi: ids) [ef] into (ov, oi) [ef]: beam
// entry i lands at i + #{cand > beam[i]}, candidate j at j + #{beam >=
// cand[j]}, positions >= ef dropped. bx/ox (or null): a flag a beam entry
// carries through the merge; a candidate enters with 0.
__device__ __forceinline__ void co_rank_merge(const float* sv, const int* si,
                                              int w, const float* bvs,
                                              const int* bi, const int* bx,
                                              int ef, float* ov, int* oi,
                                              int* ox) {
  for (int i = threadIdx.x; i < ef; i += kThreads) {
    const float b = bvs[i];
    const int p = i + count_gt(sv, w, b);
    if (p < ef) {
      const int id = bi[i];
      ov[p] = id < 0 ? kNegInf : b;
      oi[p] = id;
      if (ox) ox[p] = bx[i];
    }
  }
  for (int j = threadIdx.x; j < w; j += kThreads) {
    const float c = sv[j];
    const int p = j + count_ge(bvs, ef, c);
    if (p < ef) {
      const int id = si[j];
      ov[p] = id < 0 ? kNegInf : c;
      oi[p] = id;
      if (ox) ox[p] = 0;
    }
  }
}

// The whole traversal of one query a block, with no host in the loop, in
// the order of search_batched's loop for one row: the entry seed (a 1-wide
// merge of the entry into an empty beam), the greedy descent through every
// upper layer (each step an ef=1 merge of the current node's neighbours;
// ties keep the current node, so the step moves only on a strictly better
// one), then the layer-0 best-first beam: expand the first entry of the
// beam not yet expanded, score its neighbours not yet seen, merge them in;
// until no entry is left unexpanded. Each step is the payload's score,
// rank_sort and co_rank_merge, so every score and merge is bit for bit the
// plain hop's. The beam stays in shared memory with an expanded flag a slot
// (carried through the merge), so picking the next node reads nothing
// global. Visited state is one bit a node ("seen"): in shared memory, or,
// when vis_g is given, in its row of a [Q, words] bit matrix the caller
// zeroed. A node enters the beam only in the step that first sees it (twice
// only if its id is in a row twice), and expanding it flags every slot that
// holds it, so seen plus the flag is search_batched's stamp (0 unseen, 1
// seen, 2 expanded). Tombstoned nodes (alive[id] == 0) are seen and counted
// but never scored. evals as search_batched counts them: 1 for the seed, the
// valid neighbours of each descent step, the fresh ones of each layer-0
// step; hops: the layer-0 steps.
template <class P>
__global__ void __launch_bounds__(kThreads)
graph_traverse_kernel(P pay, const int* __restrict__ nbrs0,
                      const int* __restrict__ upper,
                      const unsigned char* __restrict__ alive, int n, int w0,
                      int m, int levels, int entry, int ef,
                      unsigned* __restrict__ vis_g, int words,
                      float* __restrict__ out_v, int* __restrict__ out_i,
                      long long* __restrict__ evals_out,
                      int* __restrict__ hops_out) {
  extern __shared__ float smem[];
  const int wmax = w0 > m ? w0 : m;
  float* qs = smem;                        // [dop] the query's operand
  float* av = qs + pay.dop;                // beam A [ef]: values, ids, flags
  int* ai = (int*)(av + ef);
  int* ax = ai + ef;
  float* bv = (float*)(ax + ef);           // beam B [ef]
  int* bi = (int*)(bv + ef);
  int* bx = bi + ef;
  float* cv = (float*)(bx + ef);           // [wmax] candidates, slot order
  int* ci = (int*)(cv + wmax);
  float* sv = (float*)(ci + wmax);         // [wmax] sorted
  int* si = (int*)(sv + wmax);
  int* cid = si + wmax;                    // [wmax] ids to score
  unsigned* vis = (unsigned*)(cid + wmax); // [words] when vis_g is null
  __shared__ float dv[2];                  // the descent's 1-wide beams
  __shared__ int di[2];
  __shared__ int s_pick, s_evals;

  const int r = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31;
  if (vis_g) vis = vis_g + (size_t)r * words;
  else
    for (int t = tid; t < words; t += kThreads) vis[t] = 0u;
  const float* op = pay.operand(r);
  for (int k = tid; k < pay.dop; k += kThreads) qs[k] = op[k];
  const float qb = pay.bias(r);
  if (tid == 0) {
    s_evals = 1;
    dv[0] = kNegInf;
    di[0] = -1;
    cid[0] = (alive == nullptr || alive[entry]) ? entry : -1;
  }
  __syncthreads();

  // entry seed: a 1-wide merge of the entry into an empty beam
  pay.score(qs, qb, cid, 1, n, cv, ci);
  __syncthreads();
  rank_sort(cv, ci, 1, sv, si);
  __syncthreads();
  co_rank_merge(sv, si, 1, dv, di, nullptr, 1, dv + 1, di + 1, nullptr);
  __syncthreads();
  if (tid == 0) {
    dv[0] = dv[1];
    di[0] = di[1];
  }
  __syncthreads();

  // upper layers: greedy descent, each step an ef=1 merge
  for (int layer = levels; layer >= 1; --layer) {
    const int* adj = upper + (size_t)(layer - 1) * n * m;
    for (;;) {
      const int cur = di[0];
      for (int t = tid; t < m; t += kThreads) {
        const int nb = cur >= 0 ? adj[(size_t)cur * m + t] : -1;
        if (nb >= 0) atomicAdd(&s_evals, 1);
        cid[t] = (nb >= 0 && (alive == nullptr || alive[nb])) ? nb : -1;
      }
      __syncthreads();
      pay.score(qs, qb, cid, m, n, cv, ci);
      __syncthreads();
      rank_sort(cv, ci, m, sv, si);
      __syncthreads();
      co_rank_merge(sv, si, m, dv, di, nullptr, 1, dv + 1, di + 1, nullptr);
      __syncthreads();
      const bool moved = di[1] != cur;
      __syncthreads();
      if (tid == 0) {
        dv[0] = dv[1];
        di[0] = di[1];
      }
      __syncthreads();
      if (!moved) break;
    }
  }

  // layer 0: best-first beam
  for (int i = tid; i < ef; i += kThreads) {
    av[i] = i == 0 ? dv[0] : kNegInf;
    ai[i] = i == 0 ? di[0] : -1;
    ax[i] = 0;
  }
  if (tid == 0 && di[0] >= 0) vis[di[0] >> 5] |= 1u << (di[0] & 31);
  __syncthreads();
  int hops = 0;
  for (;;) {
    if (tid < 32) {   // the first slot holding a node not yet expanded
      int pick = -1;
      for (int base = 0; base < ef; base += 32) {
        const int i = base + lane;
        const bool open = i < ef && ai[i] >= 0 && ax[i] == 0;
        const unsigned b = __ballot_sync(0xffffffffu, open);
        if (b) {
          pick = base + __ffs(b) - 1;
          break;
        }
      }
      if (lane == 0) s_pick = pick;
    }
    __syncthreads();
    const int pick = s_pick;
    if (pick < 0) break;
    const int node = ai[pick];
    ++hops;
    for (int t = tid; t < w0; t += kThreads) {   // the fresh neighbours
      const int nb = nbrs0[(size_t)node * w0 + t];
      cid[t] = nb >= 0 && !((vis[nb >> 5] >> (nb & 31)) & 1u) ? nb : -1;
    }
    __syncthreads();   // every slot read its bit before any is set
    for (int i = tid; i < ef; i += kThreads)   // the node's stamp: expanded
      if (ai[i] == node) ax[i] = 1;
    for (int t = tid; t < w0; t += kThreads) {
      const int nb = cid[t];
      if (nb >= 0) {
        atomicOr(&vis[nb >> 5], 1u << (nb & 31));
        atomicAdd(&s_evals, 1);
        if (alive != nullptr && !alive[nb]) cid[t] = -1;
      }
    }
    __syncthreads();
    pay.score(qs, qb, cid, w0, n, cv, ci);
    __syncthreads();
    rank_sort(cv, ci, w0, sv, si);
    __syncthreads();
    co_rank_merge(sv, si, w0, av, ai, ax, ef, bv, bi, bx);
    __syncthreads();
    float* tv = av; av = bv; bv = tv;
    int* ti = ai; ai = bi; bi = ti;
    ti = ax; ax = bx; bx = ti;
  }
  for (int i = tid; i < ef; i += kThreads) {
    out_v[(size_t)r * ef + i] = av[i];
    out_i[(size_t)r * ef + i] = ai[i];
  }
  if (tid == 0) {
    evals_out[r] = s_evals;
    hops_out[r] = hops;
  }
}

// Shared memory of a traversal launch, in bytes; smem_words: words of the
// visited set kept in shared memory (0 when it is a global matrix).
size_t traverse_smem(int dop, int w0, int m, int ef, int smem_words) {
  const size_t wmax = w0 > m ? w0 : m;
  return sizeof(float) * ((size_t)dop + 6 * (size_t)ef + 5 * wmax) +
         sizeof(unsigned) * (size_t)smem_words;
}

// The traversal of nq queries, one block each. vis_g: null (the visited
// bits in shared memory) or a zeroed [nq, words] matrix. alive: null or
// [n] uint8. Returns 0, -1 for arguments out of range, or a cudaError_t.
template <class P>
int traverse_launch(const P& pay, const int* nbrs0, const int* upper,
                    const unsigned char* alive, int nq, int n, int w0, int m,
                    int levels, int entry, int ef, unsigned* vis_g,
                    float* out_v, int* out_i, long long* evals, int* hops,
                    cudaStream_t stream) {
  if (nq == 0) return 0;
  if (pay.dop < 1 || w0 < 1 || w0 > kMaxW || m > kMaxW ||
      (levels > 0 && m < 1) || ef < 1 || ef > kMaxEf || entry < 0 ||
      entry >= n)
    return -1;
  const int words = (n + 31) / 32;
  const size_t smem = traverse_smem(pay.dop, w0, m, ef, vis_g ? 0 : words);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        graph_traverse_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  graph_traverse_kernel<P><<<nq, kThreads, smem, stream>>>(
      pay, nbrs0, upper, alive, n, w0, m, levels, entry, ef, vis_g, words,
      out_v, out_i, evals, hops);
  return (int)cudaGetLastError();
}

}  // namespace
