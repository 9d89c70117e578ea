// One HNSW traversal hop for Hopper (sm_90a): gather, score, beam merge.
//
// For each query row r: gather the corpus rows named by nbr_ids[r, :W]
// (id < 0 = masked slot), score each
//   s = 2 q.v - |v|^2 - |q|^2      (|v|^2 = db_sq[id], |q|^2 = q_sq[r])
// and merge the W (score, id) pairs into the running beam (beam_v, beam_i)
// [ef], sorted descending. The merged beam is the first ef entries of a
// stable descending sort of [beam, candidates]: ties go to the beam entry,
// then to the lower candidate slot. Masked slots score NEG_INF and keep id
// -1; every slot with id < 0 comes out as (NEG_INF, -1).
//
// Replaces the TPU kernel graph_beam_pallas
// (src/repro/kernels/graph_beam/kernel.py:65), whose grid runs in order
// over (query, slot), DMAs one gathered row a step into VMEM, and merges by
// ef sweeps of max/argmax/mask on the last slot. Blocks on the card run in
// parallel and ef reaches 4096, so one block owns one query:
//   1. q and the beam's values are staged in shared memory;
//   2. each warp scores candidate slots, four at a time: lane l reads the
//      aligned block [l*c, l*c + c) of the row (c = 2 at d = 64: the warp
//      reads a 256-byte row as one contiguous span) and a shuffle tree
//      finishes the sum. The sum is the balanced pairwise tree of rounded
//      products that the plain version's pairwise_sum takes, so kernel
//      and plain version agree bit for bit on any input;
//   3. the W scores are sorted in shared memory by (score desc, slot asc),
//      each thread ranking one candidate against all W (W <= 1024);
//   4. a co-rank merge writes the output: beam entry i lands at
//      i + #{cand > beam[i]}, candidate j (sorted) at j + #{beam >= cand[j]},
//      each count a binary search; positions >= ef are dropped.
// That is the stable sort of [beam, candidates] exactly, with no ef sweeps.
// The beam must be sorted descending (the traversal keeps it so); beam
// slots with id < 0 are read as NEG_INF, which changes no output.
//
// graph_traverse_kernel (graph_traverse.cuh, shared with the quantized
// graphs of graph_beam_q.cu) runs a whole search for one query a block
// from the same three device functions (score_slots here, rank_sort and
// co_rank_merge there): the entry seed, the descent through the upper
// layers and the layer-0 beam, with no host in the loop. The batched
// traversal of search/hnsw.py launched one hop a step and read the loop
// condition on the host after each (about 100 launches and syncs a
// search, the card mostly idle); here a search is one launch, and its time
// is the device time of its hops: each a dependent gather (a neighbour
// row, then its rows), so the bound is bytes, evals * (4d + 4) plus the
// beams, and the latency of the gathers is what the block waits on.
//
// Bound: bytes. A hop reads Q*W*(4d + 8) bytes of gathered rows, norms and
// ids, and 16*Q*ef bytes of beam in and out, against about 2*Q*W*d FLOPs:
// a few FLOPs a byte, far below the float32 ridge. The rows are gathered
// at random, so each 256-byte row costs a full DRAM latency; the design
// keeps four row loads in flight per warp and eight warps per block to
// hide it. Ids must be < N: an id >= N is treated as masked, never read.
#include "graph_traverse.cuh"

namespace {

// Lane `lane`'s part of the dot product of q (shared memory) and one corpus
// row: the balanced pairwise sum of the rounded products of its aligned
// block [lane * chunk, lane * chunk + chunk) of the row, zero-padded past d
// (chunk = next_pow2(d) / 32, or 1). The shuffle-down tree that follows
// (offsets 1, 2, ..., 16 into lane 0) completes the balanced tree over the
// row zero-padded to a power of two, which is the tree of the plain
// version's pairwise_sum: the two agree bit for bit.
__device__ __forceinline__ float lane_sum(const float* qs, const float* row,
                                          int d, int chunk, int lane) {
  if (chunk == 1) return lane < d ? __fmul_rn(qs[lane], row[lane]) : 0.0f;
  const int first = lane * chunk;
  if (chunk == 2) {
    const float a = first < d ? __fmul_rn(qs[first], row[first]) : 0.0f;
    const float b =
        first + 1 < d ? __fmul_rn(qs[first + 1], row[first + 1]) : 0.0f;
    return __fadd_rn(a, b);
  }
  // a cascade over the block: level l of `part` holds the sum of the last
  // complete aligned run of 2^l products
  float part[kMaxLevels];
  for (int t = 0; t < chunk; ++t) {
    const int k = first + t;
    float v = k < d ? __fmul_rn(qs[k], row[k]) : 0.0f;
    int level = 0;
    for (int m = t; m & 1; m >>= 1) v = __fadd_rn(part[level++], v);
    part[level] = v;
  }
  return part[31 - __clz(chunk)];
}

// Score the w candidate slots whose ids are at ids[0, w) (id < 0 or >= n:
// masked) against q (shared memory): cv[slot] = (2 q.v - |v|^2) - |q|^2 in
// the plain version's order, or NEG_INF and id -1 for a masked slot. Each
// warp scores kUnroll slots at a time, lane_sum and a shuffle tree a row.
// The one place a row's payload is read (graph_beam_q.cu's score_slots_q
// is the code payloads' counterpart).
__device__ __forceinline__ void score_slots(const float* qs,
                                            const float* __restrict__ db,
                                            const float* __restrict__ db_sq,
                                            float qsq, const int* ids, int w,
                                            int n, int d, float* cv,
                                            int* ci) {
  int chunk = 1;                 // per-lane block: next_pow2(d) / 32
  while (32 * chunk < d) chunk <<= 1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int base = warp * kUnroll; base < w; base += kWarps * kUnroll) {
    int id[kUnroll];
    float acc[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int slot = base + u;
      const int v = slot < w ? ids[slot] : -1;
      id[u] = (v >= 0 && v < n) ? v : -1;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      acc[u] = id[u] >= 0
                   ? lane_sum(qs, db + (size_t)id[u] * d, d, chunk, lane)
                   : 0.0f;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
#pragma unroll
      for (int off = 1; off < 32; off <<= 1)
        acc[u] = __fadd_rn(acc[u], __shfl_down_sync(0xffffffffu, acc[u], off));
    if (lane == 0) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int slot = base + u;
        if (slot >= w) break;
        if (id[u] >= 0) {
          // the plain version's order: (2 * dot - |v|^2) - |q|^2, unfused
          cv[slot] = __fsub_rn(__fsub_rn(__fmul_rn(2.0f, acc[u]),
                                         db_sq[id[u]]), qsq);
          ci[slot] = id[u];
        } else {
          cv[slot] = kNegInf;
          ci[slot] = -1;
        }
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
graph_beam_kernel(const float* __restrict__ q, const float* __restrict__ db,
                  const float* __restrict__ db_sq,
                  const float* __restrict__ q_sq,
                  const int* __restrict__ nbr, const float* __restrict__ bv,
                  const int* __restrict__ bi, float* __restrict__ out_v,
                  int* __restrict__ out_i, int n, int d, int w, int ef) {
  extern __shared__ float smem[];
  float* qs = smem;              // [d]
  float* bvs = qs + d;           // [ef] beam values, pads read as NEG_INF
  float* cv = bvs + ef;          // [w] candidate scores, slot order
  int* ci = (int*)(cv + w);      // [w] candidate ids, slot order
  float* sv = (float*)(ci + w);  // [w] scores, sorted
  int* si = (int*)(sv + w);      // [w] ids, sorted

  const int r = blockIdx.x;
  const int tid = threadIdx.x;
  const float* qrow = q + (size_t)r * d;
  const int* bi_row = bi + (size_t)r * ef;
  const float* bv_row = bv + (size_t)r * ef;

  for (int k = tid; k < d; k += kThreads) qs[k] = qrow[k];
  for (int i = tid; i < ef; i += kThreads)
    bvs[i] = bi_row[i] < 0 ? kNegInf : bv_row[i];
  __syncthreads();
  score_slots(qs, db, db_sq, q_sq[r], nbr + (size_t)r * w, w, n, d, cv, ci);
  __syncthreads();
  rank_sort(cv, ci, w, sv, si);
  __syncthreads();
  co_rank_merge(sv, si, w, bvs, bi_row, nullptr, ef, out_v + (size_t)r * ef,
                out_i + (size_t)r * ef, nullptr);
}

// The float32 payload of the traversal: q [Q, d] staged, |q|^2 the bias,
// score_slots over the corpus rows.
struct F32Rows {
  const float* q;
  const float* db;
  const float* db_sq;
  const float* q_sq;
  int dop;   // d
  __device__ const float* operand(int r) const { return q + (size_t)r * dop; }
  __device__ float bias(int r) const { return q_sq[r]; }
  __device__ void score(const float* qs, float qb, const int* ids, int w,
                        int n, float* cv, int* ci) const {
    score_slots(qs, db, db_sq, qb, ids, w, n, dop, cv, ci);
  }
};

size_t smem_bytes(int d, int w, int ef) {
  return sizeof(float) * ((size_t)d + ef + 4 * (size_t)w);
}

}  // namespace

// Shared memory a launch needs, in bytes (the wrapper checks it against the
// card's per-block limit).
extern "C" long long graph_beam_smem(int d, int w, int ef) {
  return (long long)smem_bytes(d, w, ef);
}

// Returns 0, -1 for arguments out of range, or a cudaError_t code.
extern "C" int graph_beam_launch(const float* q, const float* db,
                                 const float* db_sq, const float* q_sq,
                                 const int* nbr, const float* bv,
                                 const int* bi, float* out_v, int* out_i,
                                 int nq, int n, int d, int w, int ef,
                                 void* stream) {
  if (nq == 0) return 0;
  if (d < 1 || w < 1 || w > kMaxW || ef < 1 || ef > kMaxEf) return -1;
  const size_t smem = smem_bytes(d, w, ef);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        graph_beam_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  graph_beam_kernel<<<nq, kThreads, smem, (cudaStream_t)stream>>>(
      q, db, db_sq, q_sq, nbr, bv, bi, out_v, out_i, n, d, w, ef);
  return (int)cudaGetLastError();
}

// Shared memory of a traversal launch, in bytes; smem_words: words of the
// visited set kept in shared memory (0 when it is a global matrix).
extern "C" long long graph_traverse_smem(int d, int w0, int m, int ef,
                                         int smem_words) {
  return (long long)traverse_smem(d, w0, m, ef, smem_words);
}

// The traversal of nq queries, one block each. vis_g: null (the visited
// bits in shared memory) or a zeroed [nq, words] matrix. alive: null or
// [n] uint8. Returns 0, -1 for arguments out of range, or a cudaError_t.
extern "C" int graph_traverse_launch(
    const float* q, const float* db, const float* db_sq, const float* q_sq,
    const int* nbrs0, const int* upper, const unsigned char* alive, int nq,
    int n, int d, int w0, int m, int levels, int entry, int ef,
    unsigned* vis_g, float* out_v, int* out_i, long long* evals,
    int* hops, void* stream) {
  const F32Rows pay{q, db, db_sq, q_sq, d};
  return traverse_launch(pay, nbrs0, upper, alive, nq, n, w0, m, levels,
                         entry, ef, vis_g, out_v, out_i, evals, hops,
                         (cudaStream_t)stream);
}
