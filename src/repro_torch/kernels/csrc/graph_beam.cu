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
// Bound: bytes. A hop reads Q*W*(4d + 8) bytes of gathered rows, norms and
// ids, and 16*Q*ef bytes of beam in and out, against about 2*Q*W*d FLOPs:
// a few FLOPs a byte, far below the float32 ridge. The rows are gathered
// at random, so each 256-byte row costs a full DRAM latency; the design
// keeps four row loads in flight per warp and eight warps per block to
// hide it. Ids must be < N: an id >= N is treated as masked, never read.
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
  int chunk = 1;                 // per-lane block: next_pow2(d) / 32
  while (32 * chunk < d) chunk <<= 1;
  const int lane = tid & 31, warp = tid >> 5;
  const float* qrow = q + (size_t)r * d;
  const int* ids_row = nbr + (size_t)r * w;
  const float* bv_row = bv + (size_t)r * ef;
  const int* bi_row = bi + (size_t)r * ef;

  for (int k = tid; k < d; k += kThreads) qs[k] = qrow[k];
  for (int i = tid; i < ef; i += kThreads)
    bvs[i] = bi_row[i] < 0 ? kNegInf : bv_row[i];
  __syncthreads();

  const float qsq = q_sq[r];
  for (int base = warp * kUnroll; base < w; base += kWarps * kUnroll) {
    int id[kUnroll];
    float acc[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int slot = base + u;
      const int v = slot < w ? ids_row[slot] : -1;
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
    const float c = sv[j];
    const int p = j + count_ge(bvs, ef, c);
    if (p < ef) {
      const int id = si[j];
      ov[p] = id < 0 ? kNegInf : c;
      oi[p] = id;
    }
  }
}

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
