// Deterministic scatter-gather top-k merge for Hopper (sm_90a).
//
// Each query row holds C candidates (value, global id) gathered from the
// shards; the row's output is its k best under the total order
//   (value descending, id ascending),
// values compared as floats (-0.0 == +0.0: a tie, broken by the id).
// Pads are decided by the id alone: a slot with id < 0 enters the merge as
// (NEG_INF, ID_MAX) and every output slot whose id is ID_MAX comes out as
// (NEG_INF, -1). A live id keeps its own value on the way out, NEG_INF or
// -inf included, and its own sign of zero. The order is the one of the
// plain version (kernels/topk_merge/ref.py), so the two agree bit for bit.
//
// Replaces the TPU kernel topk_merge_pallas
// (src/repro/kernels/topk_merge/kernel.py:71), which holds a block of rows
// in VMEM and takes k sweeps of max / min-id / mask.
//
// Bound: bytes. A row reads 8C bytes and writes 8k: at the sharded
// search's shape (Q = 256, C = k1 x 8 shards = 320, k = 40) the whole merge
// moves 0.74 MB, 0.22 us at 3.35 TB/s, under the cost of a launch. What is
// left is the latency of a row's chain of dependent steps, so the design
// selects first, sorts only what is output, and spreads a row over enough
// warps that each step is short. A block holds a row: kNarrowThreads
// threads up to kNarrowMaxC candidates (the main path's 320: 3 keys a
// thread), kWideThreads above (up to kMaxC = 16384, KNOB_LADDER's top rung
// 2048 x 8 shards: 32 keys a thread). A pair's key is topk_select.cuh's
// make_key (larger = better; a pad is make_key(NEG_INF, ID_MAX), whose low
// word is 0; live ids are unique in a row, so live keys are distinct),
// held in registers beside the entry's own value bits (slots tid + u G of
// a block of G threads), every load of the row in flight at once.
//   1. A cut to the k-th key. Narrow rows: a pass counts the candidates
//      of each value of a kDigit-bit window of their keys, one bin a lane,
//      from six ballots a key slot (no atomic), adds the warps' counts in
//      shared memory (one barrier), and keeps the bin where the k-th falls
//      as the candidates. The first window starts at the candidates'
//      highest differing bit (warp reductions of their OR and AND, added
//      over the warps: one more barrier), and so does a window after a
//      pass that split nothing; the others are the kDigit bits below the
//      last. Once 32 candidates or fewer are left, they go to shared
//      memory (one barrier) and each one's rank among them gives the cut
//      at one key. Wide rows: 8-bit digits from the row's highest
//      differing bit, a 256-bin shared histogram a pass (pick_digit, three
//      barriers). Either stops at the first pass whose chosen bin holds
//      exactly the pairs still needed, or when the candidates are one key.
//   2. The keep pass: every key above the cut and, of the keys at it, only
//      as many as are still needed. Pads share one key, so more than
//      C - k of them can sit at the cut; they print alike, and which are
//      kept does not matter. A thread counts its kept keys, a warp scan and
//      the warps' totals place them, and a dropped key goes to a spare
//      slot: no store waits on a branch.
//   3. Up to kRankMaxK survivors each one's rank is counted against the
//      others and it is written there; above, a bitonic sort of the k
//      survivors padded to a power of two (the stages that stay inside a
//      warp's slots end in __syncwarp). At C = 16384, k = 2048 that sorts
//      2048 slots, not 16,384.
// A narrow row takes four warps, not one: a lone warp runs its dependent
// steps one after another, and with 10 keys a lane its cut passes were
// the kernel's time. Narrow rows keep their own cut: the wide rows'
// histogram cut run on them was 8-10% slower on an H100 at C = 320
// (PERF.md, section 6).
#include <cuda_runtime.h>
#include <stdint.h>

#include "topk_select.cuh"

namespace {

constexpr int kMaxC = 16384;
constexpr int kNarrowMaxC = 1024;    // widest row of a narrow block
constexpr int kNarrowThreads = 128;  // a narrow row's block
constexpr int kWideThreads = 512;    // a wide row's block
constexpr int kWideKeys = kMaxC / kWideThreads;  // keys a thread there
constexpr int kRankMaxK = 128;       // rank-count the survivors up to here
constexpr int kDigit = 5;            // bits a narrow cut pass counts
constexpr uint32_t kIdMax = 0x7fffffffu;  // the pads' tie-break id

// Shared memory before the survivors (12 bytes a slot, the sort's p and
// 32 spare) in a block of `threads`: the warps' OR / AND words (two
// buffers: a pass writes one while the last pass's is read), their bin
// counts (narrow: two buffers of 32 a warp; wide: the shared 257-bin
// histogram) and their keep totals.
__host__ __device__ constexpr int bin_ints(int threads) {
  return threads == kNarrowThreads ? 2 * (threads / 32) * 32 : 264;
}
__host__ __device__ constexpr int extra_smem(int threads) {
  return ((threads / 32) * (2 * 4 + 1) + bin_ints(threads)) * 4;
}

// The warps' OR and AND of the keys whose bit u of `in` is set, over the
// block (a warp's words to buf, a barrier, every thread adds them up):
// {OR high word, OR low word, AND high word, AND low word}.
template <int W, int R>
__device__ __forceinline__ uint4 block_or_and(const uint64_t (&key)[R],
                                              unsigned in, int tid,
                                              uint4* buf) {
  uint64_t o = 0, a = ~0ull;
#pragma unroll
  for (int u = 0; u < R; ++u) {
    const bool on = (in >> u) & 1;
    o |= on ? key[u] : 0;
    a &= on ? key[u] : ~0ull;
  }
  uint4 mine;
  mine.x = __reduce_or_sync(0xffffffffu, (uint32_t)(o >> 32));
  mine.y = __reduce_or_sync(0xffffffffu, (uint32_t)o);
  mine.z = __reduce_and_sync(0xffffffffu, (uint32_t)(a >> 32));
  mine.w = __reduce_and_sync(0xffffffffu, (uint32_t)a);
  if ((tid & 31) == 0) buf[tid >> 5] = mine;
  __syncthreads();
  uint4 all = buf[0];
#pragma unroll
  for (int i = 1; i < W; ++i) {
    const uint4 x = buf[i];
    all.x |= x.x;
    all.y |= x.y;
    all.z &= x.z;
    all.w &= x.w;
  }
  return all;
}

// The end of the narrow cut once n <= 32 candidates are left (cand, the
// pass's per-warp bin counts bbuf and its digit): they go to stage in slot
// order, a barrier, and every warp ranks them alike (equal keys by place):
// the cut is the need-th largest, at shift 0, and only the candidates
// above it are kept for sure.
template <int W, int R>
__device__ __forceinline__ void few_cut(const uint64_t (&key)[R],
                                        unsigned cand, int n, const int* bbuf,
                                        int digit, int lane, int w,
                                        uint64_t* stage, int* shift,
                                        uint64_t* prefix, int* need) {
  int pos = 0;
#pragma unroll
  for (int i = 0; i < W; ++i) pos += i < w ? bbuf[i * 32 + digit] : 0;
#pragma unroll
  for (int u = 0; u < R; ++u) {
    const bool on = (cand >> u) & 1;
    const unsigned b = __ballot_sync(0xffffffffu, on);
    if (on) stage[pos + __popc(b & lanemask_lt())] = key[u];
    pos += __popc(b);
  }
  __syncthreads();
  const uint64_t mk = stage[min(lane, n - 1)];
  int rank = 0;
#pragma unroll 4
  for (int j = 0; j < n; ++j) {
    const uint64_t kj = stage[j];
    rank += kj > mk || (kj == mk && j < lane);
  }
  const int src =
      __ffs(__ballot_sync(0xffffffffu, lane < n && rank == *need - 1)) - 1;
  const uint64_t cut_key = __shfl_sync(0xffffffffu, mk, src);
  *need -= __popc(__ballot_sync(0xffffffffu, lane < n && mk > cut_key));
  *shift = 0;
  *prefix = cut_key;
}

// The narrow blocks' cut of the row's c keys (slots tid + G u) to the
// k-th: (shift, prefix, need) such that the keys with key >> shift above
// prefix >> shift are kept, and `need` of those equal to it. A pass counts
// the candidates of each value of a kDigit-bit window, one bin a lane,
// from ballots, the warps' counts added in shared memory (one barrier),
// and keeps the bin where the k-th falls. The first window starts at the
// candidates' highest differing bit (their OR and AND: one more barrier),
// and so does the window after a pass that split nothing; the others are
// the kDigit bits below the last. few_cut ends it once 32 candidates or
// fewer are left.
template <int G, int R>
__device__ __forceinline__ void ballot_cut(const uint64_t (&key)[R], int c,
                                           int k, int tid, uint32_t* words,
                                           int* bins, uint64_t* stage,
                                           int* shift, uint64_t* prefix,
                                           int* need) {
  constexpr int W = G / 32;
  const int lane = tid & 31, w = tid >> 5;
  unsigned cand = 0;
#pragma unroll
  for (int u = 0; u < R; ++u) cand |= tid + G * u < c ? 1u << u : 0u;
  int n_cand = c, lo = 0;
  bool jump = true;
  *need = k;
  for (int pass = 0;; ++pass) {
    if (jump) {
      const uint4 all = block_or_and<W>(
          key, cand, tid, reinterpret_cast<uint4*>(words) + (pass & 1) * W);
      const uint64_t diff =
          ((uint64_t)(all.x ^ all.z) << 32) | (all.y ^ all.w);
      const uint64_t common = ((uint64_t)all.z << 32) | all.w;
      if (diff == 0) {  // the candidates are one key
        *shift = 0;
        *prefix = common;
        return;
      }
      lo = max(63 - __clzll(diff) - (kDigit - 1), 0);
      *prefix = lo + kDigit >= 64 ? 0 : common >> (lo + kDigit)
                                              << (lo + kDigit);
    } else {
      lo = max(lo - kDigit, 0);
    }
    // lane l counts the warp's candidates whose window holds l (every
    // slot, so that the compiler interleaves them; past the row none is a
    // candidate)
    int cnt = 0;
    unsigned dig[R];
#pragma unroll
    for (int u = 0; u < R; ++u) {
      dig[u] = (unsigned)(key[u] >> lo) & 31;
      unsigned m = __ballot_sync(0xffffffffu, (cand & 1u << u) != 0);
#pragma unroll
      for (int i = 0; i < kDigit; ++i) {
        const unsigned plane =
            __ballot_sync(0xffffffffu, (dig[u] & 1u << i) != 0);
        m &= (lane >> i) & 1 ? plane : ~plane;
      }
      cnt += __popc(m);
    }
    int* bbuf = bins + (pass & 1) * W * 32;
    bbuf[w * 32 + lane] = cnt;
    __syncthreads();
    cnt = 0;
#pragma unroll
    for (int i = 0; i < W; ++i) cnt += bbuf[i * 32 + lane];
    int at_or_above = cnt;  // candidates in the bins >= lane
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_down_sync(0xffffffffu, at_or_above, off);
      at_or_above += lane + off < 32 ? y : 0;
    }
    const int digit =
        31 - __clz(__ballot_sync(0xffffffffu, at_or_above >= *need));
    const int in_bin = __shfl_sync(0xffffffffu, cnt, digit);
    *need -= __shfl_sync(0xffffffffu, at_or_above, digit) - in_bin;
    *prefix |= (uint64_t)digit << lo;  // bits the window shares with it agree
    unsigned kept = 0;  // the candidates that stay
#pragma unroll
    for (int u = 0; u < R; ++u)
      kept |= dig[u] == (unsigned)digit ? 1u << u : 0u;
    cand &= kept;
    if (in_bin == *need || lo == 0) {  // lo 0: the candidates are one key
      *shift = lo;
      return;
    }
    if (in_bin <= 32) {  // few left: their ranks place the cut at one key
      few_cut<W, R>(key, cand, in_bin, bbuf, digit, lane, w, stage, shift,
                    prefix, need);
      return;
    }
    jump = in_bin == n_cand;
    n_cand = in_bin;
  }
}

// The wide blocks' cut, with ballot_cut's result: 8-bit digits from the
// byte that holds the row's highest differing bit, a 256-bin shared
// histogram a pass (pick_digit), three barriers a pass. hist [257] and
// scal [4] alias the block's bins and words past its first OR / AND.
template <int G, int R>
__device__ __forceinline__ void hist_cut(const uint64_t (&key)[R], int nu,
                                         int c, int k, int tid,
                                         uint32_t* words, int* hist,
                                         int* shift_out, uint64_t* prefix_out,
                                         int* need_out) {
  unsigned in = 0;
#pragma unroll
  for (int u = 0; u < R; ++u) in |= tid + G * u < c ? 1u << u : 0u;
  const uint4 all =
      block_or_and<G / 32>(key, in, tid, reinterpret_cast<uint4*>(words));
  int* scal = reinterpret_cast<int*>(words) + 4 * (G / 32);
  const uint64_t diff = ((uint64_t)(all.x ^ all.z) << 32) | (all.y ^ all.w);
  const uint64_t common = ((uint64_t)all.z << 32) | all.w;
  int need = k, shift = 0;
  uint64_t prefix = common;  // the row's one key, when diff is 0
  if (diff) {
    const int first = (63 - __clzll(diff)) / 8 * 8;
    prefix = first == 56 ? 0 : common >> (first + 8) << (first + 8);
    shift = first + 8;
    for (;;) {
      shift -= 8;
      for (int i = tid; i < 257; i += G) hist[i] = 0;
      __syncthreads();
#pragma unroll
      for (int u = 0; u < R; ++u) {
        if (u >= nu) break;
        const bool on = ((in >> u) & 1) &&
                        (shift == first || (key[u] >> (shift + 8)) ==
                                               (prefix >> (shift + 8)));
        atomicAdd(&hist[on ? (int)((key[u] >> shift) & 255) : 256], 1);
      }
      __syncthreads();
      if (tid < 32) {
        int above, in_bin;
        const int digit = pick_digit(hist, need, &above, &in_bin);
        if (tid == 0) {
          scal[0] = digit;
          scal[1] = above;
          scal[2] = in_bin;
        }
      }
      __syncthreads();
      need -= scal[1];
      prefix |= (uint64_t)scal[0] << shift;
      if (scal[2] == need || shift == 0) break;
    }
  }
  *shift_out = shift;
  *prefix_out = prefix;
  *need_out = need;
}

// Writes a survivor (its key and value) to output slot s.
__device__ __forceinline__ void write_pair(float* __restrict__ ov,
                                           int* __restrict__ oi, int s,
                                           uint64_t key, float v) {
  const uint32_t lo = (uint32_t)key;  // kIdMax - tie-break id
  ov[s] = lo == 0 ? kNegInf : v;
  oi[s] = lo == 0 ? kPadId : (int)(kIdMax - lo);
}

// Sorts the p keys of sk (and sv beside them) best first (larger key
// first). Thread tid of a block of G: lane l of warp w owns the pairs w *
// 32 L + i * 32 + l, i < L = max(1, p / 2G), so a stage of stride <= 32 L
// compares slots inside the warp's own 64 L and needs only __syncwarp.
template <int G>
__device__ __forceinline__ void sort_desc(uint64_t* sk, float* sv, int p,
                                          int tid) {
  const int lane = tid & 31, w = tid >> 5;
  const int per_lane = max(1, p / (2 * G));
  const int per_warp = 32 * per_lane;
  const int half = p >> 1;
  for (int size = 2; size <= p; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = 0; i < per_lane; ++i) {
        const int t = w * per_warp + i * 32 + lane;
        if (t < half) {
          const int lo = 2 * t - (t & (stride - 1)), hi = lo + stride;
          const uint64_t a = sk[lo], b = sk[hi];
          const float x = sv[lo], y = sv[hi];
          const bool swap = (lo & size) == 0 ? a < b : a > b;
          sk[lo] = swap ? b : a;
          sk[hi] = swap ? a : b;
          sv[lo] = swap ? y : x;
          sv[hi] = swap ? x : y;
        }
      }
      const int next = stride > 1 ? stride >> 1 : size;  // next stage's
      if (stride > per_warp || next > per_warp) __syncthreads();
      else __syncwarp();
    }
  }
  __syncthreads();
}

// One row's merge by a block of G threads, thread tid holding slots tid +
// u G, u < R. smem: extra_smem(G) + 12 (p + 32) bytes.
template <int G, int R>
__global__ void __launch_bounds__(G)
topk_merge_kernel(const float* __restrict__ vals, const int* __restrict__ ids,
                  float* __restrict__ out_v, int* __restrict__ out_i, int c,
                  int k, int p) {
  constexpr int W = G / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* words = reinterpret_cast<uint32_t*>(smem);   // [2][W][4]
  int* bins = reinterpret_cast<int*>(words + 2 * W * 4);
  int* totals = bins + bin_ints(G);                       // [W]
  uint64_t* sk = reinterpret_cast<uint64_t*>(smem + extra_smem(G));
  float* sv = reinterpret_cast<float*>(sk + p + 32);      // [p + 32]
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const long long r = blockIdx.x;
  const float* vrow = vals + r * c;
  const int* irow = ids + r * c;
  float* ov = out_v + r * k;
  int* oi = out_i + r * k;
  const int nu = min(R, (c + G - 1) / G);  // slots a thread holds

  // every load in flight at once (slot c - 1 stands in for those past the
  // row), then the keys
  int id[R];
  float val[R];
#pragma unroll
  for (int u = 0; u < R; ++u) {
    const int j = min(tid + u * G, c - 1);
    id[u] = irow[j];
    val[u] = vrow[j];
  }
  const uint64_t pad_key = make_key(kNegInf, (int)kIdMax);
  uint64_t key[R];
#pragma unroll
  for (int u = 0; u < R; ++u)
    key[u] = id[u] < 0 ? pad_key : make_key(val[u], id[u]);

  // 1. the cut (none when every pair is kept)
  int shift = 64, need = 0;
  uint64_t prefix = 0;
  if (k < c) {
    if constexpr (G == kNarrowThreads)
      ballot_cut<G, R>(key, c, k, tid, words, bins, sk, &shift, &prefix,
                       &need);
    else
      hist_cut<G, R>(key, nu, c, k, tid, words, bins, &shift, &prefix,
                     &need);
  }

  // 2. keep the keys above the cut (output slots [0, k - need)) and `need`
  // of those at it (slots [k - need, k)); a dropped key goes to the lane's
  // spare slot
  const uint64_t top = shift == 64 ? 0 : prefix >> shift;
  unsigned above = 0, at = 0;
#pragma unroll
  for (int u = 0; u < R; ++u) {
    const bool in = tid + u * G < c;
    const uint64_t t = shift == 64 ? 1 : key[u] >> shift;
    above |= in && t > top ? 1u << u : 0u;
    at |= in && t == top ? 1u << u : 0u;
  }
  const int mine = (__popc(at) << 16) | __popc(above);
  int incl = mine;  // inclusive prefix of the (at, above) counts
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, off);
    incl += lane >= off ? y : 0;
  }
  if (lane == 31) totals[w] = incl;
  __syncthreads();
  int base = incl - mine;
#pragma unroll
  for (int i = 0; i < W; ++i) base += i < w ? totals[i] : 0;
  const int kept = k - need;
  int n_above = base & 0xffff, n_at = base >> 16;
#pragma unroll
  for (int u = 0; u < R; ++u) {
    const bool a = (above >> u) & 1, e = (at >> u) & 1;
    const int pos = a ? n_above : e && n_at < need ? kept + n_at : p + lane;
    n_above += a;
    n_at += e;
    sk[pos] = key[u];
    sv[pos] = val[u];
  }
  __syncthreads();

  // 3. order the k survivors and write them
  if (k <= kRankMaxK) {  // 2^lt threads a survivor count its rank
    const int lt =
        min(5, __ffs(G) - 1 - max(1, 32 - __clz(k - 1)));  // log2 G / k
    const int t = 1 << lt, s = tid >> lt, part = tid & (t - 1);
    const uint64_t ks = sk[min(s, k - 1)];
    int rank = 0;
#pragma unroll 4
    for (int j = part; j < k; j += t) {
      const uint64_t kj = sk[j];
      rank += kj > ks || (kj == ks && j < s);  // equal keys: the pads
    }
    for (int off = 1; off < t; off <<= 1)
      rank += __shfl_xor_sync(0xffffffffu, rank, off);
    if (part == 0 && s < k) write_pair(ov, oi, rank, ks, sv[s]);
    return;
  }
  for (int s = k + tid; s < p; s += G) sk[s] = 0;  // the tail sorts last
  __syncthreads();
  sort_desc<G>(sk, sv, p, tid);
  for (int s = tid; s < k; s += G) write_pair(ov, oi, s, sk[s], sv[s]);
}

static_assert(kNarrowThreads >= kRankMaxK, "a thread or more a survivor");

int sort_width(int k) {
  int p = 2;
  while (p < k) p <<= 1;
  return p;
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, int threads, const float* vals,
                   const int* ids, float* out_v, int* out_i, int nq, int c,
                   int k, size_t smem, cudaStream_t s) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<nq, threads, smem, s>>>(vals, ids, out_v, out_i, c, k,
                                   sort_width(k));
  return cudaGetLastError();
}

}  // namespace

// The kernel's geometry, for the wrapper's check.
extern "C" int topk_merge_max_c() { return kMaxC; }
extern "C" int topk_merge_narrow_max_c() { return kNarrowMaxC; }
extern "C" int topk_merge_narrow_threads() { return kNarrowThreads; }
extern "C" int topk_merge_wide_threads() { return kWideThreads; }
extern "C" int topk_merge_rank_max_k() { return kRankMaxK; }
extern "C" int topk_merge_digit_bits() { return kDigit; }

// Shared memory of a launch at width c and k, in bytes.
extern "C" long long topk_merge_smem(int c, int k) {
  const int threads = c <= kNarrowMaxC ? kNarrowThreads : kWideThreads;
  return 12LL * (sort_width(k) + 32) + extra_smem(threads);
}

// vals [nq, c] float32, ids [nq, c] int32, contiguous; out [nq, k].
// Returns 0, -1 for arguments out of range, or a cudaError_t code.
extern "C" int topk_merge_launch(const float* vals, const int* ids,
                                 float* out_v, int* out_i, int nq, int c,
                                 int k, void* stream) {
  if (nq == 0) return 0;
  if (nq < 0 || c < 1 || c > kMaxC || k < 1 || k > c) return -1;
  const size_t smem = (size_t)topk_merge_smem(c, k);
  cudaStream_t s = (cudaStream_t)stream;
  constexpr int N = kNarrowThreads;
  if (c > kNarrowMaxC)
    return (int)launch(topk_merge_kernel<kWideThreads, kWideKeys>,
                       kWideThreads, vals, ids, out_v, out_i, nq, c, k, smem,
                       s);
  return (int)launch(c <= N       ? topk_merge_kernel<N, 1>
                     : c <= 2 * N ? topk_merge_kernel<N, 2>
                     : c <= 3 * N ? topk_merge_kernel<N, 3>
                     : c <= 4 * N ? topk_merge_kernel<N, 4>
                                  : topk_merge_kernel<N, 8>,
                     N, vals, ids, out_v, out_i, nq, c, k, smem, s);
}
