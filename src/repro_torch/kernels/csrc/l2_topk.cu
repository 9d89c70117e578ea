// Fused L2 scan + exact top-k for Hopper (sm_90a).
//
// For each query q and corpus row j: score = 2 q.d_j - dsq_j (float32, one
// fmaf per term in increasing dimension order from 0; dsq_j = |d_j|^2, or a
// large penalty for rows that must never win, is computed once per corpus by
// the caller). Returns, per query, the k best pairs of the multiset
//   {(score_j, j) : j < N}  U  {k copies of (NEG_INF, -1)}
// under the total order (score descending, id ascending). The k pad pairs
// give k > N its (NEG_INF, -1) tail, and make a penalised row (score about
// -1e30) lose to a pad, as the TPU kernel's running merge does.
//
// Replaces the TPU kernel l2_topk_pallas (src/repro/kernels/l2_topk/
// kernel.py), whose per-tile k sweeps of max/argmax/mask carry a running
// top-k across a sequential grid. Blocks on the card run in parallel, and
// the scan and the selection want different things of them, so the two are
// kept apart:
//   scan:   block = (64-query tile, chunk of rows), one block an SM. The
//           64 x 256 score tile of a step is a register tile of 8 queries x
//           8 rows a thread; the query and row slices (32 dimensions) come
//           into a 3-stage shared-memory ring by cp.async, so the next
//           slices load while the FMAs run, and are read as 16-byte words
//           (a row slice padded to 36 floats: conflict-free). 16 shared
//           loads feed 256 FMAs. With 64 queries a block the corpus is read
//           from device memory ceil(Q / 64) times, the tiles of one chunk
//           running side by side (blocks of a chunk are adjacent) so L2
//           serves most of the repeats.
//   arithmetic: SIMT fmaf in increasing dimension order, as the previous
//           kernel and the plain version's float32 matmul (cuBLAS, a batch
//           of queries) sum: the scores are bit for bit those of before, so
//           ids stay equal to the plain version's. The tensor cores
//           (3xTF32) would need a filter with an error margin and an exact
//           re-score; the selection, not the scan, was what cost, so it was
//           not taken.
//   select: a warp owns 8 of the block's queries and all 256 rows of a tile
//           for them. Each (query, chunk) keeps a threshold (the k-th best
//           pair its list has kept) and a survivor list. A group of 32
//           scores (one a lane) is offered at once: a ballot counts those
//           that beat the threshold, each lane writes its own at cnt + its
//           rank in the ballot - no atomics. A cut keeps a list's k best by
//           a radix select on the 64-bit key (order-preserving score bits
//           above 0x7fffffff - id, so ties go to the lower id): 8-bit digits
//           from the top, one shared histogram a pass (one atomic a distinct
//           bin a warp) over the pairs that match the digits so far,
//           stopping when the chosen bin holds exactly the pairs still
//           needed; the threshold rises to the k-th key. Only that list is
//           touched. Where the block's 64 lists fit in shared memory (k up to
//           64 on the H100) a warp cuts its own list when a group would
//           overflow it; otherwise the lists live in device memory with room
//           for one more tile, and the block cuts each list past its cut
//           point together, staged in shared memory, after the tile.
//   seed:   a list that starts from the pad pair lets through every score
//           until its first cut, then the k-th best of what it has seen: at
//           k = 2048 and chunks of 30k rows about a third of all scores. So
//           the wrapper first runs the same kernel over every 16th (and
//           256th) row, and each list of the next pass starts from that
//           pass's k-th pair: a lower bound of the k-th best (it is the k-th
//           best of a subset), so nothing it drops could be in the answer.
//   pass 2: one block a query selects k from its chunks' lists with the same
//           select over device memory (chunk by chunk when lists are long,
//           all slots at once when short, eight loads a thread in flight),
//           then sorts those k alone (bitonic, shared memory) and pads the
//           tail.
// Every score equal: keys differ by id, rows arrive in increasing id, so
// after the first cut nothing beats the threshold.
//
// Bound: at the port's shapes (d = 64, Q = 256) the scan does 2*Q*N*d FLOPs
// against 4*N*d bytes of corpus, far above the float32 ridge: bound by
// SIMT float32 operations. The selection adds one compare a score, the
// pilots 1/16 + 1/256 of the scan, and the appends past the seed.
#include "topk_select.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBQ = 64;            // queries a block, 8 a warp
constexpr int kBN = 256;           // rows a tile, 8 a lane
constexpr int kDK = 32;            // dimensions a stage
constexpr int kLd = kDK + 4;       // padded slice row, floats (144 bytes)
constexpr int kStages = 3;
constexpr int kStageFloats = (kBQ + kBN) * kLd;
constexpr int kMaxK = 4032;

// Stage (tile t, slice s) of the ring: the block's 64 query rows and the
// tile's 256 corpus rows (scan row r is corpus row r * step), dimensions
// [32 s, 32 s + 32), zero-filled past the edges. kVec: 16-byte copies
// (d % 4 == 0, 16-byte aligned rows).
template <bool kVec>
__device__ __forceinline__ void load_stage(float* st, const float* q,
                                           const float* db, int nq, int d,
                                           int q0, long long r0,
                                           long long r_end, int k0,
                                           int step) {
  float* qs = st;
  float* ds = st + kBQ * kLd;
  const int tid = threadIdx.x;
  if (kVec) {
    for (int p = tid; p < kBQ * (kDK / 4); p += kThreads) {
      const int r = p / (kDK / 4), c = 4 * (p % (kDK / 4));
      const bool ok = q0 + r < nq && k0 + c < d;
      cp_async16(qs + r * kLd + c,
                 ok ? q + (long long)(q0 + r) * d + k0 + c : q, ok);
    }
    for (int p = tid; p < kBN * (kDK / 4); p += kThreads) {
      const int r = p / (kDK / 4), c = 4 * (p % (kDK / 4));
      const bool ok = r0 + r < r_end && k0 + c < d;
      cp_async16(ds + r * kLd + c,
                 ok ? db + (r0 + r) * step * d + k0 + c : db, ok);
    }
  } else {
    for (int p = tid; p < kBQ * kDK; p += kThreads) {
      const int r = p / kDK, c = p % kDK;
      const bool ok = q0 + r < nq && k0 + c < d;
      cp_async4(qs + r * kLd + c,
                ok ? q + (long long)(q0 + r) * d + k0 + c : q, ok);
    }
    for (int p = tid; p < kBN * kDK; p += kThreads) {
      const int r = p / kDK, c = p % kDK;
      const bool ok = r0 + r < r_end && k0 + c < d;
      cp_async4(ds + r * kLd + c,
                ok ? db + (r0 + r) * step * d + k0 + c : db, ok);
    }
  }
}

// Block-wide cut of one list: the n pairs at (gv, gi) (shared or device
// memory) are staged in shared memory (sv, si), radix-selected to their k
// best with the block's threads, and written back to (gv, gi)[0, k), in no
// order. Returns the k-th best key to every thread. Called by the whole
// block, uniformly; sel: the block's shared scalars.
struct BlockSel {
  int hist[256];
  int digit, above, in_bin, out;
  unsigned long long kth;
};

__device__ uint64_t block_select(float* gv, int* gi, int n, int k,
                                 float* sv, int* si, BlockSel& sel) {
  const int tid = threadIdx.x;
  const int lane = tid & 31, w0 = (tid >> 5) * 32;
  for (int p0 = tid; p0 < n; p0 += 8 * kThreads) {   // 8 loads in flight
    float v[8];
    int id[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int p = p0 + u * kThreads;
      if (p < n) {
        v[u] = gv[p];
        id[u] = gi[p];
      }
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int p = p0 + u * kThreads;
      if (p < n) {
        sv[p] = v[u];
        si[p] = id[u];
      }
    }
  }
  if (tid == 0) {
    sel.out = 0;
    sel.kth = ~0ull;
  }
  uint64_t prefix = 0;
  int need = k, shift = 64;
  for (;;) {
    shift -= 8;
    for (int i = tid; i < 256; i += kThreads) sel.hist[i] = 0;
    __syncthreads();
    for (int p0 = w0; p0 < n; p0 += kThreads) {      // warp-uniform
      const int p = p0 + lane;
      const uint64_t key = p < n ? make_key(sv[p], si[p]) : 0;
      hist_add(sel.hist, (int)((key >> shift) & 255),
               p < n && (shift == 56 ||
                         (key >> (shift + 8)) == (prefix >> (shift + 8))));
    }
    __syncthreads();
    if (tid < 32) {
      int above, in_bin;
      const int digit = pick_digit(sel.hist, need, &above, &in_bin);
      if (tid == 0) {
        sel.digit = digit;
        sel.above = above;
        sel.in_bin = in_bin;
      }
    }
    __syncthreads();
    need -= sel.above;
    prefix |= (uint64_t)sel.digit << shift;
    const bool done = sel.in_bin == need || shift == 0;
    __syncthreads();
    if (done) break;
  }
  for (int p = tid; p < n; p += kThreads) {
    const uint64_t key = make_key(sv[p], si[p]);
    if ((key >> shift) >= (prefix >> shift)) {
      const int o = atomicAdd(&sel.out, 1);
      gv[o] = sv[p];
      gi[o] = si[p];
      atomicMin(&sel.kth, (unsigned long long)key);
    }
  }
  __syncthreads();
  return sel.kth;
}

// The append path of the epilogue, for one query and one tile: the lane's
// 8 scores s_j of rows row + 32 j, m the bits of those that beat the
// query's threshold (thr_v, thr_i). Groups of 32 rows (one a lane) are
// offered in order; each lane writes its pairs at cnt + its rank in the
// ballot (scan row r is corpus row r * step). kSmemLists: a group that
// would overflow the list (cap pairs) first cuts it to k (warp_select), the
// threshold rises and the group and the later ones are filtered again.
// Whole warp.
template <bool kSmemLists>
__device__ __forceinline__ void append_tile_body(
    float s0, float s1, float s2, float s3, float s4, float s5, float s6,
    float s7, unsigned m, long long row, int step, float* lv, int* li, int k,
    int cap, int* hist, float* thr_v, int* thr_i, int* cnt) {
  const float s[8] = {s0, s1, s2, s3, s4, s5, s6, s7};
  float t_v = *thr_v;
  int t_i = *thr_i;
  int n_in = *cnt;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int r = (int)((row + 32 * j) * step);
    bool take = (m >> j) & 1u;
    unsigned b = __ballot_sync(0xffffffffu, take);
    if (b == 0) continue;
    if (kSmemLists && n_in + __popc(b) > cap) {   // cut this list first
      __syncwarp();
      key_pair(warp_select(lv, li, n_in, k, hist), &t_v, &t_i);
      n_in = k;
#pragma unroll
      for (int jj = j; jj < 8; ++jj)   // this group and the later ones
        if (!better(s[jj], (int)((row + 32 * jj) * step), t_v, t_i))
          m &= ~(1u << jj);
      take = (m >> j) & 1u;
      b = __ballot_sync(0xffffffffu, take);
    }
    if (take) {
      const int p = n_in + __popc(b & lanemask_lt());
      lv[p] = s[j];
      li[p] = r;
    }
    n_in += __popc(b);
  }
  __syncwarp();
  if ((threadIdx.x & 31) == 0) {
    *cnt = n_in;
    *thr_v = t_v;
    *thr_i = t_i;
  }
  __syncwarp();
}

// With the lists in shared memory the append path holds a cut, rare after
// the first tiles: kept out of line, so the unrolled epilogue stays small
// (inlined 8 times it thrashed the instruction cache). In device memory it
// holds none and runs at most tiles, so it is inlined.
__device__ __noinline__ void append_tile_cut(
    float s0, float s1, float s2, float s3, float s4, float s5, float s6,
    float s7, unsigned m, long long row, int step, float* lv, int* li, int k,
    int cap, int* hist, float* thr_v, int* thr_i, int* cnt) {
  append_tile_body<true>(s0, s1, s2, s3, s4, s5, s6, s7, m, row, step, lv,
                         li, k, cap, hist, thr_v, thr_i, cnt);
}

// Pass 1. Block b = (chunk b / q_tiles, query tile b % q_tiles); the list
// of block-local query ql is L = b * 64 + ql. Its final <= k pairs go to
// out_v/out_i + L * k, counts[L] = their count.
// kSmemLists: the lists (cap pairs each) live in shared memory, each warp
// cuts its own when a group of 32 would overflow it. Otherwise they live in
// device memory (list_v/list_i + L * cap, cap = flush_at + 256), appends
// never cut, and after each tile the block cuts every list holding more
// than flush_at pairs, one at a time, staged in shared memory (at the start
// of the next step, after its barrier: no barrier of its own a tile).
template <bool kVec, bool kSmemLists>
__global__ void __launch_bounds__(kThreads, 1)
l2_topk_scan_kernel(const float* __restrict__ q, const float* __restrict__ db,
                    const float* __restrict__ dsq, int nq, int n_rows, int d,
                    int k, int cap, int flush_at, int chunk, int q_tiles,
                    int row_step, const float* __restrict__ init_v,
                    const int* __restrict__ init_i,
                    float* __restrict__ list_v, int* __restrict__ list_i,
                    float* __restrict__ out_v, int* __restrict__ out_i,
                    int* __restrict__ counts) {
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);
  int* hist = reinterpret_cast<int*>(ring + kStages * kStageFloats) +
              (threadIdx.x >> 5) * 256;
  // after the ring and the warps' histograms: the lists or the staging
  float* rest_v = reinterpret_cast<float*>(ring + kStages * kStageFloats +
                                           kWarps * 256);
  int* rest_i = reinterpret_cast<int*>(
      rest_v + (kSmemLists ? (size_t)kBQ * cap : (size_t)cap));
  __shared__ float thr_v[kBQ];
  __shared__ int thr_i[kBQ];
  __shared__ int cnt[kBQ];
  __shared__ BlockSel sel;
  __shared__ int need_cut;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int qt = blockIdx.x % q_tiles;
  const long long c = blockIdx.x / q_tiles;
  const int q0 = qt * kBQ;
  const long long r_begin = c * chunk;
  const long long r_end = min((long long)n_rows, r_begin + chunk);
  auto lv_of = [&](int ql) {
    return kSmemLists ? rest_v + (size_t)ql * cap
                      : list_v + ((long long)blockIdx.x * kBQ + ql) * cap;
  };
  auto li_of = [&](int ql) {
    return kSmemLists ? rest_i + (size_t)ql * cap
                      : list_i + ((long long)blockIdx.x * kBQ + ql) * cap;
  };
  if (tid < kBQ) {
    // the pad pair: a real pair must beat it; or a pilot's k-th pair
    // (v0, i0), which the pair itself must pass too: (v0, i0 + 1)
    const bool seeded = init_v != nullptr && q0 + tid < nq;
    thr_v[tid] = seeded ? init_v[(long long)(q0 + tid) * k + k - 1] : kNegInf;
    thr_i[tid] = seeded ? init_i[(long long)(q0 + tid) * k + k - 1] + 1
                        : kPadId;
    cnt[tid] = 0;
  }
  if (tid == 0) need_cut = 0;
  __syncthreads();

  const int nks = (d + kDK - 1) / kDK;
  const int tiles = (int)((r_end - r_begin + kBN - 1) / kBN);
  const int steps = tiles * nks;
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps)
      load_stage<kVec>(ring + s * kStageFloats, q, db, nq, d, q0,
                       r_begin + (long long)(s / nks) * kBN, r_end,
                       (s % nks) * kDK, row_step);
    cp_async_commit();
  }

  float acc[8][8];
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int b = 0; b < 8; ++b) acc[a][b] = 0.0f;
  float dq[8];

  for (int step = 0; step < steps; ++step) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    {
      const int s = step + kStages - 1;
      if (s < steps)
        load_stage<kVec>(ring + (s % kStages) * kStageFloats, q, db, nq, d,
                         q0, r_begin + (long long)(s / nks) * kBN, r_end,
                         (s % nks) * kDK, row_step);
      cp_async_commit();
    }
    if (!kSmemLists && need_cut) {   // the last tile passed flush_at: cut
      for (int ql = 0; ql < kBQ; ++ql) {   // each such list, one by one
        const int n_in = cnt[ql];
        if (n_in <= flush_at) continue;
        const uint64_t kth =
            block_select(lv_of(ql), li_of(ql), n_in, k, rest_v,
                                   rest_i, sel);
        if (tid == 0) {
          key_pair(kth, &thr_v[ql], &thr_i[ql]);
          cnt[ql] = k;
        }
        __syncthreads();
      }
      if (tid == 0) need_cut = 0;
      __syncthreads();
    }
    const bool last_slice = step % nks == nks - 1;
    const long long r0 = r_begin + (long long)(step / nks) * kBN;
    if (last_slice) {   // the tile's row terms, loaded under the FMAs
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const long long r = r0 + lane + 32 * j;
        dq[j] = r < r_end ? dsq[r * row_step] : 0.0f;
      }
    }
    const float* qs = ring + (step % kStages) * kStageFloats + warp * 8 * kLd;
    const float* ds = ring + (step % kStages) * kStageFloats + kBQ * kLd +
                      lane * kLd;
#pragma unroll 2
    for (int kk = 0; kk < kDK; kk += 4) {
      float4 a[8], b[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        a[i] = *reinterpret_cast<const float4*>(qs + i * kLd + kk);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        b[j] = *reinterpret_cast<const float4*>(ds + 32 * j * kLd + kk);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i].x, b[j].x, acc[i][j]);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i].y, b[j].y, acc[i][j]);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i].z, b[j].z, acc[i][j]);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i].w, b[j].w, acc[i][j]);
    }
    if (!last_slice) continue;

    // epilogue of the tile: this warp's 8 queries x the tile's 256 rows
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int ql = warp * 8 + i;
      float t_v = thr_v[ql];
      int t_i = thr_i[ql];
      unsigned m = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const long long r = r0 + lane + 32 * j;
        const float s = 2.0f * acc[i][j] - dq[j];
        acc[i][j] = s;
        if (r < r_end && better(s, (int)(r * row_step), t_v, t_i))
          m |= 1u << j;
      }
      if (q0 + ql < nq && __any_sync(0xffffffffu, m != 0))
      {
        if (kSmemLists)
          append_tile_cut(acc[i][0], acc[i][1], acc[i][2], acc[i][3],
                          acc[i][4], acc[i][5], acc[i][6], acc[i][7], m,
                          r0 + lane, row_step, lv_of(ql), li_of(ql), k, cap,
                          hist, thr_v + ql, thr_i + ql, cnt + ql);
        else
          append_tile_body<false>(acc[i][0], acc[i][1], acc[i][2], acc[i][3],
                                  acc[i][4], acc[i][5], acc[i][6], acc[i][7],
                                  m, r0 + lane, row_step, lv_of(ql),
                                  li_of(ql), k, cap, hist, thr_v + ql,
                                  thr_i + ql, cnt + ql);
      }
      if (!kSmemLists && lane == 0 && cnt[ql] > flush_at) need_cut = 1;
    }
#pragma unroll
    for (int a = 0; a < 8; ++a)
#pragma unroll
      for (int b = 0; b < 8; ++b) acc[a][b] = 0.0f;
  }
  cp_async_wait<0>();
  __syncthreads();

  // the chunk's end: each list cut to k, written out, its tail padded
  for (int ql = 0; ql < kBQ; ++ql) {
    if (kSmemLists) {
      if (ql / 8 != warp) continue;
      if (cnt[ql] > k) warp_select(lv_of(ql), li_of(ql), cnt[ql], k, hist);
    } else if (cnt[ql] > k) {
      block_select(lv_of(ql), li_of(ql), cnt[ql], k, rest_v,
                             rest_i, sel);
    }
  }
  __syncthreads();
  for (int ql = warp; ql < kBQ; ql += kWarps) {
    const int n_in = min(cnt[ql], k);
    const float* lv = lv_of(ql);
    const int* li = li_of(ql);
    float* ov = out_v + ((long long)blockIdx.x * kBQ + ql) * k;
    int* oi = out_i + ((long long)blockIdx.x * kBQ + ql) * k;
    for (int p = lane; p < n_in; p += 32) {
      ov[p] = lv[p];
      oi[p] = li[p];
    }
    if (lane == 0) counts[(long long)blockIdx.x * kBQ + ql] = n_in;
  }
}

size_t ring_smem() {
  return sizeof(float) * kStages * kStageFloats + sizeof(int) * kWarps * 256;
}

// Shared memory a scan block needs: the ring, the warps' histograms, and
// the lists (kSmemLists) or one list's staging.
size_t scan_smem(bool smem_lists, int cap) {
  return ring_smem() + 8 * (size_t)cap * (smem_lists ? kBQ : 1);
}

template <bool kVec, bool kSmemLists>
int launch_scan(const float* q, const float* db, const float* dsq, int nq,
                int n, int d, int k, int cap, int flush_at, int chunk,
                int q_tiles, int blocks, int row_step, const float* init_v,
                const int* init_i, float* list_v, int* list_i,
                float* part_v, int* part_i, int* counts,
                cudaStream_t stream) {
  auto kern = l2_topk_scan_kernel<kVec, kSmemLists>;
  const size_t smem = scan_smem(kSmemLists, cap);
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<blocks, kThreads, smem, stream>>>(
      q, db, dsq, nq, n, d, k, cap, flush_at, chunk, q_tiles, row_step,
      init_v, init_i, list_v, list_i, part_v, part_i, counts);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int l2_topk_max_k() { return kMaxK; }

// Geometry the wrapper plans with: queries a block, rows a tile.
extern "C" int l2_topk_query_tile() { return kBQ; }
extern "C" int l2_topk_row_tile() { return kBN; }

// Bytes of shared memory a scan block needs with its lists in shared
// memory (smem_lists = 1, cap pairs a list) or with one list staged.
extern "C" long long l2_topk_scan_smem(int smem_lists, int cap) {
  return (long long)scan_smem(smem_lists != 0, cap);
}

// Pass 1 into part (q_tiles * chunks * 64 lists of k slots) and counts,
// pass 2 into out. Pass 1 scans the rows r * row_step, r < n (the n scan
// rows of a pilot over a sample, or every row with row_step 1); init_v,
// init_i (or null): a pilot's [nq, k] output, whose k-th pair seeds each
// list's threshold. The plan comes from the wrapper: chunks = ceil(n /
// chunk), chunk a multiple of the row tile; smem_lists: the lists in shared
// memory, cap >= k + 32 pairs each; otherwise in list_v/list_i (q_tiles *
// chunks * 64 lists of cap = flush_at + 256 pairs), flush_at >= k + 32.
// Returns the first cudaError_t met, -1 for arguments out of range.
extern "C" int l2_topk_launch(const float* q, const float* db,
                              const float* dsq, int nq, int n, int d, int k,
                              int row_step, const float* init_v,
                              const int* init_i, int chunk, int chunks,
                              int smem_lists, int cap, int flush_at,
                              float* list_v, int* list_i, float* part_v,
                              int* part_i, int* counts, float* out_v,
                              int* out_i, void* stream) {
  if (nq == 0) return 0;
  if (k < 1 || k > kMaxK || chunks < 1 || chunks > kMaxChunks ||
      (long long)chunks * k >= (1ll << 31) || chunk % kBN != 0 || d < 1 ||
      row_step < 1 ||
      (smem_lists ? cap < k + 32 : (flush_at < k + 32 ||
                                     cap != flush_at + kBN)))
    return -1;
  cudaStream_t s = (cudaStream_t)stream;
  const int q_tiles = (nq + kBQ - 1) / kBQ;
  const int blocks = q_tiles * chunks;
  const bool vec = d % 4 == 0 && ((uintptr_t)q % 16) == 0 &&
                   ((uintptr_t)db % 16) == 0;
  int e;
#define L2_TOPK_SCAN(V, S)                                                   \
  launch_scan<V, S>(q, db, dsq, nq, n, d, k, cap, flush_at, chunk, q_tiles, \
                    blocks, row_step, init_v, init_i, list_v, list_i,       \
                    part_v, part_i, counts, s)
  if (smem_lists)
    e = vec ? L2_TOPK_SCAN(true, true) : L2_TOPK_SCAN(false, true);
  else
    e = vec ? L2_TOPK_SCAN(true, false) : L2_TOPK_SCAN(false, false);
#undef L2_TOPK_SCAN
  if (e != 0) return e;
  topk_merge_lists_kernel<<<nq, kMergeThreads, 0, s>>>(
      part_v, part_i, counts, q_tiles, chunks, k, kBQ, out_v, out_i);
  return (int)cudaGetLastError();
}
