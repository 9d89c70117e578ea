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
// On the card the LUT lives in shared memory and a lookup is an indexed
// read, so the scan is bound by the rate of those reads, and the design is
// about feeding them:
//   pass 0: one block per query writes its LUT (m*ksub floats, 8 KB at
//           PQ8x8) into its query tile's interleaved LUT [m][ksub][BQ];
//   scan:   a persistent block an SM (the grid is as many blocks as the SMs
//           hold, 512 threads each) walks (query tile of BQ = 16, chunk of
//           rows) items; the wrapper sizes the chunks so that the items
//           fill whole waves. A block holds its tile's LUTs (128 KB at
//           PQ8x8) in shared memory and streams the chunk's codes through a
//           double-buffered cp.async ring of T-row tiles (T = 2048: 16 KB at
//           m = 8), the next tile in flight while the block scores this
//           one. Lanes run across queries: a lane scores four of the
//           tile's queries on one row with one 16-byte read of the
//           interleaved LUT a subspace, four lanes a row, a warp eight rows
//           at once. Each 8-lane phase of such a read fetches two rows'
//           64-byte runs (at most 2-way bank conflicts, 1.5 on average,
//           where a warp on one query's LUT met about 3.5), and one read,
//           one byte extract and one address serve four lookups. A thread
//           scores 64 (row, query) pairs of a tile between two barriers.
//   select: l2_topk's (topk_select.cuh). Each (query, item) keeps a
//           threshold and a survivor list in device memory with room for a
//           tile: a score that beats the threshold is appended (one shared
//           atomic a survivor); a list past its cut point after a tile, or
//           past k at the item's end, is cut to k by the radix select of
//           one warp, the block's 16 warps cutting its 16 lists at once,
//           and the threshold rises to its k-th pair. Pilot passes over
//           every 256th and 16th row (when those samples hold k rows) seed
//           the thresholds of the next pass with their k-th pair: a lower
//           bound of the k-th best (the k-th best of a subset), so the
//           scan stays exact and about 16k pairs a query survive, not the
//           first tiles' worth. Rows arrive in id order within a list
//           only per tile, which the radix select does not need.
//   merge:  topk_select.cuh's pass selects k from each query's item lists
//           and sorts them.
// The last tile of a chunk and the last query tile are ragged: rows past
// the chunk and queries past Q are skipped. Empty lists start at the pair
// (-inf, INT_MAX), which every real row beats, even one scoring -inf.
// Bound: at the main path's shapes (Q = 256, N = 1M, m = 8) the scan reads
// 8 MB of codes and does Q*N*m = 2.05 G lookup-adds: the operations bound
// it (0.031 ms at one float32 add a lookup). Its real ceiling is the
// shared-memory read rate, 32 lookups a clock on each SM: 2.05 G / (32 *
// 132 SMs * 1.755 GHz) = 0.276 ms, 0.41 ms at 1.5 wavefronts a warp read.
#include "topk_select.cuh"

namespace {

constexpr int kThreads = 256;      // the LUT pass
constexpr int kScanThreads = 512;  // the scan: 16 warps
constexpr int kScanWarps = kScanThreads / 32;
constexpr int kEmptyId = 0x7fffffff;
constexpr int kMaxLevels = 20;     // log2 of the widest tree + 1
constexpr int kMaxK = kSortCap - 64;
constexpr int kMinCut = 128;       // a list is cut at 2k + 32, at least this

// Floats of one query tile's interleaved LUT, padded to 16 bytes.
__host__ __device__ __forceinline__ int lut_floats(int bq, int m, int ksub) {
  return (bq * m * ksub + 3) / 4 * 4;
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

// A lane's V queries' values (V = 4: one 16-byte shared-memory read of
// the interleaved LUT serves four queries; V = 1: one query), added
// elementwise with __fadd_rn.
template <int V>
struct Vec;

template <>
struct Vec<4> {
  float4 v;
  __device__ __forceinline__ static Vec load(const float* p) {
    return {*reinterpret_cast<const float4*>(p)};
  }
  __device__ __forceinline__ static Vec zero() {
    return {make_float4(0.0f, 0.0f, 0.0f, 0.0f)};
  }
  __device__ __forceinline__ Vec operator+(const Vec& b) const {
    return {make_float4(__fadd_rn(v.x, b.v.x), __fadd_rn(v.y, b.v.y),
                        __fadd_rn(v.z, b.v.z), __fadd_rn(v.w, b.v.w))};
  }
  __device__ __forceinline__ float operator[](int i) const {
    return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
  }
};

template <>
struct Vec<1> {
  float v;
  __device__ __forceinline__ static Vec load(const float* p) { return {*p}; }
  __device__ __forceinline__ static Vec zero() { return {0.0f}; }
  __device__ __forceinline__ Vec operator+(const Vec& b) const {
    return {__fadd_rn(v, b.v)};
  }
  __device__ __forceinline__ float operator[](int) const { return v; }
};

// The distances of a PQ8 code row held in registers (byte mm of the pair is
// subspace mm) to this lane's V queries, read from the interleaved LUT at
// lq: each the pairwise tree over its 8 looked-up entries.
template <int kBQ, int V>
__device__ __forceinline__ Vec<V> tree_lut8(const float* lq, uint2 c,
                                            int ksub) {
  using W = Vec<V>;
  const W a0 = W::load(lq + (c.x & 0xff) * kBQ);
  const W a1 = W::load(lq + (ksub + ((c.x >> 8) & 0xff)) * kBQ);
  const W a2 = W::load(lq + (2 * ksub + ((c.x >> 16) & 0xff)) * kBQ);
  const W a3 = W::load(lq + (3 * ksub + (c.x >> 24)) * kBQ);
  const W a4 = W::load(lq + (4 * ksub + (c.y & 0xff)) * kBQ);
  const W a5 = W::load(lq + (5 * ksub + ((c.y >> 8) & 0xff)) * kBQ);
  const W a6 = W::load(lq + (6 * ksub + ((c.y >> 16) & 0xff)) * kBQ);
  const W a7 = W::load(lq + (7 * ksub + (c.y >> 24)) * kBQ);
  return ((a0 + a1) + (a2 + a3)) + ((a4 + a5) + (a6 + a7));
}

// The distances of one code row of any width m: the pairwise tree over its
// m looked-up entries.
template <int kBQ, int V>
__device__ __forceinline__ Vec<V> tree_lut(const float* lq,
                                           const unsigned char* c, int m,
                                           int ksub) {
  int p = 1;
  while (p < m) p <<= 1;
  Vec<V> part[kMaxLevels];
  for (int t = 0; t < p; ++t) {
    Vec<V> v = t < m ? Vec<V>::load(lq + (t * ksub + c[t]) * kBQ)
                     : Vec<V>::zero();
    int level = 0;
    for (int s = t; s & 1; s >>= 1) v = part[level++] + v;
    part[level] = v;
  }
  return part[31 - __clz(p)];
}

// Pass 0: block r (of q_tiles * bq) writes query r's LUT into its tile's
// interleaved LUT, lut[(r / bq) * lut_floats + e * bq + r % bq] for e = mm
// * ksub + j; a query past nq writes zeros.
__global__ void __launch_bounds__(kThreads)
pq_lut_kernel(const float* __restrict__ q, const float* __restrict__ cb,
              int nq, int m, int ksub, int dsub, int bq,
              float* __restrict__ lut) {
  const int r = blockIdx.x;
  const int width = m * ksub;
  const float* qrow = q + (size_t)r * m * dsub;
  float* out = lut + (size_t)(r / bq) * lut_floats(bq, m, ksub) + r % bq;
  for (int e = threadIdx.x; e < width; e += kThreads) {
    float v = 0.0f;
    if (r < nq) {
      const int mm = e / ksub;
      const float* qs = qrow + (size_t)mm * dsub;
      const float* c = cb + (size_t)e * dsub;
      const float qq = tree_dot(qs, qs, dsub);
      const float qc = tree_dot(qs, c, dsub);
      const float cc = tree_dot(c, c, dsub);
      v = __fadd_rn(__fsub_rn(qq, __fmul_rn(2.0f, qc)), cc);
    }
    out[(size_t)e * bq] = v;
  }
}

__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async16_n(void* smem, const void* gmem,
                                             int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(bytes));
}

// How a tile of code rows is copied into shared memory: 16-byte cp.async
// over the contiguous span (every row, 16-byte aligned), 8 or 4 bytes a
// cp.async per row part (a pilot's strided rows, m a multiple of 8 or 4
// and rows so aligned), or byte loads.
enum Copy { kSpan16 = 0, kPart8 = 1, kPart4 = 2, kBytes = 3 };

// Copy scan rows [r0, r0 + rows) (code row r * step) into cs as [rows][m].
__device__ __forceinline__ void load_tile(unsigned char* cs,
                                          const unsigned char* codes,
                                          long long r0, int rows, int m,
                                          int step, int copy) {
  const int tid = threadIdx.x;
  if (copy == kSpan16) {
    const long long bytes = (long long)rows * m;
    const unsigned char* src = codes + r0 * m;
    for (int p = tid; 16ll * p < bytes; p += kScanThreads) {
      const long long left = bytes - 16ll * p;
      cp_async16_n(cs + 16 * p, src + 16ll * p, left < 16 ? (int)left : 16);
    }
  } else if (copy == kBytes) {
    for (int p = tid; p < rows * m; p += kScanThreads) {
      const int row = p / m;
      cs[p] = codes[(r0 + row) * step * m + (p - row * m)];
    }
  } else {
    const int unit = copy == kPart8 ? 8 : 4;
    const int parts = m / unit;
    for (int p = tid; p < rows * parts; p += kScanThreads) {
      const int row = p / parts, part = p - row * parts;
      const unsigned char* src = codes + (r0 + row) * step * m + part * unit;
      if (copy == kPart8) cp_async8(cs + (size_t)p * 8, src);
      else cp_async4(cs + (size_t)p * 4, src, true);
    }
  }
}

// The scan. Block b walks items b, b + gridDim.x, ...; item = chunk *
// q_tiles + query tile. Dynamic shared memory: the tile's LUTs
// [m][ksub][kBQ], two code tiles [tile][m] (16-byte aligned), and a radix
// histogram (256 ints) for each warp. The lists live at list_v/list_i +
// (blockIdx.x * kBQ + ql) * cap, list ql cut by warp ql % 16; a list holds
// at most cut + tile pairs (cut = the cut point, checked after every
// tile), so cap = cut + tile. An item's lists, cut to at most k pairs, go
// to part + ((chunk * q_tiles + qt) * kBQ + ql) * k with their counts.
// init_v/init_i (or null): a pilot's [nq, k] answer, whose k-th pair seeds
// each list's threshold.
template <int kBQ, bool kM8>
__global__ void __launch_bounds__(kScanThreads, 1)
pq_scan_kernel(const float* __restrict__ lut,
               const unsigned char* __restrict__ codes, int nq, int n_scan,
               int row_step, int m, int ksub, int k, int tile, int cap,
               int cut, int chunk, int q_tiles, int items, int copy,
               const float* __restrict__ init_v,
               const int* __restrict__ init_i, float* __restrict__ list_v,
               int* __restrict__ list_i, float* __restrict__ part_v,
               int* __restrict__ part_i, int* __restrict__ counts) {
  constexpr int kV = kBQ >= 4 ? 4 : 1;          // queries a lane
  constexpr int kL = kBQ / kV;                   // lanes a row
  constexpr int kRows = 32 / kL;                 // rows a warp step scores
  constexpr int kU = kV == 4 ? 2 : 4;            // row steps in flight
  extern __shared__ __align__(16) unsigned char smem[];
  const int lut_n = lut_floats(kBQ, m, ksub);
  float* luts = reinterpret_cast<float*>(smem);
  const int tile_bytes = (tile * m + 15) / 16 * 16;
  unsigned char* ring = smem + (size_t)lut_n * 4;
  int* hist = reinterpret_cast<int*>(ring + 2 * (size_t)tile_bytes) +
              (threadIdx.x >> 5) * 256;
  __shared__ float thr_v[kBQ];
  __shared__ int thr_i[kBQ];
  __shared__ int cnt[kBQ];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q_lane = (lane % kL) * kV, slot = lane / kL;
  const float* lq = luts + q_lane;
  const int steps = tile / (kScanWarps * kRows);
  auto lv_of = [&](int ql) {
    return list_v + ((long long)blockIdx.x * kBQ + ql) * cap;
  };
  auto li_of = [&](int ql) {
    return list_i + ((long long)blockIdx.x * kBQ + ql) * cap;
  };

  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int qt = item % q_tiles;
    const long long c = item / q_tiles;
    const int q0 = qt * kBQ;
    const long long r_begin = c * chunk;
    const long long r_end = min((long long)n_scan, r_begin + chunk);
    const int tiles = (int)((r_end - r_begin + tile - 1) / tile);
    __syncthreads();   // the last item is done with the LUTs and the lists
    {
      const float4* src =
          reinterpret_cast<const float4*>(lut + (size_t)qt * lut_n);
      float4* dst = reinterpret_cast<float4*>(luts);
      for (int p = tid; p < lut_n / 4; p += kScanThreads) dst[p] = src[p];
    }
    if (tid < kBQ) {
      const bool seeded = init_v != nullptr && q0 + tid < nq;
      const long long s = (long long)(q0 + tid) * k + k - 1;
      thr_v[tid] = seeded ? init_v[s] : -CUDART_INF_F;
      thr_i[tid] = seeded ? init_i[s] + 1 : kEmptyId;
      cnt[tid] = 0;
    }
    load_tile(ring, codes, r_begin, (int)min((long long)tile, r_end - r_begin),
              m, row_step, copy);
    cp_async_commit();

    for (int t = 0; t < tiles; ++t) {
      const long long r0 = r_begin + (long long)t * tile;
      const int rows = (int)min((long long)tile, r_end - r0);
      cp_async_wait<0>();
      __syncthreads();   // tile t has landed; tile t - 1 is scored
      if (t + 1 < tiles)
        load_tile(ring + ((t + 1) & 1) * (size_t)tile_bytes, codes,
                  r0 + tile, (int)min((long long)tile, r_end - r0 - tile), m,
                  row_step, copy);
      cp_async_commit();
      for (int ql = warp; ql < kBQ; ql += kScanWarps) {   // past cut: cut
        const int n_in = cnt[ql];
        if (n_in <= cut) continue;
        const uint64_t kth = warp_select(lv_of(ql), li_of(ql), n_in, k, hist);
        if (lane == 0) {
          key_pair(kth, &thr_v[ql], &thr_i[ql]);
          cnt[ql] = k;
        }
      }
      __syncthreads();   // the cuts are done: appends may go
      float t_v[kV];
      int t_i[kV];
      bool live[kV];
#pragma unroll
      for (int v = 0; v < kV; ++v) {
        t_v[v] = thr_v[q_lane + v];
        t_i[v] = thr_i[q_lane + v];
        live[v] = q0 + q_lane + v < nq;
      }
      const int row0 = (int)r0;
      const unsigned char* cs = ring + (t & 1) * (size_t)tile_bytes;
      for (int s0 = 0; s0 < steps; s0 += kU) {
        Vec<kV> dist[kU];
        int lr[kU];
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          lr[u] = ((s0 + u) * kScanWarps + warp) * kRows + slot;
          if (s0 + u >= steps || lr[u] >= rows) lr[u] = -1;
        }
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          if (lr[u] < 0) continue;
          if (kM8)
            dist[u] = tree_lut8<kBQ, kV>(
                lq, *reinterpret_cast<const uint2*>(cs + lr[u] * 8), ksub);
          else
            dist[u] = tree_lut<kBQ, kV>(lq, cs + lr[u] * m, m, ksub);
        }
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          if (lr[u] < 0) continue;
          const int id = (row0 + lr[u]) * row_step;
#pragma unroll
          for (int v = 0; v < kV; ++v) {
            const float sc = -dist[u][v];
            if (live[v] && better(sc, id, t_v[v], t_i[v])) {
              const int ql = q_lane + v;
              const int pos = atomicAdd(&cnt[ql], 1);
              lv_of(ql)[pos] = sc;
              li_of(ql)[pos] = id;
            }
          }
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();
    // the item's end: each list cut to k, written out with its count
    for (int ql = warp; ql < kBQ; ql += kScanWarps) {
      if (cnt[ql] > k) warp_select(lv_of(ql), li_of(ql), cnt[ql], k, hist);
      __syncwarp();
      const int n_in = min(cnt[ql], k);
      const long long base = (c * q_tiles + qt) * kBQ + ql;
      const float* lv = lv_of(ql);
      const int* li = li_of(ql);
      for (int p = lane; p < n_in; p += 32) {
        part_v[base * k + p] = lv[p];
        part_i[base * k + p] = li[p];
      }
      if (lane == 0) counts[base] = n_in;
    }
  }
}

size_t scan_smem(int bq, int tile, int m, int ksub) {
  const size_t tile_bytes = ((size_t)tile * m + 15) / 16 * 16;
  return 4 * (size_t)lut_floats(bq, m, ksub) + 2 * tile_bytes +
         sizeof(int) * 256 * kScanWarps;
}

template <int kBQ, bool kM8>
int blocks_per_sm(size_t smem) {
  int blocks = 0;
  const cudaError_t e = cudaFuncSetAttribute(
      pq_scan_kernel<kBQ, kM8>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return -(int)e;
  const cudaError_t o = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, pq_scan_kernel<kBQ, kM8>, kScanThreads, smem);
  return o == cudaSuccess ? blocks : -(int)o;
}

template <int kBQ, bool kM8>
int launch_scan(int grid, size_t smem, const float* lut,
                const unsigned char* codes, int nq, int n_scan, int row_step,
                int m, int ksub, int k, int tile, int cap, int cut,
                int chunk, int q_tiles, int items, int copy,
                const float* init_v, const int* init_i, float* list_v,
                int* list_i, float* part_v, int* part_i, int* counts,
                cudaStream_t stream) {
  auto kern = pq_scan_kernel<kBQ, kM8>;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<grid, kScanThreads, smem, stream>>>(
      lut, codes, nq, n_scan, row_step, m, ksub, k, tile, cap, cut, chunk,
      q_tiles, items, copy, init_v, init_i, list_v, list_i, part_v, part_i,
      counts);
  return (int)cudaGetLastError();
}

template <int kBQ>
int launch_scan_m(bool m8, int grid, size_t smem, const float* lut,
                  const unsigned char* codes, int nq, int n_scan,
                  int row_step, int m, int ksub, int k, int tile, int cap,
                  int cut, int chunk, int q_tiles, int items, int copy,
                  const float* init_v, const int* init_i, float* list_v,
                  int* list_i, float* part_v, int* part_i, int* counts,
                  cudaStream_t stream) {
  return m8 ? launch_scan<kBQ, true>(grid, smem, lut, codes, nq, n_scan,
                                     row_step, m, ksub, k, tile, cap, cut,
                                     chunk, q_tiles, items, copy, init_v,
                                     init_i, list_v, list_i, part_v, part_i,
                                     counts, stream)
            : launch_scan<kBQ, false>(grid, smem, lut, codes, nq, n_scan,
                                      row_step, m, ksub, k, tile, cap, cut,
                                      chunk, q_tiles, items, copy, init_v,
                                      init_i, list_v, list_i, part_v, part_i,
                                      counts, stream);
}

int list_cut(int k) {
  const int c = (2 * k + 32 + 31) / 32 * 32;
  return c > kMinCut ? c : kMinCut;
}

}  // namespace

extern "C" int pq_adc_max_k() { return kMaxK; }

// Scan blocks an SM holds at a plan (bq, m == 8, smem), from the card's
// occupancy calculator; a negative cudaError_t on failure.
extern "C" int pq_adc_blocks_per_sm(int bq, int m, long long smem) {
  const bool m8 = m == 8;
  if (bq == 16) return m8 ? blocks_per_sm<16, true>(smem)
                          : blocks_per_sm<16, false>(smem);
  if (bq == 4) return m8 ? blocks_per_sm<4, true>(smem)
                         : blocks_per_sm<4, false>(smem);
  return m8 ? blocks_per_sm<1, true>(smem) : blocks_per_sm<1, false>(smem);
}

// Pass 0: the interleaved LUTs of nq queries into lut (ceil(nq / bq)
// tiles of lut_floats(bq, m, ksub) floats). Returns 0 or a cudaError_t.
extern "C" int pq_adc_lut(const float* q, const float* cb, int nq, int m,
                          int ksub, int dsub, int bq, float* lut,
                          void* stream) {
  if (nq == 0) return 0;
  const int blocks = (nq + bq - 1) / bq * bq;
  pq_lut_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      q, cb, nq, m, ksub, dsub, bq, lut);
  return (int)cudaGetLastError();
}

// One pass: the scan over the scan rows r * row_step, r < n_scan, into
// part/counts (chunks * q_tiles * bq lists of k slots), then the merge of
// those lists into out [nq, k], sorted. The plan comes from the wrapper
// (kernels/pq_adc/kernel.py: plan, plan_chunks), checked here: bq in {16,
// 4, 1}, tile a multiple of 512, cut = max(128, 2k + 32 rounded up to 32),
// cap = cut + tile, smem the scan's dynamic shared memory, chunk a multiple
// of tile, chunks = ceil(n_scan / chunk), grid blocks walking the chunks *
// q_tiles items, list_v/list_i holding grid * bq lists of cap pairs;
// init_v/init_i (or null) the previous pass's answer. Returns 0, -1 for
// arguments out of range, or a cudaError_t.
extern "C" int pq_adc_pass(const float* lut, const unsigned char* codes,
                           int nq, int n_scan, int row_step, int m, int ksub,
                           int k, int bq, int tile, int cap, int cut,
                           long long smem, int chunk, int chunks, int grid,
                           const float* init_v, const int* init_i,
                           float* list_v, int* list_i, float* part_v,
                           int* part_i, int* counts, float* out_v,
                           int* out_i, void* stream) {
  if (nq == 0) return 0;
  const int q_tiles = (nq + bq - 1) / bq;
  const long long items = (long long)q_tiles * chunks;
  if (k < 1 || k > kMaxK || k > n_scan || chunks < 1 ||
      chunks > kMaxChunks || chunk % tile != 0 ||
      (long long)(chunks - 1) * chunk >= n_scan ||
      (long long)chunks * chunk < n_scan || cut != list_cut(k) ||
      cap != cut + tile || grid < 1 || items >= (1ll << 31) ||
      tile % (kScanWarps * 32) != 0 || row_step < 1 ||
      (bq != 16 && bq != 4 && bq != 1) ||
      (size_t)smem != scan_smem(bq, tile, m, ksub))
    return -1;
  cudaStream_t s = (cudaStream_t)stream;
  int copy = kBytes;
  if (row_step == 1 && (uintptr_t)codes % 16 == 0 &&
      ((long long)tile * m) % 16 == 0)
    copy = kSpan16;
  else if (m % 8 == 0 && (uintptr_t)codes % 8 == 0)
    copy = kPart8;
  else if (m % 4 == 0 && (uintptr_t)codes % 4 == 0)
    copy = kPart4;
  const bool m8 = m == 8;
  const int g = (int)(grid < items ? grid : items);
  int e;
#define PQ_SCAN(B)                                                          \
  launch_scan_m<B>(m8, g, (size_t)smem, lut, codes, nq, n_scan, row_step, \
                   m, ksub, k, tile, cap, cut, chunk, q_tiles, (int)items, \
                   copy, init_v, init_i, list_v, list_i, part_v, part_i,   \
                   counts, s)
  e = bq == 16 ? PQ_SCAN(16) : bq == 4 ? PQ_SCAN(4) : PQ_SCAN(1);
#undef PQ_SCAN
  if (e != 0) return e;
  topk_merge_lists_kernel<<<nq, kMergeThreads, 0, s>>>(
      part_v, part_i, counts, q_tiles, chunks, k, bq, out_v, out_i);
  return (int)cudaGetLastError();
}
