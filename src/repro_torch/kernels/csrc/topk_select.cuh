// What the two scans with an exact top-k (l2_topk.cu, pq_adc.cu) share:
// cp.async copies, the order of (score, id) pairs and its 64-bit key, the
// radix select that cuts a survivor list to its k best, and the pass that
// merges the chunks' lists. Designed in l2_topk.cu (see its note); pq_adc.cu
// runs the same selection over ADC scores, and topk_merge.cu merges shard
// candidates under the same key (its wide rows' cut with pick_digit).
//
// The pair order: score descending, then id ascending. A pair's key is the
// order-preserving bits of its score (-0 read as +0) above 0x7fffffff - id,
// so a larger key is a better pair and distinct pairs have distinct keys.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kMergeThreads = 256;  // the merge pass's block
constexpr float kNegInf = -1e30f;   // NEG_INF of kernels/common.py
constexpr int kPadId = -1;
constexpr int kSortCap = 4096;      // the merge pass sorts at most this many
constexpr int kMaxChunks = 1024;

__device__ __forceinline__ uint32_t ord_score(float s) {
  const uint32_t b = __float_as_uint(s == 0.0f ? 0.0f : s);  // -0 as +0
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// Larger key = better pair: score descending, then id ascending.
__device__ __forceinline__ uint64_t make_key(float s, int id) {
  return ((uint64_t)ord_score(s) << 32) | (0x7fffffffu - (uint32_t)id);
}

__device__ __forceinline__ bool better(float v1, int i1, float v2, int i2) {
  return v1 > v2 || (v1 == v2 && i1 < i2);
}

__device__ __forceinline__ unsigned lanemask_lt() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The digit of one radix pass: given the histogram of the pass (256 bins,
// shared memory) and the pairs still needed, the highest bin d with
// #{bins >= d} >= need. Returns d; sets *above = #{bins > d} and *in_bin =
// hist[d]. Called by a whole warp; every lane gets the result.
__device__ __forceinline__ int pick_digit(const int* hist, int need,
                                          int* above, int* in_bin) {
  const int lane = threadIdx.x & 31;
  int c[8], s = 0;
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    c[t] = hist[255 - 8 * lane - t];
    s += c[t];
  }
  int incl = s;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += y;
  }
  const int excl = incl - s;
  const bool mine = excl < need && need <= incl;
  const unsigned ball = __ballot_sync(0xffffffffu, mine);
  const int src = __ffs(ball) - 1;
  int digit = 0, ab = 0, cnt = 0;
  if (mine) {
    int acc = excl;
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      if (acc + c[t] >= need) {
        digit = 255 - 8 * lane - t;
        ab = acc;
        cnt = c[t];
        break;
      }
      acc += c[t];
    }
  }
  *above = __shfl_sync(0xffffffffu, ab, src);
  *in_bin = __shfl_sync(0xffffffffu, cnt, src);
  return __shfl_sync(0xffffffffu, digit, src);
}

// Add one to hist[bin] for each lane with `valid`, one shared atomic per
// distinct bin of the warp: the keys of a list share their top bits, so a
// plain atomic a lane would serialise the warp on one or two bins. Called
// by the whole warp.
__device__ __forceinline__ void hist_add(int* hist, int bin, bool valid) {
  if (!__any_sync(0xffffffffu, valid)) return;
  const unsigned peers = __match_any_sync(0xffffffffu, valid ? bin : -1);
  if (valid && (int)(threadIdx.x & 31) == __ffs(peers) - 1)
    atomicAdd(&hist[bin], __popc(peers));
}

// One warp cuts the list (v, id) (shared or device memory) of n > k pairs
// (distinct keys) to its k best in place, unordered, and returns the k-th
// best key. hist: this warp's 256 ints of shared memory. Radix select on
// the 64-bit key, 8 bits a pass from the top; it stops at the first pass
// whose chosen bin holds exactly the pairs still needed (with distinct
// keys, at the last pass at worst).
__device__ __noinline__ uint64_t warp_select(float* __restrict__ v,
                                             int* __restrict__ id, int n,
                                             int k, int* hist) {
  const int lane = threadIdx.x & 31;
  uint64_t prefix = 0;
  int need = k, shift = 64;
  for (;;) {
    shift -= 8;
    for (int i = lane; i < 256; i += 32) hist[i] = 0;
    __syncwarp();
    for (int j0 = 0; j0 < n; j0 += 4 * 32) {
      uint64_t key[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int j = j0 + 32 * u + lane;
        key[u] = j < n ? make_key(v[j], id[j]) : 0;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int j = j0 + 32 * u + lane;
        hist_add(hist, (int)((key[u] >> shift) & 255),
                 j < n && (shift == 56 || (key[u] >> (shift + 8)) ==
                                              (prefix >> (shift + 8))));
      }
    }
    __syncwarp();
    int above, in_bin;
    const int digit = pick_digit(hist, need, &above, &in_bin);
    __syncwarp();
    need -= above;
    prefix |= (uint64_t)digit << shift;
    if (in_bin == need || shift == 0) break;
  }
  // keep the pairs whose top (64 - shift) bits are >= the prefix's
  uint64_t lo = ~0ull;
  int out = 0;
  for (int j0 = 0; j0 < n; j0 += 32) {
    const int j = j0 + lane;
    float sv = 0.0f;
    int si = 0;
    uint64_t key = 0;
    bool keep = false;
    if (j < n) {
      sv = v[j];
      si = id[j];
      key = make_key(sv, si);
      keep = (key >> shift) >= (prefix >> shift);
    }
    const unsigned b = __ballot_sync(0xffffffffu, keep);
    __syncwarp();  // every lane has read its pair before any is overwritten
    if (keep) {
      const int p = out + __popc(b & lanemask_lt());
      v[p] = sv;
      id[p] = si;
      lo = key < lo ? key : lo;
    }
    out += __popc(b);
    __syncwarp();
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const uint64_t o = __shfl_xor_sync(0xffffffffu, lo, off);
    lo = o < lo ? o : lo;
  }
  return lo;
}

// The pair a key stands for (-0 comes back as +0, which compares equal).
__device__ __forceinline__ void key_pair(uint64_t key, float* v, int* id) {
  const uint32_t u = (uint32_t)(key >> 32);
  *v = __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
  *id = (int)(0x7fffffffu - (uint32_t)key);
}

// Calls f(v, id, ok) for each real pair (v, id) of one query's chunk
// lists (offs[c + 1] - offs[c] pairs at the front of chunk c's k slots,
// offs[chunks] = total; ok false for the calls that hold none), every lane
// of a warp calling the same number of times, eight loads a thread in
// flight. Up to kFlatMax pairs in all, the real pairs are walked as one
// flat range, each index mapped to its chunk by a binary search of offs,
// so short lists do not wait for each other; longer ones are walked one
// chunk at a time, each chunk a whole number of block-wide loads.
constexpr int kFlatMax = 8 * 1024;

template <typename F>
__device__ __forceinline__ void visit_pairs(const float* __restrict__ pv,
                                            const int* __restrict__ pi,
                                            const int* offs, int chunks,
                                            int k, int q_tiles, int bq,
                                            int qt, int ql, F&& f) {
  constexpr int kIn = 8;
  const int lane = threadIdx.x & 31, w0 = threadIdx.x - lane;
  const int total = offs[chunks];
  auto base = [&](int c) {
    return (((long long)c * q_tiles + qt) * bq + ql) * k;
  };
  float v[kIn];
  int id[kIn];
  bool ok[kIn];
  if (total > kFlatMax) {
    for (int c = 0; c < chunks; ++c) {
      const int n_c = offs[c + 1] - offs[c];
      const long long b = base(c);
      for (int j0 = w0; j0 < n_c; j0 += kIn * kMergeThreads) {
#pragma unroll
        for (int u = 0; u < kIn; ++u) {
          const int j = j0 + lane + u * kMergeThreads;
          ok[u] = j < n_c;
          v[u] = ok[u] ? pv[b + j] : 0.0f;
          id[u] = ok[u] ? pi[b + j] : 0;
        }
#pragma unroll
        for (int u = 0; u < kIn; ++u) f(v[u], id[u], ok[u]);
      }
    }
    return;
  }
  for (int e0 = w0; e0 < total; e0 += kIn * kMergeThreads) {
#pragma unroll
    for (int u = 0; u < kIn; ++u) {
      const int e = e0 + lane + u * kMergeThreads;
      ok[u] = e < total;
      v[u] = 0.0f;
      id[u] = 0;
      if (ok[u]) {
        int lo = 0, hi = chunks;   // offs[lo] <= e < offs[hi]
        while (hi - lo > 1) {
          const int mid = (lo + hi) >> 1;
          if (offs[mid] <= e) lo = mid; else hi = mid;
        }
        v[u] = pv[base(lo) + (e - offs[lo])];
        id[u] = pi[base(lo) + (e - offs[lo])];
      }
    }
#pragma unroll
    for (int u = 0; u < kIn; ++u) f(v[u], id[u], ok[u]);
  }
}

// The merge pass: block q selects k pairs from its chunks' lists (counts[L]
// real pairs at the front of each list's k slots; list L = (chunk * q_tiles
// + q / bq) * bq + q % bq) by a radix select over device memory
// (visit_pairs), sorts them and writes them, the tail padded with (NEG_INF,
// -1). At most kMaxChunks chunks, k <= kSortCap.
__global__ void __launch_bounds__(kMergeThreads)
topk_merge_lists_kernel(const float* __restrict__ part_v,
                        const int* __restrict__ part_i,
                        const int* __restrict__ counts, int q_tiles,
                        int chunks, int k, int bq, float* __restrict__ out_v,
                        int* __restrict__ out_i) {
  __shared__ float sv[kSortCap];
  __shared__ int si[kSortCap];
  __shared__ int hist[256];
  __shared__ int offs[kMaxChunks + 1];
  __shared__ int n_sel, s_digit, s_above, s_in_bin;

  const int tid = threadIdx.x;
  const int qb = blockIdx.x;
  const int qt = qb / bq, ql = qb % bq;
  if (tid < 32) {   // offs: the exclusive prefix of the lists' counts
    const int per = (chunks + 31) / 32, c0 = tid * per;
    const int c1 = min(chunks, c0 + per);
    int sum = 0;
    for (int c = c0; c < c1; ++c)
      sum += counts[((long long)c * q_tiles + qt) * bq + ql];
    int incl = sum;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, off);
      if (tid >= off) incl += y;
    }
    int run = incl - sum;
    for (int c = c0; c < c1; ++c) {
      offs[c] = run;
      run += counts[((long long)c * q_tiles + qt) * bq + ql];
    }
    if (tid == 31) offs[chunks] = incl;
    if (tid == 0) n_sel = 0;
  }
  __syncthreads();
  const int total = offs[chunks];

  int shift = 64;
  uint64_t prefix = 0;
  if (total > k) {
    int need = k;
    for (;;) {
      shift -= 8;
      for (int i = tid; i < 256; i += kMergeThreads) hist[i] = 0;
      __syncthreads();
      visit_pairs(part_v, part_i, offs, chunks, k, q_tiles, bq, qt, ql,
                  [&](float v, int id, bool ok) {
                    const uint64_t key = ok ? make_key(v, id) : 0;
                    hist_add(hist, (int)((key >> shift) & 255),
                             ok && (shift == 56 ||
                                    (key >> (shift + 8)) ==
                                        (prefix >> (shift + 8))));
                  });
      __syncthreads();
      if (tid < 32) {
        int above, in_bin;
        const int digit = pick_digit(hist, need, &above, &in_bin);
        if (tid == 0) {
          s_digit = digit;
          s_above = above;
          s_in_bin = in_bin;
        }
      }
      __syncthreads();
      need -= s_above;
      prefix |= (uint64_t)s_digit << shift;
      const bool done = s_in_bin == need || shift == 0;
      __syncthreads();
      if (done) break;
    }
  }
  // gather the kept pairs (every pair when there are at most k)
  visit_pairs(part_v, part_i, offs, chunks, k, q_tiles, bq, qt, ql,
              [&](float v, int id, bool ok) {
                if (ok && (shift == 64 || (make_key(v, id) >> shift) >=
                                              (prefix >> shift))) {
                  const int p = atomicAdd(&n_sel, 1);
                  sv[p] = v;
                  si[p] = id;
                }
              });
  __syncthreads();
  const int m = n_sel;  // min(total, k)
  int size = 1;
  while (size < m) size <<= 1;
  for (int p = m + tid; p < size; p += kMergeThreads) {
    sv[p] = -CUDART_INF_F;
    si[p] = 0x7fffffff;
  }
  __syncthreads();
  // bitonic sort of the kept pairs, best first
  for (int len = 2; len <= size; len <<= 1) {
    for (int stride = len >> 1; stride > 0; stride >>= 1) {
      for (int t = tid; t < size / 2; t += kMergeThreads) {
        const int i = 2 * t - (t & (stride - 1));
        const int j = i + stride;
        const bool best_first = (i & len) == 0;
        const float vi = sv[i], vj = sv[j];
        const int ii = si[i], ij = si[j];
        if (best_first ? better(vj, ij, vi, ii) : better(vi, ii, vj, ij)) {
          sv[i] = vj; sv[j] = vi;
          si[i] = ij; si[j] = ii;
        }
      }
      __syncthreads();
    }
  }
  for (int s = tid; s < k; s += kMergeThreads) {
    out_v[(long long)qb * k + s] = s < m ? sv[s] : kNegInf;
    out_i[(long long)qb * k + s] = s < m ? si[s] : kPadId;
  }
}

}  // namespace
