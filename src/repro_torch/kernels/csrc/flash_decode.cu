// One-token GQA decode attention for Hopper (sm_90a), split over the KV axis.
//
// For every batch row b, KV head h and query head i of its group of g:
//   s_p = (q[b, h, i] * dh^-0.5) . k[b, p, h]        (float32)
//   out[b, h, i] = sum_{p < len} softmax(s)_p v[b, p, h]
// with len = min(max(cur_len, 0), S) read from device memory (the decode
// step keeps the cache length there, so no launch waits on the host), and
// out = acc / max(l, 1e-30): at len = 0 the output is zeros, as the TPU
// kernel and the model's decode path give (ROADMAP C5).
//
// Replaces the TPU kernel flash_decode_pallas
// (src/repro/kernels/flash_decode/kernel.py:62), whose grid (B, S / bs)
// walks the KV axis in order on one core, carrying (m, l, acc) in VMEM.
// On Hopper one block per (b, h) would give B * kh blocks (8 at B = 1,
// kh = 8) for 132 SMs, so the KV axis is split:
//   pass 1 (flash_decode_partial): grid (splits, kh, B). A block walks its
//     split's positions in tiles of kTile; it stages a K tile in shared
//     memory (widened to float32, rows padded to dh + 1 floats so that
//     neighbouring positions fall in different banks), scores it against
//     all g query heads of the group (the GQA reuse: a tile is read once
//     for g heads), folds the tile into a running (m, l) per head, stages
//     the V tile in the same buffer and adds p * V into per-thread float32
//     accumulators rescaled by exp(m_old - m_new). It writes (m, l, acc) of
//     its split. Splits wholly past len return before loading anything.
//   pass 2 (flash_decode_merge): grid B * kh. Merges the live splits'
//     partials: M = max m, L = sum l e^(m - M), A = sum acc e^(m - M),
//     out = A / max(L, 1e-30).
//
// Bound: bytes. A step reads the live K and V once: at long_500k (B = 1,
// S = 524,288, kh = 8, dh = 64, bfloat16) 1.07 GB a layer, 0.32 ms at
// 3.35 TB/s; at decode_32k with B = 32, 2.15 GB, 0.64 ms. The arithmetic
// is about 4 g dh flops a position and head, far below the card's rate; the
// tile's trips through shared memory (a score is a dot of dh products read
// from there, as is each term of p * V) are what this first version spends
// beyond the bytes.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 128;        // positions staged a tile
constexpr int kThreads = 256;
constexpr int kMaxDh = 128;
constexpr int kMaxAcc = 16;       // g * dh <= kThreads * kMaxAcc
constexpr float kNegInf = -1e30f; // NEG_INF of kernels/common.py

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(uint16_t h) {
  return __uint_as_float(((uint32_t)h) << 16);
}

// Stage rows [0, n) of one tile (row stride kh * dh in the cache) into
// buf[p * (dh + 1) + c] as float32. VEC elements a load where the rows allow.
template <typename T, int VEC>
__device__ __forceinline__ void stage(const T* __restrict__ src, size_t row_stride,
                                      int n, int dh, float* buf) {
  const int per_row = dh / VEC;
  for (int i = threadIdx.x; i < n * per_row; i += blockDim.x) {
    const int p = i / per_row;
    const int c = (i - p * per_row) * VEC;
    const T* r = src + (size_t)p * row_stride + c;
    float* o = buf + p * (dh + 1) + c;
    if constexpr (VEC == 1) {
      o[0] = to_f32(__ldg(r));
    } else if constexpr (sizeof(T) == 4) {   // float4
      const float4 x = __ldg(reinterpret_cast<const float4*>(r));
      o[0] = x.x; o[1] = x.y; o[2] = x.z; o[3] = x.w;
    } else {                                  // eight bfloat16
      const uint4 x = __ldg(reinterpret_cast<const uint4*>(r));
      const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        o[2 * e] = __uint_as_float(w[e] << 16);
        o[2 * e + 1] = __uint_as_float(w[e] & 0xffff0000u);
      }
    }
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads, 4)
flash_decode_partial(const float* __restrict__ q, const T* __restrict__ kc,
                     const T* __restrict__ vc, const int* __restrict__ cur_len,
                     float* __restrict__ pm, float* __restrict__ pl,
                     float* __restrict__ pacc, int s, int kh, int g, int dh,
                     int split, int nsplit, float scale) {
  extern __shared__ float smem[];
  float* qs = smem;                          // [g * dh]
  float* buf = qs + g * dh;                  // [kTile * (dh + 1)]
  float* sc = buf + kTile * (dh + 1);        // [g * kTile]
  float* m_run = sc + g * kTile;             // [g]
  float* l_run = m_run + g;                  // [g]
  float* alpha = l_run + g;                  // [g]

  const int sp = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  int len = *cur_len;
  len = len < 0 ? 0 : (len > s ? s : len);
  const int start = sp * split;
  if (start >= len) return;                  // a dead split: pass 2 skips it
  const int stop = start + split < len ? start + split : len;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int gd = g * dh;

  const float* qb = q + ((size_t)b * kh + h) * gd;
  for (int i = tid; i < gd; i += blockDim.x) qs[i] = qb[i] * scale;
  for (int i = tid; i < g; i += blockDim.x) {
    m_run[i] = kNegInf;
    l_run[i] = 0.0f;
  }
  float acc[kMaxAcc];
#pragma unroll
  for (int r = 0; r < kMaxAcc; ++r) acc[r] = 0.0f;

  const size_t row_stride = (size_t)kh * dh;
  const size_t base = ((size_t)b * s * kh + h) * dh;
  for (int t0 = start; t0 < stop; t0 += kTile) {
    const int n = stop - t0 < kTile ? stop - t0 : kTile;
    __syncthreads();   // the previous tile's V reads are done
    stage<T, VEC>(kc + base + (size_t)t0 * row_stride, row_stride, n, dh, buf);
    __syncthreads();
    for (int i = tid; i < g * n; i += blockDim.x) {
      const int gi = i / n, p = i - gi * n;
      const float* qr = qs + gi * dh;
      const float* kr = buf + p * (dh + 1);
      float dot = 0.0f;
      for (int c = 0; c < dh; ++c) dot = fmaf(qr[c], kr[c], dot);
      sc[gi * kTile + p] = dot;
    }
    __syncthreads();
    for (int gi = warp; gi < g; gi += nwarps) {
      float* row = sc + gi * kTile;
      float mt = kNegInf;
      for (int p = lane; p < n; p += 32) mt = fmaxf(mt, row[p]);
      for (int o = 16; o > 0; o >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, o));
      const float m_old = m_run[gi];
      const float m_new = fmaxf(m_old, mt);
      float ls = 0.0f;
      for (int p = lane; p < n; p += 32) {
        const float e = expf(row[p] - m_new);
        row[p] = e;
        ls += e;
      }
      for (int o = 16; o > 0; o >>= 1)
        ls += __shfl_xor_sync(0xffffffffu, ls, o);
      if (lane == 0) {
        const float a = expf(m_old - m_new);
        alpha[gi] = a;
        l_run[gi] = l_run[gi] * a + ls;
        m_run[gi] = m_new;
      }
    }
    __syncthreads();   // scores are weights now; K is no longer read
    stage<T, VEC>(vc + base + (size_t)t0 * row_stride, row_stride, n, dh, buf);
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kMaxAcc; ++r) {
      const int o = tid + r * blockDim.x;
      if (o < gd) {
        const int gi = o / dh, c = o - gi * dh;
        const float* w = sc + gi * kTile;
        float sum = 0.0f;
        for (int p = 0; p < n; ++p) sum = fmaf(w[p], buf[p * (dh + 1) + c], sum);
        acc[r] = acc[r] * alpha[gi] + sum;
      }
    }
  }
  const size_t part = ((size_t)b * kh + h) * nsplit + sp;   // [B, kh, nsplit]
#pragma unroll
  for (int r = 0; r < kMaxAcc; ++r) {
    const int o = tid + r * blockDim.x;
    if (o < gd) pacc[part * gd + o] = acc[r];
  }
  for (int i = tid; i < g; i += blockDim.x) {
    pm[part * g + i] = m_run[i];
    pl[part * g + i] = l_run[i];
  }
}

__global__ void __launch_bounds__(kThreads)
flash_decode_merge(const float* __restrict__ pm, const float* __restrict__ pl,
                   const float* __restrict__ pacc,
                   const int* __restrict__ cur_len, float* __restrict__ out,
                   int s, int g, int dh, int split, int nsplit) {
  const int bh = blockIdx.x;               // b * kh + h
  int len = *cur_len;
  len = len < 0 ? 0 : (len > s ? s : len);
  const int live = (len + split - 1) / split;
  const int gd = g * dh;
  const float* m = pm + (size_t)bh * nsplit * g;
  const float* l = pl + (size_t)bh * nsplit * g;
  const float* a = pacc + (size_t)bh * nsplit * gd;
  for (int o = threadIdx.x; o < gd; o += blockDim.x) {
    const int gi = o / dh;
    float mx = kNegInf;
#pragma unroll 8
    for (int sp = 0; sp < live; ++sp) mx = fmaxf(mx, m[sp * g + gi]);
    float lsum = 0.0f, asum = 0.0f;
#pragma unroll 8
    for (int sp = 0; sp < live; ++sp) {
      const float w = expf(m[sp * g + gi] - mx);
      lsum += l[sp * g + gi] * w;
      asum += a[(size_t)sp * gd + o] * w;
    }
    out[(size_t)bh * gd + o] = asum / fmaxf(lsum, 1e-30f);
  }
}

size_t partial_smem(int g, int dh) {
  return sizeof(float) * ((size_t)g * dh + (size_t)kTile * (dh + 1) +
                          (size_t)g * kTile + 3 * (size_t)g);
}

template <typename T, int VEC>
int launch(const float* q, const void* kc, const void* vc, const int* cur_len,
           float* pm, float* pl, float* pacc, float* out, int b, int s,
           int kh, int g, int dh, int split, int nsplit, float scale,
           cudaStream_t stream) {
  const size_t smem = partial_smem(g, dh);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_decode_partial<T, VEC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(nsplit, kh, b);
  flash_decode_partial<T, VEC><<<grid, kThreads, smem, stream>>>(
      q, static_cast<const T*>(kc), static_cast<const T*>(vc), cur_len, pm,
      pl, pacc, s, kh, g, dh, split, nsplit, scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  flash_decode_merge<<<b * kh, kThreads, 0, stream>>>(
      pm, pl, pacc, cur_len, out, s, g, dh, split, nsplit);
  return (int)cudaGetLastError();
}

}  // namespace

// Largest head width and group width (g * dh) the kernel takes.
extern "C" int flash_decode_max_dh() { return kMaxDh; }
extern "C" int flash_decode_max_gd() { return kThreads * kMaxAcc; }
// Positions a tile stages; a split is a whole number of tiles.
extern "C" int flash_decode_tile() { return kTile; }
// Shared memory pass 1 needs for (g, dh), in bytes.
extern "C" long long flash_decode_smem(int g, int dh) {
  return (long long)partial_smem(g, dh);
}

// q [b, kh, g, dh] float32; k, v [b, s, kh, dh] (dtype 0: float32,
// 1: bfloat16); cur_len one int32 on the device; partials pm, pl
// [b, kh, nsplit, g] and pacc [b, kh, nsplit, g, dh] float32 scratch;
// out [b, kh, g, dh] float32; all contiguous. split: positions a pass-1
// block takes (a multiple of the tile), nsplit * split >= s. A tile is
// staged 16 bytes a load where every cache row starts on a 16-byte boundary
// (dh a multiple of 4 float32 / 8 bfloat16, aligned caches), else one
// element a load. Returns 0, -1 for arguments out of range, or a
// cudaError_t code.
extern "C" int flash_decode_launch(const float* q, const void* kc,
                                   const void* vc, int dtype,
                                   const int* cur_len, float* pm, float* pl,
                                   float* pacc, float* out, int b, int s,
                                   int kh, int g, int dh, int split,
                                   int nsplit, float scale, void* stream) {
  if (b == 0 || kh == 0 || g == 0) return 0;
  if (b < 0 || s < 1 || kh < 0 || g < 0 || dh < 1 || dh > kMaxDh ||
      g * dh > kThreads * kMaxAcc || split < 1 || split % kTile != 0 ||
      nsplit < 1 || (long long)split * nsplit < s || kh > 65535 ||
      b > 65535)
    return -1;
  cudaStream_t st = (cudaStream_t)stream;
  const bool aligned = (uintptr_t)kc % 16 == 0 && (uintptr_t)vc % 16 == 0;
  if (dtype == 0)
    return aligned && dh % 4 == 0
               ? launch<float, 4>(q, kc, vc, cur_len, pm, pl, pacc, out, b,
                                  s, kh, g, dh, split, nsplit, scale, st)
               : launch<float, 1>(q, kc, vc, cur_len, pm, pl, pacc, out, b,
                                  s, kh, g, dh, split, nsplit, scale, st);
  if (dtype == 1)
    return aligned && dh % 8 == 0
               ? launch<uint16_t, 8>(q, kc, vc, cur_len, pm, pl, pacc, out,
                                     b, s, kh, g, dh, split, nsplit, scale,
                                     st)
               : launch<uint16_t, 1>(q, kc, vc, cur_len, pm, pl, pacc, out,
                                     b, s, kh, g, dh, split, nsplit, scale,
                                     st);
  return -1;
}
