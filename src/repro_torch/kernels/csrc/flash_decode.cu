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
//
// Bound: bytes. A step reads the live K and V once: at long_500k (B = 1,
// S = 524,288, kh = 8, g = 4, dh = 64, bfloat16) 1.07 GB a layer, 0.32 ms
// at 3.35 TB/s; at decode_32k (B = 32) 2.15 GB, 0.64 ms. The arithmetic is
// about 4 g flops a byte of bfloat16 cache: at 3.35 TB/s some 13 TFLOP/s of
// float32 FMA, a fifth of the SIMT peak, so the kernel keeps up with the
// bytes only if it computes from registers while loads are in flight.
//
// Design (the first version staged each tile through shared memory as
// float32, with synchronous loads and four block barriers a tile, and read
// every operand of every score and every p * V term back from there: a
// third of the bandwidth):
//   pass 1 (flash_decode_partial): grid (splits, kh * head chunks, B), 256
//     threads. A group of LP = pow2(ceil(dh / 8)) lanes holds one position,
//     8 head elements a lane (16 bytes of bfloat16, two 16-byte vectors of
//     float32): 8 lanes at dh = 64, four positions a warp and load. Each
//     lane keeps its 8-element slice of the chunk's GC <= 8 scaled query
//     heads in registers; a score is 8 FMAs and a shuffle-xor reduction
//     inside the group. The same lanes hold V for those positions, so p * V
//     runs in registers too: each lane accumulates GC x its 8 elements of
//     dh, with its own running (m, l) per head (a float32 online softmax with
//     expf, folding NP positions at a time: one rescale a chunk). Loads go
//     through a per-thread ring of kStages cp.async stages in shared memory
//     (16-byte cp.async.cg, zero-filled past the live length): a thread
//     waits only for its own copies, so the loop has no block barrier and
//     kStages - 1 stages (32 KB a block) stay in flight. At the end of its
//     split a block merges its position groups (shuffles) and its warps
//     (shared memory, once) and writes (m, l, acc) of the split. Splits
//     wholly past len return before loading anything. Caches that are not
//     16-byte aligned, or a dh that is not a multiple of 8 (1, 6, 12, ...),
//     take the scalar variant of the same loop: element loads straight into
//     registers, masked past dh, no ring. (The tensor memory accelerator
//     bringing each stage's K and V rows on an mbarrier ran no faster on
//     the H100.)
//   pass 2 (flash_decode_merge): grid B * kh. Merges the live splits'
//     partials: M = max m, L = sum l e^(m - M), A = sum acc e^(m - M),
//     out = A / max(L, 1e-30).
// Split constants: a split is a whole number of kTile = 64 positions (a
// stage of a block at dh = 64, bfloat16); the wrapper (kernel.py) aims for
// 264 pass-1 blocks, one wave of two blocks on each of the 132 SMs, from
// (B, kh, S) alone: long_500k 33 splits of 15,936 positions, decode_32k 2
// of 16,384.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kEpl = 8;           // head elements a lane holds
constexpr int kStages = 3;        // cp.async ring depth
constexpr int kVecs = 2;          // 16-byte vectors a lane stages a stage, K and V each
constexpr int kTile = 64;         // a split is a whole number of these
constexpr int kMaxDh = 128;
constexpr int kMaxGd = 4096;      // g * dh
constexpr int kMaxGc = 8;         // query heads a block holds in registers
constexpr float kNegInf = -1e30f; // NEG_INF of kernels/common.py
// the ring: [kStages][K, V][kVecs][kThreads] 16-byte vectors
constexpr size_t kSmem = (size_t)kStages * 2 * kVecs * kThreads * 16;
static_assert(kSmem >= sizeof(float) * kWarps * kMaxGc * (kMaxDh + 2),
              "the merge area fits in the ring");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(uint16_t h) {
  return __uint_as_float(((uint32_t)h) << 16);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// kEpl head elements from one 16-byte vector of bfloat16 or two of float32
template <typename T>
__device__ __forceinline__ void unpack(const uint4* r, float (&x)[kEpl]) {
  if constexpr (sizeof(T) == 2) {
    const uint4 a = r[0];
    const uint32_t w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      x[2 * e] = __uint_as_float(w[e] << 16);
      x[2 * e + 1] = __uint_as_float(w[e] & 0xffff0000u);
    }
  } else {
    const uint4 a = r[0], b = r[kThreads];   // the lane's next vector
    x[0] = __uint_as_float(a.x); x[1] = __uint_as_float(a.y);
    x[2] = __uint_as_float(a.z); x[3] = __uint_as_float(a.w);
    x[4] = __uint_as_float(b.x); x[5] = __uint_as_float(b.y);
    x[6] = __uint_as_float(b.z); x[7] = __uint_as_float(b.w);
  }
}

// Fold NP positions into the lane's running softmax. s: the lane's partial
// dots, reduced here over the LP lanes of its group; ok: the position is
// live (uniform over the group; dead positions have zero K and V).
template <int GC, int NP>
__device__ __forceinline__ void fold(float (&s)[NP][GC],
                                     const float (&vx)[NP][kEpl],
                                     const bool (&ok)[NP], int lp,
                                     float (&m)[GC], float (&l)[GC],
                                     float (&acc)[GC][kEpl]) {
  for (int o = lp >> 1; o > 0; o >>= 1)
#pragma unroll
    for (int np = 0; np < NP; ++np)
#pragma unroll
      for (int i = 0; i < GC; ++i)
        s[np][i] += __shfl_xor_sync(0xffffffffu, s[np][i], o);
#pragma unroll
  for (int i = 0; i < GC; ++i) {
    float mx = kNegInf;
#pragma unroll
    for (int np = 0; np < NP; ++np)
      if (ok[np]) mx = fmaxf(mx, s[np][i]);
    const float mn = fmaxf(m[i], mx);
    const float a = expf(m[i] - mn);
    float p[NP], ps = 0.0f;
#pragma unroll
    for (int np = 0; np < NP; ++np) {
      p[np] = ok[np] ? expf(s[np][i] - mn) : 0.0f;
      ps += p[np];
    }
    l[i] = fmaf(l[i], a, ps);
    m[i] = mn;
#pragma unroll
    for (int e = 0; e < kEpl; ++e) {
      float t = acc[i][e] * a;
#pragma unroll
      for (int np = 0; np < NP; ++np) t = fmaf(p[np], vx[np][e], t);
      acc[i][e] = t;
    }
  }
}

// T: float or uint16_t (bfloat16 bits). GC: query heads a block holds (a
// chunk of the group). VEC: 16-byte cp.async ring (aligned caches, dh a
// multiple of 8), else element loads into registers.
template <typename T, int GC, bool VEC>
__global__ void __launch_bounds__(kThreads, GC <= 4 ? 2 : 1)
flash_decode_partial(const float* __restrict__ q, const T* __restrict__ kc,
                     const T* __restrict__ vc, const int* __restrict__ cur_len,
                     float* __restrict__ pm, float* __restrict__ pl,
                     float* __restrict__ pacc, int s, int kh, int g, int dh,
                     int split, int nsplit, float scale) {
  constexpr int VPP = kEpl * (int)sizeof(T) / 16;   // vectors a position
  constexpr int NP = kVecs / VPP;                   // positions a lane a stage
  extern __shared__ uint4 ring[];

  const int sp = blockIdx.x, b = blockIdx.z;
  const int nchunk = (g + GC - 1) / GC;
  const int h = blockIdx.y / nchunk, i0 = (blockIdx.y % nchunk) * GC;
  int len = *cur_len;
  len = len < 0 ? 0 : (len > s ? s : len);
  const int start = sp * split;
  if (start >= len) return;                  // a dead split: pass 2 skips it
  const int stop = start + split < len ? start + split : len;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int lp = 1;                                // lanes a position
  while (lp * kEpl < dh) lp <<= 1;
  const int ppw = 32 / lp;                   // positions a warp and slot
  const int grp = lane / lp, sub = lane % lp, c0 = sub * kEpl;
  const bool lane_ok = c0 < dh;
  const int per_stage = NP * kWarps * ppw;   // positions a block a stage
  const int nst = (stop - start + per_stage - 1) / per_stage;

  float qr[GC][kEpl], m[GC], l[GC], acc[GC][kEpl];
  const float* qb = q + ((size_t)b * kh + h) * g * dh;
#pragma unroll
  for (int i = 0; i < GC; ++i) {
#pragma unroll
    for (int e = 0; e < kEpl; ++e) {
      const int c = c0 + e;
      qr[i][e] = (i0 + i < g && c < dh) ? qb[(i0 + i) * dh + c] * scale
                                        : 0.0f;
      acc[i][e] = 0.0f;
    }
    m[i] = kNegInf;
    l[i] = 0.0f;
  }

  const size_t row_stride = (size_t)kh * dh;
  const size_t base = ((size_t)b * s * kh + h) * dh + c0;
  auto pos = [&](int st, int np) {
    return start + st * per_stage + (np * kWarps + warp) * ppw + grp;
  };

  if constexpr (VEC) {
    auto issue = [&](int st) {
      if (st < nst) {
        uint4* slot = ring + (size_t)(st % kStages) * 2 * kVecs * kThreads;
#pragma unroll
        for (int np = 0; np < NP; ++np) {
          const int p = pos(st, np);
          const bool ok = lane_ok && p < stop;
          const size_t off = ok ? base + (size_t)p * row_stride : 0;
#pragma unroll
          for (int j = 0; j < VPP; ++j) {
            const int v = np * VPP + j;
            cp_async16(slot + v * kThreads + tid, kc + off + j * 16 / sizeof(T),
                       ok ? 16 : 0);
            cp_async16(slot + (kVecs + v) * kThreads + tid,
                       vc + off + j * 16 / sizeof(T), ok ? 16 : 0);
          }
        }
      }
      cp_async_commit();                     // empty past nst: counts stay
    };
#pragma unroll
    for (int st = 0; st < kStages - 1; ++st) issue(st);
    for (int st = 0; st < nst; ++st) {
      cp_async_wait<kStages - 2>();          // this thread's stage st landed
      // refill the slot this thread read last iteration
      issue(st + kStages - 1);
      const uint4* slot = ring + (size_t)(st % kStages) * 2 * kVecs * kThreads;
      float sc[NP][GC], vx[NP][kEpl];
      bool ok[NP];
#pragma unroll
      for (int np = 0; np < NP; ++np) {
        ok[np] = pos(st, np) < stop;
        float kx[kEpl];
        unpack<T>(slot + np * VPP * kThreads + tid, kx);
#pragma unroll
        for (int i = 0; i < GC; ++i) {
          float d = 0.0f;
#pragma unroll
          for (int e = 0; e < kEpl; ++e) d = fmaf(qr[i][e], kx[e], d);
          sc[np][i] = d;
        }
        unpack<T>(slot + (kVecs + np * VPP) * kThreads + tid, vx[np]);
      }
      fold<GC, NP>(sc, vx, ok, lp, m, l, acc);
    }
    cp_async_wait<0>();
  } else {
    for (int st = 0; st < nst; ++st) {
      float kx[NP][kEpl], vx[NP][kEpl], sc[NP][GC];
      bool ok[NP];
#pragma unroll
      for (int np = 0; np < NP; ++np) {
        const int p = pos(st, np);
        ok[np] = p < stop;
        const T* kr = kc + base + (size_t)p * row_stride;
        const T* vr = vc + base + (size_t)p * row_stride;
#pragma unroll
        for (int e = 0; e < kEpl; ++e) {
          const bool in = ok[np] && c0 + e < dh;
          kx[np][e] = in ? to_f32(__ldg(kr + e)) : 0.0f;
          vx[np][e] = in ? to_f32(__ldg(vr + e)) : 0.0f;
        }
      }
#pragma unroll
      for (int np = 0; np < NP; ++np)
#pragma unroll
        for (int i = 0; i < GC; ++i) {
          float d = 0.0f;
#pragma unroll
          for (int e = 0; e < kEpl; ++e) d = fmaf(qr[i][e], kx[np][e], d);
          sc[np][i] = d;
        }
      fold<GC, NP>(sc, vx, ok, lp, m, l, acc);
    }
  }

  // merge the warp's position groups (lanes of one sub, other groups)
  for (int o = lp; o < 32; o <<= 1) {
#pragma unroll
    for (int i = 0; i < GC; ++i) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[i], o);
      const float lo = __shfl_xor_sync(0xffffffffu, l[i], o);
      const float mn = fmaxf(m[i], mo);
      const float a = expf(m[i] - mn), ao = expf(mo - mn);
      l[i] = l[i] * a + lo * ao;
#pragma unroll
      for (int e = 0; e < kEpl; ++e)
        acc[i][e] = acc[i][e] * a +
                    __shfl_xor_sync(0xffffffffu, acc[i][e], o) * ao;
      m[i] = mn;
    }
  }
  // then the block's warps, through the ring's memory: [warp][head] m and
  // l, [warp][head][dh] acc
  __syncthreads();                           // every thread's ring reads done
  float* red = reinterpret_cast<float*>(ring);
  float* rm = red;
  float* rl = rm + kWarps * GC;
  float* ra = rl + kWarps * GC;
  if (grp == 0 && lane_ok) {
#pragma unroll
    for (int i = 0; i < GC; ++i) {
#pragma unroll
      for (int e = 0; e < kEpl; ++e)
        if (c0 + e < dh) ra[(warp * GC + i) * dh + c0 + e] = acc[i][e];
      if (sub == 0) {
        rm[warp * GC + i] = m[i];
        rl[warp * GC + i] = l[i];
      }
    }
  }
  __syncthreads();
  const int nh = g - i0 < GC ? g - i0 : GC;
  const size_t part = ((size_t)b * kh + h) * nsplit + sp;   // [B, kh, nsplit]
  for (int o = tid; o < nh * dh; o += kThreads) {
    const int i = o / dh, c = o - i * dh;
    float mx = kNegInf;
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, rm[w * GC + i]);
    float ls = 0.0f, as = 0.0f;
    for (int w = 0; w < kWarps; ++w) {
      const float e = expf(rm[w * GC + i] - mx);
      ls += rl[w * GC + i] * e;
      as += ra[(w * GC + i) * dh + c] * e;
    }
    pacc[(part * g + i0 + i) * dh + c] = as;
    if (c == 0) {
      pm[part * g + i0 + i] = mx;
      pl[part * g + i0 + i] = ls;
    }
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

template <typename T, int GC, bool VEC>
int launch(const float* q, const void* kc, const void* vc, const int* cur_len,
           float* pm, float* pl, float* pacc, float* out, int b, int s,
           int kh, int g, int dh, int split, int nsplit, float scale,
           cudaStream_t stream) {
  const int nchunk = (g + GC - 1) / GC;
  if ((long long)kh * nchunk > 65535) return -1;
  const dim3 grid(nsplit, kh * nchunk, b);
  flash_decode_partial<T, GC, VEC><<<grid, kThreads, kSmem, stream>>>(
      q, static_cast<const T*>(kc), static_cast<const T*>(vc), cur_len, pm,
      pl, pacc, s, kh, g, dh, split, nsplit, scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  flash_decode_merge<<<b * kh, kThreads, 0, stream>>>(
      pm, pl, pacc, cur_len, out, s, g, dh, split, nsplit);
  return (int)cudaGetLastError();
}

template <typename T, bool VEC>
int launch_g(const float* q, const void* kc, const void* vc,
             const int* cur_len, float* pm, float* pl, float* pacc,
             float* out, int b, int s, int kh, int g, int dh, int split,
             int nsplit, float scale, cudaStream_t st) {
  if (g <= 1)
    return launch<T, 1, VEC>(q, kc, vc, cur_len, pm, pl, pacc, out, b, s, kh,
                             g, dh, split, nsplit, scale, st);
  if (g <= 2)
    return launch<T, 2, VEC>(q, kc, vc, cur_len, pm, pl, pacc, out, b, s, kh,
                             g, dh, split, nsplit, scale, st);
  if (g <= 4)
    return launch<T, 4, VEC>(q, kc, vc, cur_len, pm, pl, pacc, out, b, s, kh,
                             g, dh, split, nsplit, scale, st);
  // wider groups: chunks of 8 heads, each chunk's blocks read the tile
  return launch<T, kMaxGc, VEC>(q, kc, vc, cur_len, pm, pl, pacc, out, b, s,
                                kh, g, dh, split, nsplit, scale, st);
}

}  // namespace

// Largest head width and group width (g * dh) the kernel takes.
extern "C" int flash_decode_max_dh() { return kMaxDh; }
extern "C" int flash_decode_max_gd() { return kMaxGd; }
// Positions of the split granularity; a split is a whole number of tiles.
extern "C" int flash_decode_tile() { return kTile; }

// q [b, kh, g, dh] float32; k, v [b, s, kh, dh] (dtype 0: float32,
// 1: bfloat16); cur_len one int32 on the device; partials pm, pl
// [b, kh, nsplit, g] and pacc [b, kh, nsplit, g, dh] float32 scratch;
// out [b, kh, g, dh] float32; all contiguous. split: positions a pass-1
// block takes (a multiple of the tile), nsplit * split >= s. The ring of
// 16-byte copies runs where both caches start on a 16-byte boundary and dh
// is a multiple of 8 (every row then does too); else the scalar variant.
// Returns 0, -1 for arguments out of range, or a cudaError_t code.
extern "C" int flash_decode_launch(const float* q, const void* kc,
                                   const void* vc, int dtype,
                                   const int* cur_len, float* pm, float* pl,
                                   float* pacc, float* out, int b, int s,
                                   int kh, int g, int dh, int split,
                                   int nsplit, float scale, void* stream) {
  if (b == 0 || kh == 0 || g == 0) return 0;
  if (b < 0 || s < 1 || kh < 0 || g < 0 || dh < 1 || dh > kMaxDh ||
      g * dh > kMaxGd || split < 1 || split % kTile != 0 || nsplit < 1 ||
      (long long)split * nsplit < s || kh > 65535 || b > 65535)
    return -1;
  cudaStream_t st = (cudaStream_t)stream;
  const bool vec = (uintptr_t)kc % 16 == 0 && (uintptr_t)vc % 16 == 0 &&
                   dh % kEpl == 0;
  if (dtype == 0)
    return vec ? launch_g<float, true>(q, kc, vc, cur_len, pm, pl, pacc, out,
                                       b, s, kh, g, dh, split, nsplit, scale,
                                       st)
               : launch_g<float, false>(q, kc, vc, cur_len, pm, pl, pacc, out,
                                        b, s, kh, g, dh, split, nsplit, scale,
                                        st);
  if (dtype == 1)
    return vec ? launch_g<uint16_t, true>(q, kc, vc, cur_len, pm, pl, pacc,
                                          out, b, s, kh, g, dh, split, nsplit,
                                          scale, st)
               : launch_g<uint16_t, false>(q, kc, vc, cur_len, pm, pl, pacc,
                                           out, b, s, kh, g, dh, split, nsplit,
                                           scale, st);
  return -1;
}
