// RAE encoder GEMM for Hopper (sm_90a): z[R, m] = x[R, n] @ W_e[n, m] at
// float32 accuracy on the tensor cores (3xTF32), with an optional row
// L2-normalize epilogue z / max(|z|, 1e-12).
//
// Replaces the TPU kernel rae_encode_pallas (src/repro/kernels/rae_encode/
// kernel.py:39).
//
// Bound: bytes. At the port's main shape, [1M, 768] @ [768, 64], x is 3.07
// GB and x read and z written 3.33 GB: 0.99 ms at 3.35 TB/s. The three
// TF32 products are 3 x 2 R n m = 295 GFLOP, 0.60 ms at the 495 TFLOP/s
// TF32 rate. On SIMT float32 (the first version: one fmaf a term, 67
// TFLOP/s) the 98 GFLOP alone need 1.47 ms; it ran at 5.2 ms.
//
// Arithmetic: 3xTF32. Each operand is split as big = rna(a) and small =
// rna(a - big), rna rounding to TF32 to nearest, ties away from zero, as
// cvt.rna.tf32.f32 does (the subtraction is exact in float32; both parts
// are rounded explicitly, since a TF32 product fed raw float32 bits
// truncates them), and the float32 accumulators take small * big + big *
// small + big * big. On the paper's shapes ([4096, 768] @ [768, 64] and
// [768, 384], x ~ N(0, 1), W ~ N(0, 1/768)) that model, summed in float32
// on the CPU, is off from the float64 product by 6e-7 of max(1, max |z|),
// float32's own error; on the card about 6e-6 (the tensor cores align the
// products before they add them, and drop the bits shifted out), under the
// bar of 1e-4. One TF32 product is off by about 3e-4, over it. Small
// integers are exact in TF32 (small = 0), so integer inputs give the
// float32 product bit for bit.
//
// Main path (m <= 64, rows 16-byte aligned): wgmma. A first launch splits
// W_e once into its big and small parts, slice by slice of 32 k, in
// wgmma's K-major core-matrix layout (scratch from the wrapper, 393 KB at
// n = 768). The encoder's block of 256 threads (two warpgroups) owns 128
// whole rows and all 64 columns, so the normalize epilogue stays in
// registers (a row's columns sit in four lanes). A ring of 3 stages holds
// x's 128 x 32 tile, brought by the tensor memory accelerator (one 2-D
// copy, 128-byte swizzle, rows past R and k past n filled with zeros), and
// W_e's split slice (one bulk copy from L2, 16 KB, as many bytes as x's
// tile), both signalled on an mbarrier. Each warpgroup loads its A
// fragments from x's tile (8 contiguous floats of each of its rows; W_e's
// slices are stored in the matching k order), splits them in registers
// and issues small * big, big * small and big * big as m64n64k8 TF32
// wgmmas, B from shared memory. wgmma and the copy engine, not mma.sync:
// on the H100 at this shape the same loop ran markedly slower on mma.sync
// m16n8k8, and on wgmma fed by cp.async (whose loads alone fell short of
// the bytes bound's pace) than on wgmma fed by the copy engine.
//
// Other shapes (m up to 512, or rows not 16-byte aligned: n or m not a
// multiple of 4, an offset pointer): the same 3xTF32 on mma.sync m16n8k8,
// both operands split in registers. A block of 8 warps owns BM whole rows
// and all m columns (BN >= m, padded with zeros); x's BM x BK tile and
// W_e's BK x BN slice come through a 4-stage cp.async ring (16-byte copies
// where rows are aligned, else 4-byte ones), shared-memory rows padded (x
// by 4 floats, W by 8) so that the fragment loads hit 32 distinct banks.
#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kStages = 4;   // the mma.sync path's cp.async ring

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// cvt.rna.tf32.f32 in two integer operations: add half of the 13 dropped
// bits' weight to the magnitude, clear them (the conversion instruction
// compiles to a longer sequence, which slowed the mma.sync loop).
__device__ __forceinline__ uint32_t tf32_rna(float a) {
  return (__float_as_uint(a) + 0x1000u) & 0xffffe000u;
}
__device__ __forceinline__ void split(float a, uint32_t& big,
                                      uint32_t& small) {
  big = tf32_rna(a);
  small = tf32_rna(a - __uint_as_float(big));
}

// d += a (16 x 8, row) * b (8 x 8, col), TF32 in, float32 accumulate
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// ---------------------------------------------------------------------------
// other shapes: mma.sync
// ---------------------------------------------------------------------------
template <int BM, int BN, int BK>
constexpr size_t smem_bytes() {
  return sizeof(float) * kStages * (BM * (BK + 4) + BK * (BN + 8));
}

template <int BM, int BN, int BK, int WM, int WN, bool VEC>
__global__ void __launch_bounds__(kThreads, BN <= 64 ? 2 : 1)
rae_encode_mma(const float* __restrict__ x, const float* __restrict__ w,
                  float* __restrict__ z, int rows, int n, int m,
                  int normalize) {
  static_assert(WM * WN * 32 == kThreads, "8 warps");
  constexpr int TM = BM / WM, TN = BN / WN;   // a warp's tile
  constexpr int MT = TM / 16, NT = TN / 8;    // its m16n8 tiles
  static_assert(MT * 16 == TM && NT * 8 == TN && BK % 8 == 0, "tiles");
  constexpr int XS = BK + 4;   // x row stride: fragment banks 4g + t
  constexpr int WS = BN + 8;   // W row stride: fragment banks 8t + g
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                          // [kStages][BM][XS]
  float* ws = smem + kStages * BM * XS;      // [kStages][BK][WS]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / WN, wn = warp % WN;
  const int gq = lane >> 2, tq = lane & 3;   // the fragments' group, thread
  const long long row0 = (long long)blockIdx.x * BM;
  const int nk = (n + BK - 1) / BK;

  auto load = [&](int kt) {
    if (kt < nk) {
      float* xd = xs + (kt % kStages) * BM * XS;
      float* wd = ws + (kt % kStages) * BK * WS;
      const int k0 = kt * BK;
      if constexpr (VEC) {   // n, m multiples of 4: whole 16-byte chunks
        for (int c = tid; c < BM * BK / 4; c += kThreads) {
          const int r = c / (BK / 4), kk = (c % (BK / 4)) * 4;
          const long long gr = row0 + r;
          const bool ok = gr < rows && k0 + kk < n;
          cp_async16(xd + r * XS + kk, ok ? x + gr * n + k0 + kk : x,
                     ok ? 16 : 0);
        }
        for (int c = tid; c < BK * BN / 4; c += kThreads) {
          const int kk = c / (BN / 4), col = (c % (BN / 4)) * 4;
          const bool ok = k0 + kk < n && col < m;
          cp_async16(wd + kk * WS + col,
                     ok ? w + (long long)(k0 + kk) * m + col : w,
                     ok ? 16 : 0);
        }
      } else {
        for (int c = tid; c < BM * BK; c += kThreads) {
          const int r = c / BK, kk = c % BK;
          const long long gr = row0 + r;
          const bool ok = gr < rows && k0 + kk < n;
          cp_async4(xd + r * XS + kk, ok ? x + gr * n + k0 + kk : x,
                    ok ? 4 : 0);
        }
        for (int c = tid; c < BK * BN; c += kThreads) {
          const int kk = c / BN, col = c % BN;
          const bool ok = k0 + kk < n && col < m;
          cp_async4(wd + kk * WS + col,
                    ok ? w + (long long)(k0 + kk) * m + col : w, ok ? 4 : 0);
        }
      }
    }
    cp_async_commit();   // empty past nk: the group count stays
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.0f;

#pragma unroll
  for (int kt = 0; kt < kStages - 1; ++kt) load(kt);
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStages - 2>();   // this thread's slice kt landed
    __syncthreads();                // everyone's; slot kt - 1 is free
    load(kt + kStages - 1);
    const float* xt = xs + (kt % kStages) * BM * XS + (wm * TM + gq) * XS + tq;
    const float* wt = ws + (kt % kStages) * BK * WS + tq * WS + wn * TN + gq;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 8) {
      uint32_t ab[MT][4], as[MT][4], bb[NT][2], bs[NT][2];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const float* p = xt + i * 16 * XS + kk;
        split(p[0], ab[i][0], as[i][0]);             // (g, t)
        split(p[8 * XS], ab[i][1], as[i][1]);        // (g + 8, t)
        split(p[4], ab[i][2], as[i][2]);             // (g, t + 4)
        split(p[8 * XS + 4], ab[i][3], as[i][3]);    // (g + 8, t + 4)
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float* p = wt + kk * WS + j * 8;
        split(p[0], bb[j][0], bs[j][0]);             // (k = t, n = g)
        split(p[4 * WS], bb[j][1], bs[j][1]);        // (k = t + 4, n = g)
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          mma(acc[i][j], as[i], bb[j]);
          mma(acc[i][j], ab[i], bs[j]);
          mma(acc[i][j], ab[i], bb[j]);
        }
    }
  }
  cp_async_wait<0>();

  // rows wm * TM + i * 16 + gq (+ 8), columns wn * TN + j * 8 + 2 tq (+ 1)
  float denom[MT][2];
#pragma unroll
  for (int i = 0; i < MT; ++i) denom[i][0] = denom[i][1] = 1.0f;
  if (normalize) {
    float ss[MT][2];
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      ss[i][0] = ss[i][1] = 0.0f;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        ss[i][0] = fmaf(acc[i][j][0], acc[i][j][0], ss[i][0]);
        ss[i][0] = fmaf(acc[i][j][1], acc[i][j][1], ss[i][0]);
        ss[i][1] = fmaf(acc[i][j][2], acc[i][j][2], ss[i][1]);
        ss[i][1] = fmaf(acc[i][j][3], acc[i][j][3], ss[i][1]);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {   // the row's four tq lanes
        ss[i][h] += __shfl_xor_sync(0xffffffffu, ss[i][h], 1);
        ss[i][h] += __shfl_xor_sync(0xffffffffu, ss[i][h], 2);
      }
    }
    // then the row's WN warps, through shared memory: red[BM][WN]
    __syncthreads();
    float* red = smem;
    if (tq == 0)
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          red[(wm * TM + i * 16 + gq + 8 * h) * WN + wn] = ss[i][h];
    __syncthreads();
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float* r = red + (wm * TM + i * 16 + gq + 8 * h) * WN;
        float t = 0.0f;
#pragma unroll
        for (int u = 0; u < WN; ++u) t += r[u];
        denom[i][h] = fmaxf(sqrtf(t), 1e-12f);
      }
  }
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long gr = row0 + wm * TM + i * 16 + gq + 8 * h;
      if (gr >= rows) continue;
      float* out = z + gr * m;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int col = wn * TN + j * 8 + 2 * tq;
        const float v0 = acc[i][j][2 * h], v1 = acc[i][j][2 * h + 1];
        if (col < m) out[col] = normalize ? v0 / denom[i][h] : v0;
        if (col + 1 < m) out[col + 1] = normalize ? v1 / denom[i][h] : v1;
      }
    }
}

template <int BM, int BN, int BK, int WM, int WN>
int launch_mma(const float* x, const float* w, float* z, int rows, int n,
               int m, int normalize, bool vec, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<BM, BN, BK>();
  static_assert(smem <= 232448, "a block's shared memory");
  auto kern = vec ? &rae_encode_mma<BM, BN, BK, WM, WN, true>
                  : &rae_encode_mma<BM, BN, BK, WM, WN, false>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const unsigned grid = (unsigned)((rows + BM - 1) / BM);
  kern<<<grid, kThreads, smem, stream>>>(x, w, z, rows, n, m, normalize);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// main path: wgmma (m <= 64, 16-byte aligned rows)
// ---------------------------------------------------------------------------
constexpr int kWgBM = 128;       // rows a block
constexpr int kWgBK = 32;        // k a slice
constexpr int kWgBN = 64;        // output columns (m padded with zeros)
constexpr int kWgStages = 3;
constexpr int kWPart = kWgBK * kWgBN;   // floats of W's big or small slice
// wgmma's shared-memory descriptor, K-major, no swizzle: core matrices
// (8 rows of 16 bytes) 128 bytes apart along k, 1024 along n
constexpr uint32_t kLbo = 128, kSbo = 1024;

// W_e [n, m] -> per slice of 32 k: [big, small] x [64 n][32 k] in wgmma's
// K-major core-matrix order (8 n x 4 k, 128 contiguous bytes each): element
// (n, k) at (n / 8) * 256 + (k / 4) * 32 + (n % 8) * 4 + k % 4 floats, k
// counted in the order the encoder's A fragments take x (below). Columns
// past m and k past n are zeros.
__global__ void rae_w_split(const float* __restrict__ w,
                            uint32_t* __restrict__ out, int n, int m,
                            int nk) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= nk * kWPart) return;
  const int kt = idx / kWPart, r = idx % kWPart;
  const int kk = r / kWgBN, nn = r % kWgBN;
  // logical k (step s = kk / 8, fragment column c = kk % 8) holds physical
  // k 8 (c % 4) + 2 s + c / 4 of the slice
  const int c = kk % 8, k = kt * kWgBK + 8 * (c % 4) + 2 * (kk / 8) + c / 4;
  const float v = (k < n && nn < m) ? w[(long long)k * m + nn] : 0.0f;
  uint32_t big, small;
  split(v, big, small);
  const int off = (nn / 8) * 256 + (kk / 4) * 32 + (nn % 8) * 4 + kk % 4;
  out[(size_t)kt * 2 * kWPart + off] = big;
  out[(size_t)kt * 2 * kWPart + kWPart + off] = small;
}

__device__ __forceinline__ uint64_t smem_desc(const void* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  return (uint64_t)((a & 0x3FFFF) >> 4) |
         ((uint64_t)((kLbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((kSbo & 0x3FFFF) >> 4) << 32);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// d[64 x 64] += a[64 x 8] (registers) * b[8 x 64] (shared, K-major)
__device__ __forceinline__ void wgmma_tf32(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(uint64_t* b, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(b)),
               "r"(count));
}
__device__ __forceinline__ void mbar_expect(uint64_t* b, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(b)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* b, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(b)), "r"(parity) : "memory");
  } while (!done);
}
__device__ __forceinline__ void bulk_g2s(void* dst, const void* src,
                                         uint32_t bytes, uint64_t* b) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)), "l"(src), "r"(bytes),
      "r"(smem_u32(b)) : "memory");
}

__device__ __forceinline__ void tma_2d(void* dst, const CUtensorMap* map,
                                       int c0, int c1, uint64_t* b) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(smem_u32(b)) : "memory");
}

// x tiles by the tensor memory accelerator (kWgBM rows x 32 k, 128-byte
// swizzle: 16-byte chunk c of row r lands at chunk c ^ (r % 8), so the
// fragment loads below hit 32 distinct banks), W_e's split slice by a bulk
// copy; both on the stage's mbarrier
__global__ void __launch_bounds__(kThreads, 2)
rae_encode_tma(const __grid_constant__ CUtensorMap xmap,
               const float* __restrict__ wsp, float* __restrict__ z,
               int rows, int n, int m, int normalize) {
  constexpr int XT = kWgBM * kWgBK;                  // floats of an x tile
  extern __shared__ __align__(1024) float smem[];
  float* xs = smem;                                  // [stages][kWgBM][32]
  float* ws = smem + kWgStages * XT;                 // [stages][2][kWPart]
  uint64_t* full = reinterpret_cast<uint64_t*>(ws + kWgStages * 2 * kWPart);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2, wq = warp & 3;           // warpgroup, its warp
  const int gq = lane >> 2, tq = lane & 3;           // fragment group, thread
  const long long row0 = (long long)blockIdx.x * kWgBM;
  const int nk = (n + kWgBK - 1) / kWgBK;
  if (tid == 0)
    for (int st = 0; st < kWgStages; ++st) mbar_init(&full[st], 1);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  __syncthreads();

  auto load = [&](int kt) {
    if (kt < nk && tid == 0) {
      const int slot = kt % kWgStages;
      mbar_expect(&full[slot], (uint32_t)((XT + 2 * kWPart) * sizeof(float)));
      tma_2d(xs + slot * XT, &xmap, kt * kWgBK, (int)row0, &full[slot]);
      bulk_g2s(ws + slot * 2 * kWPart, wsp + (size_t)kt * 2 * kWPart,
               2 * kWPart * sizeof(float), &full[slot]);
    }
  };

  float acc[32];
#pragma unroll
  for (int r = 0; r < 32; ++r) acc[r] = 0.0f;
  for (int kt = 0; kt < kWgStages; ++kt) load(kt);
  const int r0 = wg * 64 + wq * 16 + gq;   // the thread's rows r0, r0 + 8
  for (int kt = 0; kt < nk; ++kt) {
    mbar_wait(&full[kt % kWgStages], (kt / kWgStages) & 1);
    const float* xr = xs + (kt % kWgStages) * XT + r0 * kWgBK;
    const float* wb = ws + (kt % kWgStages) * 2 * kWPart;
    // step s takes floats 8 tq + 2 s and + 1 of each row (chunk 2 tq + s / 2,
    // swizzled by r % 8 = gq): rows r0 and r0 + 8, fragment columns tq and
    // tq + 4
    uint32_t ab[kWgBK / 8][4], as[kWgBK / 8][4];
#pragma unroll
    for (int s = 0; s < kWgBK / 8; ++s) {
      const float* p = xr + ((2 * tq + s / 2) ^ gq) * 4 + 2 * (s % 2);
      split(p[0], ab[s][0], as[s][0]);
      split(p[8 * kWgBK], ab[s][1], as[s][1]);
      split(p[1], ab[s][2], as[s][2]);
      split(p[8 * kWgBK + 1], ab[s][3], as[s][3]);
    }
    wg_fence();
#pragma unroll
    for (int s = 0; s < kWgBK / 8; ++s) {   // k-chunks 2 s and 2 s + 1
      const uint64_t big = smem_desc(wb + s * 64);
      const uint64_t small = smem_desc(wb + kWPart + s * 64);
      wgmma_tf32(acc, as[s], big);
      wgmma_tf32(acc, ab[s], small);
      wgmma_tf32(acc, ab[s], big);
    }
    wg_commit();
    wg_wait0();
    // the A registers and the accumulators stay put until the wait
#pragma unroll
    for (int s = 0; s < kWgBK / 8; ++s)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        asm volatile("" : "+r"(ab[s][r]), "+r"(as[s][r])::"memory");
#pragma unroll
    for (int r = 0; r < 32; ++r) asm volatile("" : "+f"(acc[r])::"memory");
    __syncthreads();          // every warp has read the slot: refill it
    load(kt + kWgStages);
  }

  // acc[4 j + r]: row r0 (+ 8 for r >= 2) of the block's tile, column
  // 8 j + 2 tq (+ 1 for odd r); a row's 64 columns are in the four tq
  // lanes of one group
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float denom = 1.0f;
    if (normalize) {
      float ss = 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        ss = fmaf(acc[4 * j + 2 * h], acc[4 * j + 2 * h], ss);
        ss = fmaf(acc[4 * j + 2 * h + 1], acc[4 * j + 2 * h + 1], ss);
      }
      ss += __shfl_xor_sync(0xffffffffu, ss, 1);
      ss += __shfl_xor_sync(0xffffffffu, ss, 2);
      denom = fmaxf(sqrtf(ss), 1e-12f);
    }
    const long long gr = row0 + r0 + 8 * h;
    if (gr >= rows) continue;
    float* out = z + gr * m;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 8 * j + 2 * tq;
      const float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
      if (col < m) out[col] = normalize ? v0 / denom : v0;
      if (col + 1 < m) out[col + 1] = normalize ? v1 / denom : v1;
    }
  }
}

int launch_tma(const float* x, const float* w, float* z, int rows, int n,
               int m, int normalize, void* scratch, cudaStream_t stream) {
  static PFN_cuTensorMapEncodeTiled encode = nullptr;
  if (encode == nullptr) {
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", (void**)&encode,
                                cudaEnableDefault, &q) != cudaSuccess ||
        encode == nullptr)
      return -2;
  }
  // x as a 2-D tensor [rows][n] of float32, cut in kWgBM x kWgBK boxes
  CUtensorMap map;
  const cuuint64_t dims[2] = {(cuuint64_t)n, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)n * sizeof(float)};
  const cuuint32_t box[2] = {kWgBK, kWgBM}, estr[2] = {1, 1};
  if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, (void*)x, dims,
             strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return -3;
  constexpr size_t smem =
      sizeof(float) * kWgStages * (kWgBM * kWgBK + 2 * kWPart) +
      sizeof(uint64_t) * kWgStages;
  const int nk = (n + kWgBK - 1) / kWgBK;
  rae_w_split<<<(nk * kWPart + 255) / 256, 256, 0, stream>>>(
      w, static_cast<uint32_t*>(scratch), n, m, nk);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(rae_encode_tma,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return (int)e;
  rae_encode_tma<<<(unsigned)((rows + kWgBM - 1) / kWgBM), kThreads, smem,
                   stream>>>(map, static_cast<const float*>(scratch), z,
                             rows, n, m, normalize);
  return (int)cudaGetLastError();
}

}  // namespace

// Scratch bytes the launch needs for (n, m): W_e's split slices.
extern "C" long long rae_encode_scratch_bytes(int n, int m) {
  (void)m;
  return (long long)((n + kWgBK - 1) / kWgBK) * 2 * kWPart * sizeof(float);
}

// Plain C entry point (loaded with ctypes). x [rows, n], w [n, m] and
// z [rows, m] float32, contiguous; scratch: rae_encode_scratch_bytes(n, m)
// bytes on the device. Returns the cudaError_t of the launch; -1 when m is
// outside 1..512 or n < 1; -2 without the driver's tensor-map encoder, -3
// when it refuses x.
extern "C" int rae_encode_launch(const float* x, const float* w, float* z,
                                 int rows, int n, int m, int normalize,
                                 void* scratch, void* stream) {
  if (rows == 0) return 0;
  if (rows < 0 || n < 1 || m < 1 || m > 512) return -1;
  cudaStream_t s = (cudaStream_t)stream;
  const bool vec = n % 4 == 0 && m % 4 == 0 && (uintptr_t)x % 16 == 0 &&
                   (uintptr_t)w % 16 == 0;
  if (vec && m <= kWgBN)
    return launch_tma(x, w, z, rows, n, m, normalize, scratch, s);
  // (BM, BN, BK, WM, WN): BN >= m; the block's accumulators bound BM
  if (m <= 64)
    return launch_mma<128, 64, 32, 4, 2>(x, w, z, rows, n, m, normalize, vec,
                                         s);
  if (m <= 128)
    return launch_mma<128, 128, 32, 4, 2>(x, w, z, rows, n, m, normalize,
                                          vec, s);
  if (m <= 256)
    return launch_mma<64, 256, 32, 2, 4>(x, w, z, rows, n, m, normalize, vec,
                                         s);
  return launch_mma<32, 512, 16, 1, 8>(x, w, z, rows, n, m, normalize, vec,
                                       s);
}
