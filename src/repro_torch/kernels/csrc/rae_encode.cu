// RAE encoder GEMM for Hopper (sm_90a): z[R, m] = x[R, n] @ W_e[n, m] in
// full float32, with an optional row L2-normalize epilogue
// z / max(|z|, 1e-12).
//
// Replaces the TPU kernel rae_encode_pallas (src/repro/kernels/rae_encode/
// kernel.py). At the port's shapes (n = 768, m = 64) the work is 2*R*n*m
// FLOPs against 4*R*(n + m) bytes, about 30 FLOP per byte: above the
// card's float32 ridge (67 TFLOP/s over 3.35 TB/s = 20 FLOP per byte), so
// it is bounded by float32 operations. Tensor cores are not used: parity
// with the reference is measured at full float32 (no TF32).
//
// Design: one block of 256 threads (16 x 16) owns BM = 16*TM whole output
// rows and all m columns, so the normalize epilogue needs no second pass.
// The contraction walks n in slices of BK = 16 through shared memory; each
// thread accumulates TM x TN outputs in registers with one fmaf per term,
// in increasing n order. Thread (ty, tx) owns rows ty + 16*i and columns
// tx + 16*j, so neighbouring threads read neighbouring shared-memory words.
// A row's 16 column-owners sit in one half-warp, so the row norm is a
// 16-lane shuffle reduction.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBK = 16;

template <int TM, int TN>
__global__ void __launch_bounds__(kThreads)
rae_encode_kernel(const float* __restrict__ x, const float* __restrict__ w,
                  float* __restrict__ z, int rows, int n, int m,
                  int normalize) {
  constexpr int BM = 16 * TM;
  constexpr int BN = 16 * TN;
  __shared__ float xs[BM][kBK + 1];
  __shared__ float ws[kBK][BN];

  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const long long row0 = (long long)blockIdx.x * BM;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < n; k0 += kBK) {
    for (int p = tid; p < BM * kBK; p += kThreads) {
      const int r = p / kBK, kk = p % kBK;
      const long long gr = row0 + r;
      const int gk = k0 + kk;
      xs[r][kk] = (gr < rows && gk < n) ? x[gr * n + gk] : 0.0f;
    }
    for (int p = tid; p < kBK * BN; p += kThreads) {
      const int kk = p / BN, c = p % BN;
      const int gk = k0 + kk;
      ws[kk][c] = (gk < n && c < m) ? w[(long long)gk * m + c] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xs[ty + 16 * i][kk];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = ws[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const long long gr = row0 + ty + 16 * i;
    float denom = 1.0f;
    if (normalize) {
      float ss = 0.0f;
#pragma unroll
      for (int j = 0; j < TN; ++j) ss = fmaf(acc[i][j], acc[i][j], ss);
      // the 16 owners of this row are lanes tx = 0..15 of one half-warp
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        ss += __shfl_xor_sync(0xffffffffu, ss, off, 16);
      denom = fmaxf(sqrtf(ss), 1e-12f);
    }
    if (gr < rows) {
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int c = tx + 16 * j;
        if (c < m) z[gr * m + c] = normalize ? acc[i][j] / denom : acc[i][j];
      }
    }
  }
}

template <int TM, int TN>
int launch(const float* x, const float* w, float* z, int rows, int n, int m,
           int normalize, cudaStream_t stream) {
  const int bm = 16 * TM;
  const unsigned grid = (unsigned)((rows + bm - 1) / bm);
  rae_encode_kernel<TM, TN><<<grid, kThreads, 0, stream>>>(
      x, w, z, rows, n, m, normalize);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes). Returns the cudaError_t of the
// launch; -1 when m is outside 1..512.
extern "C" int rae_encode_launch(const float* x, const float* w, float* z,
                                 int rows, int n, int m, int normalize,
                                 void* stream) {
  if (rows == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int tn = (m + 15) / 16;  // columns per thread
  // TM * TN <= 64 accumulators a thread
  if (tn <= 1) return launch<8, 1>(x, w, z, rows, n, m, normalize, s);
  if (tn <= 2) return launch<8, 2>(x, w, z, rows, n, m, normalize, s);
  if (tn <= 4) return launch<8, 4>(x, w, z, rows, n, m, normalize, s);
  if (tn <= 8) return launch<4, 8>(x, w, z, rows, n, m, normalize, s);
  if (tn <= 16) return launch<4, 16>(x, w, z, rows, n, m, normalize, s);
  if (tn <= 24) return launch<2, 24>(x, w, z, rows, n, m, normalize, s);
  if (tn <= 32) return launch<2, 32>(x, w, z, rows, n, m, normalize, s);
  return -1;
}
