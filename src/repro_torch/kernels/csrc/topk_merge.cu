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
// in VMEM and takes k sweeps of max / min-id / mask. Here one block owns one
// row: the row's C pairs go to shared memory as 64-bit sort keys
//   key = (~orderable(value) << 32) | tie-break id
// (orderable() maps float order onto unsigned order after -0.0 -> +0.0,
// and the complement makes larger values sort first), each beside the
// entry's own value; a bitonic sort orders the keys ascending over the row
// padded to a power of two P >= C with pad keys, and the first k are
// written. Live ids are unique per row (the shards are disjoint), so the
// keys of live entries are distinct and the sort needs no stability; pads
// share one key and one value.
//
// Bound: bytes. A row reads 8C bytes and writes 8k; the sort is about
// P log2(P)^2 / 4 compare-exchanges in shared memory, all on chip. At the
// sharded search's shape (Q = 256, C = 320, k = 40) the whole merge moves
// 0.74 MB, 0.22 us at 3.35 TB/s; the kernel's time is the 45 barrier-
// separated sort stages of each block. The widest row is C = 16384
// (KNOB_LADDER's top rung 2048 times 8 shards): 12 bytes a slot, 192 KiB of
// shared memory, inside a block's 227 KB.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxC = 16384;
constexpr int kMaxThreads = 1024;
constexpr float kNegInf = -1e30f;           // NEG_INF of kernels/common.py
constexpr uint32_t kIdMax = 0x7fffffffu;    // the pads' tie-break id

__device__ __forceinline__ unsigned long long make_key(float v, int id) {
  uint32_t tb = (uint32_t)id;
  if (id < 0) {
    v = kNegInf;
    tb = kIdMax;
  }
  if (v == 0.0f) v = 0.0f;                  // -0.0 and +0.0: one class
  const uint32_t b = __float_as_uint(v);
  const uint32_t ord = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  return ((unsigned long long)(~ord) << 32) | tb;
}

__global__ void topk_merge_kernel(const float* __restrict__ vals,
                                  const int* __restrict__ ids,
                                  float* __restrict__ out_v,
                                  int* __restrict__ out_i, int c, int k,
                                  int p) {
  extern __shared__ unsigned long long keys[];  // [p] keys, then [p] values
  float* sv = (float*)(keys + p);

  const int r = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const float* vrow = vals + (size_t)r * c;
  const int* irow = ids + (size_t)r * c;
  const unsigned long long pad_key = make_key(kNegInf, -1);

  for (int j = tid; j < p; j += nt) {
    if (j < c) {
      const int id = irow[j];
      keys[j] = make_key(vrow[j], id);
      sv[j] = id < 0 ? kNegInf : vrow[j];
    } else {
      keys[j] = pad_key;
      sv[j] = kNegInf;
    }
  }
  __syncthreads();

  // bitonic sort, ascending keys; pair t of a stage compares slots lo and
  // lo + stride, ascending where the size-block of lo is even
  for (int size = 2; size <= p; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = tid; t < (p >> 1); t += nt) {
        const int lo = 2 * t - (t & (stride - 1));
        const int hi = lo + stride;
        const bool asc = (lo & size) == 0;
        const unsigned long long a = keys[lo], b = keys[hi];
        if ((a > b) == asc) {
          keys[lo] = b;
          keys[hi] = a;
          const float x = sv[lo];
          sv[lo] = sv[hi];
          sv[hi] = x;
        }
      }
      __syncthreads();
    }
  }

  float* ov = out_v + (size_t)r * k;
  int* oi = out_i + (size_t)r * k;
  for (int j = tid; j < k; j += nt) {
    const uint32_t tb = (uint32_t)(keys[j] & 0xffffffffull);
    if (tb == kIdMax) {
      ov[j] = kNegInf;
      oi[j] = -1;
    } else {
      ov[j] = sv[j];
      oi[j] = (int)tb;
    }
  }
}

int padded_width(int c) {
  int p = 2;
  while (p < c) p <<= 1;
  return p;
}

}  // namespace

// Widest candidate row the kernel takes.
extern "C" int topk_merge_max_c() { return kMaxC; }

// Shared memory a launch of width c needs, in bytes.
extern "C" long long topk_merge_smem(int c) {
  return (long long)padded_width(c) * (sizeof(unsigned long long) +
                                       sizeof(float));
}

// vals [nq, c] float32, ids [nq, c] int32, contiguous; out [nq, k].
// Returns 0, -1 for arguments out of range, or a cudaError_t code.
extern "C" int topk_merge_launch(const float* vals, const int* ids,
                                 float* out_v, int* out_i, int nq, int c,
                                 int k, void* stream) {
  if (nq == 0) return 0;
  if (c < 1 || c > kMaxC || k < 1 || k > c) return -1;
  const int p = padded_width(c);
  const size_t smem = (size_t)topk_merge_smem(c);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        topk_merge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  int threads = p / 2;
  if (threads < 32) threads = 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  topk_merge_kernel<<<nq, threads, smem, (cudaStream_t)stream>>>(
      vals, ids, out_v, out_i, c, k, p);
  return (int)cudaGetLastError();
}
