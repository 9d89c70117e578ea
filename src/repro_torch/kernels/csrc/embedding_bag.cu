// EmbeddingBag for Hopper (sm_90a): a row gather and a masked segment sum.
//
//   out[b] = sum_{j < min(lengths[b], L)} table[clip(ids[b, j], 0, V-1)]
//
// in float32 (a bfloat16 table is widened row by row), then divided by
// max(lengths[b], 1) in mode "mean". lengths[b] > L sums all L slots and
// still divides by lengths[b]; lengths[b] <= 0 gives zeros. Slots at or past
// lengths[b] are never read: the TPU kernel reads them and adds them times
// zero, which is the same sum for a finite table (a dead slot whose row is
// not finite turns the TPU kernel's bag to NaN, and not this one's).
//
// Replaces the TPU kernel embedding_bag_pallas
// (src/repro/kernels/embedding_bag/kernel.py:44), whose grid (B, L) DMAs one
// prefetched row per step into a VMEM accumulator. Here one warp owns one
// bag, a block holds eight bags. The warp's lanes read the bag's ids 32 at a
// time and pass each along by shuffle; for every live slot the lanes load the
// row across d, 16 bytes a lane where the row allows it (float4 of float32,
// eight bfloat16), and add it to their float32 accumulators. Rows are added
// in slot order j = 0, 1, ... as the TPU kernel and the plain version
// (kernels/embedding_bag/ref.py) add them, so the three agree bit for bit;
// four rows' loads are issued before their four adds, to keep loads in
// flight.
//
// Bound: bytes. Each live slot reads one d-wide row; at the two-tower
// serve_bulk cell (B = 262,144 bags of up to 50 slots, d = 256, float32
// rows) every row is 1 KiB, 13.4 GB for full bags, about 4 ms at 3.35 TB/s
// (lengths uniform in 1..50, as the cell draws them, read about half that).
// The rows are scattered at random over a 10M-row table, so every row is a
// fresh HBM read; the kernel does one add per loaded float.
//
// The backward (embedding_bag_bwd_launch) gives the table's gradient:
//
//   dtable[r] = sum over live slots (b, l) with clip(ids[b, l]) == r of
//               grad[b]  (grad[b] / max(lengths[b], 1) in mode "mean")
//
// It replaces no TPU kernel: the reference differentiates jnp.take plus a
// masked sum, and XLA makes that a scatter-add. On the card a scatter-add is
// atomic (index_add_), so its float32 sums land in another order every run;
// here every row is summed in one fixed order, ascending (b, l), and written
// once, so two runs of a training step give the same bits. The wrapper sorts
// the B * L slot keys (clipped id, or V for a dead slot) with a stable
// torch.sort, which lays each row's slots out as a run in (b, l) order, and
// zero-fills the [V, d] output. A warp takes one sorted position and one
// 32 * VEC column tile; unless the position starts a run of a live row, it
// returns at once. Otherwise it walks the run 32 entries at a time (the lanes
// load 32 keys and slots, a ballot says how many are still the row's; the
// keys are sorted, so those are the first), loads four grad rows before
// their four adds, divides each by its bag's length in mode "mean" as the
// forward does (__fdiv_rn), adds them in order from zero (__fadd_rn), and
// writes the row. The row lookups of the models run the same kernel with
// bags of one (lengths 1, "sum"). The plain version
// (kernels/embedding_bag/ref.py:embedding_bag_bwd_ref) adds the same values
// in the same order: the two agree bit for bit.
//
// Bound: bytes. The grad rows of the bags with a live slot are read, the ids
// and lengths once, each touched row written once (d floats); the zero fill
// of the [V, d] output (a memset by the wrapper) is counted apart. A row with
// a long run (a frequent token's embedding) is one warp's serial walk: at
// llama3.2-1b's train cell the commonest of 128,256 Zipfian tokens takes
// about 8% of the slots.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float bf16_to_f32(uint16_t h) {
  return __uint_as_float(((uint32_t)h) << 16);
}

// VEC consecutive elements of a row, widened to float32.
template <typename T, int VEC>
struct Loader;

template <>
struct Loader<float, 1> {
  static __device__ __forceinline__ void load(const float* p, float* v) {
    v[0] = __ldg(p);
  }
};

template <>
struct Loader<float, 4> {
  static __device__ __forceinline__ void load(const float* p, float* v) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = x.x;
    v[1] = x.y;
    v[2] = x.z;
    v[3] = x.w;
  }
};

template <>
struct Loader<uint16_t, 1> {
  static __device__ __forceinline__ void load(const uint16_t* p, float* v) {
    v[0] = bf16_to_f32(__ldg(p));
  }
};

template <>
struct Loader<uint16_t, 8> {
  static __device__ __forceinline__ void load(const uint16_t* p, float* v) {
    const uint4 x = __ldg(reinterpret_cast<const uint4*>(p));
    const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

template <typename T, int VEC>
__global__ void embedding_bag_kernel(const T* __restrict__ table,
                                     const int* __restrict__ ids,
                                     const int* __restrict__ lengths,
                                     float* __restrict__ out, int nbags,
                                     int l, int v, int d, int mean) {
  const int lane = threadIdx.x & 31;
  const int bag = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (bag >= nbags) return;
  const int len = lengths[bag];
  const int n = len < 0 ? 0 : (len < l ? len : l);
  const int* bag_ids = ids + (size_t)bag * l;
  const float div = mean ? fmaxf((float)len, 1.0f) : 1.0f;

  for (int c0 = 0; c0 < d; c0 += 32 * VEC) {
    const int col = c0 + lane * VEC;
    const bool on = col < d;   // VEC divides d where VEC > 1
    float acc[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = 0.0f;
    for (int j0 = 0; j0 < n; j0 += 32) {
      int my_id = 0;
      if (j0 + lane < n) {
        my_id = bag_ids[j0 + lane];
        my_id = my_id < 0 ? 0 : (my_id >= v ? v - 1 : my_id);
      }
      const int cnt = n - j0 < 32 ? n - j0 : 32;
      int jj = 0;
      for (; jj + 4 <= cnt; jj += 4) {
        float r[4][VEC];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int id = __shfl_sync(kFull, my_id, jj + u);
          if (on) Loader<T, VEC>::load(table + (size_t)id * d + col, r[u]);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[e] = __fadd_rn(acc[e], r[u][e]);
        }
      }
      for (; jj < cnt; ++jj) {
        const int id = __shfl_sync(kFull, my_id, jj);
        float r[VEC];
        if (on) {
          Loader<T, VEC>::load(table + (size_t)id * d + col, r);
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[e] = __fadd_rn(acc[e], r[e]);
        }
      }
    }
    if (on) {
      float* o = out + (size_t)bag * d + col;
#pragma unroll
      for (int e = 0; e < VEC; ++e) o[e] = mean ? __fdiv_rn(acc[e], div)
                                                : acc[e];
    }
  }
}

template <typename T, int VEC>
int launch(const void* table, const int* ids, const int* lengths, float* out,
           int nbags, int l, int v, int d, int mean, cudaStream_t stream) {
  const int blocks = (nbags + kWarpsPerBlock - 1) / kWarpsPerBlock;
  embedding_bag_kernel<T, VEC><<<blocks, 32 * kWarpsPerBlock, 0, stream>>>(
      static_cast<const T*>(table), ids, lengths, out, nbags, l, v, d, mean);
  return (int)cudaGetLastError();
}

template <int VEC>
__device__ __forceinline__ void load_grad(const float* p, float* v) {
  if (VEC == 4) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = x.x;
    v[1] = x.y;
    v[2] = x.z;
    v[3] = x.w;
  } else {
#pragma unroll
    for (int e = 0; e < VEC; ++e) v[e] = __ldg(p + e);
  }
}

template <int VEC>
__global__ void embedding_bag_bwd_kernel(const float* __restrict__ grad,
                                         const int* __restrict__ lengths,
                                         const int* __restrict__ keys,
                                         const int* __restrict__ slots,
                                         float* __restrict__ out, int n, int l,
                                         int v, int d, int mean) {
  const int lane = threadIdx.x & 31;
  const int p = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (p >= n) return;
  const int key = keys[p];
  if (key >= v) return;                       // dead slots sort last
  if (p > 0 && keys[p - 1] == key) return;    // not the start of its run
  const int col = (blockIdx.y * 32 + lane) * VEC;
  const bool on = col < d;   // VEC divides d where VEC > 1
  float acc[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) acc[e] = 0.0f;
  for (int q0 = p;; q0 += 32) {
    int my_key = v, my_bag = 0;
    float my_div = 1.0f;
    if (q0 + lane < n) {
      my_key = keys[q0 + lane];
      my_bag = slots[q0 + lane] / l;
      if (mean) my_div = fmaxf((float)lengths[my_bag], 1.0f);
    }
    const int cnt = __popc(__ballot_sync(kFull, my_key == key));
    int jj = 0;
    for (; jj + 4 <= cnt; jj += 4) {
      float r[4][VEC];
      float dv[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int bag = __shfl_sync(kFull, my_bag, jj + u);
        dv[u] = __shfl_sync(kFull, my_div, jj + u);
        if (on) load_grad<VEC>(grad + (size_t)bag * d + col, r[u]);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          acc[e] = __fadd_rn(acc[e], mean ? __fdiv_rn(r[u][e], dv[u])
                                          : r[u][e]);
      }
    }
    for (; jj < cnt; ++jj) {
      const int bag = __shfl_sync(kFull, my_bag, jj);
      const float dv = __shfl_sync(kFull, my_div, jj);
      if (on) {
        float r[VEC];
        load_grad<VEC>(grad + (size_t)bag * d + col, r);
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          acc[e] = __fadd_rn(acc[e], mean ? __fdiv_rn(r[e], dv) : r[e]);
      }
    }
    if (cnt < 32) break;
  }
  if (on) {
    float* o = out + (size_t)key * d + col;
#pragma unroll
    for (int e = 0; e < VEC; ++e) o[e] = acc[e];
  }
}

template <int VEC>
int launch_bwd(const float* grad, const int* lengths, const int* keys,
               const int* slots, float* out, int n, int l, int v, int d,
               int mean, cudaStream_t stream) {
  const dim3 grid((n + kWarpsPerBlock - 1) / kWarpsPerBlock,
                  (d + 32 * VEC - 1) / (32 * VEC));
  if (grid.y > 65535) return -1;
  embedding_bag_bwd_kernel<VEC><<<grid, 32 * kWarpsPerBlock, 0, stream>>>(
      grad, lengths, keys, slots, out, n, l, v, d, mean);
  return (int)cudaGetLastError();
}

}  // namespace

// table [v, d] (dtype 0: float32, 1: bfloat16), ids [nbags, l] int32,
// lengths [nbags] int32, out [nbags, d] float32, all contiguous. A lane
// loads 16 bytes of a row at once where every row starts on a 16-byte
// boundary (d a multiple of 4 float32 / 8 bfloat16, an aligned table), else
// one element. Returns 0, -1 for arguments out of range, or a cudaError_t
// code.
extern "C" int embedding_bag_launch(const void* table, int dtype,
                                    const int* ids, const int* lengths,
                                    float* out, int nbags, int l, int v,
                                    int d, int mean, void* stream) {
  if (nbags == 0) return 0;
  if (nbags < 0 || l < 0 || v < 1 || d < 1) return -1;
  cudaStream_t s = (cudaStream_t)stream;
  const bool aligned = (uintptr_t)table % 16 == 0;
  if (dtype == 0)
    return aligned && d % 4 == 0
               ? launch<float, 4>(table, ids, lengths, out, nbags, l, v, d,
                                  mean, s)
               : launch<float, 1>(table, ids, lengths, out, nbags, l, v, d,
                                  mean, s);
  if (dtype == 1)
    return aligned && d % 8 == 0
               ? launch<uint16_t, 8>(table, ids, lengths, out, nbags, l, v, d,
                                     mean, s)
               : launch<uint16_t, 1>(table, ids, lengths, out, nbags, l, v, d,
                                     mean, s);
  return -1;
}

// grad [n / l, d] float32, lengths [n / l] int32, keys and slots [n] int32
// (the slots b * l + j sorted by (clipped id, b, j), dead slots keyed v and
// last), out [v, d] float32 zero-filled, all contiguous. A lane loads 16
// bytes of a grad row at once where d is a multiple of 4 and grad 16-byte
// aligned, else one float. Writes each row with a live slot once. Returns
// 0, -1 for arguments out of range, or a cudaError_t code.
extern "C" int embedding_bag_bwd_launch(const float* grad, const int* lengths,
                                        const int* keys, const int* slots,
                                        float* out, int n, int l, int v, int d,
                                        int mean, void* stream) {
  if (n == 0) return 0;
  if (n < 0 || l < 1 || v < 1 || d < 1) return -1;
  cudaStream_t s = (cudaStream_t)stream;
  if ((uintptr_t)grad % 16 == 0 && (uintptr_t)out % 16 == 0 && d % 4 == 0)
    return launch_bwd<4>(grad, lengths, keys, slots, out, n, l, v, d, mean, s);
  return launch_bwd<1>(grad, lengths, keys, slots, out, n, l, v, d, mean, s);
}
