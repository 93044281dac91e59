// Embedding bag (weighted gather-sum of table rows) for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/embedding_bag/embedding_bag.py, `_kernel`
// (launched by `embedding_bag_pallas`), the Pallas TPU kernel, and the int8
// fold of its op (`kernels/embedding_bag/ops.py`). Two entry points, one per
// launch key: `embedding_bag_fwd` (an fp32 or bf16 table) and
// `embedding_bag_q8_fwd` (int8 codes with one fp32 scale per row).
//
// Computes out[b, :] = sum_j w[b, j] * table[clamp(ids[b, j]), :] in fp32,
// slots in order j = 0..H-1. ids are clamped into [0, V) (masked slots may
// hold anything). In the int8 mode the row's scale folds into the weight,
// w[b, j] * scale[id], and the codes are widened to fp32 here: no fp32 copy
// of the table is ever made (the reference's op casts the whole table).
// Every slot adds row * w, a masked or zero-weight one too, as the
// reference's kernel does: an inf or NaN row gives NaN there as well.
//
// What bounds it on this card: bytes. Each slot reads one row (D
// values of 4, 2 or 1 bytes) and the kernel does 2 D operations per slot,
// about 0.5 operation per byte, far under the ~20 FLOP/byte where 67 TFLOP/s
// of fp32 would take over from 3.35 TB/s. At DIN's shape (65,536 bags of 100
// slots, D = 18, fp32) the rows, ids, weights and output are ~0.5 GB, so
// ~0.16 ms. The TPU kernel walks the (bag, slot) grid in order and sums
// into a revisited output block; here a warp owns a whole bag (no atomics,
// no second pass): lanes load 32 of the bag's ids and weights at once and
// broadcast them with shuffles (this takes the place of scalar prefetch),
// each lane owns D columns 32 apart, and four slots' rows are loaded before
// they are summed, so each lane has four loads in flight. Row offsets are
// 64-bit (DIN's table is 4.8 GB). Loads are 4, 2 or 1 byte a lane, as rows
// of 18 or 10 values are not 16-byte aligned; a row of 18 values leaves 14
// lanes idle. Wider loads and several bags per warp for narrow rows are
// later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;        // 8 warps, one bag each
constexpr int CPL = 4;              // columns per lane: 128 per warp
constexpr int DCHUNK = 32 * CPL;    // columns of one block row (grid.y)
constexpr int UNROLL = 4;           // rows in flight per lane
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(signed char x) { return (float)x; }

template <typename T, bool QUANT>
__global__ void __launch_bounds__(THREADS)
bag_kernel(const T* __restrict__ table, const float* __restrict__ scale,
           const int* __restrict__ ids, const float* __restrict__ w,
           float* __restrict__ out, int B, int H, int V, int D) {
  const int bag = blockIdx.x * (THREADS / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (bag >= B) return;                       // whole warps leave together
  const int d0 = blockIdx.y * DCHUNK + lane;
  const int* bid = ids + (size_t)bag * H;
  const float* bw = w + (size_t)bag * H;
  float acc[CPL];
#pragma unroll
  for (int c = 0; c < CPL; ++c) acc[c] = 0.f;

  for (int j0 = 0; j0 < H; j0 += 32) {
    const int n = min(32, H - j0);
    int id = 0;
    float wj = 0.f;
    if (lane < n) {
      id = min(max(bid[j0 + lane], 0), V - 1);
      wj = bw[j0 + lane];
      if (QUANT) wj *= scale[id];
    }
    for (int t = 0; t < n; t += UNROLL) {
      float v[UNROLL][CPL], wt[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        // every lane takes part in both shuffles; the slot's weight and id
        // are then the same across the warp, so the branch is uniform.
        // Only the steps past the bag's last slot load nothing.
        wt[u] = __shfl_sync(FULL, wj, (t + u) & 31);
        const int it = __shfl_sync(FULL, id, (t + u) & 31);
        const bool slot = t + u < n;
        if (!slot) wt[u] = 0.f;
        const T* row = table + (size_t)it * (size_t)D;
#pragma unroll
        for (int c = 0; c < CPL; ++c) {
          const int d = d0 + 32 * c;
          v[u][c] = (slot && d < D) ? to_f(row[d]) : 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
#pragma unroll
        for (int c = 0; c < CPL; ++c) acc[c] = fmaf(v[u][c], wt[u], acc[c]);
    }
  }
#pragma unroll
  for (int c = 0; c < CPL; ++c) {
    const int d = d0 + 32 * c;
    if (d < D) out[(size_t)bag * D + d] = acc[c];
  }
}

template <typename T, bool QUANT>
int launch(const void* table, const void* scale, const void* ids,
           const void* w, void* out, int B, int H, int V, int D,
           void* stream) {
  if (B < 0 || H < 0 || D <= 0 || V <= 0 || table == nullptr ||
      ids == nullptr || w == nullptr || out == nullptr ||
      (QUANT && scale == nullptr))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  dim3 grid((B + THREADS / 32 - 1) / (THREADS / 32),
            (D + DCHUNK - 1) / DCHUNK);
  bag_kernel<T, QUANT><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(table), static_cast<const float*>(scale),
      static_cast<const int*>(ids), static_cast<const float*>(w),
      static_cast<float*>(out), B, H, V, D);
  return (int)cudaGetLastError();
}

}  // namespace

// Both entry points return the launch's cudaError_t (0 = launched).
// table (V, D) row-major, ids (B, H) int32, w (B, H) fp32, out (B, D) fp32.
// `is_bf16` selects a bf16 table, else fp32.
extern "C" int embedding_bag_fwd(const void* table, const void* ids,
                                 const void* w, void* out, int B, int H,
                                 int V, int D, int is_bf16, void* stream) {
  if (is_bf16)
    return launch<__nv_bfloat16, false>(table, nullptr, ids, w, out, B, H,
                                        V, D, stream);
  return launch<float, false>(table, nullptr, ids, w, out, B, H, V, D,
                              stream);
}

// The int8 mode: codes (V, D) int8, scale (V,) fp32.
extern "C" int embedding_bag_q8_fwd(const void* codes, const void* scale,
                                    const void* ids, const void* w,
                                    void* out, int B, int H, int V, int D,
                                    void* stream) {
  return launch<signed char, true>(codes, scale, ids, w, out, B, H, V, D,
                                   stream);
}
