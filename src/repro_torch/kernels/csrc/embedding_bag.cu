// Embedding bag (weighted gather-sum of table rows) for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/embedding_bag/embedding_bag.py, `_kernel`
// (launched by `embedding_bag_pallas`), the Pallas TPU kernel, and the int8
// fold of its op (`kernels/embedding_bag/ops.py`). Two entry points, one per
// launch key: `embedding_bag_fwd` (an fp32 or bf16 table) and
// `embedding_bag_q8_fwd` (int8 codes with one fp32 scale per row).
//
// Computes out[b, :] = sum_j w[b, j] * table[clamp(ids[b, j]), :] in fp32.
// ids are clamped into [0, V) (masked slots may hold anything). In the int8
// mode the row's scale folds into the weight, w[b, j] * scale[id], before it
// multiplies the widened code; no fp32 copy of the table is ever made (the
// reference's op casts the whole table). Every slot adds row * w, a masked
// or zero-weight one too, as the reference's kernel does: an inf or NaN row
// or scale under such a slot gives NaN there as well. No atomics: the plan
// fixes the order of every sum, so equal inputs give equal bits.
//
// What bounds it on this card: the memory system's random accesses. A slot
// reads one row at a random place in a table of up to several GB (DIN's is
// 2^26 x 18 fp32, 4.8 GB), so nearly every row misses L2 and costs whole
// 32-byte sectors (a 72-byte fp32 row at a 72-byte stride always spans 3),
// and the kernel does 2 D operations per slot, about 0.5 per byte. On an
// H100 the cost follows the number of random accesses more than their
// sectors: a gather with one thread per slot and nothing else to wait for
// takes about as long as this kernel at DIN's shape, and an int8 slot makes
// two accesses (its row and, 1.2 GB away, its scale) where an fp32 slot
// makes one, so the int8 mode is slower than fp32 though it moves fewer
// bytes (PERF.md, section 6). The design keeps many rows in flight and
// wastes no lane:
//
// - Several rows per warp instruction, with the widest aligned vector. A
//   lane loads `vec` bytes, the largest power of two up to 16 that divides
//   both the row's byte stride and the table pointer's alignment (a view
//   such as table[1:] shifts it). `lanes_per_row` lanes cover one row, so
//   one warp step loads floor(32 / lanes_per_row) slots' rows at once (fp32
//   D = 18: 8-byte loads, 9 lanes, 3 rows; int8 D = 64: 16-byte loads, 4
//   lanes, 8 rows). Rows wider than 32 lanes split into column chunks, one
//   per grid.y, balanced over the lanes.
// - A warp walks its bag in rounds of `steps` warp steps: every lane group
//   issues the row loads of all its steps (up to STEPS = 8) before it does
//   any FMA. The ids and weights of the next round are loaded before the
//   current round's rows, so that round's id load overlaps these row loads.
//   Each group keeps its own fp32 partial sums; a fixed shuffle tree adds
//   the groups at the end of the bag. 4 or 16 steps were no faster at DIN's
//   shape (16 costs registers and occupancy).
// - int8: the scale load goes out with the row loads (both depend only on
//   the id): the lane that holds a slot's id loads scale[id] and folds it
//   into the slot's weight after the rows are asked for, and the weight is
//   then broadcast to the slot's group. No dependent round before the rows.
// - A grid that fills the card (`bag_plan` in kernels/embedding_bag.py):
//   warps per block (8, 4, 2 or 1) so that the grid has at least 2 blocks
//   per SM wherever the bags allow it. With few bags, each is split over
//   the most warps of a block (up to 8, one a round at least) that keep
//   the grid within 16 warps an SM (MIND's 512 bags: 4 warps each), warp k
//   taking rounds k, k + split, ..., and warp 0 adds the warps' sums in
//   order through shared memory (faster at MIND's shape than one warp a
//   bag; PERF.md, section 6).
//
// The entry points derive the plan themselves and refuse (cudaErrorInvalid-
// Value, without launching) a host plan that differs: vec, lanes_per_row,
// steps, split, warps per block or the pointer's alignment. Row offsets are
// 64-bit; ids are int32 (V < 2^31).
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int STEPS = 8;            // most warp steps of rows in flight
constexpr int MAX_WARPS = 8;        // warps (bags) per block
constexpr int SPLIT_WARPS_PER_SM = 16;  // few bags: split each over warps
constexpr unsigned FULL = 0xffffffffu;

// element types, by size: fp32, bf16 (raw bits), int8 codes
struct F32 { static constexpr int size = 4; };
struct BF16 { static constexpr int size = 2; };
struct I8 { static constexpr int size = 1; };

// `vec` bytes of one lane, as 32-bit words (one zero-extended word below 4)
template <int VEC>
struct Raw { unsigned w[VEC >= 4 ? VEC / 4 : 1]; };

template <int VEC>
__device__ __forceinline__ Raw<VEC> load_raw(const unsigned char* p) {
  Raw<VEC> r;
  if constexpr (VEC == 16) {
    const uint4 x = __ldg(reinterpret_cast<const uint4*>(p));
    r.w[0] = x.x; r.w[1] = x.y; r.w[2] = x.z; r.w[3] = x.w;
  } else if constexpr (VEC == 8) {
    const uint2 x = __ldg(reinterpret_cast<const uint2*>(p));
    r.w[0] = x.x; r.w[1] = x.y;
  } else if constexpr (VEC == 4) {
    r.w[0] = __ldg(reinterpret_cast<const unsigned*>(p));
  } else if constexpr (VEC == 2) {
    r.w[0] = __ldg(reinterpret_cast<const unsigned short*>(p));
  } else {
    r.w[0] = __ldg(p);
  }
  return r;
}

// element e (little-endian within each word) widened to fp32
template <typename T>
__device__ __forceinline__ float elem(const unsigned* w, int e) {
  if constexpr (T::size == 4) {
    return __uint_as_float(w[e]);
  } else if constexpr (T::size == 2) {
    const unsigned x = w[e >> 1];
    return __uint_as_float((e & 1) ? (x & 0xffff0000u) : (x << 16));
  } else {
    return (float)(int)(signed char)(w[e >> 2] >> (8 * (e & 3)));
  }
}

struct Plan {
  int vec, lanes_per_row, rows_per_step, steps, col_chunks, split, warps,
      blocks, align;
};

// The plan, as kernels/embedding_bag.py::bag_plan makes it.
Plan make_plan(int B, int H, int D, int esize, uintptr_t addr, int n_sm) {
  Plan p;
  p.align = 16;
  while (p.align > 1 && addr % p.align) p.align >>= 1;
  const long long row = (long long)D * esize;
  p.vec = 16;
  while (p.vec > 1 && (row % p.vec || p.align % p.vec)) p.vec >>= 1;
  const long long lanes = row / p.vec;
  p.col_chunks = (int)((lanes + 31) / 32);
  p.lanes_per_row = (int)((lanes + p.col_chunks - 1) / p.col_chunks);
  p.rows_per_step = 32 / p.lanes_per_row;
  p.steps = STEPS < 32 / p.rows_per_step ? STEPS : 32 / p.rows_per_step;
  const int chunk = p.rows_per_step * p.steps;
  const long long rounds = ((long long)H + chunk - 1) / chunk;
  const long long bags = (long long)B * p.col_chunks;
  p.split = 1;
  while (2 * p.split <= MAX_WARPS && 2 * p.split <= rounds &&
         bags * 2 * p.split <= (long long)SPLIT_WARPS_PER_SM * n_sm)
    p.split <<= 1;
  if (p.split > 1) {
    p.warps = p.split;
    p.blocks = B;
    return p;
  }
  for (p.warps = MAX_WARPS; p.warps > 1; p.warps >>= 1)
    if ((long long)((B + p.warps - 1) / p.warps) * p.col_chunks >=
        2LL * n_sm)
      break;
  p.blocks = (B + p.warps - 1) / p.warps;
  return p;
}

// SPLIT: a block is one bag, of which warp `wid` takes rounds wid,
// wid + split, ...; else each warp is a bag of its own (split is 1). A
// template flag: as a runtime branch it slowed the unsplit body.
template <typename T, bool QUANT, int VEC, bool SPLIT>
__device__ __forceinline__ void
bag_body(const unsigned char* __restrict__ table,
         const float* __restrict__ scale, const int* __restrict__ ids,
         const float* __restrict__ w, float* __restrict__ out, int B, int H,
         int V, int D, int lpr, int rps, int steps, int split) {
  constexpr int E = VEC / T::size;            // columns per lane
  extern __shared__ float parts[];            // SPLIT: (split, 32 E)
  const int wid = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int bag = SPLIT ? blockIdx.x : blockIdx.x * (blockDim.x >> 5) + wid;
  if (!SPLIT && bag >= B) return;             // whole warps leave together
  const int g = lane / lpr;                   // the lane's group (slot)
  const int l = lane - g * lpr;
  const int col = (blockIdx.y * lpr + l) * E;
  const bool active = g < rps && col < D;
  const size_t row_bytes = (size_t)D * T::size;
  const unsigned char* base = table + (size_t)col * T::size;
  const int chunk = rps * steps;              // slots a round, <= 32
  const int stride = SPLIT ? chunk * split : chunk;
  const int* bid = ids + (size_t)bag * H;
  const float* bw = w + (size_t)bag * H;

  float acc[E];
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = 0.f;

  int j0 = SPLIT ? wid * chunk : 0;
  int nid = 0;
  float nw = 0.f;
  if (lane < chunk && j0 + lane < H) {
    nid = __ldg(bid + j0 + lane);
    nw = __ldg(bw + j0 + lane);
  }
  for (; j0 < H; j0 += stride) {
    const int n = min(chunk, H - j0);
    const int id = min(max(nid, 0), V - 1);   // this lane's slot j0 + lane
    float wj = nw;
    float sc = 1.f;
    if (QUANT && lane < n) sc = __ldg(scale + id);
    const int jn = j0 + stride;               // the next round's ids
    if (lane < chunk && jn + lane < H) {
      nid = __ldg(bid + jn + lane);
      nw = __ldg(bw + jn + lane);
    }
    Raw<VEC> raw[STEPS];
#pragma unroll
    for (int u = 0; u < STEPS; ++u) {
      // all lanes shuffle; group g takes slot u * rps + g of the round
      const int s = u * rps + g;
      const int it = __shfl_sync(FULL, id, s & 31);
      if (u < steps && s < n && active)
        raw[u] = load_raw<VEC>(base + (size_t)it * row_bytes);
      else
#pragma unroll
        for (int k = 0; k < (VEC >= 4 ? VEC / 4 : 1); ++k) raw[u].w[k] = 0u;
    }
    if (QUANT) wj *= sc;                      // w * scale[id], then * code
#pragma unroll
    for (int u = 0; u < STEPS; ++u) {
      const int s = u * rps + g;
      const float wt = __shfl_sync(FULL, wj, s & 31);
      if (u < steps && s < n && active) {
#pragma unroll
        for (int e = 0; e < E; ++e)
          acc[e] = fmaf(elem<T>(raw[u].w, e), wt, acc[e]);
      }
    }
  }
  // add the groups' partial sums in a fixed tree: group g takes g + s
  for (int s = 1; s < rps; s <<= 1) {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const float o = __shfl_down_sync(FULL, acc[e], s * lpr);
      if (g % (2 * s) == 0 && g + s < rps) acc[e] += o;
    }
  }
  const bool writes = g == 0 && col < D;
  if (SPLIT) {                                // then the warps, in order
    if (writes)
#pragma unroll
      for (int e = 0; e < E; ++e) parts[(wid * 32 + l) * E + e] = acc[e];
    __syncthreads();
    if (wid != 0) return;
    if (writes)
      for (int k = 1; k < split; ++k)
#pragma unroll
        for (int e = 0; e < E; ++e) acc[e] += parts[(k * 32 + l) * E + e];
  }
  if (writes) {
    float* o = out + (size_t)bag * D + col;
#pragma unroll
    for (int e = 0; e < E; ++e) o[e] = acc[e];
  }
}

#define BAG_ARGS                                                            \
  const unsigned char* __restrict__ table, const float* __restrict__ scale, \
      const int* __restrict__ ids, const float* __restrict__ w,            \
      float* __restrict__ out, int B, int H, int V, int D, int lpr,        \
      int rps, int steps, int split

template <typename T, bool QUANT, int VEC>
__global__ void __launch_bounds__(32 * MAX_WARPS) bag_kernel(BAG_ARGS) {
  bag_body<T, QUANT, VEC, false>(table, scale, ids, w, out, B, H, V, D, lpr,
                                 rps, steps, 1);
}

// One block a bag. ptxas's default register target spills a few values
// across the barrier here; a floor of one block per SM removes that (on
// the unsplit kernel it slowed the bf16 mode).
template <typename T, bool QUANT, int VEC>
__global__ void __launch_bounds__(32 * MAX_WARPS, 1)
bag_split_kernel(BAG_ARGS) {
  bag_body<T, QUANT, VEC, true>(table, scale, ids, w, out, B, H, V, D, lpr,
                                rps, steps, split);
}

template <typename T, bool QUANT, int VEC>
int run(const Plan& p, const void* table, const float* scale, const int* ids,
        const float* w, float* out, int B, int H, int V, int D,
        cudaStream_t stream) {
  dim3 grid(p.blocks, p.col_chunks);
  const unsigned char* t = static_cast<const unsigned char*>(table);
  if (p.split > 1) {
    const size_t smem = (size_t)p.split * 32 * (VEC / T::size) * sizeof(float);
    bag_split_kernel<T, QUANT, VEC><<<grid, 32 * p.warps, smem, stream>>>(
        t, scale, ids, w, out, B, H, V, D, p.lanes_per_row, p.rows_per_step,
        p.steps, p.split);
  } else {
    bag_kernel<T, QUANT, VEC><<<grid, 32 * p.warps, 0, stream>>>(
        t, scale, ids, w, out, B, H, V, D, p.lanes_per_row, p.rows_per_step,
        p.steps, 1);
  }
  return (int)cudaGetLastError();
}

template <typename T, bool QUANT>
int launch(const void* table, const void* scale, const void* ids,
           const void* w, void* out, int B, int H, int V, int D, int vec,
           int lanes_per_row, int steps, int split, int warps, int align,
           void* stream) {
  if (B < 0 || H < 0 || D <= 0 || V <= 0 || table == nullptr ||
      ids == nullptr || w == nullptr || out == nullptr ||
      (QUANT && scale == nullptr))
    return (int)cudaErrorInvalidValue;
  int dev = 0, n_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const Plan p = make_plan(B, H, D, T::size,
                           reinterpret_cast<uintptr_t>(table), n_sm);
  if (vec != p.vec || lanes_per_row != p.lanes_per_row || steps != p.steps ||
      split != p.split || warps != p.warps || align != p.align ||
      p.vec < T::size ||
      p.col_chunks > 65535)
    return (int)cudaErrorInvalidValue;        // a plan it would not make
  if (B == 0) return 0;
  const float* sc = static_cast<const float*>(scale);
  const int* id = static_cast<const int*>(ids);
  const float* wt = static_cast<const float*>(w);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (p.vec) {
    case 16: return run<T, QUANT, 16>(p, table, sc, id, wt, o, B, H, V, D, st);
    case 8: return run<T, QUANT, 8>(p, table, sc, id, wt, o, B, H, V, D, st);
    case 4: return run<T, QUANT, 4>(p, table, sc, id, wt, o, B, H, V, D, st);
    case 2:
      if constexpr (T::size <= 2)
        return run<T, QUANT, 2>(p, table, sc, id, wt, o, B, H, V, D, st);
      break;
    default:
      if constexpr (T::size == 1)
        return run<T, QUANT, 1>(p, table, sc, id, wt, o, B, H, V, D, st);
      break;
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Both entry points return the launch's cudaError_t (0 = launched).
// table (V, D) row-major, ids (B, H) int32, w (B, H) fp32, out (B, D) fp32.
// `is_bf16` selects a bf16 table, else fp32. vec, lanes_per_row, steps,
// split, warps and align are the host's plan (`bag_plan`), checked against
// the entry point's own.
extern "C" int embedding_bag_fwd(const void* table, const void* ids,
                                 const void* w, void* out, int B, int H,
                                 int V, int D, int is_bf16, int vec,
                                 int lanes_per_row, int steps, int split,
                                 int warps, int align, void* stream) {
  if (is_bf16)
    return launch<BF16, false>(table, nullptr, ids, w, out, B, H, V, D, vec,
                               lanes_per_row, steps, split, warps, align,
                               stream);
  return launch<F32, false>(table, nullptr, ids, w, out, B, H, V, D, vec,
                            lanes_per_row, steps, split, warps, align,
                            stream);
}

// The int8 mode: codes (V, D) int8, scale (V,) fp32.
extern "C" int embedding_bag_q8_fwd(const void* codes, const void* scale,
                                    const void* ids, const void* w,
                                    void* out, int B, int H, int V, int D,
                                    int vec, int lanes_per_row, int steps,
                                    int split, int warps, int align,
                                    void* stream) {
  return launch<I8, true>(codes, scale, ids, w, out, B, H, V, D, vec,
                          lanes_per_row, steps, split, warps, align, stream);
}
