// K2-K7: the fused embedding-update kernels for Hopper (sm_90a).
//
//   K2 scatter_rows_write    W[id_t] = rows[t]
//   K3 fused_update_sgd      W[id_t] = W[id_t] - lr * (g[t] + wd * W[id_t])
//   K4 scaled row update     W[id_t] = W[id_t] + scale[t] * g[t]
//   K5 rowwise momentum      m[u] += sum of a run's g_sq;
//                            inv[p] = -1 / (sqrt(m_new[uids[p]]) + eps)
//   K6 fused_update_adagrad  g += wd * W; m += g * g;
//                            W -= lr * g / (sqrt(m) + eps), elementwise
//   K7 fused_update_adam     g += wd * W; m1 = b1 * m1 + (1 - b1) * g;
//                            m2 = b2 * m2 + (1 - b2) * g * g;
//                            W -= lr * (m1 * bc1) / (sqrt(m2 * bc2) + eps)
//   K4 + K5 fused rowwise Adagrad, the default route: g += wd * W;
//                            m[u] += mean(g * g); W += lr * -1 /
//                            (sqrt(m[u]) + eps) * g, in one pass (its own
//                            note is at rowwise_adagrad_kernel below)
//   K3h, K4h                 K3 and the fused K4 on bf16 / fp16 tables
//                            (their note is at "Half-precision tables")
//
// each for every slot t whose id is a real row (0 <= id < R). Slots whose id
// is a sentinel (2^31 - 1 from run_total_row_grads, R + pos from
// dedup_row_grads) are skipped before any read of their g, rows or scale.
// Tables and momentum are updated in place.
//
// Replaces, in torchrec_tpu/ops/pallas_embedding.py:
//   K2 `scatter_rows_write` / `_scatter_write_kernel` (:154-227)
//   K3 `fused_update_sgd` / `_sgd_kernel` (:457-475, :577-614)
//   K4 `fused_update_rowwise_adagrad` (:617-734) with K5 on its default
//      route (rowwise_adagrad_kernel); on its other routes, its scaled RMW
//      `_scaled_update_kernel` (:477-500, :706-733)
//   K5 `rowwise_momentum_stream` / `_rowwise_mom_stream_kernel`
//      (:737-1030)
//   K6 `fused_update_adagrad` / `_adagrad_kernel` (:503-528, :1033-1086)
//   K7 `fused_update_adam` / `_adam_kernel` (:531-565, :1089-1163)
// They compute the same functions. None of the TPU's machinery is carried
// over: the DMA waves capped by 256 semaphores, the SMEM id budget, and
// K5's one-hot MXU matmuls over [TB, 128] momentum tiles with their
// contribution windows and `overflowed` fallback. Any N, R and D >= 1 are
// taken, and K5 cannot overflow.
//
// Bound: bytes. K2-K4 move whole 512-byte rows of a D=128 f32 table at
// random places and do 1-4 flops per element moved; K6 and K7 move five and
// seven such rows per real slot (W, the momenta and g read, W and the
// momenta written) and do 7-16 flops per element, about 0.5 flop per byte;
// K5 moves 4-byte momentum words and does a sqrt and a divide per row. All
// are far below the card's ~20 fp32 flops per byte, so the least time is
// the bytes over the memory rate. What the design does about it:
//   * K2-K4, K6, K7: one warp takes up to 32 consecutive slots. Lane i
//     loads slot i's id (and K4's scale) once; the warp walks the slots,
//     broadcasting each id with a shuffle, and moves each real slot's rows
//     with every lane holding one 16-byte float4 of each tensor, so a
//     512-byte row is one coalesced request per tensor (wider rows loop over
//     512-byte chunks). A sentinel slot costs only its 4-byte id.
//   * Narrow rows (every kernel here but K5, which has no D): a row of
//     quads = ceil(D / 4) quads takes G lanes, the smallest power of two
//     >= quads, at most 32, picked by the wrapper from D
//     (ops/lane_groups.py). Below 65 columns (G < 32) the warp's P = 32 / G
//     lane groups walk disjoint slots of the warp's `slots` (a multiple of
//     P the wrapper picks), so P rows are in flight at once: at D=10
//     (G = 4) 8 rows. The row kernel of K2, K3, K3h and K4's scaled RMW
//     (`row_update_kernel`) and K6 / K7's (`moment_update_kernel`) give
//     group p slots p, p + P, p + 2P, ...; the fused K4 / K4h
//     (`rowwise_adagrad_narrow_kernel`) ranks the warp's real slots by a
//     ballot and gives group p those of rank p, p + P, ..., so a sentinel
//     costs no step. Lane l of a group holds quad l, as the vector or
//     masked path below has it, so each column's arithmetic is the
//     one-row-a-warp layout's; an even narrow row whose quads are not whole
//     (D=10) moves its quads as pairs ("Access"). Every group runs the
//     same number of steps, so every lane reaches each full-mask shuffle;
//     the sentinels are skipped after it. At G = 32 (D > 64) the row and
//     moment kernels walk a row a warp, one slot after another, and the
//     fused K4 / K4h keeps its own one-row-a-warp kernel.
//   * Any width: a row whose float4s would not be whole or aligned (D % 4
//     != 0, or a table view that starts mid-row) takes the masked path,
//     which the launcher picks from D and the pointers (see "Row access").
//   * K7's bias corrections bc = [1 / (1 - b1^t), 1 / (1 - b2^t)] are read
//     from device memory (the caller computes them from the device step), so
//     no launch waits for the host to learn the step. 1 - b1 and 1 - b2 are
//     rounded once from double on the host, as JAX rounds the kernel's
//     Python constants, and passed by value.
//   * The ids are unique among real slots (dedup or run totals upstream),
//     so no two warps touch one row and nothing is atomic.
//   * K5: the ids are sorted, so the thread of each run's first slot walks
//     its run: it sums the run's g_sq onto m[u] in slot order, writes m[u]
//     once, and writes the run's inverse scale into every slot of the run.
//     One launch, no atomics, deterministic; every slot of a run gets the
//     run's m_new, as the TPU kernel's contract asks for sorted input with
//     duplicates (pallas_embedding.py:921-924).
//   * Row addresses are 64-bit: R * D passes 2^31 elements at bench scale.
//
// FMA contraction: off by construction. Every product and sum goes through
// __fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn / __fsqrt_rn, which nvcc
// never contracts into an fma, and the library is built without
// --use_fast_math (IEEE sqrt and divide). So each kernel rounds at the same
// places as its plain PyTorch version (ops/fused_update_kernels.py) and
// matches it bit for bit on the same inputs.
//
// The kernels launch on the caller's stream, allocate nothing and do not
// synchronise; each entry point returns cudaGetLastError() after its launch.


#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kMomentumThreads = 256;
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ bool is_real(int32_t id, int64_t R) {
  return id >= 0 && static_cast<int64_t>(id) < R;
}

// A half element as the low 16 bits of a word, widened exactly / rounded to
// nearest-even (T only selects the format)
template <typename T>
__device__ __forceinline__ float from_bits(uint32_t b);
template <>
__device__ __forceinline__ float from_bits<__nv_bfloat16>(uint32_t b) {
  return __uint_as_float(b << 16);
}
template <>
__device__ __forceinline__ float from_bits<__half>(uint32_t b) {
  return __half2float(__ushort_as_half(static_cast<unsigned short>(b)));
}

template <typename T>
__device__ __forceinline__ uint32_t to_bits(float x);
template <>
__device__ __forceinline__ uint32_t to_bits<__nv_bfloat16>(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}
template <>
__device__ __forceinline__ uint32_t to_bits<__half>(float x) {
  return __half_as_ushort(__float2half_rn(x));
}

// -- Row access: the vector path and the masked path --------------------------
//
// A lane holds a row's elements four at a time: quad q is columns 4q .. 4q+3,
// and lane l of the warp takes quads l, l + 32, l + 64, ... (chunk c's quad
// 32c + l). On the vector path each quad is one load and one store: a 16-byte
// float4 of an f32 row, an 8-byte uint2 of a half row (elements 0 and 1 in
// .x, low half first, 2 and 3 in .y). That needs D % 4 == 0 and rows aligned
// to those sizes. Every other table (D % 4 != 0, or a view that starts
// mid-row) takes the masked path, which each launcher picks from D and the
// pointers: the same lanes hold the same quads, each element read with a
// scalar load, zeros taken past D, and only the columns below D written. So
// the lane-to-column map, with it the rowwise kernels' order of the g^2 sum
// (a +0.0 past D leaves a partial as it was) and the stochastic-rounding
// bits keyed by (row, column), are the vector path's. At D % 4 == 0 with
// aligned rows the vector path runs unchanged.

bool aligned(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// Element c of a row, widened to f32
template <typename T>
__device__ __forceinline__ float elem(const T* row, int64_t c) {
  if constexpr (std::is_same<T, float>::value) {
    return row[c];
  } else {
    return from_bits<T>(reinterpret_cast<const unsigned short*>(row)[c]);
  }
}

// Quad q of a table row (read and written by the kernel), widened to f32
template <bool kMasked, typename T>
__device__ __forceinline__ float4 load4(const T* row, int64_t q, int64_t D) {
  if constexpr (!kMasked) {
    if constexpr (std::is_same<T, float>::value) {
      return reinterpret_cast<const float4*>(row)[q];
    } else {
      const uint2 h = reinterpret_cast<const uint2*>(row)[q];
      return make_float4(from_bits<T>(h.x & 0xffffu), from_bits<T>(h.x >> 16),
                         from_bits<T>(h.y & 0xffffu), from_bits<T>(h.y >> 16));
    }
  } else {
    const int64_t c = 4 * q;  // < D: q < ceil(D / 4)
    return make_float4(elem(row, c), c + 1 < D ? elem(row, c + 1) : 0.f,
                       c + 2 < D ? elem(row, c + 2) : 0.f,
                       c + 3 < D ? elem(row, c + 3) : 0.f);
  }
}

// Quad q of a read-only f32 row (g, K2's rows), through the read-only cache
template <bool kMasked>
__device__ __forceinline__ float4 load_g4(const float* row, int64_t q,
                                          int64_t D) {
  if constexpr (!kMasked) {
    return __ldg(reinterpret_cast<const float4*>(row) + q);
  } else {
    const int64_t c = 4 * q;
    return make_float4(__ldg(row + c), c + 1 < D ? __ldg(row + c + 1) : 0.f,
                       c + 2 < D ? __ldg(row + c + 2) : 0.f,
                       c + 3 < D ? __ldg(row + c + 3) : 0.f);
  }
}

// row[4q .. 4q + 3] = v, the columns below D only on the masked path
template <bool kMasked>
__device__ __forceinline__ void store4(float* row, int64_t q, float4 v,
                                       int64_t D) {
  if constexpr (!kMasked) {
    reinterpret_cast<float4*>(row)[q] = v;
  } else {
    const int64_t c = 4 * q;
    row[c] = v.x;
    if (c + 1 < D) row[c + 1] = v.y;
    if (c + 2 < D) row[c + 2] = v.z;
    if (c + 3 < D) row[c + 3] = v.w;
  }
}

// Narrow rows whose quads are not whole but whose pairs are (D % 2 == 0,
// rows aligned to two elements) take a third path in the narrow kernels
// (G < 32 lanes a row): a quad as two pairs, the second only below D, the
// same columns and arithmetic as the masked path, half its loads and
// stores. A pair is a float2 of an f32 row, one 4-byte word of a half row.
// At D=10 a row is two whole quads and a pair. Below G = 32 a lane holds
// one quad at most, and the row and moment kernels leave their quad loop
// after it: unrolled by nvcc, the row kernel's loop issued a quad's second
// pair after the first pair's arithmetic, two memory round trips a quad;
// with the `break` both pairs' loads of g and of the row go out before any
// arithmetic, the second predicated on c + 2 < D (PERF.md).
enum class Access { kVector, kPairs, kMasked };

// Quad q of an f32 row: kReadOnly rows (g, K2's rows) through the read-only
// cache, as load_g4; table rows as load4
template <Access kAcc, bool kReadOnly>
__device__ __forceinline__ float4 row_load(const float* row, int64_t q,
                                           int64_t D) {
  if constexpr (kAcc == Access::kPairs) {
    const int64_t c = 4 * q;
    const float2* p = reinterpret_cast<const float2*>(row + c);
    const float2 a = kReadOnly ? __ldg(p) : p[0];
    float2 b = make_float2(0.f, 0.f);
    if (c + 2 < D) b = kReadOnly ? __ldg(p + 1) : p[1];
    return make_float4(a.x, a.y, b.x, b.y);
  } else if constexpr (kReadOnly) {
    return load_g4<kAcc == Access::kMasked>(row, q, D);
  } else {
    return load4<kAcc == Access::kMasked>(row, q, D);
  }
}

template <Access kAcc>
__device__ __forceinline__ void row_store(float* row, int64_t q, float4 v,
                                          int64_t D) {
  if constexpr (kAcc == Access::kPairs) {
    const int64_t c = 4 * q;
    float2* p = reinterpret_cast<float2*>(row + c);
    p[0] = make_float2(v.x, v.y);
    if (c + 2 < D) p[1] = make_float2(v.z, v.w);
  } else {
    store4<kAcc == Access::kMasked>(row, q, v, D);
  }
}

// Quad q of a table row of type T widened to f32, by any access: on the
// pair path a half row's quad is two 4-byte words (elements 0 and 1, then
// 2 and 3, the second only below D)
template <Access kAcc, typename T>
__device__ __forceinline__ float4 table_load(const T* row, int64_t q,
                                             int64_t D) {
  if constexpr (kAcc != Access::kPairs) {
    return load4<kAcc == Access::kMasked>(row, q, D);
  } else if constexpr (std::is_same<T, float>::value) {
    return row_load<kAcc, false>(row, q, D);
  } else {
    const int64_t c = 4 * q;
    const uint32_t* p = reinterpret_cast<const uint32_t*>(row + c);
    const uint32_t a = p[0];
    const uint32_t b = c + 2 < D ? p[1] : 0u;  // +0.0 in both formats
    return make_float4(from_bits<T>(a & 0xffffu), from_bits<T>(a >> 16),
                       from_bits<T>(b & 0xffffu), from_bits<T>(b >> 16));
  }
}

// -- K6, K7: elementwise moments ----------------------------------------------

enum class Moment { kAdagrad, kAdam };

struct MomentArgs {
  float lr, eps, wd;
  float b1, omb1, b2, omb2;  // K7 only; omb = 1 - b, rounded on the host
};

// One element of K6 (m1 = Adagrad's accumulator) or K7 (m1, m2 = Adam's
// moments); x is the element's total gradient.
template <Moment kOpt>
__device__ __forceinline__ void moment_step(float& w, float& m1, float& m2,
                                            float x, const MomentArgs& a,
                                            float bc1, float bc2) {
  const float g = a.wd != 0.f ? __fadd_rn(x, __fmul_rn(a.wd, w)) : x;
  if (kOpt == Moment::kAdagrad) {
    m1 = __fadd_rn(m1, __fmul_rn(g, g));
    w = __fsub_rn(w, __fdiv_rn(__fmul_rn(a.lr, g),
                               __fadd_rn(__fsqrt_rn(m1), a.eps)));
  } else {
    m1 = __fadd_rn(__fmul_rn(a.b1, m1), __fmul_rn(a.omb1, g));
    m2 = __fadd_rn(__fmul_rn(a.b2, m2), __fmul_rn(__fmul_rn(a.omb2, g), g));
    const float m1_hat = __fmul_rn(m1, bc1);
    const float m2_hat = __fmul_rn(m2, bc2);
    w = __fsub_rn(w, __fdiv_rn(__fmul_rn(a.lr, m1_hat),
                               __fadd_rn(__fsqrt_rn(m2_hat), a.eps)));
  }
}

// K6 / K7: w, m1 (and K7's m2) [R, D], g [N, D]; bc is K7's [2] bias
// corrections (unused by K6). The walk is row_update_kernel's: kGroup lanes
// hold a row (lane `sub` of a group its quads sub, sub + kGroup, ...), a
// warp takes `slots` consecutive slots, a multiple of its 32 / kGroup
// groups, and group p walks slots p, p + 32 / kGroup, ..., skipping the
// sentinels after the shuffle (ranking the real slots by a ballot instead
// was no faster on an H100; PERF.md).
template <Moment kOpt, Access kAcc, int kGroup>
__global__ void moment_update_kernel(float* __restrict__ w,
                                     float* __restrict__ m1,
                                     float* __restrict__ m2,
                                     const int32_t* __restrict__ uids,
                                     const float* __restrict__ g,
                                     const float* __restrict__ bc, int64_t R,
                                     int64_t D, int64_t N, int slots,
                                     MomentArgs a) {
  constexpr int kRows = 32 / kGroup;  // rows in flight per warp
  const int lane = threadIdx.x & 31;
  const int sub = lane % kGroup;
  const int64_t warp =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  const int64_t base = warp * slots;
  if (base >= N) return;  // whole warp leaves together
  const int n = static_cast<int>(N - base < slots ? N - base : slots);
  const int32_t my_id = lane < n ? uids[base + lane] : -1;
  float bc1 = 0.f, bc2 = 0.f;
  if (kOpt == Moment::kAdam) {
    bc1 = __ldg(bc);
    bc2 = __ldg(bc + 1);
  }
  const int64_t quads = (D + 3) / 4;
  // the same trip count in every group; j < slots <= 32 (lanes from n on
  // hold -1, a sentinel)
  for (int step = 0; step < n; step += kRows) {
    const int j = step + lane / kGroup;
    const int32_t id = __shfl_sync(kFullMask, my_id, j);
    if (!is_real(id, R)) continue;  // the same for the whole group
    const int64_t row = static_cast<int64_t>(id) * D;
    float* wrow = w + row;
    float* m1row = m1 + row;
    float* m2row = kOpt == Moment::kAdam ? m2 + row : nullptr;
    const float* grow = g + (base + j) * D;
    for (int64_t q = sub; q < quads; q += kGroup) {
      const float4 x = row_load<kAcc, true>(grow, q, D);
      float4 wv = row_load<kAcc, false>(wrow, q, D);
      float4 av = row_load<kAcc, false>(m1row, q, D);
      float4 bv = make_float4(0.f, 0.f, 0.f, 0.f);
      if (kOpt == Moment::kAdam) bv = row_load<kAcc, false>(m2row, q, D);
      moment_step<kOpt>(wv.x, av.x, bv.x, x.x, a, bc1, bc2);
      moment_step<kOpt>(wv.y, av.y, bv.y, x.y, a, bc1, bc2);
      moment_step<kOpt>(wv.z, av.z, bv.z, x.z, a, bc1, bc2);
      moment_step<kOpt>(wv.w, av.w, bv.w, x.w, a, bc1, bc2);
      row_store<kAcc>(wrow, q, wv, D);
      row_store<kAcc>(m1row, q, av, D);
      if (kOpt == Moment::kAdam) row_store<kAcc>(m2row, q, bv, D);
      if (kGroup < 32) break;  // a narrow row: one quad a lane at most
    }
  }
}

// -- K5 -----------------------------------------------------------------------

__global__ void rowwise_momentum_kernel(float* __restrict__ m,
                                        const int32_t* __restrict__ uids,
                                        const float* __restrict__ g_sq,
                                        float* __restrict__ inv, int64_t R,
                                        int64_t N, float eps) {
  const int64_t p =
      static_cast<int64_t>(blockIdx.x) * kMomentumThreads + threadIdx.x;
  if (p >= N) return;
  const int32_t u = uids[p];
  if (!is_real(u, R)) {
    inv[p] = 0.f;
    return;
  }
  if (p > 0 && uids[p - 1] == u) return;  // the run's first slot does it
  float acc = m[u];
  int64_t q = p;
  do {
    acc = __fadd_rn(acc, g_sq[q]);
    ++q;
  } while (q < N && uids[q] == u);
  m[u] = acc;
  const float v = __fdiv_rn(-1.0f, __fadd_rn(__fsqrt_rn(acc), eps));
  for (int64_t r = p; r < q; ++r) inv[r] = v;
}

// -- Half-precision tables: K3h and K4h ---------------------------------------
//
// K3h and K4h are K3 and the fused K4 on bf16 / fp16 tables. They replace
// what the JAX package runs in XLA for such tables, since its Pallas
// kernels take f32 only: `apply_fused_update`'s SGD / EXACT_SGD and
// ROWWISE_ADAGRAD branches (torchrec_tpu/ops/fused_update.py:534-543,
// :647-656) with `_sr_set` (:523-532) and `stochastic_round` (:254-275).
// Each loads the row, computes exactly as its f32 form (the row widened to
// f32, momenta and gradients f32), and writes the row back rounded by one
// of two epilogues:
//   SR  (stochastic_rounding, the default): x = w + upd in f32; add the low
//       16 (bf16) or 13 (fp16) bits of sr_bits(seed, step, row, col) to x's
//       bit pattern, clear them, convert (fp16 rounds to nearest-even again
//       below its normal range and overflows to inf, as JAX's astype does);
//   RNE (stochastic_rounding=False): half(w + half(upd)), JAX's
//       `weights.at[uids].add(upd.astype(weights.dtype))`.
// sr_bits is the port's counter-based generator (ops/stochastic_rounding.py
// spells it out in torch ops, bit for bit): murmur3's fmix32 chained over
// the seed, the step, the row and the column. The step is read from the
// device step tensor, so no launch waits for the host. Keying by row and
// column, not slot, makes the result independent of the slot order.
//
// Bound: bytes, as their f32 forms, with a 2-byte row: per real slot the
// row is read and written (2 x 2 B per element) and g read (4 B), K4h also
// reads and writes the row's 4-byte momentum word. The hash costs about ten
// integer operations an element, well under the card's integer rate at
// these bytes. A lane holds 4 columns: its row quad is one 8-byte load
// (uint2, so a D=128 bf16 row is one 256-byte request per warp) beside the
// 16-byte float4 of g's same 4 columns, so the f32 kernels' lane-to-column
// map, and with it K4's summation order of g^2, is unchanged. Rows that are
// not 8-byte aligned quads (D % 4 != 0, a view that starts mid-row) take the
// masked path ("Row access"); narrow rows (G < 32) that are 4-byte aligned
// pairs (an even D, as D=10's 20-byte rows) move each quad as two 4-byte
// words. K3h is the row kernel on a half table (T = __nv_bfloat16 /
// __half), so it takes the row kernel's lane groups and slots a warp.

constexpr uint32_t kGolden = 0x9E3779B9u;

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  return h ^ (h >> 16);
}

// sr_bits(seed, step, row, col) = fmix32(row_key ^ col * kGolden) with
// row_key = fmix32(step_key ^ row), step_key = fmix32(fmix32(seed +
// kGolden) ^ step); unsigned arithmetic wraps mod 2^32
__device__ __forceinline__ uint32_t sr_step_key(uint32_t seed, int32_t step) {
  return fmix32(fmix32(seed + kGolden) ^ static_cast<uint32_t>(step));
}

// `row` is the shard's local row; the key takes row_base + row, the row's
// index across the group (rank * local rows), so that two shards' rows of
// one local index draw different bits
__device__ __forceinline__ uint32_t sr_row_key(uint32_t step_key, int32_t row,
                                               int64_t row_base) {
  return fmix32(step_key ^ static_cast<uint32_t>(row_base + row));
}

__device__ __forceinline__ uint32_t sr_bits(uint32_t row_key, int64_t col) {
  return fmix32(row_key ^ (static_cast<uint32_t>(col) * kGolden));
}

template <typename T>
struct LowBits;  // the f32 mantissa bits the SR epilogue drops
template <>
struct LowBits<__nv_bfloat16> {
  static constexpr uint32_t kMask = (1u << 16) - 1u;
};
template <>
struct LowBits<__half> {
  static constexpr uint32_t kMask = (1u << 13) - 1u;
};

// What a row write needs beyond w and upd: the SR flag and the row's key.
struct RowRound {
  bool sr;
  uint32_t key;
};

template <typename T>
__device__ __forceinline__ uint32_t round_elem(float w, float upd, RowRound r,
                                               int64_t col) {
  if (r.sr) {
    constexpr uint32_t kLow = LowBits<T>::kMask;
    const uint32_t u =
        __float_as_uint(__fadd_rn(w, upd)) + (sr_bits(r.key, col) & kLow);
    return to_bits<T>(__uint_as_float(u & ~kLow));
  }
  return to_bits<T>(__fadd_rn(w, from_bits<T>(to_bits<T>(upd))));
}

// row quad q = w + upd: f32 rounds the sum once; halves round by `r`
template <bool kMasked, typename T>
__device__ __forceinline__ void store_quad(T* row, int64_t q, float4 w,
                                           float4 upd, RowRound r, int64_t D) {
  if constexpr (std::is_same<T, float>::value) {
    store4<kMasked>(row, q,
                    make_float4(__fadd_rn(w.x, upd.x), __fadd_rn(w.y, upd.y),
                                __fadd_rn(w.z, upd.z), __fadd_rn(w.w, upd.w)),
                    D);
  } else {
    const int64_t c = 4 * q;
    const uint32_t e0 = round_elem<T>(w.x, upd.x, r, c);
    const uint32_t e1 = round_elem<T>(w.y, upd.y, r, c + 1);
    const uint32_t e2 = round_elem<T>(w.z, upd.z, r, c + 2);
    const uint32_t e3 = round_elem<T>(w.w, upd.w, r, c + 3);
    if constexpr (!kMasked) {
      reinterpret_cast<uint2*>(row)[q] =
          make_uint2(e0 | (e1 << 16), e2 | (e3 << 16));
    } else {
      unsigned short* h = reinterpret_cast<unsigned short*>(row);
      h[c] = static_cast<unsigned short>(e0);
      if (c + 1 < D) h[c + 1] = static_cast<unsigned short>(e1);
      if (c + 2 < D) h[c + 2] = static_cast<unsigned short>(e2);
      if (c + 3 < D) h[c + 3] = static_cast<unsigned short>(e3);
    }
  }
}

// store_quad by any access: on the pair path the quad's elements are the
// same, written as two pairs (a float2 of an f32 row, a 4-byte word of a
// half row), the second only below D
template <Access kAcc, typename T>
__device__ __forceinline__ void table_store(T* row, int64_t q, float4 w,
                                            float4 upd, RowRound r,
                                            int64_t D) {
  if constexpr (kAcc != Access::kPairs) {
    store_quad<kAcc == Access::kMasked>(row, q, w, upd, r, D);
  } else if constexpr (std::is_same<T, float>::value) {
    row_store<kAcc>(row, q,
                    make_float4(__fadd_rn(w.x, upd.x), __fadd_rn(w.y, upd.y),
                                __fadd_rn(w.z, upd.z), __fadd_rn(w.w, upd.w)),
                    D);
  } else {
    const int64_t c = 4 * q;
    uint32_t* p = reinterpret_cast<uint32_t*>(row + c);
    p[0] = round_elem<T>(w.x, upd.x, r, c) |
           (round_elem<T>(w.y, upd.y, r, c + 1) << 16);
    if (c + 2 < D)
      p[1] = round_elem<T>(w.z, upd.z, r, c + 2) |
             (round_elem<T>(w.w, upd.w, r, c + 3) << 16);
  }
}

// g' = g + wd * W, FBGEMM's weight decay fold (pallas_embedding.py:647-654)
__device__ __forceinline__ float4 fold_wd(float4 x, float4 w, float wd) {
  if (wd == 0.f) return x;
  return make_float4(__fadd_rn(x.x, __fmul_rn(wd, w.x)),
                     __fadd_rn(x.y, __fmul_rn(wd, w.y)),
                     __fadd_rn(x.z, __fmul_rn(wd, w.z)),
                     __fadd_rn(x.w, __fmul_rn(wd, w.w)));
}

__device__ __forceinline__ float4 scale4(float s, float4 x) {
  return make_float4(__fmul_rn(s, x.x), __fmul_rn(s, x.y), __fmul_rn(s, x.z),
                     __fmul_rn(s, x.w));
}

// -- K2, K3, K3h and K4's scaled RMW: the row kernel -------------------------

enum class RowOp { kWrite, kSgd, kScaled };

template <RowOp kOp>
__device__ __forceinline__ float row_op(float w, float x, float lr, float wd,
                                        float s) {
  if (kOp == RowOp::kWrite) return x;
  if (kOp == RowOp::kScaled) return __fadd_rn(w, __fmul_rn(s, x));
  const float g = wd != 0.f ? __fadd_rn(x, __fmul_rn(wd, w)) : x;
  return __fsub_rn(w, __fmul_rn(lr, g));
}

// src is `rows` (K2) or `g` (K3, K3h, K4), [N, D]; scale is K4's [N]. kGroup
// lanes hold a row; a warp takes `slots` consecutive slots, a multiple of
// its 32 / kGroup groups, and group p walks slots p, p + 32 / kGroup, ...
// T is the table's type: float, or K3h's __nv_bfloat16 / __half (kSgd
// only), whose row quads are widened on load (table_load) and written back
// through table_store's epilogue, `sr` with bits keyed by (row_base + id,
// column) from the device step, or to nearest; the f32 arithmetic between
// is K3's, W + -(lr * (g + wd * W)). f32 tables never read step, sr, seed
// or row_base.
template <RowOp kOp, Access kAcc, int kGroup, typename T>
__global__ void row_update_kernel(T* __restrict__ w,
                                  const int32_t* __restrict__ uids,
                                  const float* __restrict__ src,
                                  const float* __restrict__ scale,
                                  const int32_t* __restrict__ step, int64_t R,
                                  int64_t D, int64_t N, int slots, float lr,
                                  float wd, bool sr, uint32_t seed,
                                  int64_t row_base) {
  constexpr bool kHalf = !std::is_same<T, float>::value;
  static_assert(!kHalf || kOp == RowOp::kSgd, "half tables: K3h only");
  constexpr int kRows = 32 / kGroup;  // rows in flight per warp
  const int lane = threadIdx.x & 31;
  const int sub = lane % kGroup;
  const int64_t warp =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  const int64_t base = warp * slots;
  if (base >= N) return;  // whole warp leaves together
  const int n = static_cast<int>(N - base < slots ? N - base : slots);
  int32_t my_id = -1;
  float my_s = 0.f;
  if (lane < n) {
    my_id = uids[base + lane];
    if (kOp == RowOp::kScaled && is_real(my_id, R)) my_s = scale[base + lane];
  }
  uint32_t step_key = 0u;
  if (kHalf && sr) step_key = sr_step_key(seed, __ldg(step));
  const int64_t quads = (D + 3) / 4;
  // the same trip count in every group; j < slots <= 32 (lanes from n on
  // hold -1, a sentinel)
  for (int at = 0; at < n; at += kRows) {
    const int j = at + lane / kGroup;
    const int32_t id = __shfl_sync(kFullMask, my_id, j);
    const float s = __shfl_sync(kFullMask, my_s, j);
    if (!is_real(id, R)) continue;  // the same for the whole group
    T* wrow = w + static_cast<int64_t>(id) * D;
    const float* srow = src + (base + j) * D;
    [[maybe_unused]] const RowRound r{
        sr, kHalf && sr ? sr_row_key(step_key, id, row_base) : 0u};
    for (int64_t q = sub; q < quads; q += kGroup) {
      const float4 x = row_load<kAcc, true>(srow, q, D);
      if constexpr (kHalf) {
        const float4 wv = table_load<kAcc>(wrow, q, D);
        const float4 g = fold_wd(x, wv, wd);
        table_store<kAcc>(wrow, q, wv,
                          make_float4(-__fmul_rn(lr, g.x), -__fmul_rn(lr, g.y),
                                      -__fmul_rn(lr, g.z), -__fmul_rn(lr, g.w)),
                          r, D);
      } else {
        float4 v;
        if (kOp == RowOp::kWrite) {
          v = x;
        } else {
          v = row_load<kAcc, false>(wrow, q, D);
          v.x = row_op<kOp>(v.x, x.x, lr, wd, s);
          v.y = row_op<kOp>(v.y, x.y, lr, wd, s);
          v.z = row_op<kOp>(v.z, x.z, lr, wd, s);
          v.w = row_op<kOp>(v.w, x.w, lr, wd, s);
        }
        row_store<kAcc>(wrow, q, v, D);
      }
      if (kGroup < 32) break;  // a narrow row: one quad a lane at most
    }
  }
}

// K4 + K5 fused: the whole rowwise-Adagrad update in one pass.
//
// Replaces, on the route `momentum_stream=True, w_impl="rmw"` (what "auto"
// picks), pallas_embedding.py's `fused_update_rowwise_adagrad` (:617-734)
// together with the `rowwise_momentum_stream` kernel it calls (:737-1030).
// The TPU runs them as two kernels with XLA ops between them because a
// scalar-per-row DMA breaks Mosaic's (8,128) HBM tiling, so the momentum
// word cannot ride the row wave (:633-638). Here the warp that holds a
// row's gradient and weights reads and writes the row's 4-byte momentum
// word in the same pass, and nothing lands in device memory between the
// steps: no g_sq, inverse-scale or scale buffers. For every slot t whose id
// u = uids[t] is a real row:
//
//   g'    = wd != 0 ? g[t] + wd * W[u] : g[t]   (FBGEMM's fold, :647-654)
//   g_sq  = mean over D of g' * g'              (in the fixed order below)
//   m[u]  = m[u] + g_sq
//   scale = lr * (-1 / (sqrt(m[u]) + eps))      (K5's rounding, then :676)
//   W[u]  = W[u] + scale * g'                   (K4's rounding)
//
// Sentinel slots (R + pos from dedup_row_grads) are skipped before any read:
// their g is never read and they never index m.
//
// Bound: bytes. Per real slot it reads g's and W's rows, writes W's row and
// reads and writes one momentum word; every slot's id is read once. At the
// DLRM shape (N 212,992 slots, 204,544 real, D 128) that is 316,667,904 B,
// 0.0945 ms at 3.35 TB/s, against about 7 flops per element. A row is used
// once and there is no product, so no wgmma, TMA or shared-memory staging:
// the only lever is bytes in flight. What the design does:
//   * one warp takes `slots` (at most 32) consecutive slots; lane i loads
//     slot i's id, and a ballot of the real lanes lets the warp walk the
//     real slots only, so a run of sentinels costs no iterations. The walk
//     is a chain of memory latencies, one per real slot, so the caller
//     gives each warp fewer slots when N is small (see the wrapper);
//   * past 64 columns the 32 lanes hold a row, one quad per lane for each
//     128-column chunk ("Row access"), kChunks = ceil(D / 128) chunks in
//     registers; a row of up to 64 columns takes a lane group instead
//     (rowwise_adagrad_narrow_kernel below), whose g^2 sum is this one's
//     bit for bit;
//   * the next real slot's g and W chunks and its momentum word are loaded
//     before the current slot is reduced and stored, so two rows are in
//     flight per warp across the reduction's latency. This relies on the
//     real ids being unique (dedup_row_grads' output is sorted and unique):
//     the row loaded ahead is never the row being written;
//   * g_sq: lane l's partial is the running sum, over the chunks c in
//     ascending order, of ((x*x + y*y) + z*z) + w*w of quad c * 32 + l
//     (lanes past D add nothing, or +0.0 on the masked path); then a xor
//     butterfly of __shfl_xor_sync over 16, 8, 4, 2, 1, after which every
//     lane holds bitwise the same total (a + b == b + a in IEEE arithmetic),
//     and no shared memory is used; then one rounded division by D.
//     row_mean_sq in ops/fused_update_kernels.py spells out the same order
//     in torch ops;
//   * lane 0 reads and writes m[u] and broadcasts the scale;
//   * a row wider than four chunks (D > 512) does not fit the registers: the
//     wide kernel below walks it twice instead, with the same sums.
// T is the table's type: float, or K4h's __nv_bfloat16 / __half, whose row
// quads are widened to f32 on load and rounded by `sr` on store (see
// "Half-precision tables"); everything between is the same f32 arithmetic.

// ((x*x + y*y) + z*z) + w*w, a lane's share of a quad of g'^2
__device__ __forceinline__ float sum_sq(float4 x) {
  return __fadd_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(x.x, x.x), __fmul_rn(x.y, x.y)),
                __fmul_rn(x.z, x.z)),
      __fmul_rn(x.w, x.w));
}

// The row's momentum step from the partials of the row's kGroup lanes
// (the warp's 32, or a lane group of a narrow row): the xor butterfly over
// kGroup / 2, ..., 1 inside the group, then the lane that `writes` (the
// group's first, `lead`, for a real row) adds the mean to its momentum word
// mv and writes m[id]; every lane of the group gets the scale
// lr * (-1 / (sqrt(m_new) + eps)). Every lane of the warp must call it.
template <int kGroup>
__device__ __forceinline__ float rowwise_scale(float part, float* m,
                                               int32_t id, float mv, int64_t D,
                                               float lr, float eps,
                                               bool writes, int lead) {
#pragma unroll
  for (int off = kGroup / 2; off > 0; off >>= 1)
    part = __fadd_rn(part, __shfl_xor_sync(kFullMask, part, off));
  float s = 0.f;
  if (writes) {
    const float m_new = __fadd_rn(mv, __fdiv_rn(part, static_cast<float>(D)));
    m[id] = m_new;
    s = __fmul_rn(lr, __fdiv_rn(-1.0f, __fadd_rn(__fsqrt_rn(m_new), eps)));
  }
  return __shfl_sync(kFullMask, s, lead);
}

template <int kChunks, bool kMasked, typename T>
__device__ __forceinline__ void load_slot(
    const T* __restrict__ w, const float* __restrict__ m,
    const float* __restrict__ g, int32_t id, int64_t slot, int64_t D,
    int lane, float4 (&gv)[kChunks], float4 (&wv)[kChunks], float& mv) {
  const float* grow = g + slot * D;
  const T* wrow = w + static_cast<int64_t>(id) * D;
  const int64_t quads = (D + 3) / 4;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int64_t q = c * 32 + lane;
    if (q < quads) {
      gv[c] = load_g4<kMasked>(grow, q, D);
      wv[c] = load4<kMasked>(wrow, q, D);
    }
  }
  if (lane == 0) mv = m[id];
}

template <int kChunks, typename T, bool kMasked>
__global__ void rowwise_adagrad_kernel(T* __restrict__ w,
                                       float* __restrict__ m,
                                       const int32_t* __restrict__ uids,
                                       const float* __restrict__ g,
                                       const int32_t* __restrict__ step,
                                       int64_t R, int64_t D, int64_t N,
                                       int slots, float lr, float eps,
                                       float wd, bool sr, uint32_t seed,
                                       int64_t row_base) {
  const int lane = threadIdx.x & 31;
  const int64_t warp =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  const int64_t base = warp * slots;
  if (base >= N) return;  // whole warp leaves together
  const int n = static_cast<int>(N - base < slots ? N - base : slots);
  const int32_t my_id = lane < n ? uids[base + lane] : -1;
  unsigned todo = __ballot_sync(kFullMask, is_real(my_id, R));
  if (todo == 0) return;  // the same for the whole warp
  const int64_t quads = (D + 3) / 4;
  const uint32_t step_key = sr ? sr_step_key(seed, __ldg(step)) : 0u;
  float4 gv[kChunks], wv[kChunks], gn[kChunks], wn[kChunks];
  float mv = 0.f, mn = 0.f;
  int j = __ffs(todo) - 1;
  todo &= todo - 1;
  int32_t id = __shfl_sync(kFullMask, my_id, j);
  load_slot<kChunks, kMasked>(w, m, g, id, base + j, D, lane, gv, wv, mv);
  while (true) {
    // the next real slot's loads go out before this slot's reduction
    const bool more = todo != 0;  // the same for the whole warp
    int32_t next = -1;
    if (more) {
      const int jn = __ffs(todo) - 1;
      todo &= todo - 1;
      next = __shfl_sync(kFullMask, my_id, jn);
      load_slot<kChunks, kMasked>(w, m, g, next, base + jn, D, lane, gn, wn,
                                  mn);
    }
    float part = 0.f;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      if (c * 32 + lane < quads) {
        gv[c] = fold_wd(gv[c], wv[c], wd);
        part = __fadd_rn(part, sum_sq(gv[c]));
      }
    }
    const float s =
        rowwise_scale<32>(part, m, id, mv, D, lr, eps, lane == 0, 0);
    T* wrow = w + static_cast<int64_t>(id) * D;
    const RowRound r{sr, sr ? sr_row_key(step_key, id, row_base) : 0u};
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int64_t q = c * 32 + lane;
      if (q < quads)
        store_quad<kMasked>(wrow, q, wv[c], scale4(s, gv[c]), r, D);
    }
    if (!more) break;
    id = next;
    mv = mn;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      gv[c] = gn[c];
      wv[c] = wn[c];
    }
  }
}

// The slot of rank r (from 0) among a warp's real slots `mask`, r <
// popc(mask): r itself when the real slots come first (dedup output), else
// the position of the set bit of rank r
__device__ __forceinline__ int nth_set_bit(unsigned mask, int r) {
  if ((mask & (mask + 1u)) == 0u) return r;  // a prefix of the warp
  int pos = 0;
#pragma unroll
  for (int half = 16; half > 0; half >>= 1) {
    const int low = __popc(mask & ((1u << half) - 1u));
    if (r >= low) {
      r -= low;
      mask >>= half;
      pos += half;
    }
  }
  return pos;
}

// The fused rowwise Adagrad on narrow rows (D <= 64): kGroup < 32 lanes a
// row, lane `sub` of a group holding quad `sub` (the only one: kGroup >=
// ceil(D / 4)), so the warp holds 32 / kGroup rows. A ballot of the warp's
// real slots ranks them, and group p takes those of rank p, p + 32 /
// kGroup, ..., loading its next row (g, W and the momentum word) before it
// reduces and stores the current one, as rowwise_adagrad_kernel does per
// warp. Every group runs the warp's trip count, and a group with no row
// this step runs the butterfly on +0.0 partials, so every lane reaches each
// full-mask shuffle; the momentum word and the row are skipped after it.
// The g^2 butterfly runs inside the group (kGroup / 2, ..., 1). The lanes
// past the row's quads hold +0.0, and partials are sums of squares, never
// -0.0, so the warp-wide butterfly's steps over offsets >= kGroup add +0.0
// and change nothing: the group's total is the warp's, bit for bit, and so
// row_mean_sq's. The group's first lane reads and writes m[u].
template <int kGroup, typename T, Access kAcc>
__global__ void rowwise_adagrad_narrow_kernel(
    T* __restrict__ w, float* __restrict__ m,
    const int32_t* __restrict__ uids, const float* __restrict__ g,
    const int32_t* __restrict__ step, int64_t R, int64_t D, int64_t N,
    int slots, float lr, float eps, float wd, bool sr, uint32_t seed,
    int64_t row_base) {
  constexpr int kRows = 32 / kGroup;  // rows in flight per warp
  const int lane = threadIdx.x & 31;
  const int sub = lane % kGroup;
  const int lead = lane - sub;  // the group's first lane
  const int64_t warp =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  const int64_t base = warp * slots;
  if (base >= N) return;  // whole warp leaves together
  const int n = static_cast<int>(N - base < slots ? N - base : slots);
  const int32_t my_id = lane < n ? uids[base + lane] : -1;
  const unsigned todo = __ballot_sync(kFullMask, is_real(my_id, R));
  const int count = __popc(todo);
  if (count == 0) return;  // the same for the whole warp
  const bool has_quad = sub < (D + 3) / 4;
  const uint32_t step_key = sr ? sr_step_key(seed, __ldg(step)) : 0u;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  // this group's row of rank r, its slot j, and what it loads
  int r = lane / kGroup;
  bool live = r < count;
  int j = live ? nth_set_bit(todo, r) : 0;
  int32_t id = __shfl_sync(kFullMask, my_id, j);
  float4 gv = zero, wv = zero;
  float mv = 0.f;
  if (live) {
    if (has_quad) {
      gv = row_load<kAcc, true>(g + (base + j) * D, sub, D);
      wv = table_load<kAcc>(w + static_cast<int64_t>(id) * D, sub, D);
    }
    if (sub == 0) mv = m[id];
  }
  for (int done = 0; done < count; done += kRows) {  // the same trip count
    // the group's next row's loads go out before this row's reduction
    const int rn = r + kRows;
    const bool live_n = rn < count;
    const int jn = live_n ? nth_set_bit(todo, rn) : 0;
    const int32_t next = __shfl_sync(kFullMask, my_id, jn);
    float4 gn = zero, wn = zero;
    float mn = 0.f;
    if (live_n) {
      if (has_quad) {
        gn = row_load<kAcc, true>(g + (base + jn) * D, sub, D);
        wn = table_load<kAcc>(w + static_cast<int64_t>(next) * D, sub, D);
      }
      if (sub == 0) mn = m[next];
    }
    float part = 0.f;
    if (live && has_quad) {
      gv = fold_wd(gv, wv, wd);
      part = __fadd_rn(part, sum_sq(gv));
    }
    const float s = rowwise_scale<kGroup>(part, m, id, mv, D, lr, eps,
                                          live && sub == 0, lead);
    if (live && has_quad) {
      const RowRound rr{sr, sr ? sr_row_key(step_key, id, row_base) : 0u};
      table_store<kAcc>(w + static_cast<int64_t>(id) * D, sub, wv,
                        scale4(s, gv), rr, D);
    }
    r = rn;
    live = live_n;
    id = next;
    gv = gn;
    wv = wn;
    mv = mn;
  }
}

// The fused rowwise Adagrad for rows wider than four chunks (D > 512), any
// T: the warp walks its real slots as rowwise_adagrad_kernel does, one at a
// time, and each row twice. Pass 1 reads g's and W's quads chunk by chunk in
// ascending order, folds the weight decay and sums g'^2 into each lane's
// partial in the same order as the kernel above; then the same momentum
// step. Pass 2 reads the quads again, folds again (the same rounding) and
// writes W through the same epilogue. So it equals the plain version bit
// for bit at any D; a row costs one more read of g and W than the bound.
template <typename T, bool kMasked>
__global__ void rowwise_adagrad_wide_kernel(T* __restrict__ w,
                                            float* __restrict__ m,
                                            const int32_t* __restrict__ uids,
                                            const float* __restrict__ g,
                                            const int32_t* __restrict__ step,
                                            int64_t R, int64_t D, int64_t N,
                                            int slots, float lr, float eps,
                                            float wd, bool sr, uint32_t seed,
                                            int64_t row_base) {
  const int lane = threadIdx.x & 31;
  const int64_t warp =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  const int64_t base = warp * slots;
  if (base >= N) return;  // whole warp leaves together
  const int n = static_cast<int>(N - base < slots ? N - base : slots);
  const int32_t my_id = lane < n ? uids[base + lane] : -1;
  unsigned todo = __ballot_sync(kFullMask, is_real(my_id, R));
  const int64_t quads = (D + 3) / 4;
  const uint32_t step_key =
      sr && todo != 0 ? sr_step_key(seed, __ldg(step)) : 0u;
  while (todo != 0) {  // the same for the whole warp
    const int j = __ffs(todo) - 1;
    todo &= todo - 1;
    const int32_t id = __shfl_sync(kFullMask, my_id, j);
    const float* grow = g + (base + j) * D;
    T* wrow = w + static_cast<int64_t>(id) * D;
    const float mv = lane == 0 ? m[id] : 0.f;
    float part = 0.f;
    for (int64_t q = lane; q < quads; q += 32)
      part = __fadd_rn(part, sum_sq(fold_wd(load_g4<kMasked>(grow, q, D),
                                            load4<kMasked>(wrow, q, D), wd)));
    const float s =
        rowwise_scale<32>(part, m, id, mv, D, lr, eps, lane == 0, 0);
    const RowRound r{sr, sr ? sr_row_key(step_key, id, row_base) : 0u};
    for (int64_t q = lane; q < quads; q += 32) {
      const float4 wv = load4<kMasked>(wrow, q, D);
      const float4 x = fold_wd(load_g4<kMasked>(grow, q, D), wv, wd);
      store_quad<kMasked>(wrow, q, wv, scale4(s, x), r, D);
    }
  }
}

// -- Launchers: each picks the vector or the masked path ----------------------

// A lane group a launch may take at width D: 32 (a warp a row), or a
// power of two below 32 that covers the row's ceil(D / 4) quads
bool group_ok(int group, int64_t D) {
  return group >= 1 && group <= 32 && (group & (group - 1)) == 0 &&
         (group == 32 || group >= (D + 3) / 4);
}

// The rowwise kernels' arguments, as the entry points receive them
struct RowwiseCall {
  void* w;
  void* m;
  const void* uids;
  const void* g;
  const void* step;
  int64_t R, D, N;
  int group, slots;
  float lr, eps, wd;
  bool sr;
  uint32_t seed;
  int64_t row_base;
  void* stream;
};

// kChunks 1-4: rowwise_adagrad_kernel; 0: the wide kernel
template <int kChunks, typename T, bool kMasked>
int launch_rowwise_adagrad(const RowwiseCall& c) {
  const int64_t warps = (c.N + c.slots - 1) / c.slots;
  const dim3 grid(
      static_cast<unsigned>((warps + kWarpsPerBlock - 1) / kWarpsPerBlock));
  const auto s = static_cast<cudaStream_t>(c.stream);
  T* w = static_cast<T*>(c.w);
  float* m = static_cast<float*>(c.m);
  const auto* uids = static_cast<const int32_t*>(c.uids);
  const auto* g = static_cast<const float*>(c.g);
  const auto* step = static_cast<const int32_t*>(c.step);
  if constexpr (kChunks == 0) {
    rowwise_adagrad_wide_kernel<T, kMasked><<<grid, 32 * kWarpsPerBlock, 0,
                                              s>>>(
        w, m, uids, g, step, c.R, c.D, c.N, c.slots, c.lr, c.eps, c.wd, c.sr,
        c.seed, c.row_base);
  } else {
    rowwise_adagrad_kernel<kChunks, T, kMasked><<<grid, 32 * kWarpsPerBlock,
                                                  0, s>>>(
        w, m, uids, g, step, c.R, c.D, c.N, c.slots, c.lr, c.eps, c.wd, c.sr,
        c.seed, c.row_base);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kMasked>
int rowwise_adagrad_path(const RowwiseCall& c) {
  switch ((c.D + 127) / 128) {
    case 1:
      return launch_rowwise_adagrad<1, T, kMasked>(c);
    case 2:
      return launch_rowwise_adagrad<2, T, kMasked>(c);
    case 3:
      return launch_rowwise_adagrad<3, T, kMasked>(c);
    case 4:
      return launch_rowwise_adagrad<4, T, kMasked>(c);
    default:
      return launch_rowwise_adagrad<0, T, kMasked>(c);
  }
}

template <int kGroup, typename T, Access kAcc>
int launch_rowwise_narrow(const RowwiseCall& c) {
  const int64_t warps = (c.N + c.slots - 1) / c.slots;
  const dim3 grid(
      static_cast<unsigned>((warps + kWarpsPerBlock - 1) / kWarpsPerBlock));
  rowwise_adagrad_narrow_kernel<kGroup, T, kAcc>
      <<<grid, 32 * kWarpsPerBlock, 0, static_cast<cudaStream_t>(c.stream)>>>(
          static_cast<T*>(c.w), static_cast<float*>(c.m),
          static_cast<const int32_t*>(c.uids),
          static_cast<const float*>(c.g),
          static_cast<const int32_t*>(c.step), c.R, c.D, c.N, c.slots, c.lr,
          c.eps, c.wd, c.sr, c.seed, c.row_base);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, Access kAcc>
int rowwise_narrow_group(const RowwiseCall& c) {
  switch (c.group) {
    case 1:
      return launch_rowwise_narrow<1, T, kAcc>(c);
    case 2:
      return launch_rowwise_narrow<2, T, kAcc>(c);
    case 4:
      return launch_rowwise_narrow<4, T, kAcc>(c);
    case 8:
      return launch_rowwise_narrow<8, T, kAcc>(c);
    default:
      return launch_rowwise_narrow<16, T, kAcc>(c);
  }
}

// `group` lanes per row: 32 (a warp a row, any D >= 1), or a power of two
// below 32 of at least ceil(D / 4) (the narrow kernel); `slots` per warp:
// 1-32, a multiple of 32 / group
template <typename T>
int rowwise_adagrad(const RowwiseCall& c) {
  if (!group_ok(c.group, c.D) || c.slots < 1 || c.slots > 32 ||
      c.slots % (32 / c.group) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (c.group == 32) {
    const bool masked =
        c.D % 4 != 0 || !aligned(c.w, 4 * sizeof(T)) || !aligned(c.g, 16);
    return masked ? rowwise_adagrad_path<T, true>(c)
                  : rowwise_adagrad_path<T, false>(c);
  }
  if (c.D % 4 == 0 && aligned(c.w, 4 * sizeof(T)) && aligned(c.g, 16))
    return rowwise_narrow_group<T, Access::kVector>(c);
  if (c.D % 2 == 0 && aligned(c.w, 2 * sizeof(T)) && aligned(c.g, 8))
    return rowwise_narrow_group<T, Access::kPairs>(c);
  return rowwise_narrow_group<T, Access::kMasked>(c);
}

// What the row kernels' launchers share: the tensors, the sizes, the lane
// groups and slots per warp the wrapper picked, K3's lr and weight decay,
// and K3h's step tensor and rounding (sr, seed, row_base).
struct RowsCall {
  void* w;
  const void* uids;
  const void* src;
  const void* scale;
  const void* step;
  int64_t R, D, N;
  int group, slots;
  float lr, wd;
  bool sr;
  uint32_t seed;
  int64_t row_base;
  void* stream;
};

template <RowOp kOp, Access kAcc, int kGroup, typename T>
int launch_rows_path(const RowsCall& c) {
  const int64_t warps = (c.N + c.slots - 1) / c.slots;
  const dim3 grid(
      static_cast<unsigned>((warps + kWarpsPerBlock - 1) / kWarpsPerBlock));
  row_update_kernel<kOp, kAcc, kGroup, T>
      <<<grid, 32 * kWarpsPerBlock, 0, static_cast<cudaStream_t>(c.stream)>>>(
          static_cast<T*>(c.w), static_cast<const int32_t*>(c.uids),
          static_cast<const float*>(c.src),
          static_cast<const float*>(c.scale),
          static_cast<const int32_t*>(c.step), c.R, c.D, c.N, c.slots, c.lr,
          c.wd, c.sr, c.seed, c.row_base);
  return static_cast<int>(cudaGetLastError());
}

template <RowOp kOp, Access kAcc, typename T>
int launch_rows_group(const RowsCall& c) {
  switch (c.group) {
    case 1:
      return launch_rows_path<kOp, kAcc, 1, T>(c);
    case 2:
      return launch_rows_path<kOp, kAcc, 2, T>(c);
    case 4:
      return launch_rows_path<kOp, kAcc, 4, T>(c);
    case 8:
      return launch_rows_path<kOp, kAcc, 8, T>(c);
    case 16:
      return launch_rows_path<kOp, kAcc, 16, T>(c);
    default:
      return launch_rows_path<kOp, kAcc, 32, T>(c);
  }
}

// `group` lanes per row: 32, or a power of two of at least ceil(D / 4);
// `slots` per warp: a multiple of 32 / group, at most 32. A quad moves
// whole (a float4 of an f32 row, a uint2 of a half row) where D % 4 == 0
// and the rows are aligned to it, as pairs on narrow rows (G < 32) at an
// even D with rows aligned to a pair, else masked.
template <RowOp kOp, typename T = float>
int launch_rows(const RowsCall& c) {
  if (!group_ok(c.group, c.D) || c.slots < 1 || c.slots > 32 ||
      c.slots % (32 / c.group) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (c.D % 4 == 0 && aligned(c.w, 4 * sizeof(T)) && aligned(c.src, 16))
    return launch_rows_group<kOp, Access::kVector, T>(c);
  if (c.group < 32 && c.D % 2 == 0 && aligned(c.w, 2 * sizeof(T)) &&
      aligned(c.src, 8))
    return launch_rows_group<kOp, Access::kPairs, T>(c);
  return launch_rows_group<kOp, Access::kMasked, T>(c);
}

// What the moment kernels' launchers share
struct MomentsCall {
  void* w;
  void* m1;
  void* m2;  // K7 only
  const void* uids;
  const void* g;
  const void* bc;  // K7 only
  int64_t R, D, N;
  int group, slots;
  MomentArgs a;
  void* stream;
};

template <Moment kOpt, Access kAcc, int kGroup>
int launch_moments_path(const MomentsCall& c) {
  const int64_t warps = (c.N + c.slots - 1) / c.slots;
  const dim3 grid(
      static_cast<unsigned>((warps + kWarpsPerBlock - 1) / kWarpsPerBlock));
  moment_update_kernel<kOpt, kAcc, kGroup>
      <<<grid, 32 * kWarpsPerBlock, 0, static_cast<cudaStream_t>(c.stream)>>>(
          static_cast<float*>(c.w), static_cast<float*>(c.m1),
          static_cast<float*>(c.m2), static_cast<const int32_t*>(c.uids),
          static_cast<const float*>(c.g), static_cast<const float*>(c.bc),
          c.R, c.D, c.N, c.slots, c.a);
  return static_cast<int>(cudaGetLastError());
}

template <Moment kOpt, Access kAcc>
int launch_moments_group(const MomentsCall& c) {
  switch (c.group) {
    case 1:
      return launch_moments_path<kOpt, kAcc, 1>(c);
    case 2:
      return launch_moments_path<kOpt, kAcc, 2>(c);
    case 4:
      return launch_moments_path<kOpt, kAcc, 4>(c);
    case 8:
      return launch_moments_path<kOpt, kAcc, 8>(c);
    case 16:
      return launch_moments_path<kOpt, kAcc, 16>(c);
    default:
      return launch_moments_path<kOpt, kAcc, 32>(c);
  }
}

// `group` lanes per row: 32, or a power of two of at least ceil(D / 4);
// `slots` per warp: a multiple of 32 / group, at most 32
template <Moment kOpt>
int launch_moments(const MomentsCall& c) {
  if (!group_ok(c.group, c.D) || c.slots < 1 || c.slots > 32 ||
      c.slots % (32 / c.group) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool m2_16 = c.m2 == nullptr || aligned(c.m2, 16);
  if (c.D % 4 == 0 && aligned(c.w, 16) && aligned(c.m1, 16) && m2_16 &&
      aligned(c.g, 16))
    return launch_moments_group<kOpt, Access::kVector>(c);
  // pairs on narrow rows (G < 32); wider rows take the masked path
  const bool m2_8 = c.m2 == nullptr || aligned(c.m2, 8);
  if (c.group < 32 && c.D % 2 == 0 && aligned(c.w, 8) && aligned(c.m1, 8) &&
      m2_8 && aligned(c.g, 8))
    return launch_moments_group<kOpt, Access::kPairs>(c);
  return launch_moments_group<kOpt, Access::kMasked>(c);
}

}  // namespace

extern "C" {

// K2, K3 and K4's scaled RMW (and K3h below): `group` lanes per row and
// `slots` per warp, both picked by the wrapper (ops/lane_groups.py,
// row_slots_per_warp)
int trt_scatter_rows_write_f32(void* w, const void* uids, const void* rows,
                               int64_t R, int64_t D, int64_t N, int group,
                               int slots, void* stream) {
  return launch_rows<RowOp::kWrite>({w, uids, rows, nullptr, nullptr, R, D,
                                     N, group, slots, 0.f, 0.f, false, 0u,
                                     0, stream});
}

int trt_fused_update_sgd_f32(void* w, const void* uids, const void* g,
                             int64_t R, int64_t D, int64_t N, int group,
                             int slots, float lr, float wd, void* stream) {
  return launch_rows<RowOp::kSgd>({w, uids, g, nullptr, nullptr, R, D, N,
                                   group, slots, lr, wd, false, 0u, 0,
                                   stream});
}

int trt_scaled_row_update_f32(void* w, const void* uids, const void* g,
                              const void* scale, int64_t R, int64_t D,
                              int64_t N, int group, int slots, void* stream) {
  return launch_rows<RowOp::kScaled>({w, uids, g, scale, nullptr, R, D, N,
                                      group, slots, 0.f, 0.f, false, 0u, 0,
                                      stream});
}

int trt_rowwise_momentum_f32(void* m, const void* uids, const void* g_sq,
                             void* inv, int64_t R, int64_t N, float eps,
                             void* stream) {
  const dim3 grid(
      static_cast<unsigned>((N + kMomentumThreads - 1) / kMomentumThreads));
  rowwise_momentum_kernel<<<grid, kMomentumThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(m), static_cast<const int32_t*>(uids),
      static_cast<const float*>(g_sq), static_cast<float*>(inv), R, N, eps);
  return static_cast<int>(cudaGetLastError());
}

// The fused rowwise Adagrad, any D >= 1 (up to 512 columns in registers,
// wider rows in two passes): `group` lanes per row and `slots` per warp,
// both picked by the wrapper (fused_geometry)
int trt_fused_rowwise_adagrad_f32(void* w, void* m, const void* uids,
                                  const void* g, int64_t R, int64_t D,
                                  int64_t N, int group, int slots, float lr,
                                  float eps, float wd, void* stream) {
  return rowwise_adagrad<float>({w, m, uids, g, nullptr, R, D, N, group,
                                 slots, lr, eps, wd, false, 0u, 0, stream});
}

// The half-table entry points: `half` 0 is bf16, 1 fp16; `sr` selects the
// stochastic-rounding epilogue, whose bits take the step from device memory
// at `step` (an int32, read before the caller increments it), `seed` and
// `row_base`, the first row of this shard across the group.
// K4h: any D >= 1, `group` and `slots` as the f32 entry point's.
int trt_fused_rowwise_adagrad_half(void* w, void* m, const void* uids,
                                   const void* g, const void* step,
                                   int64_t R, int64_t D, int64_t N, int group,
                                   int slots, float lr, float eps, float wd,
                                   int half, int sr, uint32_t seed,
                                   int64_t row_base, void* stream) {
  const RowwiseCall c{w,  m,     uids, g,  step, R,       D,    N,
                      group, slots, lr, eps, wd, sr != 0, seed, row_base,
                      stream};
  if (half == 0) return rowwise_adagrad<__nv_bfloat16>(c);
  if (half == 1) return rowwise_adagrad<__half>(c);
  return static_cast<int>(cudaErrorInvalidValue);
}

// K3h: the row kernel on a half table, any D >= 1, `group` and `slots` as
// K3's
int trt_fused_update_sgd_half(void* w, const void* uids, const void* g,
                              const void* step, int64_t R, int64_t D,
                              int64_t N, int group, int slots, float lr,
                              float wd, int half, int sr, uint32_t seed,
                              int64_t row_base, void* stream) {
  const RowsCall c{w,     uids,  g,  nullptr, step,    R,    D,        N,
                   group, slots, lr, wd,      sr != 0, seed, row_base, stream};
  if (half == 0) return launch_rows<RowOp::kSgd, __nv_bfloat16>(c);
  if (half == 1) return launch_rows<RowOp::kSgd, __half>(c);
  return static_cast<int>(cudaErrorInvalidValue);
}

// K6 and K7: `group` lanes per row and `slots` per warp, both picked by the
// wrapper (moment_geometry)
int trt_fused_update_adagrad_f32(void* w, void* m, const void* uids,
                                 const void* g, int64_t R, int64_t D,
                                 int64_t N, int group, int slots, float lr,
                                 float eps, float wd, void* stream) {
  const MomentArgs a{lr, eps, wd, 0.f, 0.f, 0.f, 0.f};
  return launch_moments<Moment::kAdagrad>({w, m, nullptr, uids, g, nullptr,
                                           R, D, N, group, slots, a,
                                           stream});
}

int trt_fused_update_adam_f32(void* w, void* m1, void* m2, const void* uids,
                              const void* g, const void* bc, int64_t R,
                              int64_t D, int64_t N, int group, int slots,
                              float lr, float eps, float wd, float b1,
                              float omb1, float b2, float omb2,
                              void* stream) {
  const MomentArgs a{lr, eps, wd, b1, omb1, b2, omb2};
  return launch_moments<Moment::kAdam>({w, m1, m2, uids, g, bc, R, D, N,
                                        group, slots, a, stream});
}

const char* trt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
