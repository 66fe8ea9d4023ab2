// K1: fused pooled embedding lookup for Hopper (sm_90a).
//
//   out[b, :] = sum_l coeff[b, l] * W[clamp(ids[b, l], 0, R - 1), :]
//
// Replaces the TPU kernel `tbe_lookup_pooled` / `_tbe_lookup_impl` /
// `_lookup_kernel` in torchrec_tpu/ops/pallas_embedding.py:235-372. It
// computes the same function; the TPU kernel's DMA waves, its (TB*L, 1)
// coefficient column, the bag-select matmul and its SMEM and semaphore
// budgets are not carried over, so any NB and L are taken.
//
// Bound: bytes, not operations. Per bag the kernel reads L ids, L
// coefficients and L rows of D floats, and writes one row of D floats: 2*L*D
// flops against about 4*(L + 1)*D bytes, a quarter of a flop per byte,
// far below the card's ~20 flops per byte at fp32. The least time is
// therefore the bytes over the memory rate.
//
// What the design does about it:
//   * A row has quads = ceil(D / 4) quads of 4 columns and gets G lanes:
//     the smallest power of two >= quads, at most 32. The wrapper picks G
//     from D (ops/lane_groups.py) and passes it in.
//   * Rows wider than 64 columns (G = 32): one warp per bag and column
//     chunk. With D % 4 == 0 each lane moves one 16-byte float4 of a row,
//     so a warp reads 512 contiguous bytes of a row in one coalesced
//     request (a D=128 f32 row is exactly 512 bytes); otherwise each lane
//     moves one float of a 32-column chunk (blockIdx.y).
//   * Narrow rows (D <= 64, G < 32): a warp takes P = 32 / G bags, one per
//     lane group; lane l of a group holds quad l of its bag's rows, as a
//     vector (D % 4 == 0, aligned rows), as two pairs (D % 2 == 0, rows
//     aligned to a pair) or element by element, zeros past D, only the
//     columns below D written. At D=10 (G = 4) a
//     warp pools 8 bags and at D=64 (G = 16) two, so a warp's lanes are
//     busy and the launch has P times fewer warps than bags. Every output
//     element gets the same operations in the same order as on the wide
//     paths (acc += c * v, slot by slot).
//   * The L coefficients and ids of a bag are loaded once, G at a time (one
//     per lane of its group; 32 at a time on the wide paths), and broadcast
//     with shuffles within the group. L is the same for every bag, so
//     every group runs the same number of shuffles and every lane of the
//     warp reaches each full-mask shuffle; a group past NB loads nothing.
//   * The sum stays in registers; each output element is written once.
//   * A slot whose coefficient is 0 (padding, the empty bag of a MEAN
//     feature, a row another shard owns) is not read: those bytes are not
//     moved at all.
//   * Row addresses are 64-bit: R * D can pass 2^31 elements.
//   * Rows are read through the read-only path (__ldg); nothing is cached
//     in shared memory, since ids are random and rarely repeat in a bag.
//
// K1h is the same kernel over bf16 / fp16 rows (`trt_tbe_lookup_pooled_half`),
// in place of the plain XLA gather and einsum the JAX package pools such
// tables with (torchrec_tpu/ops/embedding.py:77-116, since its Pallas
// kernel takes f32 only): each row element is widened to f32 exactly, the
// sum is f32 and so is the output. A lane then reads 4 elements, one 8-byte
// quad, so a warp reads a D=128 bf16 row (256 bytes) in one request; the
// bytes per row halve, which is the point of the half table.
// K1j (`trt_tbe_lookup_jagged`) is the offsets form of the same lookup, for
// jagged batches: bag b pools the ids between offsets[b] and offsets[b + 1]
// (at most `cap` of them), so a batch of bags of many lengths moves only
// its real ids, where the padded form above reads L slots a bag.
// The kernels launch on the caller's stream, allocate nothing and do not
// synchronise; the Python wrapper allocates `out`.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFullMask = 0xffffffffu;

// a half element from the low 16 bits of a word, widened exactly
__device__ __forceinline__ float widen(uint32_t b, const __nv_bfloat16*) {
  return __uint_as_float(b << 16);
}
__device__ __forceinline__ float widen(uint32_t b, const __half*) {
  return __half2float(__ushort_as_half(static_cast<unsigned short>(b)));
}

// 4 consecutive row elements: a float4 for f32, an 8-byte uint2 for halves
__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

template <typename T>
__device__ __forceinline__ float4 load4(const T* p) {
  const uint2 h = __ldg(reinterpret_cast<const uint2*>(p));
  return make_float4(widen(h.x & 0xffffu, p), widen(h.x >> 16, p),
                     widen(h.y & 0xffffu, p), widen(h.y >> 16, p));
}

__device__ __forceinline__ float load1(const float* p) { return __ldg(p); }

template <typename T>
__device__ __forceinline__ float load1(const T* p) {
  return widen(__ldg(reinterpret_cast<const unsigned short*>(p)), p);
}

template <typename T, bool kVec>
__global__ void tbe_lookup_pooled_kernel(const T* __restrict__ w,
                                         const int32_t* __restrict__ ids,
                                         const float* __restrict__ coeff,
                                         float* __restrict__ out, int64_t R,
                                         int64_t D, int64_t NB, int64_t L) {
  const int lane = threadIdx.x & 31;
  const int64_t bag =
      (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (bag >= NB) return;  // whole warp leaves together
  // Columns are counted in float4s on the vector path, in floats otherwise.
  const int64_t cols = kVec ? D / 4 : D;
  const int64_t col = (int64_t)blockIdx.y * 32 + lane;
  const bool active = col < cols;

  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  const int64_t slot0 = bag * L;
  for (int64_t base = 0; base < L; base += 32) {
    const int n = (int)(L - base < 32 ? L - base : 32);
    int64_t my_id = 0;
    float my_c = 0.f;
    if (lane < n) {
      const int64_t id = ids[slot0 + base + lane];
      my_id = id < 0 ? 0 : (id >= R ? R - 1 : id);
      my_c = coeff[slot0 + base + lane];
    }
    for (int j = 0; j < n; ++j) {
      const float c = __shfl_sync(kFullMask, my_c, j);
      const int64_t row = __shfl_sync(kFullMask, my_id, j);
      if (c == 0.f || !active) continue;
      if (kVec) {
        const float4 v = load4(w + row * D + 4 * col);
        acc.x += c * v.x;
        acc.y += c * v.y;
        acc.z += c * v.z;
        acc.w += c * v.w;
      } else {
        acc.x += c * load1(w + row * D + col);
      }
    }
  }
  if (!active) return;
  if (kVec) {
    reinterpret_cast<float4*>(out + bag * D)[col] = acc;
  } else {
    out[bag * D + col] = acc.x;
  }
}

// 2 consecutive row elements: a float2 for f32, a 4-byte word for halves
__device__ __forceinline__ float2 load2(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}

template <typename T>
__device__ __forceinline__ float2 load2(const T* p) {
  const uint32_t h = __ldg(reinterpret_cast<const unsigned int*>(p));
  return make_float2(widen(h & 0xffffu, p), widen(h >> 16, p));
}

// How the narrow kernel moves a quad of a row: whole (D % 4 == 0, aligned
// rows), as two pairs (D % 2 == 0, rows aligned to a pair), or element by
// element; past D it reads zeros and writes nothing.
enum class Access { kQuad, kPair, kElem };

template <Access kAcc, typename T>
__device__ __forceinline__ float4 load_quad(const T* row, int q, int64_t D) {
  const int64_t c = 4 * (int64_t)q;  // < D: q < ceil(D / 4)
  if constexpr (kAcc == Access::kQuad) {
    return load4(row + c);
  } else if constexpr (kAcc == Access::kPair) {
    const float2 a = load2(row + c);
    const float2 b = c + 2 < D ? load2(row + c + 2) : make_float2(0.f, 0.f);
    return make_float4(a.x, a.y, b.x, b.y);
  } else {
    return make_float4(load1(row + c), c + 1 < D ? load1(row + c + 1) : 0.f,
                       c + 2 < D ? load1(row + c + 2) : 0.f,
                       c + 3 < D ? load1(row + c + 3) : 0.f);
  }
}

// Narrow rows: kGroup lanes per bag, 32 / kGroup bags per warp; lane `sub`
// of a group holds quad `sub` of its bag (see the note at the top).
template <typename T, Access kAcc, int kGroup>
__global__ void tbe_lookup_narrow_kernel(const T* __restrict__ w,
                                         const int32_t* __restrict__ ids,
                                         const float* __restrict__ coeff,
                                         float* __restrict__ out, int64_t R,
                                         int64_t D, int64_t NB, int64_t L) {
  constexpr int kBags = 32 / kGroup;
  const int lane = threadIdx.x & 31;
  const int sub = lane % kGroup;
  const int64_t first =
      ((int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5)) * kBags;
  if (first >= NB) return;  // whole warp leaves together
  const int64_t bag = first + lane / kGroup;
  const bool live = bag < NB;
  const bool active = live && sub < (D + 3) / 4;

  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  const int64_t slot0 = bag * L;
  for (int64_t base = 0; base < L; base += kGroup) {
    // the same n in every group: L is every bag's length
    const int n = (int)(L - base < kGroup ? L - base : kGroup);
    int64_t my_id = 0;
    float my_c = 0.f;
    if (live && sub < n) {
      const int64_t id = ids[slot0 + base + sub];
      my_id = id < 0 ? 0 : (id >= R ? R - 1 : id);
      my_c = coeff[slot0 + base + sub];
    }
    for (int j = 0; j < n; ++j) {
      const float c = __shfl_sync(kFullMask, my_c, j, kGroup);
      const int64_t row = __shfl_sync(kFullMask, my_id, j, kGroup);
      if (c == 0.f || !active) continue;
      const float4 v = load_quad<kAcc>(w + row * D, sub, D);
      acc.x += c * v.x;
      acc.y += c * v.y;
      acc.z += c * v.z;
      acc.w += c * v.w;
    }
  }
  if (!active) return;
  float* o = out + bag * D + 4 * sub;
  const int64_t c = 4 * (int64_t)sub;
  if constexpr (kAcc == Access::kQuad) {
    *reinterpret_cast<float4*>(o) = acc;
  } else if constexpr (kAcc == Access::kPair) {
    *reinterpret_cast<float2*>(o) = make_float2(acc.x, acc.y);
    if (c + 2 < D) {
      *reinterpret_cast<float2*>(o + 2) = make_float2(acc.z, acc.w);
    }
  } else {
    o[0] = acc.x;
    if (c + 1 < D) o[1] = acc.y;
    if (c + 2 < D) o[2] = acc.z;
    if (c + 3 < D) o[3] = acc.w;
  }
}

// The offsets form (K1j): bag b pools the ids[offsets[b] + l] for l below
// min(offsets[b + 1] - offsets[b], cap), each times coeff[offsets[b] + l],
// or times 1 where `coeff` is null (plain sum pooling). kGroup lanes take a
// bag and 32 / kGroup bags share a warp; lane `sub` holds quad
// blockIdx.y * kGroup + sub of its bag's rows, so at kGroup = 32 the
// column chunks of a row wider than 128 columns are blockIdx.y. Bags differ
// in length, so a warp runs its longest bag's slots: a lane past its own
// bag's length loads a coefficient of 0 and reads nothing, and every lane
// reaches every full-mask shuffle. Each output element gets the operations
// of the padded kernels above in the same order (acc += c * v over the
// bag's slots), so the two forms agree bit for bit on the same bags.
template <typename T, Access kAcc, int kGroup>
__global__ void tbe_lookup_jagged_kernel(const T* __restrict__ w,
                                         const int32_t* __restrict__ ids,
                                         const int32_t* __restrict__ offsets,
                                         const float* __restrict__ coeff,
                                         float* __restrict__ out, int64_t R,
                                         int64_t D, int64_t NB, int64_t cap) {
  constexpr int kBags = 32 / kGroup;
  const int lane = threadIdx.x & 31;
  const int sub = lane % kGroup;
  const int64_t first =
      ((int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5)) * kBags;
  if (first >= NB) return;  // whole warp leaves together
  const int64_t bag = first + lane / kGroup;
  const bool live = bag < NB;
  const int q = (int)blockIdx.y * kGroup + sub;
  const bool active = live && q < (D + 3) / 4;
  int64_t start = 0;
  int len = 0;
  if (live) {
    start = offsets[bag];
    const int64_t n = offsets[bag + 1] - start;
    len = (int)(n < cap ? n : cap);
  }
  const int longest = (int)__reduce_max_sync(kFullMask, (unsigned)len);

  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int base = 0; base < longest; base += kGroup) {
    const int n = longest - base < kGroup ? longest - base : kGroup;
    int64_t my_id = 0;
    float my_c = 0.f;
    if (base + sub < len) {
      const int64_t slot = start + base + sub;
      const int64_t id = ids[slot];
      my_id = id < 0 ? 0 : (id >= R ? R - 1 : id);
      my_c = coeff == nullptr ? 1.f : coeff[slot];
    }
    for (int j = 0; j < n; ++j) {
      const float c = __shfl_sync(kFullMask, my_c, j, kGroup);
      const int64_t row = __shfl_sync(kFullMask, my_id, j, kGroup);
      if (c == 0.f || !active) continue;
      const float4 v = load_quad<kAcc>(w + row * D, q, D);
      acc.x += c * v.x;
      acc.y += c * v.y;
      acc.z += c * v.z;
      acc.w += c * v.w;
    }
  }
  if (!active) return;
  float* o = out + bag * D + 4 * (int64_t)q;
  const int64_t c = 4 * (int64_t)q;
  if constexpr (kAcc == Access::kQuad) {
    *reinterpret_cast<float4*>(o) = acc;
  } else if constexpr (kAcc == Access::kPair) {
    *reinterpret_cast<float2*>(o) = make_float2(acc.x, acc.y);
    if (c + 2 < D) {
      *reinterpret_cast<float2*>(o + 2) = make_float2(acc.z, acc.w);
    }
  } else {
    o[0] = acc.x;
    if (c + 1 < D) o[1] = acc.y;
    if (c + 2 < D) o[2] = acc.z;
    if (c + 3 < D) o[3] = acc.w;
  }
}

template <typename T, int kGroup>
int launch_jagged_group(const T* w, const int32_t* ids, const int32_t* offs,
                        const float* cf, float* out, int64_t R, int64_t D,
                        int64_t NB, int64_t cap, cudaStream_t s) {
  constexpr int kBags = 32 / kGroup;
  const int64_t warps = (NB + kBags - 1) / kBags;
  const int64_t quads = (D + 3) / 4;
  const dim3 grid((unsigned)((warps + kWarpsPerBlock - 1) / kWarpsPerBlock),
                  (unsigned)((quads + kGroup - 1) / kGroup));
  const dim3 block(32 * kWarpsPerBlock);
  const bool vec = (D % 4 == 0) && ((uintptr_t)w % (4 * sizeof(T)) == 0) &&
                   ((uintptr_t)out % 16 == 0);
  const bool pairs = (D % 2 == 0) && ((uintptr_t)w % (2 * sizeof(T)) == 0) &&
                     ((uintptr_t)out % 8 == 0);
  if (vec) {
    tbe_lookup_jagged_kernel<T, Access::kQuad, kGroup>
        <<<grid, block, 0, s>>>(w, ids, offs, cf, out, R, D, NB, cap);
  } else if (pairs) {
    tbe_lookup_jagged_kernel<T, Access::kPair, kGroup>
        <<<grid, block, 0, s>>>(w, ids, offs, cf, out, R, D, NB, cap);
  } else {
    tbe_lookup_jagged_kernel<T, Access::kElem, kGroup>
        <<<grid, block, 0, s>>>(w, ids, offs, cf, out, R, D, NB, cap);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_jagged(const void* w, const void* ids, const void* offsets,
                  const void* coeff, void* out, int64_t R, int64_t D,
                  int64_t NB, int64_t cap, int group, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* wt = static_cast<const T*>(w);
  const int32_t* idp = static_cast<const int32_t*>(ids);
  const int32_t* op = static_cast<const int32_t*>(offsets);
  const float* cf = static_cast<const float*>(coeff);
  float* of = static_cast<float*>(out);
  if (group != 32 && (D + 3) / 4 > group) return (int)cudaErrorInvalidValue;
  switch (group) {
    case 1:
      return launch_jagged_group<T, 1>(wt, idp, op, cf, of, R, D, NB, cap, s);
    case 2:
      return launch_jagged_group<T, 2>(wt, idp, op, cf, of, R, D, NB, cap, s);
    case 4:
      return launch_jagged_group<T, 4>(wt, idp, op, cf, of, R, D, NB, cap, s);
    case 8:
      return launch_jagged_group<T, 8>(wt, idp, op, cf, of, R, D, NB, cap, s);
    case 16:
      return launch_jagged_group<T, 16>(wt, idp, op, cf, of, R, D, NB, cap,
                                        s);
    case 32:
      return launch_jagged_group<T, 32>(wt, idp, op, cf, of, R, D, NB, cap,
                                        s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <typename T, int kGroup>
int launch_narrow(bool vec, const T* w, const int32_t* ids, const float* cf,
                  float* out, int64_t R, int64_t D, int64_t NB, int64_t L,
                  cudaStream_t s) {
  constexpr int kBags = 32 / kGroup;
  const int64_t warps = (NB + kBags - 1) / kBags;
  const dim3 grid((unsigned)((warps + kWarpsPerBlock - 1) / kWarpsPerBlock));
  const dim3 block(32 * kWarpsPerBlock);
  // pairs: 8 bytes of f32 or 4 of a half type, aligned to their size
  const bool pairs = (D % 2 == 0) && ((uintptr_t)w % (2 * sizeof(T)) == 0) &&
                     ((uintptr_t)out % 8 == 0);
  if (vec) {
    tbe_lookup_narrow_kernel<T, Access::kQuad, kGroup>
        <<<grid, block, 0, s>>>(w, ids, cf, out, R, D, NB, L);
  } else if (pairs) {
    tbe_lookup_narrow_kernel<T, Access::kPair, kGroup>
        <<<grid, block, 0, s>>>(w, ids, cf, out, R, D, NB, L);
  } else {
    tbe_lookup_narrow_kernel<T, Access::kElem, kGroup>
        <<<grid, block, 0, s>>>(w, ids, cf, out, R, D, NB, L);
  }
  return (int)cudaGetLastError();
}

// `group` is G, the lanes a row takes: 32 for the wide paths, a power of
// two of at least ceil(D / 4) below it for the narrow one.
template <typename T>
int launch(const void* w, const void* ids, const void* coeff, void* out,
           int64_t R, int64_t D, int64_t NB, int64_t L, int group,
           void* stream) {
  // the vector path reads 4 row elements at once: 16 bytes of f32 or 8 of
  // a half type, aligned to their size
  const bool vec = (D % 4 == 0) && ((uintptr_t)w % (4 * sizeof(T)) == 0) &&
                   ((uintptr_t)out % 16 == 0);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* wt = static_cast<const T*>(w);
  const int32_t* idp = static_cast<const int32_t*>(ids);
  const float* cf = static_cast<const float*>(coeff);
  float* of = static_cast<float*>(out);
  if (group != 32 && (D + 3) / 4 > group) return (int)cudaErrorInvalidValue;
  switch (group) {
    case 1:
      return launch_narrow<T, 1>(vec, wt, idp, cf, of, R, D, NB, L, s);
    case 2:
      return launch_narrow<T, 2>(vec, wt, idp, cf, of, R, D, NB, L, s);
    case 4:
      return launch_narrow<T, 4>(vec, wt, idp, cf, of, R, D, NB, L, s);
    case 8:
      return launch_narrow<T, 8>(vec, wt, idp, cf, of, R, D, NB, L, s);
    case 16:
      return launch_narrow<T, 16>(vec, wt, idp, cf, of, R, D, NB, L, s);
    case 32:
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  const int64_t cols = vec ? D / 4 : D;
  dim3 grid((unsigned)((NB + kWarpsPerBlock - 1) / kWarpsPerBlock),
            (unsigned)((cols + 31) / 32));
  dim3 block(32 * kWarpsPerBlock);
  if (vec) {
    tbe_lookup_pooled_kernel<T, true><<<grid, block, 0, s>>>(wt, idp, cf, of,
                                                             R, D, NB, L);
  } else {
    tbe_lookup_pooled_kernel<T, false><<<grid, block, 0, s>>>(wt, idp, cf,
                                                              of, R, D, NB, L);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 on success).
// `group`: lanes per row, from D (ops/lane_groups.py).
int trt_tbe_lookup_pooled_f32(const void* w, const void* ids,
                              const void* coeff, void* out, int64_t R,
                              int64_t D, int64_t NB, int64_t L, int group,
                              void* stream) {
  return launch<float>(w, ids, coeff, out, R, D, NB, L, group, stream);
}

// K1h: `half` 0 for bf16 rows, 1 for fp16 rows; out is f32.
int trt_tbe_lookup_pooled_half(const void* w, const void* ids,
                               const void* coeff, void* out, int64_t R,
                               int64_t D, int64_t NB, int64_t L, int group,
                               int half, void* stream) {
  if (half == 0)
    return launch<__nv_bfloat16>(w, ids, coeff, out, R, D, NB, L, group,
                                 stream);
  if (half == 1)
    return launch<__half>(w, ids, coeff, out, R, D, NB, L, group, stream);
  return (int)cudaErrorInvalidValue;
}

// K1j, the offsets form: bag b pools ids[offsets[b] .. offsets[b] +
// min(length, cap)), `coeff` per id or null (every coefficient 1); int32
// ids and offsets [NB + 1]; `half` -1 for f32 rows, 0 bf16, 1 fp16.
int trt_tbe_lookup_jagged(const void* w, const void* ids, const void* offsets,
                          const void* coeff, void* out, int64_t R, int64_t D,
                          int64_t NB, int64_t cap, int group, int half,
                          void* stream) {
  if (half == -1)
    return launch_jagged<float>(w, ids, offsets, coeff, out, R, D, NB, cap,
                                group, stream);
  if (half == 0)
    return launch_jagged<__nv_bfloat16>(w, ids, offsets, coeff, out, R, D,
                                        NB, cap, group, stream);
  if (half == 1)
    return launch_jagged<__half>(w, ids, offsets, coeff, out, R, D, NB, cap,
                                 group, stream);
  return (int)cudaErrorInvalidValue;
}

const char* trt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
