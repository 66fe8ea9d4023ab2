// Kq: the int-N row-wise quantized embedding lookup for Hopper (sm_90a).
//
//   pooled:   out[b, :] = sum_l coeff[b, l] * deq(clamp(ids[b, l], 0, R - 1))
//   unpooled: out[n, :] = coeff[n] * deq(clamp(ids[n], 0, R - 1))
//             (without coeff: deq(...) alone)
//   deq(r)[c] = q[r, c] * scale[r] + shift[r]
//
// `q` is unpacked from the uint8 `data` [R, D * bits / 8]: value j of a
// byte sits at bits [bits * j, bits * (j + 1)), so column c of a row is
// byte c * bits / 8, bits (c % (8 / bits)) * bits upward.
//
// Stands for XLA code of the JAX package, not a Pallas kernel: the
// gather, unpack, dequantize and einsum of `dequantize_rows` and
// `quant_embedding_bag_lookup` (torchrec_tpu/ops/quant.py:68-109). Done in
// plain torch that is four passes over [N, D] (gather the packed bytes,
// unpack, dequantize to f32, reduce); here each packed row is read once
// and each output row written once.
//
// Bound: bytes. Per slot the kernel reads D * bits / 8 bytes of a row, 8
// bytes of scale and shift, an id and a coefficient, and does 4 * D flops
// (the dequantize's multiply and add, the pooling's multiply and add);
// per bag it writes D floats. At D = 128 and int8 that is about 1.3
// flops per byte, far below the card's ~20 at fp32.
//
// Design (K1's, csrc/tbe_lookup.cu):
//   * A row of D columns has quads = ceil(D / 4) quads and takes G lanes,
//     the smallest power of two >= quads, at most 32 (the wrapper picks G
//     from D, ops/lane_groups.py; the C entry points refuse any other).
//   * Narrow rows (D <= 64, G < 32; quant_lookup_narrow_kernel): a warp
//     takes 32 / G bags, one per lane group, and lane l of a group holds
//     quad l of its bag's rows: at D=10 (G = 4) 8 bags a warp, at D=64
//     (G = 16) two. A bag's ids and coefficients are loaded G at a time,
//     one per lane of its group, and broadcast with group-width shuffles.
//     A lane reads its quad's packed bits as one word where the packed row
//     allows it (4 bytes at int8 and 2 at int4 when D % 4 == 0 and the
//     data is aligned to the word, a byte at int2), otherwise in smaller
//     aligned pieces: two 2-byte pairs at int8 and an even D (a D=10 row is
//     10 bytes at an even address), bytes at int4 (a D=10 row is 5 bytes)
//     and at int8 otherwise. Nothing past a packed row is read and no
//     column past D is written.
//   * Rows wider than 64 columns (G = 32; quant_lookup_kernel): one warp
//     per bag and 128-column chunk. With D % 4 == 0 each lane owns 4
//     consecutive columns and reads them as one word of 4 * bits bits and
//     accumulates a float4; a D = 128 int8 row is one 128-byte request of
//     the warp. Otherwise one lane owns one column and reads its byte. The
//     slots' ids and coefficients are loaded once per warp, one slot per
//     lane, and broadcast with shuffles.
//   * Each slot's scale and shift are read beside its row, by every lane
//     of the group from one address each (one request for the group):
//     loaded with the ids, they would put a second dependent load before
//     every row. They live in two arrays beside the packed rows, so a
//     narrow row costs at least three 32-byte sectors (the row, its scale,
//     its shift), where the byte bound counts D * bits / 8 + 8 bytes.
//   * A pooled slot whose coefficient is 0 is not read, as in K1; ids are
//     clamped to [0, R - 1].
//
// Rounding: the dequantize is q * scale rounded, then + shift rounded, and
// the pooling adds coeff * value, rounded, to the sum in slot order: the
// plain version's operations one by one. __fmul_rn / __fadd_rn keep nvcc
// from contracting them into fused multiply-adds, so kernel and plain
// version agree bit for bit (q * scale is exact anyway: the scale is an
// fp16 value and q has at most 8 bits).
//
// Row addresses are 64-bit. The kernel launches on the caller's stream,
// allocates nothing and does not synchronise; the wrapper
// (ops/quant_lookup.py) allocates `out`.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFullMask = 0xffffffffu;

// the lane's 4 consecutive columns as one little-endian word of 4 * kBits
// bits
template <int kBits>
__device__ __forceinline__ uint32_t load_word(const uint8_t* p);

template <>
__device__ __forceinline__ uint32_t load_word<8>(const uint8_t* p) {
  return __ldg(reinterpret_cast<const uint32_t*>(p));
}
template <>
__device__ __forceinline__ uint32_t load_word<4>(const uint8_t* p) {
  return __ldg(reinterpret_cast<const unsigned short*>(p));
}
template <>
__device__ __forceinline__ uint32_t load_word<2>(const uint8_t* p) {
  return __ldg(p);
}

__device__ __forceinline__ float deq(uint32_t q, float s, float sh) {
  return __fadd_rn(__fmul_rn(static_cast<float>(q), s), sh);
}

template <int kBits, bool kVec, bool kPooled>
__global__ void quant_lookup_kernel(const uint8_t* __restrict__ data,
                                    const float* __restrict__ scale,
                                    const float* __restrict__ shift,
                                    const int32_t* __restrict__ ids,
                                    const float* __restrict__ coeff,
                                    float* __restrict__ out, int64_t R,
                                    int64_t D, int64_t NB, int64_t L) {
  constexpr uint32_t kMask = (1u << kBits) - 1u;
  constexpr int kPerByte = 8 / kBits;
  const int lane = threadIdx.x & 31;
  const int64_t bag =
      (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (bag >= NB) return;  // whole warp leaves together
  const int64_t bytes_per_row = D / kPerByte;
  // columns are counted in groups of 4 on the vector path
  const int64_t cols = kVec ? D / 4 : D;
  const int64_t col = (int64_t)blockIdx.y * 32 + lane;
  const bool active = col < cols;

  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  const int64_t slot0 = bag * L;
  for (int64_t base = 0; base < L; base += 32) {
    const int n = (int)(L - base < 32 ? L - base : 32);
    int64_t my_id = 0;
    float my_c = 1.f;
    if (lane < n) {
      const int64_t id = ids[slot0 + base + lane];
      my_id = id < 0 ? 0 : (id >= R ? R - 1 : id);
      if (coeff != nullptr) my_c = coeff[slot0 + base + lane];
    }
    for (int j = 0; j < n; ++j) {
      const float c = __shfl_sync(kFullMask, my_c, j);
      const int64_t row = __shfl_sync(kFullMask, my_id, j);
      if (!active || (kPooled && c == 0.f)) continue;
      // the row's scale and shift (one broadcast load each for the warp)
      // are issued beside its packed word, not before it: the slot then
      // waits on one memory latency after its id, not two
      const float s = __ldg(scale + row);
      const float sh = __ldg(shift + row);
      const uint8_t* r = data + row * bytes_per_row;
      if (kVec) {
        const uint32_t w = load_word<kBits>(r + col * 4 / kPerByte);
        float4 v = make_float4(deq(w & kMask, s, sh),
                               deq((w >> kBits) & kMask, s, sh),
                               deq((w >> (2 * kBits)) & kMask, s, sh),
                               deq((w >> (3 * kBits)) & kMask, s, sh));
        if (coeff != nullptr) {
          v.x = __fmul_rn(c, v.x);
          v.y = __fmul_rn(c, v.y);
          v.z = __fmul_rn(c, v.z);
          v.w = __fmul_rn(c, v.w);
        }
        acc.x = __fadd_rn(acc.x, v.x);
        acc.y = __fadd_rn(acc.y, v.y);
        acc.z = __fadd_rn(acc.z, v.z);
        acc.w = __fadd_rn(acc.w, v.w);
      } else {
        const uint32_t b = __ldg(r + col / kPerByte);
        float v = deq((b >> ((col % kPerByte) * kBits)) & kMask, s, sh);
        if (coeff != nullptr) v = __fmul_rn(c, v);
        acc.x = __fadd_rn(acc.x, v);
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

// How a narrow lane reads its quad's packed bits (see the note at the top):
// one word, 2-column pieces (2 bytes at int8, a byte at int4), or bytes.
enum class Access { kQuad, kPair, kElem };

// 2 columns' packed bits: 2 bytes at int8, a byte at int4
template <int kBytes>
__device__ __forceinline__ uint32_t load_piece(const uint8_t* p) {
  if constexpr (kBytes == 2) {
    return __ldg(reinterpret_cast<const unsigned short*>(p));
  } else {
    return __ldg(p);
  }
}

// The quad of columns c .. c + 3 of a packed row as one little-endian word
// of 4 * kBits bits, zero past D.
template <int kBits, Access kAcc>
__device__ __forceinline__ uint32_t load_packed_quad(const uint8_t* row,
                                                     int64_t c, int64_t D) {
  if constexpr (kAcc == Access::kQuad) {
    return load_word<kBits>(row + c * kBits / 8);
  } else if constexpr (kAcc == Access::kPair) {
    // an even D: columns c, c + 1 are real, c + 2, c + 3 both or neither
    static_assert(kBits == 8 || kBits == 4, "2-column pieces at 8 or 4 bits");
    constexpr int kPiece = 2 * kBits / 8;  // bytes of 2 columns
    const uint8_t* p = row + c * kBits / 8;
    const uint32_t a = load_piece<kPiece>(p);
    const uint32_t b = c + 2 < D ? load_piece<kPiece>(p + kPiece) : 0u;
    return a | (b << (2 * kBits));
  } else {
    static_assert(kBits == 8, "bytes a column at 8 bits");
    const uint8_t* p = row + c;
    uint32_t w = __ldg(p);
    if (c + 1 < D) w |= (uint32_t)__ldg(p + 1) << 8;
    if (c + 2 < D) w |= (uint32_t)__ldg(p + 2) << 16;
    if (c + 3 < D) w |= (uint32_t)__ldg(p + 3) << 24;
    return w;
  }
}

// Narrow rows: kGroup lanes a bag, 32 / kGroup bags a warp; lane `sub` of
// a group holds quad `sub` of its bag. The same operations in the same
// order as quant_lookup_kernel for every element.
template <int kBits, Access kAcc, int kGroup, bool kPooled>
__global__ void quant_lookup_narrow_kernel(
    const uint8_t* __restrict__ data, const float* __restrict__ scale,
    const float* __restrict__ shift, const int32_t* __restrict__ ids,
    const float* __restrict__ coeff, float* __restrict__ out, int64_t R,
    int64_t D, int64_t NB, int64_t L, int out_form) {
  constexpr uint32_t kMask = (1u << kBits) - 1u;
  constexpr int kBags = 32 / kGroup;
  const int lane = threadIdx.x & 31;
  const int sub = lane % kGroup;
  const int64_t first =
      ((int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5)) * kBags;
  if (first >= NB) return;  // whole warp leaves together
  const int64_t bag = first + lane / kGroup;
  const bool live = bag < NB;
  const int64_t c = 4 * (int64_t)sub;
  const bool active = live && c < D;
  const int64_t bytes_per_row = D * kBits / 8;

  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  const int64_t slot0 = bag * L;
  for (int64_t base = 0; base < L; base += kGroup) {
    // the same n in every group: L is every bag's length
    const int n = (int)(L - base < kGroup ? L - base : kGroup);
    int64_t my_id = 0;
    float my_c = 1.f;
    if (live && sub < n) {
      const int64_t id = ids[slot0 + base + sub];
      my_id = id < 0 ? 0 : (id >= R ? R - 1 : id);
      if (coeff != nullptr) my_c = coeff[slot0 + base + sub];
    }
    for (int j = 0; j < n; ++j) {
      const float cf = __shfl_sync(kFullMask, my_c, j, kGroup);
      const int64_t row = __shfl_sync(kFullMask, my_id, j, kGroup);
      if (!active || (kPooled && cf == 0.f)) continue;
      const float s = __ldg(scale + row);
      const float sh = __ldg(shift + row);
      const uint32_t w =
          load_packed_quad<kBits, kAcc>(data + row * bytes_per_row, c, D);
      float4 v = make_float4(deq(w & kMask, s, sh),
                             deq((w >> kBits) & kMask, s, sh),
                             deq((w >> (2 * kBits)) & kMask, s, sh),
                             deq((w >> (3 * kBits)) & kMask, s, sh));
      if (coeff != nullptr) {
        v.x = __fmul_rn(cf, v.x);
        v.y = __fmul_rn(cf, v.y);
        v.z = __fmul_rn(cf, v.z);
        v.w = __fmul_rn(cf, v.w);
      }
      acc.x = __fadd_rn(acc.x, v.x);
      acc.y = __fadd_rn(acc.y, v.y);
      acc.z = __fadd_rn(acc.z, v.z);
      acc.w = __fadd_rn(acc.w, v.w);
    }
  }
  if (!active) return;
  float* o = out + bag * D + c;
  if (out_form == 2) {  // D % 4 == 0 and a 16-byte aligned output
    *reinterpret_cast<float4*>(o) = acc;
  } else if (out_form == 1) {  // an even D and an 8-byte aligned output
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

// G for a row of D columns: the smallest power of two >= ceil(D / 4), at
// most 32 (ops/lane_groups.py).
int lanes_per_row(int64_t D) {
  const int64_t quads = (D + 3) / 4;
  int lanes = 1;
  while (lanes < quads && lanes < 32) lanes *= 2;
  return lanes;
}

struct Args {
  const uint8_t* data;
  const float* scale;
  const float* shift;
  const int32_t* ids;
  const float* coeff;
  float* out;
  int64_t R, D, NB, L;
  cudaStream_t stream;
};

template <int kBits, Access kAcc, int kGroup, bool kPooled>
int launch_narrow_as(const Args& a) {
  constexpr int kBags = 32 / kGroup;
  const int64_t warps = (a.NB + kBags - 1) / kBags;
  const dim3 grid((unsigned)((warps + kWarpsPerBlock - 1) / kWarpsPerBlock));
  // the output's stores: float4s, float2 pairs or elements
  const uintptr_t o = (uintptr_t)a.out;
  const int out_form = a.D % 4 == 0 && o % 16 == 0 ? 2
                       : a.D % 2 == 0 && o % 8 == 0 ? 1 : 0;
  quant_lookup_narrow_kernel<kBits, kAcc, kGroup, kPooled>
      <<<grid, 32 * kWarpsPerBlock, 0, a.stream>>>(
          a.data, a.scale, a.shift, a.ids, a.coeff, a.out, a.R, a.D, a.NB,
          a.L, out_form);
  return (int)cudaGetLastError();
}

template <int kBits, Access kAcc, bool kPooled>
int launch_narrow_group(const Args& a, int group) {
  switch (group) {
    case 1:
      return launch_narrow_as<kBits, kAcc, 1, kPooled>(a);
    case 2:
      return launch_narrow_as<kBits, kAcc, 2, kPooled>(a);
    case 4:
      return launch_narrow_as<kBits, kAcc, 4, kPooled>(a);
    case 8:
      return launch_narrow_as<kBits, kAcc, 8, kPooled>(a);
    case 16:
      return launch_narrow_as<kBits, kAcc, 16, kPooled>(a);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The narrow launch: the access the packed rows allow (D and the data's
// alignment), then the lane group.
template <int kBits, bool kPooled>
int launch_narrow(const Args& a, int group) {
  const uintptr_t p = (uintptr_t)a.data;
  if constexpr (kBits == 2) {
    return launch_narrow_group<2, Access::kQuad, kPooled>(a, group);
  } else if constexpr (kBits == 4) {
    if (a.D % 4 == 0 && p % 2 == 0)
      return launch_narrow_group<4, Access::kQuad, kPooled>(a, group);
    return launch_narrow_group<4, Access::kPair, kPooled>(a, group);
  } else {
    if (a.D % 4 == 0 && p % 4 == 0)
      return launch_narrow_group<8, Access::kQuad, kPooled>(a, group);
    if (a.D % 2 == 0 && p % 2 == 0)
      return launch_narrow_group<8, Access::kPair, kPooled>(a, group);
    return launch_narrow_group<8, Access::kElem, kPooled>(a, group);
  }
}

template <int kBits, bool kPooled>
int launch(const void* data, const void* scale, const void* shift,
           const void* ids, const void* coeff, void* out, int64_t R,
           int64_t D, int64_t NB, int64_t L, int group, void* stream) {
  if (D < 1 || group != lanes_per_row(D)) return (int)cudaErrorInvalidValue;
  if (group < 32) {
    return launch_narrow<kBits, kPooled>(
        Args{static_cast<const uint8_t*>(data),
             static_cast<const float*>(scale),
             static_cast<const float*>(shift),
             static_cast<const int32_t*>(ids),
             static_cast<const float*>(coeff), static_cast<float*>(out), R,
             D, NB, L, static_cast<cudaStream_t>(stream)},
        group);
  }
  // the vector path reads 4 columns as one aligned word and writes a float4
  const int64_t word = 4 * kBits / 8;
  const bool vec = (D % 4 == 0) && ((uintptr_t)data % word == 0) &&
                   ((uintptr_t)out % 16 == 0);
  const int64_t cols = vec ? D / 4 : D;
  dim3 grid((unsigned)((NB + kWarpsPerBlock - 1) / kWarpsPerBlock),
            (unsigned)((cols + 31) / 32));
  dim3 block(32 * kWarpsPerBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* dp = static_cast<const uint8_t*>(data);
  const float* sp = static_cast<const float*>(scale);
  const float* hp = static_cast<const float*>(shift);
  const int32_t* ip = static_cast<const int32_t*>(ids);
  const float* cp = static_cast<const float*>(coeff);
  float* op = static_cast<float*>(out);
  if (vec) {
    quant_lookup_kernel<kBits, true, kPooled><<<grid, block, 0, s>>>(
        dp, sp, hp, ip, cp, op, R, D, NB, L);
  } else {
    quant_lookup_kernel<kBits, false, kPooled><<<grid, block, 0, s>>>(
        dp, sp, hp, ip, cp, op, R, D, NB, L);
  }
  return (int)cudaGetLastError();
}

template <bool kPooled>
int dispatch(const void* data, const void* scale, const void* shift,
             const void* ids, const void* coeff, void* out, int64_t R,
             int64_t D, int64_t NB, int64_t L, int bits, int group,
             void* stream) {
  switch (bits) {
    case 8:
      return launch<8, kPooled>(data, scale, shift, ids, coeff, out, R, D,
                                NB, L, group, stream);
    case 4:
      return launch<4, kPooled>(data, scale, shift, ids, coeff, out, R, D,
                                NB, L, group, stream);
    case 2:
      return launch<2, kPooled>(data, scale, shift, ids, coeff, out, R, D,
                                NB, L, group, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Pooled: ids and coeff [NB, L]; out [NB, D] f32. `group`: lanes per row,
// lanes_per_row(D) (ops/lane_groups.py); any other value is refused.
// Returns cudaGetLastError() after the launch (0 on success).
int trt_quant_lookup_pooled(const void* data, const void* scale,
                            const void* shift, const void* ids,
                            const void* coeff, void* out, int64_t R,
                            int64_t D, int64_t NB, int64_t L, int bits,
                            int group, void* stream) {
  return dispatch<true>(data, scale, shift, ids, coeff, out, R, D, NB, L,
                        bits, group, stream);
}

// Unpooled: ids [N], coeff [N] or null; out [N, D] f32.
int trt_quant_lookup_rows(const void* data, const void* scale,
                          const void* shift, const void* ids,
                          const void* coeff, void* out, int64_t R, int64_t D,
                          int64_t N, int bits, int group, void* stream) {
  return dispatch<false>(data, scale, shift, ids, coeff, out, R, D, N, 1,
                         bits, group, stream);
}

const char* trt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
