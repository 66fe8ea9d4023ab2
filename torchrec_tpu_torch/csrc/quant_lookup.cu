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
// Design (K1's, csrc/tbe_lookup.cu): one warp per bag and 128-column chunk.
// With D % 4 == 0 each lane owns 4 consecutive columns and reads them as
// one word of 4 * bits bits (a uint32 at int8, a uint16 at int4, a byte at
// int2), unpacks them and accumulates a float4; a D = 128 int8 row is one
// 128-byte request of the warp. Otherwise one lane owns one column and
// reads its byte. The slots' ids and coefficients are loaded once per
// warp, one slot per lane, and broadcast with shuffles; each slot's scale
// and shift are read beside its row (loaded with the ids, they put a
// second dependent load before every row).
// A pooled slot whose coefficient is 0 is not read, as in K1.
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

template <int kBits, bool kPooled>
int launch(const void* data, const void* scale, const void* shift,
           const void* ids, const void* coeff, void* out, int64_t R,
           int64_t D, int64_t NB, int64_t L, void* stream) {
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
             int64_t D, int64_t NB, int64_t L, int bits, void* stream) {
  switch (bits) {
    case 8:
      return launch<8, kPooled>(data, scale, shift, ids, coeff, out, R, D,
                                NB, L, stream);
    case 4:
      return launch<4, kPooled>(data, scale, shift, ids, coeff, out, R, D,
                                NB, L, stream);
    case 2:
      return launch<2, kPooled>(data, scale, shift, ids, coeff, out, R, D,
                                NB, L, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Pooled: ids and coeff [NB, L]; out [NB, D] f32. Returns
// cudaGetLastError() after the launch (0 on success).
int trt_quant_lookup_pooled(const void* data, const void* scale,
                            const void* shift, const void* ids,
                            const void* coeff, void* out, int64_t R,
                            int64_t D, int64_t NB, int64_t L, int bits,
                            void* stream) {
  return dispatch<true>(data, scale, shift, ids, coeff, out, R, D, NB, L,
                        bits, stream);
}

// Unpooled: ids [N], coeff [N] or null; out [N, D] f32.
int trt_quant_lookup_rows(const void* data, const void* scale,
                          const void* shift, const void* ids,
                          const void* coeff, void* out, int64_t R, int64_t D,
                          int64_t N, int bits, void* stream) {
  return dispatch<false>(data, scale, shift, ids, coeff, out, R, D, N, 1,
                         bits, stream);
}

const char* trt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
