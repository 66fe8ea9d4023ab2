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
//   * One warp per bag and column chunk. With D % 4 == 0 each lane moves one
//     16-byte float4 of a row, so a warp reads 512 contiguous bytes of a
//     row in one coalesced request (a D=128 f32 row is exactly 512 bytes).
//   * The L coefficients and ids of a bag are loaded once by the warp, 32
//     at a time (one per lane), and broadcast with shuffles.
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
// The kernel launches on the caller's stream, allocates nothing and does
// not synchronise; the Python wrapper allocates `out`.

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

template <typename T>
int launch(const void* w, const void* ids, const void* coeff, void* out,
           int64_t R, int64_t D, int64_t NB, int64_t L, void* stream) {
  // the vector path reads 4 row elements at once: 16 bytes of f32 or 8 of
  // a half type, aligned to their size
  const bool vec = (D % 4 == 0) && ((uintptr_t)w % (4 * sizeof(T)) == 0) &&
                   ((uintptr_t)out % 16 == 0);
  const int64_t cols = vec ? D / 4 : D;
  dim3 grid((unsigned)((NB + kWarpsPerBlock - 1) / kWarpsPerBlock),
            (unsigned)((cols + 31) / 32));
  dim3 block(32 * kWarpsPerBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* wt = static_cast<const T*>(w);
  const int32_t* idp = static_cast<const int32_t*>(ids);
  const float* cf = static_cast<const float*>(coeff);
  float* of = static_cast<float*>(out);
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
int trt_tbe_lookup_pooled_f32(const void* w, const void* ids,
                              const void* coeff, void* out, int64_t R,
                              int64_t D, int64_t NB, int64_t L,
                              void* stream) {
  return launch<float>(w, ids, coeff, out, R, D, NB, L, stream);
}

// K1h: `half` 0 for bf16 rows, 1 for fp16 rows; out is f32.
int trt_tbe_lookup_pooled_half(const void* w, const void* ids,
                               const void* coeff, void* out, int64_t R,
                               int64_t D, int64_t NB, int64_t L, int half,
                               void* stream) {
  if (half == 0)
    return launch<__nv_bfloat16>(w, ids, coeff, out, R, D, NB, L, stream);
  if (half == 1) return launch<__half>(w, ids, coeff, out, R, D, NB, L, stream);
  return (int)cudaErrorInvalidValue;
}

const char* trt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
