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
// The kernel launches on the caller's stream, allocates nothing and does
// not synchronise; the Python wrapper allocates `out`.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFullMask = 0xffffffffu;

template <bool kVec>
__global__ void tbe_lookup_pooled_kernel(const float* __restrict__ w,
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
        const float4 v =
            __ldg(reinterpret_cast<const float4*>(w + row * D) + col);
        acc.x += c * v.x;
        acc.y += c * v.y;
        acc.z += c * v.z;
        acc.w += c * v.w;
      } else {
        acc.x += c * __ldg(w + row * D + col);
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

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 on success).
int trt_tbe_lookup_pooled_f32(const void* w, const void* ids,
                              const void* coeff, void* out, int64_t R,
                              int64_t D, int64_t NB, int64_t L,
                              void* stream) {
  const bool vec = (D % 4 == 0) && ((uintptr_t)w % 16 == 0) &&
                   ((uintptr_t)out % 16 == 0);
  const int64_t cols = vec ? D / 4 : D;
  dim3 grid((unsigned)((NB + kWarpsPerBlock - 1) / kWarpsPerBlock),
            (unsigned)((cols + 31) / 32));
  dim3 block(32 * kWarpsPerBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  const int32_t* idp = static_cast<const int32_t*>(ids);
  const float* cf = static_cast<const float*>(coeff);
  float* of = static_cast<float*>(out);
  if (vec) {
    tbe_lookup_pooled_kernel<true><<<grid, block, 0, s>>>(wf, idp, cf, of, R,
                                                          D, NB, L);
  } else {
    tbe_lookup_pooled_kernel<false><<<grid, block, 0, s>>>(wf, idp, cf, of, R,
                                                           D, NB, L);
  }
  return (int)cudaGetLastError();
}

const char* trt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
