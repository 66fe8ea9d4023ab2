// K8: embedding row gather for Hopper (sm_90a).
//
//   out[n, :] = W[clamp(ids[n], 0, R - 1), :]
//
// Replaces the TPU kernel `gather_rows` / `_gather_rows_impl` /
// `_gather_kernel` in torchrec_tpu/ops/pallas_embedding.py:70-146. It
// computes the same function; the TPU kernel's waves of T single-row DMAs
// (T <= 256 semaphores), the scalar-prefetched ids and the padding of N to
// a multiple of T are not carried over, so any N is taken.
//
// Bound: bytes. Per id the kernel reads 4 bytes of id and one row of D
// floats and writes one row; it does no arithmetic on the values. The
// least time is those bytes over the memory rate.
//
// What the design does about it (K1's idiom without the sum):
//   * Each lane moves one 16-byte float4 of a row (D % 4 == 0 and 16-byte
//     aligned rows), so a row is one coalesced request.
//   * A row takes the smallest power of two of lanes that covers its
//     float4s, at most 32; narrow rows share a warp. At D=64 a row is 16
//     float4s, so a warp moves two rows and no lane idles; at D=128 a warp
//     moves one 512-byte row. Rows wider than 32 float4s loop.
//   * Every lane of a row reads the row's id itself: the loads of one
//     address by neighbouring lanes are served by one transaction.
//   * Rows are read through the read-only path (__ldg) and written once;
//     nothing is staged in shared memory, since nothing is reused.
//   * A scalar path (one float per lane) covers D % 4 != 0 and unaligned
//     pointers. Row offsets are 64-bit: R * D can pass 2^31 elements.
// The kernel launches on the caller's stream, allocates nothing and does
// not synchronise; the Python wrapper allocates `out`.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// T is float4 on the vector path and float otherwise; `cols` counts T's per
// row. Thread t serves row t >> log_tpr, lane t & (tpr - 1) of it.
template <typename T>
__global__ void gather_rows_kernel(const T* __restrict__ w,
                                   const int32_t* __restrict__ ids,
                                   T* __restrict__ out, int64_t R,
                                   int64_t cols, int64_t N, int log_tpr) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t n = t >> log_tpr;
  if (n >= N) return;
  const int64_t tpr = (int64_t)1 << log_tpr;
  int64_t id = ids[n];
  id = id < 0 ? 0 : (id >= R ? R - 1 : id);
  const T* src = w + id * cols;
  T* dst = out + n * cols;
  for (int64_t c = t & (tpr - 1); c < cols; c += tpr) {
    dst[c] = __ldg(src + c);
  }
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 on success).
int trt_gather_rows_f32(const void* w, const void* ids, void* out, int64_t R,
                        int64_t D, int64_t N, void* stream) {
  const bool vec = (D % 4 == 0) && ((uintptr_t)w % 16 == 0) &&
                   ((uintptr_t)out % 16 == 0);
  const int64_t cols = vec ? D / 4 : D;
  int log_tpr = 0;
  while (log_tpr < 5 && ((int64_t)1 << log_tpr) < cols) ++log_tpr;
  const int64_t threads = N << log_tpr;
  const dim3 grid((unsigned)((threads + kThreads - 1) / kThreads));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* idp = static_cast<const int32_t*>(ids);
  if (vec) {
    gather_rows_kernel<float4><<<grid, kThreads, 0, s>>>(
        static_cast<const float4*>(w), idp, static_cast<float4*>(out), R,
        cols, N, log_tpr);
  } else {
    gather_rows_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(w), idp, static_cast<float*>(out), R, cols,
        N, log_tpr);
  }
  return (int)cudaGetLastError();
}

const char* trt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
