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
//
// The routed gather (trt_routed_gather_rows_f32) is K8 redesigned for the
// sharded sequence path, RwSequenceEmbeddingSharding.forward. There the TPU
// path is the route (torchrec_tpu/parallel/strategies.py:829-836), then
// `gather_rows` (pallas_embedding.py:121), then `rows * owned`
// (sequence_strategies.py:110). For ids [F, B, L], lengths [F, B],
// per-feature shard rows sr[F] and local offsets off[F]:
//
//   owner = floor(id / sr[f]);  local = (id mod sr[f]) + off[f]
//   owned = (owner == rank) & (l < lengths[f, b])
//   out[f, b, l, :] = owned ? W[clamp(local, 0, R - 1), :] : 0
//
// with Python's floor division and modulo, as torch.div(rounding_mode=
// "floor") and torch.remainder compute them: C++ truncates toward zero, so
// a negative id would otherwise get owner 0 and be owned on rank 0.
//
// Bound: bytes, as K8. On this card the gather at the path's shape takes
// one launch's latency; the torch ops of the route, the mask and the
// multiply around it were nine more launches. So one launch does all of
// it: each row's lanes route their token from ids[n], lengths[f, b],
// sr[f] and off[f], with f, b and l from n through B * L and L, and then
// copy the row or write zeros. A masked token reads no row of W. The
// layout is K8's (lanes per row, float4 per lane, the scalar path).
// With W and out null the kernel routes only, one thread per token, and
// writes `local` (int32) and `owned` (one byte, 0 or 1): the fused
// update's inputs, in one launch.

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

template <typename T>
__device__ __forceinline__ T zero_value();
template <>
__device__ __forceinline__ float zero_value<float>() { return 0.0f; }
template <>
__device__ __forceinline__ float4 zero_value<float4>() {
  return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

// Thread t serves token n = t >> log_tpr, lane t & (tpr - 1) of its row.
// w / out null: route only; local / owned null: not written.
template <typename T>
__global__ void routed_gather_kernel(
    const T* __restrict__ w, const int32_t* __restrict__ ids,
    const int32_t* __restrict__ lengths, const int32_t* __restrict__ sr,
    const int32_t* __restrict__ off, T* __restrict__ out,
    int32_t* __restrict__ local_out, uint8_t* __restrict__ owned_out,
    int64_t R, int64_t cols, int64_t N, int64_t B, int64_t L, int64_t rank,
    int log_tpr) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t n = t >> log_tpr;
  if (n >= N) return;
  const int64_t fb = n / L;  // f * B + b: the token's row of `lengths`
  const int64_t l = n - fb * L;
  const int64_t f = fb / B;
  const int32_t id = ids[n];
  const int32_t s = sr[f];  // > 0: ceil(rows / n) of a table
  int32_t q = id / s;
  int32_t r = id - q * s;
  if (r != 0 && ((r < 0) != (s < 0))) {  // floor, not truncation
    q -= 1;
    r += s;
  }
  // int32 wrap-around, as torch's int32 add
  const int32_t local = (int32_t)((uint32_t)r + (uint32_t)off[f]);
  const bool owned = (int64_t)q == rank && l < (int64_t)lengths[fb];
  const int64_t lane = t & (((int64_t)1 << log_tpr) - 1);
  if (lane == 0) {
    if (local_out != nullptr) local_out[n] = local;
    if (owned_out != nullptr) owned_out[n] = owned ? 1 : 0;
  }
  if (out == nullptr) return;
  const int64_t tpr = (int64_t)1 << log_tpr;
  T* dst = out + n * cols;
  if (owned) {
    const int64_t row = local < 0 ? 0 : (local >= R ? R - 1 : local);
    const T* src = w + row * cols;
    for (int64_t c = lane; c < cols; c += tpr) dst[c] = __ldg(src + c);
  } else {
    const T z = zero_value<T>();
    for (int64_t c = lane; c < cols; c += tpr) dst[c] = z;
  }
}

// Lanes per row: the smallest power of two covering `cols`, at most 32.
int lanes_log2(int64_t cols) {
  int log_tpr = 0;
  while (log_tpr < 5 && ((int64_t)1 << log_tpr) < cols) ++log_tpr;
  return log_tpr;
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 on success).
int trt_gather_rows_f32(const void* w, const void* ids, void* out, int64_t R,
                        int64_t D, int64_t N, void* stream) {
  const bool vec = (D % 4 == 0) && ((uintptr_t)w % 16 == 0) &&
                   ((uintptr_t)out % 16 == 0);
  const int64_t cols = vec ? D / 4 : D;
  const int log_tpr = lanes_log2(cols);
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

// The routed gather over ids [F, B, L]: w [R, D] and out [F, B, L, D] f32,
// or both null for the route alone; local [F, B, L] int32 and owned
// [F, B, L] bytes, each optional. Returns cudaGetLastError() after the
// launch (0 on success).
int trt_routed_gather_rows_f32(const void* w, const void* ids,
                               const void* lengths, const void* shard_rows,
                               const void* local_off, void* out, void* local,
                               void* owned, int64_t R, int64_t D, int64_t F,
                               int64_t B, int64_t L, int64_t rank,
                               void* stream) {
  const int64_t N = F * B * L;
  const bool rows = out != nullptr;
  const bool vec = rows && (D % 4 == 0) && ((uintptr_t)w % 16 == 0) &&
                   ((uintptr_t)out % 16 == 0);
  const int64_t cols = vec ? D / 4 : D;
  const int log_tpr = rows ? lanes_log2(cols) : 0;
  const int64_t threads = N << log_tpr;
  const dim3 grid((unsigned)((threads + kThreads - 1) / kThreads));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* idp = static_cast<const int32_t*>(ids);
  const int32_t* lenp = static_cast<const int32_t*>(lengths);
  const int32_t* srp = static_cast<const int32_t*>(shard_rows);
  const int32_t* offp = static_cast<const int32_t*>(local_off);
  int32_t* localp = static_cast<int32_t*>(local);
  uint8_t* ownedp = static_cast<uint8_t*>(owned);
  if (vec) {
    routed_gather_kernel<float4><<<grid, kThreads, 0, s>>>(
        static_cast<const float4*>(w), idp, lenp, srp, offp,
        static_cast<float4*>(out), localp, ownedp, R, cols, N, B, L, rank,
        log_tpr);
  } else {
    routed_gather_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(w), idp, lenp, srp, offp,
        static_cast<float*>(out), localp, ownedp, R, cols, N, B, L, rank,
        log_tpr);
  }
  return (int)cudaGetLastError();
}

const char* trt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
