// K2-K5: the fused embedding-update kernels for Hopper (sm_90a).
//
//   K2 scatter_rows_write    W[id_t] = rows[t]
//   K3 fused_update_sgd      W[id_t] = W[id_t] - lr * (g[t] + wd * W[id_t])
//   K4 scaled row update     W[id_t] = W[id_t] + scale[t] * g[t]
//   K5 rowwise momentum      m[u] += sum of a run's g_sq;
//                            inv[p] = -1 / (sqrt(m_new[uids[p]]) + eps)
//
// each for every slot t whose id is a real row (0 <= id < R). Slots whose id
// is a sentinel (2^31 - 1 from run_total_row_grads, R + pos from
// dedup_row_grads) are skipped before any read of their g, rows or scale.
// Tables and momentum are updated in place.
//
// Replaces, in torchrec_tpu/ops/pallas_embedding.py:
//   K2 `scatter_rows_write` / `_scatter_write_kernel` (:154-227)
//   K3 `fused_update_sgd` / `_sgd_kernel` (:457-475, :577-614)
//   K4 the scaled RMW of `fused_update_rowwise_adagrad`,
//      `_scaled_update_kernel` (:477-500, :706-733)
//   K5 `rowwise_momentum_stream` / `_rowwise_mom_stream_kernel`
//      (:737-1030)
// They compute the same functions. None of the TPU's machinery is carried
// over: the DMA waves capped by 256 semaphores, the SMEM id budget, and
// K5's one-hot MXU matmuls over [TB, 128] momentum tiles with their
// contribution windows and `overflowed` fallback. Any N, R and D % 4 == 0
// are taken, and K5 cannot overflow.
//
// Bound: bytes. K2-K4 move whole 512-byte rows of a D=128 f32 table at
// random places and do 1-4 flops per element moved; K5 moves 4-byte momentum
// words and does a sqrt and a divide per row. Both are far below the card's
// ~20 fp32 flops per byte, so the least time is the bytes over the memory
// rate. What the design does about it:
//   * K2-K4: one warp takes 32 consecutive slots. Lane i loads slot i's id
//     (and K4's scale) once; the warp walks the 32 slots, broadcasting each
//     id with a shuffle, and moves each real slot's row with every lane
//     holding one 16-byte float4, so a 512-byte row is one coalesced request
//     (wider rows loop over 512-byte chunks). A sentinel slot costs only its
//     4-byte id.
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

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kMomentumThreads = 256;
constexpr unsigned kFullMask = 0xffffffffu;

enum class RowOp { kWrite, kSgd, kScaled };

__device__ __forceinline__ bool is_real(int32_t id, int64_t R) {
  return id >= 0 && static_cast<int64_t>(id) < R;
}

template <RowOp kOp>
__device__ __forceinline__ float row_op(float w, float x, float lr, float wd,
                                        float s) {
  if (kOp == RowOp::kWrite) return x;
  if (kOp == RowOp::kScaled) return __fadd_rn(w, __fmul_rn(s, x));
  const float g = wd != 0.f ? __fadd_rn(x, __fmul_rn(wd, w)) : x;
  return __fsub_rn(w, __fmul_rn(lr, g));
}

// src is `rows` (K2) or `g` (K3, K4), [N, D]; scale is K4's [N].
template <RowOp kOp>
__global__ void row_update_kernel(float* __restrict__ w,
                                  const int32_t* __restrict__ uids,
                                  const float* __restrict__ src,
                                  const float* __restrict__ scale, int64_t R,
                                  int64_t D, int64_t N, float lr, float wd) {
  const int lane = threadIdx.x & 31;
  const int64_t warp =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  const int64_t base = warp * 32;
  if (base >= N) return;  // whole warp leaves together
  const int n = static_cast<int>(N - base < 32 ? N - base : 32);
  int32_t my_id = -1;
  float my_s = 0.f;
  if (lane < n) {
    my_id = uids[base + lane];
    if (kOp == RowOp::kScaled && is_real(my_id, R)) my_s = scale[base + lane];
  }
  const int64_t cols = D / 4;
  for (int j = 0; j < n; ++j) {
    const int32_t id = __shfl_sync(kFullMask, my_id, j);
    const float s = __shfl_sync(kFullMask, my_s, j);
    if (!is_real(id, R)) continue;  // the same for the whole warp
    float4* wrow = reinterpret_cast<float4*>(w + static_cast<int64_t>(id) * D);
    const float4* srow = reinterpret_cast<const float4*>(src + (base + j) * D);
    for (int64_t c = lane; c < cols; c += 32) {
      const float4 x = __ldg(srow + c);
      float4 v;
      if (kOp == RowOp::kWrite) {
        v = x;
      } else {
        v = wrow[c];
        v.x = row_op<kOp>(v.x, x.x, lr, wd, s);
        v.y = row_op<kOp>(v.y, x.y, lr, wd, s);
        v.z = row_op<kOp>(v.z, x.z, lr, wd, s);
        v.w = row_op<kOp>(v.w, x.w, lr, wd, s);
      }
      wrow[c] = v;
    }
  }
}

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

template <RowOp kOp>
int launch_rows(void* w, const void* uids, const void* src, const void* scale,
                int64_t R, int64_t D, int64_t N, float lr, float wd,
                void* stream) {
  const int64_t warps = (N + 31) / 32;
  const dim3 grid(
      static_cast<unsigned>((warps + kWarpsPerBlock - 1) / kWarpsPerBlock));
  row_update_kernel<kOp><<<grid, 32 * kWarpsPerBlock, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(w), static_cast<const int32_t*>(uids),
      static_cast<const float*>(src), static_cast<const float*>(scale), R, D,
      N, lr, wd);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int trt_scatter_rows_write_f32(void* w, const void* uids, const void* rows,
                               int64_t R, int64_t D, int64_t N,
                               void* stream) {
  return launch_rows<RowOp::kWrite>(w, uids, rows, nullptr, R, D, N, 0.f,
                                    0.f, stream);
}

int trt_fused_update_sgd_f32(void* w, const void* uids, const void* g,
                             int64_t R, int64_t D, int64_t N, float lr,
                             float wd, void* stream) {
  return launch_rows<RowOp::kSgd>(w, uids, g, nullptr, R, D, N, lr, wd,
                                  stream);
}

int trt_scaled_row_update_f32(void* w, const void* uids, const void* g,
                              const void* scale, int64_t R, int64_t D,
                              int64_t N, void* stream) {
  return launch_rows<RowOp::kScaled>(w, uids, g, scale, R, D, N, 0.f, 0.f,
                                     stream);
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

const char* trt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
