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
// What the design does about it:
//   * A row of D columns has quads = ceil(D / 4) quads of 4 floats and
//     takes G lanes, the smallest power of two >= quads, at most 32: the
//     lane groups of K1 and the update kernels. The wrapper picks G from D
//     (ops/lane_groups.py) and passes it in; the C entry points refuse any
//     other G.
//   * Narrow rows (D <= 64, G < 32): a warp holds 32 / G lane groups, one
//     row each at a time, and each group copies 4 rows in turn (kTurns):
//     32 rows of 40 bytes a warp at D=10, 8 rows of 256 bytes at D=64.
//     A lane moves quad l % G of each of its rows, with the row kernel's
//     three accesses: one 16-byte float4 (D % 4 == 0 and 16-byte aligned
//     pointers), two 8-byte float2 pairs (an even D and 8-byte aligned
//     pointers: a D=10 row is 40 bytes at an 8-byte aligned offset), or
//     element by element; past D it reads and writes nothing. A lane
//     loads its 4 ids, then its 4 rows' quads, then stores them: the
//     gather is latency-bound at these widths (a row is one or two
//     sectors), and 4 rows in flight a lane beat one a lane by 5-11 % on
//     an H100 (PERF.md §6). There is no quad loop: at G < 32 a lane
//     holds one quad of a row.
//   * Rows wider than 64 columns (G = 32): a warp a row, one float4 (D % 4
//     == 0 and 16-byte aligned pointers) or one float per lane, looping
//     over 32 of them.
//   * The lanes of a group load each of its rows' ids from the same
//     address: a turn's load of the warp touches 32 / G consecutive ids.
//   * Rows are read through the read-only path (__ldg) and written once;
//     nothing is staged in shared memory, since nothing is reused. Row
//     offsets are 64-bit: R * D can pass 2^31 elements.
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
// layout is K8's: G lanes a token at D <= 64, each a quad with the three
// accesses, a warp a token past that. The route's divisions by L and B
// are 32-bit where the token count allows it (a 64-bit divide is a long
// software routine on this card).
// With W and out null the kernel routes only, one thread per token (G =
// 1), and writes `local` (int32) and `owned` (one byte, 0 or 1): the
// fused update's inputs, in one launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// -- rows wider than 64 columns: a warp a row -------------------------------

// T is float4 on the vector path and float otherwise; `cols` counts T's per
// row. Thread t serves row t >> log_tpr, lane t & (tpr - 1) of it. The
// launcher passes log_tpr = 5: a constant 32 in its place made the kernel
// 31 % slower at D=128 on an H100 (PERF.md §6).
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

// Token n of [F, B, L] as (f * B + b, l, f): 32-bit divisions when the
// token count N fits in 32 bits.
__device__ __forceinline__ void token_coords(int64_t n, int64_t N, int64_t B,
                                             int64_t L, int64_t& fb,
                                             int64_t& l, int64_t& f) {
  if (N <= (int64_t)UINT32_MAX) {
    const uint32_t fb32 = (uint32_t)n / (uint32_t)L;
    l = (int64_t)((uint32_t)n - fb32 * (uint32_t)L);
    f = (int64_t)(fb32 / (uint32_t)B);
    fb = (int64_t)fb32;
  } else {
    fb = n / L;
    l = n - fb * L;
    f = fb / B;
  }
}

// The route of token n (see the note at the top): its row in the owner's
// packed shard, and whether this rank owns it and it is not padding.
__device__ __forceinline__ bool route(const int32_t* __restrict__ ids,
                                      const int32_t* __restrict__ lengths,
                                      const int32_t* __restrict__ sr,
                                      const int32_t* __restrict__ off,
                                      int64_t n, int64_t N, int64_t B,
                                      int64_t L, int64_t rank,
                                      int32_t& local) {
  int64_t fb, l, f;
  token_coords(n, N, B, L, fb, l, f);
  const int32_t id = ids[n];
  const int32_t s = sr[f];  // > 0: ceil(rows / n) of a table
  int32_t q = id / s;
  int32_t r = id - q * s;
  if (r != 0 && ((r < 0) != (s < 0))) {  // floor, not truncation
    q -= 1;
    r += s;
  }
  // int32 wrap-around, as torch's int32 add
  local = (int32_t)((uint32_t)r + (uint32_t)off[f]);
  return (int64_t)q == rank && l < (int64_t)lengths[fb];
}

// Thread t serves token n = t >> log_tpr, lane t & (tpr - 1) of its row
// (log_tpr = 5, as gather_rows_kernel).
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
  int32_t local;
  const bool owned = route(ids, lengths, sr, off, n, N, B, L, rank, local);
  const int64_t lane = t & (((int64_t)1 << log_tpr) - 1);
  if (lane == 0) {
    if (local_out != nullptr) local_out[n] = local;
    if (owned_out != nullptr) owned_out[n] = owned ? 1 : 0;
  }
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

// -- narrow rows (D <= 64): G lanes a row, a quad a lane --------------------

// How a lane moves its quad of 4 columns: whole (D % 4 == 0, 16-byte
// aligned pointers), as two pairs (an even D, 8-byte aligned pointers), or
// element by element; past D nothing is read or written.
enum class Access { kQuad, kPair, kElem };

template <Access kAcc>
__device__ __forceinline__ float4 load_quad(const float* row, int64_t c,
                                            int64_t D) {
  if constexpr (kAcc == Access::kQuad) {
    return __ldg(reinterpret_cast<const float4*>(row + c));
  } else if constexpr (kAcc == Access::kPair) {
    const float2 a = __ldg(reinterpret_cast<const float2*>(row + c));
    const float2 b = c + 2 < D
                         ? __ldg(reinterpret_cast<const float2*>(row + c + 2))
                         : make_float2(0.f, 0.f);
    return make_float4(a.x, a.y, b.x, b.y);
  } else {
    return make_float4(__ldg(row + c), c + 1 < D ? __ldg(row + c + 1) : 0.f,
                       c + 2 < D ? __ldg(row + c + 2) : 0.f,
                       c + 3 < D ? __ldg(row + c + 3) : 0.f);
  }
}

template <Access kAcc>
__device__ __forceinline__ void store_quad(float* row, int64_t c, int64_t D,
                                           float4 v) {
  if constexpr (kAcc == Access::kQuad) {
    *reinterpret_cast<float4*>(row + c) = v;
  } else if constexpr (kAcc == Access::kPair) {
    *reinterpret_cast<float2*>(row + c) = make_float2(v.x, v.y);
    if (c + 2 < D) {
      *reinterpret_cast<float2*>(row + c + 2) = make_float2(v.z, v.w);
    }
  } else {
    row[c] = v.x;
    if (c + 1 < D) row[c + 1] = v.y;
    if (c + 2 < D) row[c + 2] = v.z;
    if (c + 3 < D) row[c + 3] = v.w;
  }
}

__host__ __device__ constexpr int log2_of(int g) {
  return g > 1 ? 1 + log2_of(g / 2) : 0;
}

// Rows a lane group copies in turn: a warp copies kTurns * 32 / kGroup
// rows, all its loads issued before its first store.
constexpr int kTurns = 4;

// Lane l of warp w copies quad l % kGroup of rows base + k * P, k <
// kTurns, where P = 32 / kGroup and base = w * P * kTurns + l / kGroup: the
// warp's P groups take P consecutive rows at each turn, so each turn's
// stores are one contiguous run of P rows.
template <Access kAcc, int kGroup>
__global__ void gather_rows_narrow_kernel(const float* __restrict__ w,
                                          const int32_t* __restrict__ ids,
                                          float* __restrict__ out, int64_t R,
                                          int64_t D, int64_t N) {
  constexpr int kP = 32 / kGroup;
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = (int)(t & 31);
  const int64_t c = 4 * (lane & (kGroup - 1));
  if (c >= D) return;
  const int64_t base = (t >> 5) * (kP * kTurns) + lane / kGroup;
  int64_t id[kTurns];
#pragma unroll
  for (int k = 0; k < kTurns; ++k) {
    const int64_t n = base + k * kP;
    const int64_t raw = n < N ? ids[n] : 0;
    id[k] = raw < 0 ? 0 : (raw >= R ? R - 1 : raw);
  }
  float4 v[kTurns];
#pragma unroll
  for (int k = 0; k < kTurns; ++k) {
    if (base + k * kP < N) v[k] = load_quad<kAcc>(w + id[k] * D, c, D);
  }
#pragma unroll
  for (int k = 0; k < kTurns; ++k) {
    const int64_t n = base + k * kP;
    if (n < N) store_quad<kAcc>(out + n * D, c, D, v[k]);
  }
}

// Thread t serves quad t % kGroup of token t / kGroup; kGroup = 1 with w and
// out null is the route-only mode.
template <Access kAcc, int kGroup>
__global__ void routed_gather_narrow_kernel(
    const float* __restrict__ w, const int32_t* __restrict__ ids,
    const int32_t* __restrict__ lengths, const int32_t* __restrict__ sr,
    const int32_t* __restrict__ off, float* __restrict__ out,
    int32_t* __restrict__ local_out, uint8_t* __restrict__ owned_out,
    int64_t R, int64_t D, int64_t N, int64_t B, int64_t L, int64_t rank) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t n = t >> log2_of(kGroup);
  const int sub = (int)(t & (kGroup - 1));
  if (n >= N) return;
  int32_t local;
  const bool owned = route(ids, lengths, sr, off, n, N, B, L, rank, local);
  if (sub == 0) {
    if (local_out != nullptr) local_out[n] = local;
    if (owned_out != nullptr) owned_out[n] = owned ? 1 : 0;
  }
  const int64_t c = 4 * (int64_t)sub;
  if (out == nullptr || c >= D) return;
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (owned) {
    const int64_t row = local < 0 ? 0 : (local >= R ? R - 1 : local);
    v = load_quad<kAcc>(w + row * D, c, D);
  }
  store_quad<kAcc>(out + n * D, c, D, v);
}

// G for a row of D columns: the smallest power of two >= ceil(D / 4), at
// most 32 (ops/lane_groups.py).
int lanes_per_row(int64_t D) {
  const int64_t quads = (D + 3) / 4;
  int lanes = 1;
  while (lanes < quads && lanes < 32) lanes *= 2;
  return lanes;
}

Access pick_access(int64_t D, const void* w, const void* out) {
  const uintptr_t a = (uintptr_t)w | (uintptr_t)out;
  if (D % 4 == 0 && a % 16 == 0) return Access::kQuad;
  if (D % 2 == 0 && a % 8 == 0) return Access::kPair;
  return Access::kElem;
}

dim3 grid_of(int64_t threads) {
  return dim3((unsigned)((threads + kThreads - 1) / kThreads));
}

template <int kGroup>
void launch_gather_narrow(Access acc, const float* w, const int32_t* ids,
                          float* out, int64_t R, int64_t D, int64_t N,
                          cudaStream_t s) {
  constexpr int64_t kRows = 32 / kGroup * kTurns;  // a warp's
  const dim3 grid = grid_of((N + kRows - 1) / kRows * 32);
  if (acc == Access::kQuad) {
    gather_rows_narrow_kernel<Access::kQuad, kGroup>
        <<<grid, kThreads, 0, s>>>(w, ids, out, R, D, N);
  } else if (acc == Access::kPair) {
    gather_rows_narrow_kernel<Access::kPair, kGroup>
        <<<grid, kThreads, 0, s>>>(w, ids, out, R, D, N);
  } else {
    gather_rows_narrow_kernel<Access::kElem, kGroup>
        <<<grid, kThreads, 0, s>>>(w, ids, out, R, D, N);
  }
}

struct Routed {
  const float* w;
  const int32_t* ids;
  const int32_t* lengths;
  const int32_t* sr;
  const int32_t* off;
  float* out;
  int32_t* local;
  uint8_t* owned;
  int64_t R, D, N, B, L, rank;
};

template <Access kAcc, int kGroup>
void launch_routed_as(const Routed& a, cudaStream_t s) {
  routed_gather_narrow_kernel<kAcc, kGroup>
      <<<grid_of(a.N * kGroup), kThreads, 0, s>>>(
          a.w, a.ids, a.lengths, a.sr, a.off, a.out, a.local, a.owned, a.R,
          a.D, a.N, a.B, a.L, a.rank);
}

template <int kGroup>
void launch_routed_narrow(Access acc, const Routed& a, cudaStream_t s) {
  if (acc == Access::kQuad) {
    launch_routed_as<Access::kQuad, kGroup>(a, s);
  } else if (acc == Access::kPair) {
    launch_routed_as<Access::kPair, kGroup>(a, s);
  } else {
    launch_routed_as<Access::kElem, kGroup>(a, s);
  }
}

}  // namespace

extern "C" {

// `group`: lanes per row, lanes_per_row(D) (ops/lane_groups.py); any other
// value is refused. Returns cudaGetLastError() after the launch (0 on
// success).
int trt_gather_rows_f32(const void* w, const void* ids, void* out, int64_t R,
                        int64_t D, int64_t N, int group, void* stream) {
  if (D < 1 || group != lanes_per_row(D)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  const int32_t* idp = static_cast<const int32_t*>(ids);
  float* of = static_cast<float*>(out);
  const Access acc = pick_access(D, w, out);
  switch (group) {
    case 1:
      launch_gather_narrow<1>(acc, wf, idp, of, R, D, N, s);
      break;
    case 2:
      launch_gather_narrow<2>(acc, wf, idp, of, R, D, N, s);
      break;
    case 4:
      launch_gather_narrow<4>(acc, wf, idp, of, R, D, N, s);
      break;
    case 8:
      launch_gather_narrow<8>(acc, wf, idp, of, R, D, N, s);
      break;
    case 16:
      launch_gather_narrow<16>(acc, wf, idp, of, R, D, N, s);
      break;
    default: {  // 32: a warp a row
      const dim3 grid = grid_of(N << 5);
      if (acc == Access::kQuad) {
        gather_rows_kernel<float4><<<grid, kThreads, 0, s>>>(
            static_cast<const float4*>(w), idp, static_cast<float4*>(out), R,
            D / 4, N, 5);
      } else {
        gather_rows_kernel<float><<<grid, kThreads, 0, s>>>(wf, idp, of, R, D,
                                                            N, 5);
      }
    }
  }
  return (int)cudaGetLastError();
}

// The routed gather over ids [F, B, L]: w [R, D] and out [F, B, L, D] f32
// with group = lanes_per_row(D), or both null with group 1 for the route
// alone; local [F, B, L] int32 and owned [F, B, L] bytes, each optional.
// Returns cudaGetLastError() after the launch (0 on success).
int trt_routed_gather_rows_f32(const void* w, const void* ids,
                               const void* lengths, const void* shard_rows,
                               const void* local_off, void* out, void* local,
                               void* owned, int64_t R, int64_t D, int64_t F,
                               int64_t B, int64_t L, int64_t rank, int group,
                               void* stream) {
  const bool rows = out != nullptr;
  if (rows ? (D < 1 || group != lanes_per_row(D)) : group != 1) {
    return (int)cudaErrorInvalidValue;
  }
  const Routed a{static_cast<const float*>(w),
                 static_cast<const int32_t*>(ids),
                 static_cast<const int32_t*>(lengths),
                 static_cast<const int32_t*>(shard_rows),
                 static_cast<const int32_t*>(local_off),
                 static_cast<float*>(out),
                 static_cast<int32_t*>(local),
                 static_cast<uint8_t*>(owned),
                 R, rows ? D : 0, F * B * L, B, L, rank};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Access acc = rows ? pick_access(D, w, out) : Access::kElem;
  switch (group) {
    case 1:
      launch_routed_narrow<1>(acc, a, s);
      break;
    case 2:
      launch_routed_narrow<2>(acc, a, s);
      break;
    case 4:
      launch_routed_narrow<4>(acc, a, s);
      break;
    case 8:
      launch_routed_narrow<8>(acc, a, s);
      break;
    case 16:
      launch_routed_narrow<16>(acc, a, s);
      break;
    default: {  // 32: a warp a token
      const dim3 grid = grid_of(a.N << 5);
      if (acc == Access::kQuad) {
        routed_gather_kernel<float4><<<grid, kThreads, 0, s>>>(
            static_cast<const float4*>(w), a.ids, a.lengths, a.sr, a.off,
            static_cast<float4*>(out), a.local, a.owned, R, D / 4, a.N, B, L,
            rank, 5);
      } else {
        routed_gather_kernel<float><<<grid, kThreads, 0, s>>>(
            a.w, a.ids, a.lengths, a.sr, a.off, a.out, a.local, a.owned, R, D,
            a.N, B, L, rank, 5);
      }
    }
  }
  return (int)cudaGetLastError();
}

const char* trt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
