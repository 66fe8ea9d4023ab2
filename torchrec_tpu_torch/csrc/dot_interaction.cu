// The DLRM's dot interaction, forward and backward, for Hopper (sm_90a).
//
// For each example b, with n = F + 1 and C_b = [dense[b]; sparse[b]] the
// n x D matrix of the dense vector over the F pooled embeddings:
//
//   forward:  out[b] = [dense[b], the upper triangle (offset 1) of
//                       C_b C_b^T in torch.triu_indices(n, n, 1) order]
//   backward: S_b = the symmetric n x n matrix whose (i, j) and (j, i)
//             entries are grad_out[b, D + p(i, j)], zero on the diagonal;
//             dC_b = S_b C_b,
//             d_dense[b] = grad_out[b, :D] + dC_b[0], d_sparse[b] = dC_b[1:]
//
// Replaces no `pl.pallas_call`: the JAX package's InteractionArch
// (torchrec_tpu/models/dlrm.py:73-80) is a jnp.einsum and a triu_indices
// gather that it leaves to XLA. Here one kernel a direction takes the place
// of the port's composition: the torch.cat that built C, the Gram
// torch.bmm, the gather gram[:, iu, ju] with its torch.triu_indices, and
// the output's torch.cat; in the backward PyTorch's sorted index_put_ (the
// gather's backward), the two products of the bmm's backward and the cats'
// backward.
//
// Bound: bytes. At the Criteo Kaggle DLRM's B = 65,536, n = 27, D = 64 the
// forward reads C (453 MB) and writes the [B, 64 + 351] output (109 MB),
// 0.168 ms at 3.35 TB/s; the backward reads grad_out (109 MB) and C
// (453 MB) and writes dC (453 MB), 0.303 ms. The arithmetic is 351 + 729
// dot products of length 64 an example, about 9 GFLOP a step, 0.14 ms of
// f32 FMA: bound by memory.
//
// What the design does about it:
//   * One warp an example, four a block. Its C is staged in shared memory
//     one chunk of 64 columns at a time (a row 68 floats apart, so that
//     consecutive rows start in different banks), read once from device
//     memory by asynchronous copies (cp.async) that a lane issues back to
//     back and waits for once: one 16-byte float4 a lane, 16 lanes a row
//     (D % 4 == 0 and 16-byte aligned pointers, as every DLRM of the
//     repository has), else one element a lane. Columns past D
//     read as zeros. Nothing of size n x n or B x n x D goes to device
//     memory: no C, no Gram matrix, no index tensor.
//   * Forward: the rows fall into G = ceil(n / 4) groups of four,
//     interleaved (group I holds rows I, I + G, I + 2G, I + 3G), and a lane
//     forms the 4 x 4 products of two groups I <= J in registers: per four
//     columns it reads 8 float4s and makes 64 FMAs. With the interleave,
//     the lanes of a warp read G distinct rows at a time, consecutive ones,
//     so a read is a broadcast without bank conflicts. At n = 27 the 28
//     group pairs fit one warp. The products go to shared memory at their
//     triu positions and the warp writes the output row once, coalesced.
//   * Every product is one FMA chain over ascending d from 0, in f32, as a
//     SIMT GEMM thread sums it (no TF32, no tensor cores); the Gram is
//     symmetric, so the product of rows i and j is the same number either
//     way round.
//   * Backward: grad_out's products are copied in beside the first chunk
//     of C and spread into S (zero diagonal, rows padded to a multiple of
//     16 with zeros); a lane owns two columns of 16 rows of dC at a time
//     and per row j of C reads one float2 of C_j and 16 entries of S_j
//     (four broadcast float4s) for 32 FMAs. Each element of dC is written
//     by one lane, once: no atomics, the same result on every run. d_dense
//     adds grad_out[b, :D] as the last step.
//   * n = F + 1 is at most 64 (kMaxRows): a warp's forward then loops over
//     the G (G + 1) / 2 group pairs 32 at a time; a block's shared memory
//     is 36 KB forward and 49 KB backward at n = 27, at most 167 KB. Every
//     DLRM of the repository has n = 27.
// The kernels launch on the caller's stream, allocate nothing and do not
// synchronise; the Python wrapper allocates the outputs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 64;           // columns of C staged at a time
constexpr int kPad = kChunk + 4;     // floats a staged row takes
constexpr int kMaxRows = 64;         // the largest n = F + 1 taken
constexpr int kWarps = 4;            // warps a block, an example each

// How a chunk of C is read: float4s (D % 4 == 0, 16-byte aligned
// pointers) or elements.
enum class Access { kQuad, kElem };

__host__ __device__ __forceinline__ int ceil_to(int x, int m) {
  return (x + m - 1) / m * m;
}

// the position of the product of rows lo < hi in torch.triu_indices order
__device__ __forceinline__ int triu_pos(int lo, int hi, int n) {
  return lo * (2 * n - lo - 1) / 2 + hi - lo - 1;
}

// Asynchronous copies from device to shared memory (cp.async): a lane
// issues all of its copies of a chunk back to back, and waits once.
__device__ __forceinline__ unsigned smem_addr(const float* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void copy16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}
__device__ __forceinline__ void copy4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}
__device__ __forceinline__ void copies_done() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Start copying columns [c0, c0 + w) of C_b's rows 0..n-1 into `tile` (row
// r at r * kPad); zeros go to the columns up to the next multiple of 4 and
// to the rows n..rows-1. The lane waits with copies_done().
template <Access kAcc>
__device__ __forceinline__ void start_chunk(float* tile,
                                            const float* __restrict__ drow,
                                            const float* __restrict__ srow,
                                            int n, int rows, int D, int c0,
                                            int w, int lane) {
  if constexpr (kAcc == Access::kQuad) {
    const int q = 4 * (lane & 15);  // w is a multiple of 4 here
    if (q >= w) return;
    for (int r = lane >> 4; r < rows; r += 2) {
      float* dst = tile + r * kPad + q;
      if (r < n) {
        copy16(dst, (r == 0 ? drow : srow + (int64_t)(r - 1) * D) + c0 + q);
      } else {
        *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
  } else {
    const int wq = ceil_to(w, 4);
    for (int r = 0; r < rows; ++r) {
      for (int c = lane; c < wq; c += 32) {
        float* dst = tile + r * kPad + c;
        if (r < n && c < w) {
          copy4(dst, (r == 0 ? drow : srow + (int64_t)(r - 1) * D) + c0 + c);
        } else {
          *dst = 0.f;
        }
      }
    }
  }
}

// floats of shared memory a warp takes: the forward's tile of 4 G rows
// and its staged products; the backward's tile of n rows, S, and grad_out's
// staged products
__host__ __device__ __forceinline__ int fwd_floats(int n) {
  const int G = (n + 3) / 4;
  return 4 * G * kPad + ceil_to(n * (n - 1) / 2, 4);
}
__host__ __device__ __forceinline__ int bwd_floats(int n) {
  return n * kPad + n * ceil_to(n, 16) + ceil_to(n * (n - 1) / 2, 4);
}

template <Access kAcc>
__global__ void dot_interaction_fwd_kernel(const float* __restrict__ dense,
                                           const float* __restrict__ sparse,
                                           float* __restrict__ out,
                                           int64_t B, int n, int D) {
  extern __shared__ float4 smem_f4[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t b = (int64_t)blockIdx.x * kWarps + warp;
  if (b >= B) return;  // whole warp leaves together
  const int G = (n + 3) / 4;
  const int rows = 4 * G;
  const int P = n * (n - 1) / 2;
  const int T = G * (G + 1) / 2;
  float* tile = reinterpret_cast<float*>(smem_f4) + warp * fwd_floats(n);
  float* stage = tile + rows * kPad;
  const float* drow = dense + b * D;
  const float* srow = sparse + b * (int64_t)(n - 1) * D;
  float* orow = out + b * (int64_t)(D + P);
  const int gs = G * kPad;  // from a row to the next of its group

  for (int t0 = 0; t0 < T; t0 += 32) {
    // this lane's group pair I <= J
    const int t = t0 + lane;
    const bool has = t < T;
    int I = 0, J = 0;
    if (has) {
      int rem = t;
      while (rem >= G - I) {
        rem -= G - I;
        ++I;
      }
      J = I + rem;
    }
    float acc[4][4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
#pragma unroll
      for (int m = 0; m < 4; ++m) acc[k][m] = 0.f;
    }
    for (int c0 = 0; c0 < D; c0 += kChunk) {
      const int w = min(kChunk, D - c0);
      if (D > kChunk || t0 == 0) {  // this chunk is not staged yet
        __syncwarp();
        start_chunk<kAcc>(tile, drow, srow, n, rows, D, c0, w, lane);
        copies_done();
        __syncwarp();
        if (t0 == 0) {
          for (int c = lane; c < w; c += 32) orow[c0 + c] = tile[c];
        }
      }
      if (!has) continue;
      const float* ra = tile + I * kPad;
      const float* rb = tile + J * kPad;
      const int wq = (w + 3) / 4;
      for (int q = 0; q < wq; ++q) {
        float4 a[4], v[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          a[k] = *reinterpret_cast<const float4*>(ra + k * gs + 4 * q);
          v[k] = *reinterpret_cast<const float4*>(rb + k * gs + 4 * q);
        }
        // ascending d: the four columns of the quad in order
#pragma unroll
        for (int k = 0; k < 4; ++k) {
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            acc[k][m] = __fmaf_rn(a[k].x, v[m].x, acc[k][m]);
          }
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) {
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            acc[k][m] = __fmaf_rn(a[k].y, v[m].y, acc[k][m]);
          }
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) {
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            acc[k][m] = __fmaf_rn(a[k].z, v[m].z, acc[k][m]);
          }
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) {
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            acc[k][m] = __fmaf_rn(a[k].w, v[m].w, acc[k][m]);
          }
        }
      }
    }
    if (!has) continue;
    // rows I + G k and J + G m: each pair of distinct rows below n once
    // (within one group only k < m)
#pragma unroll
    for (int k = 0; k < 4; ++k) {
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int i = I + G * k, j = J + G * m;
        if (i < n && j < n && (I < J || k < m)) {
          stage[triu_pos(min(i, j), max(i, j), n)] = acc[k][m];
        }
      }
    }
  }
  __syncwarp();
  for (int p = lane; p < P; p += 32) orow[D + p] = stage[p];
}

template <Access kAcc>
__global__ void dot_interaction_bwd_kernel(const float* __restrict__ grad_out,
                                           const float* __restrict__ dense,
                                           const float* __restrict__ sparse,
                                           float* __restrict__ d_dense,
                                           float* __restrict__ d_sparse,
                                           int64_t B, int n, int D) {
  extern __shared__ float4 smem_f4[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t b = (int64_t)blockIdx.x * kWarps + warp;
  if (b >= B) return;  // whole warp leaves together
  const int P = n * (n - 1) / 2;
  const int NS = ceil_to(n, 16);
  float* tile = reinterpret_cast<float*>(smem_f4) + warp * bwd_floats(n);
  float* S = tile + n * kPad;
  float* gst = S + n * NS;  // grad_out's products as they came
  const int64_t width = D + P;
  const float* grow = grad_out + b * width;
  const float* drow = dense + b * D;
  const float* srow = sparse + b * (int64_t)(n - 1) * D;
  float* ddrow = d_dense + b * D;
  float* dsrow = d_sparse + b * (int64_t)(n - 1) * D;

  // grad_out's products (a row of grad_out is not 16-byte aligned) and the
  // first chunk of C are copied together
  for (int p = lane; p < P; p += 32) copy4(gst + p, grow + D + p);
  for (int c0 = 0; c0 < D; c0 += kChunk) {
    const int w = min(kChunk, D - c0);
    __syncwarp();  // the last chunk's products are done
    start_chunk<kAcc>(tile, drow, srow, n, n, D, c0, w, lane);
    copies_done();
    __syncwarp();
    if (c0 == 0) {  // S: symmetric, zero diagonal, zero columns past n
      for (int j = 0; j < n; ++j) {
        for (int k = lane; k < NS; k += 32) {
          S[j * NS + k] = (k < n && k != j)
                              ? gst[triu_pos(min(j, k), max(j, k), n)]
                              : 0.f;
        }
      }
      __syncwarp();
    }
    const int c = 2 * lane;  // this lane's two columns of the chunk
    if (c >= w) continue;
    const bool pair = kAcc == Access::kQuad;  // then c + 1 < w too
    for (int kb = 0; kb < n; kb += 16) {
      float2 acc[16];
#pragma unroll
      for (int r = 0; r < 16; ++r) acc[r] = make_float2(0.f, 0.f);
      for (int j = 0; j < n; ++j) {
        const float2 x = *reinterpret_cast<const float2*>(tile + j * kPad + c);
        const float4* sj = reinterpret_cast<const float4*>(S + j * NS + kb);
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          const float4 s = sj[h];
          acc[4 * h].x = __fmaf_rn(s.x, x.x, acc[4 * h].x);
          acc[4 * h].y = __fmaf_rn(s.x, x.y, acc[4 * h].y);
          acc[4 * h + 1].x = __fmaf_rn(s.y, x.x, acc[4 * h + 1].x);
          acc[4 * h + 1].y = __fmaf_rn(s.y, x.y, acc[4 * h + 1].y);
          acc[4 * h + 2].x = __fmaf_rn(s.z, x.x, acc[4 * h + 2].x);
          acc[4 * h + 2].y = __fmaf_rn(s.z, x.y, acc[4 * h + 2].y);
          acc[4 * h + 3].x = __fmaf_rn(s.w, x.x, acc[4 * h + 3].x);
          acc[4 * h + 3].y = __fmaf_rn(s.w, x.y, acc[4 * h + 3].y);
        }
      }
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        const int k = kb + r;
        if (k >= n) break;
        float2 v = acc[r];
        const int d = c0 + c;
        float* dst = (k == 0 ? ddrow : dsrow + (int64_t)(k - 1) * D) + d;
        if (k == 0) {
          v.x += grow[d];
          if (c + 1 < w) v.y += grow[d + 1];
        }
        if (pair) {
          *reinterpret_cast<float2*>(dst) = v;
        } else {
          dst[0] = v.x;
          if (c + 1 < w) dst[1] = v.y;
        }
      }
    }
  }
}

Access pick_access(int D, const void* const* ptrs, int count) {
  bool quad = D % 4 == 0;
  for (int i = 0; i < count; ++i) {
    quad = quad && (uintptr_t)ptrs[i] % 16 == 0;
  }
  return quad ? Access::kQuad : Access::kElem;
}

// Launch `kernel` with kWarps warps a block and `smem` bytes of dynamic
// shared memory, raising the kernel's limit past the default 48 KB first
// where it needs more (at most 167 KB, at n = 64).
template <typename Kernel, typename... Args>
int launch(Kernel kernel, int64_t B, size_t smem, cudaStream_t s,
           Args... args) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((unsigned)((B + kWarps - 1) / kWarps));
  kernel<<<grid, 32 * kWarps, smem, s>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 on success); refuses
// n = F + 1 outside [2, kMaxRows] and D < 1.
int trt_dot_interaction_fwd_f32(const void* dense, const void* sparse,
                                void* out, int64_t B, int n, int D,
                                void* stream) {
  if (n < 2 || n > kMaxRows || D < 1 || B < 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (B == 0) return 0;
  const size_t smem = (size_t)kWarps * fwd_floats(n) * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* dp = static_cast<const float*>(dense);
  const float* sp = static_cast<const float*>(sparse);
  float* op = static_cast<float*>(out);
  const void* ptrs[] = {dense, sparse};
  switch (pick_access(D, ptrs, 2)) {
    case Access::kQuad:
      return launch(dot_interaction_fwd_kernel<Access::kQuad>, B, smem, s,
                    dp, sp, op, B, n, D);
    default:
      return launch(dot_interaction_fwd_kernel<Access::kElem>, B, smem, s,
                    dp, sp, op, B, n, D);
  }
}

// grad_out [B, D + n (n - 1) / 2]; d_dense [B, D]; d_sparse [B, n - 1, D].
int trt_dot_interaction_bwd_f32(const void* grad_out, const void* dense,
                                const void* sparse, void* d_dense,
                                void* d_sparse, int64_t B, int n, int D,
                                void* stream) {
  if (n < 2 || n > kMaxRows || D < 1 || B < 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (B == 0) return 0;
  const size_t smem = (size_t)kWarps * bwd_floats(n) * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* gp = static_cast<const float*>(grad_out);
  const float* dp = static_cast<const float*>(dense);
  const float* sp = static_cast<const float*>(sparse);
  float* ddp = static_cast<float*>(d_dense);
  float* dsp = static_cast<float*>(d_sparse);
  // grad_out is read element by element; the access covers C and dC
  const void* ptrs[] = {dense, sparse, d_dense, d_sparse};
  switch (pick_access(D, ptrs, 4)) {
    case Access::kQuad:
      return launch(dot_interaction_bwd_kernel<Access::kQuad>, B, smem, s,
                    gp, dp, sp, ddp, dsp, B, n, D);
    default:
      return launch(dot_interaction_bwd_kernel<Access::kElem>, B, smem, s,
                    gp, dp, sp, ddp, dsp, B, n, D);
  }
}

const char* trt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
