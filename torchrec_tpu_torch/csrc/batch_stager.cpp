// Host-side batch assembly for the Criteo npy loader.
//
// The per-step host work of the real-data path is: slice B rows of the
// dense [N, 13] f32 / sparse [N, 26] i32 / labels [N, 1] i32 arrays, and
// transpose sparse to the [F, B, 1] padded layout. This stager copies and
// transposes one contiguous range of rows in one pass, writing into
// caller-owned output buffers. On a GPU run those are pinned host
// tensors, one set a batch, which the train pipeline copies to the card
// without a staging copy of its own.
//
// The transpose takes kTile rows at a time and writes each feature's
// kTile ids as one contiguous run (a row-by-row walk scatters every row's
// 26 ids over 26 output streams, 4x slower at B=8192). The dense rows go
// with one memcpy. One thread: the JAX package's copy starts four a call,
// which cost more than they save at B=8192.
//
// ref role: the reference delegates its heavy data plumbing to native
// code as well (FBGEMM ops for jagged manipulation; C++ datapipes
// upstream); this is the port's equivalent for the only host-bound
// stage of the Criteo pipeline (datasets/criteo.py).

#include <algorithm>
#include <cstdint>
#include <cstring>

namespace {

constexpr int64_t kTile = 8;

}  // namespace

extern "C" {

// Assemble the batch of rows [start, start + batch).
//   dense_in  [num_rows, dense_dim] f32 (full table)
//   sparse_in [num_rows, num_feats] i32
//   labels_in [num_rows] i32
//   outputs: dense_out [batch, dense_dim] f32,
//            sparse_out [num_feats, batch] i32  (transposed!),
//            labels_out [batch] f32
void stage_batch(const float* dense_in, const int32_t* sparse_in,
                 const int32_t* labels_in, int64_t start, int64_t batch,
                 int32_t dense_dim, int32_t num_feats, float* dense_out,
                 int32_t* sparse_out, float* labels_out) {
  std::memcpy(dense_out, dense_in + start * dense_dim,
              sizeof(float) * dense_dim * batch);
  const int32_t* rows[kTile];
  for (int64_t b0 = 0; b0 < batch; b0 += kTile) {
    const int64_t n = std::min<int64_t>(kTile, batch - b0);
    for (int64_t k = 0; k < n; ++k) {
      rows[k] = sparse_in + (start + b0 + k) * num_feats;
    }
    for (int32_t f = 0; f < num_feats; ++f) {
      int32_t* out = sparse_out + static_cast<int64_t>(f) * batch + b0;
      if (n == kTile) {
        for (int64_t k = 0; k < kTile; ++k) out[k] = rows[k][f];
      } else {
        for (int64_t k = 0; k < n; ++k) out[k] = rows[k][f];
      }
    }
  }
  for (int64_t b = 0; b < batch; ++b) {
    labels_out[b] = static_cast<float>(labels_in[start + b]);
  }
}

}  // extern "C"
