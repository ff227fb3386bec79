// G1: the backward of the edge MLP's source-row gather x[j], hand-written
// for Hopper (sm_90a).
//
// It has no Pallas source: it serves the JAX package's exact per-image
// backward pemp_tpu/ops/gather_mm.py::_bwd (a one-hot dot_general on the
// TPU's matrix unit). Given the cotangent g (E, D) and the plan built once
// per forward from j (ops/gather_mm.py::gather_plan: the slots sorted
// stably by their row key b * n_img + j % n_img, that order cut into
// pieces of at most 64 positions of one row, each piece's first position
// and each row's first piece):
//
//   part[k] = sum over piece k's positions p, in order, of g[order[p]]
//   dx[r]   = sum over row r's pieces k, in order, of part[k]
//
// summed in f32, dx written once in g's type (f32, or bf16 rounded once); a
// row no slot names gets zeros.
//
// What bounds it on an H100: memory. At the model_58_4 training shapes
// (B = 8: N = 5440 rows, E = 435,200 slots, D = 64, f32) it must read g
// (111 MB) and the plan (~1.8 MB) and write dx (1.4 MB): ~0.034 ms at
// 3.35 TB/s. An add per element read.
//
// What the design does about it: every g row belongs to exactly one piece,
// so a warp owns a piece and reads its g rows in plan order, each once: 8
// rows in flight, a lane's two columns of each straight into registers (a
// 64-wide f32 row is one 8-byte load a lane, 256 B a row), the slot
// numbers fetched 8 at a time and passed on by shuffles. Pieces, not rows,
// are the unit of work because the rows are uneven: every invalid slot of
// an image names the image's node 0 (thousands of slots at model_58_4's
// size), the other rows ~C. The second launch, a warp per row, sums the
// row's pieces (one for most rows; ~1.4 MB of partials, written and read
// once through L2) and writes the row. No float atomics, a fixed order:
// two calls give the same bits, and the output needs no zeroing
// beforehand. 256 threads a block, no shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "group_softmax.cuh"

namespace {

using pemp::kFull;
using pemp::kRows;
using pemp::kThreads;
using pemp::kWarps;

// part[k] = the f32 sum of piece k's g rows, in order (a warp a piece).
template <typename T>
__global__ void __launch_bounds__(kThreads) gather_rows_pieces(
    const T* __restrict__ g, const int* __restrict__ order, const int* __restrict__ bounds,
    float* __restrict__ part, int pieces, int d) {
  const int lane = threadIdx.x & 31;
  const int k = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (k >= pieces) return;  // a whole warp; no block barrier
  const int p0 = bounds[k], p1 = bounds[k + 1];
  for (int col = 2 * lane; col - 2 * lane < d; col += 64) {
    const bool mine = col < d;
    float2 acc = make_float2(0.f, 0.f);
    for (int p = p0; p < p1; p += kRows) {
      const int q = p + (lane & (kRows - 1));
      const int slot_l = q < p1 ? order[q] : 0;
      float2 v[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const long long slot = __shfl_sync(kFull, slot_l, i);
        v[i] = make_float2(0.f, 0.f);
        if (mine && p + i < p1) v[i] = pemp::load_row2(g + slot * d + col);
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        if (p + i < p1) {
          acc.x += v[i].x;
          acc.y += v[i].y;
        }
      }
    }
    if (mine) pemp::store2(part + static_cast<long long>(k) * d + col, acc);
  }
}

// dx[r] = the sum of row r's pieces, in order (a warp a row; zeros for a
// row of no piece).
template <typename T>
__global__ void __launch_bounds__(kThreads) gather_rows_sum(const float* __restrict__ part,
                                                            const int* __restrict__ row_pieces,
                                                            T* __restrict__ dx, int num_rows,
                                                            int d) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (r >= num_rows) return;
  const int k0 = row_pieces[r], k1 = row_pieces[r + 1];
  for (int col = 2 * lane; col < d; col += 64) {
    float2 acc = make_float2(0.f, 0.f);
    for (int k = k0; k < k1; ++k) {
      const float2 v = *reinterpret_cast<const float2*>(part + static_cast<long long>(k) * d + col);
      acc.x += v.x;
      acc.y += v.y;
    }
    pemp::store2(dx + static_cast<long long>(r) * d + col, acc);
  }
}

template <typename T>
int launch(const void* g, const int* order, const int* bounds, const int* row_pieces,
           float* part, void* dx, int num_rows, int pieces, int d, cudaStream_t s) {
  if (pieces > 0) {
    gather_rows_pieces<T><<<(pieces + kWarps - 1) / kWarps, kThreads, 0, s>>>(
        static_cast<const T*>(g), order, bounds, part, pieces, d);
    const int err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
  }
  gather_rows_sum<T><<<(num_rows + kWarps - 1) / kWarps, kThreads, 0, s>>>(
      part, row_pieces, static_cast<T*>(dx), num_rows, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// g (E, d) and dx (num_rows, d) both f32 (bf16 = 0) or both bf16 (bf16 =
// 1), each aligned to two of its values, d even; order (E,), bounds
// (pieces + 1,) and row_pieces (num_rows + 1,) int32 from the plan; part
// (pieces, d) f32 workspace. dx is written whole. Returns a cudaError_t, or
// -2 for sizes or alignments it does not take.
extern "C" int pemp_gather_rows_bwd(const void* g, const int* order, const int* bounds,
                                    const int* row_pieces, float* part, void* dx, int num_rows,
                                    int pieces, int d, int bf16, void* stream) {
  const int pair = bf16 ? 4 : 8;
  if (num_rows < 1 || pieces < 0 || d < 2 || d % 2 != 0 || pemp::misaligned(g, pair) ||
      pemp::misaligned(dx, pair) || pemp::misaligned(part, 8))
    return -2;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<__nv_bfloat16>(g, order, bounds, row_pieces, part, dx, num_rows, pieces, d,
                                 s);
  return launch<float>(g, order, bounds, row_pieces, part, dx, num_rows, pieces, d, s);
}
