// K3 and K3b: the slim attention aggregation of the hybrid message path,
// forward and backward, hand-written for Hopper (sm_90a).
//
// Replace the TPU kernels pemp_tpu/ops/pallas/fused_typed_message.py::
// _attn_kernel (via _attn_forward's pl.pallas_call, body _attn_tile) and
// ::_attn_bwd_kernel (via _attn_bwd_rule's pl.pallas_call). The typed edge
// projection b is computed outside, by the reverse-permutation batched
// matmul; per slot s of target node n = s / C with source type t_s, for
// the valid slots only:
//
//   pre[s]    = a[n, t_s] + b[s]
//   m[s]      = relu(pre[s])
//   e[s]      = exp(logit[s] - max over n's valid type-t_s slots)
//   out[n, t] = sum_s e[s] m[s] / max(sum_s e[s], 1e-16)   (0 for an empty group)
//
// and its backward from the cotangent g (N, T, D), per group (no sums
// across groups, so no workspace and a single launch, unlike K2b):
// ghat = g / den, q = <g, out> / den, dm = e * ghat, dpre = dm * 1[pre > 0],
// db[s] = dpre[s], da[n, t] = sum_s dpre[s], dlogit[s] = <dm, m> - e * q.
//
// What bounds them on an H100: memory. At the model_58_4 training shapes
// (B = 8: N = 5440 nodes, C = 80 slots, E = 435,200, T = 17, width 64, f32)
// with about 70 % of the slots valid, K3 must read the valid slots' b rows
// (~77 MB), a (24 MB), the index and logit columns (~5 MB) and write out
// (24 MB): ~130 MB, ~0.039 ms at 3.35 TB/s; K3b adds g and writes every db
// row, da and dlogit: ~265 MB, ~0.079 ms. A few flops per byte: bound by
// bytes.
//
// What the design does about it: as K2, a block owns one source type t and
// a chunk of nodes, finds each node's type-t group with one ballot per warp
// (group_softmax.cuh) and loads only the group's b rows, a warp per row;
// a[n, t] is one row shared by the whole group, so nothing is gathered for
// it. Each b, db and out row is touched by exactly one block. Invalid slots
// belong to no group: the caller zeroes db and dlogit. This first version
// is simple CUDA-core code (no TMA or pipelining); a block spends a few
// barriers per group of ~3 rows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "group_softmax.cuh"

namespace {

using pemp::kMaxSlots;
using pemp::kThreads;
using pemp::kWarps;
using pemp::kWidth;

constexpr int kNodeChunk = 64;  // nodes per block

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// Shared state of one block for the current group.
struct Group {
  int list[kMaxSlots];        // the group's slot offsets within the node
  int warp_cnt[kWarps];
  float logit[kMaxSlots];     // the group's logits
  float e[kMaxSlots];         // exp(logit - max)
  float red[kWarps * kWidth]; // per-warp partial sums
  float arow[kWidth];         // a[n, t]
  float grow[kWidth];         // g[n, t] (backward)
  float scal[4];              // max, den, two halves of <g, out>
};

// Loads the group's logits and a[n, t], then its softmax weights. cnt > 0.
template <typename T>
__device__ __forceinline__ void load_group(Group& s, const T* __restrict__ a,
                                           const float* __restrict__ logits, long long slot0,
                                           long long row, int cnt) {
  for (int r = threadIdx.x; r < cnt; r += kThreads) s.logit[r] = logits[slot0 + s.list[r]];
  if (threadIdx.x < kWidth) s.arow[threadIdx.x] = to_f32(a[row + threadIdx.x]);
  __syncthreads();
  pemp::group_softmax(s.logit, s.e, s.scal, cnt);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) attn_aggregate_fwd(
    const T* __restrict__ b, const T* __restrict__ a, const int* __restrict__ types,
    const int* __restrict__ valid, const float* __restrict__ logits, float* __restrict__ out,
    int num_nodes, int c, int num_types) {
  __shared__ Group s;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t = blockIdx.y;
  const int n0 = blockIdx.x * kNodeChunk;
  const int n1 = min(n0 + kNodeChunk, num_nodes);
  for (int n = n0; n < n1; ++n) {
    const long long slot0 = static_cast<long long>(n) * c;
    const long long row = (static_cast<long long>(n) * num_types + t) * kWidth;
    const int cnt = pemp::select_group(s.list, s.warp_cnt, types, valid, slot0, c, t);
    if (cnt == 0) {
      if (tid < kWidth) out[row + tid] = 0.f;
      continue;
    }
    load_group(s, a, logits, slot0, row, cnt);
    float acc0 = 0.f, acc1 = 0.f;
    for (int r = warp; r < cnt; r += kWarps) {
      const T* br = b + (slot0 + s.list[r]) * kWidth;
      const float ev = s.e[r];
      acc0 += ev * fmaxf(s.arow[lane] + to_f32(br[lane]), 0.f);
      acc1 += ev * fmaxf(s.arow[lane + 32] + to_f32(br[lane + 32]), 0.f);
    }
    s.red[warp * kWidth + lane] = acc0;
    s.red[warp * kWidth + lane + 32] = acc1;
    __syncthreads();
    if (tid < kWidth) out[row + tid] = pemp::sum_partials(s.red, tid) / s.scal[1];
  }
}

__global__ void __launch_bounds__(kThreads) attn_aggregate_bwd(
    const float* __restrict__ b, const float* __restrict__ a, const int* __restrict__ types,
    const int* __restrict__ valid, const float* __restrict__ logits,
    const float* __restrict__ g, float* __restrict__ db, float* __restrict__ da,
    float* __restrict__ dlogit, int num_nodes, int c, int num_types) {
  __shared__ Group s;
  extern __shared__ float pre[];  // C x kWidth: the group's pre-activations
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t = blockIdx.y;
  const int n0 = blockIdx.x * kNodeChunk;
  const int n1 = min(n0 + kNodeChunk, num_nodes);
  for (int n = n0; n < n1; ++n) {
    const long long slot0 = static_cast<long long>(n) * c;
    const long long row = (static_cast<long long>(n) * num_types + t) * kWidth;
    const int cnt = pemp::select_group(s.list, s.warp_cnt, types, valid, slot0, c, t);
    if (cnt == 0) {
      if (tid < kWidth) da[row + tid] = 0.f;
      continue;
    }
    if (tid < kWidth) s.grow[tid] = g[row + tid];
    load_group(s, a, logits, slot0, row, cnt);

    // the forward again: pre kept per row, out's per-warp partials
    float acc0 = 0.f, acc1 = 0.f;
    for (int r = warp; r < cnt; r += kWarps) {
      const float* br = b + (slot0 + s.list[r]) * kWidth;
      const float p0 = s.arow[lane] + br[lane];
      const float p1 = s.arow[lane + 32] + br[lane + 32];
      pre[r * kWidth + lane] = p0;
      pre[r * kWidth + lane + 32] = p1;
      const float ev = s.e[r];
      acc0 += ev * fmaxf(p0, 0.f);
      acc1 += ev * fmaxf(p1, 0.f);
    }
    s.red[warp * kWidth + lane] = acc0;
    s.red[warp * kWidth + lane + 32] = acc1;
    __syncthreads();
    const float den = s.scal[1];
    if (tid < kWidth) {  // warps 0 and 1: <g, out>, a half each
      const float prod = pemp::warp_sum(s.grow[tid] * (pemp::sum_partials(s.red, tid) / den));
      if (lane == 0) s.scal[2 + warp] = prod;
    }
    __syncthreads();
    const float q = (s.scal[2] + s.scal[3]) / den;
    const float gh0 = s.grow[lane] / den, gh1 = s.grow[lane + 32] / den;

    float da0 = 0.f, da1 = 0.f;
    for (int r = warp; r < cnt; r += kWarps) {
      const float ev = s.e[r];
      const float p0 = pre[r * kWidth + lane], p1 = pre[r * kWidth + lane + 32];
      const float dm0 = ev * gh0, dm1 = ev * gh1;
      const float dp0 = p0 > 0.f ? dm0 : 0.f;
      const float dp1 = p1 > 0.f ? dm1 : 0.f;
      const float dl = pemp::warp_sum(dm0 * fmaxf(p0, 0.f) + dm1 * fmaxf(p1, 0.f)) - ev * q;
      const long long slot = slot0 + s.list[r];
      db[slot * kWidth + lane] = dp0;
      db[slot * kWidth + lane + 32] = dp1;
      if (lane == 0) dlogit[slot] = dl;
      da0 += dp0;
      da1 += dp1;
    }
    s.red[warp * kWidth + lane] = da0;
    s.red[warp * kWidth + lane + 32] = da1;
    __syncthreads();
    if (tid < kWidth) da[row + tid] = pemp::sum_partials(s.red, tid);
  }
}

bool bad_sizes(int num_nodes, int c, int num_types) {
  return c < 1 || c > kMaxSlots || num_types < 1 || num_types > 65535 || num_nodes < 1;
}

dim3 grid_of(int num_nodes, int num_types) {
  return dim3((num_nodes + kNodeChunk - 1) / kNodeChunk, num_types);
}

}  // namespace

// Forward (K3). b (E, kWidth) and a (N, T, kWidth) are both f32 (bf16 = 0)
// or both bf16 (bf16 = 1); types and valid int32, logits f32 (E,); out
// (N, T, kWidth) f32. Returns a cudaError_t, or -2 for unsupported sizes.
extern "C" int pemp_attn_aggregate_fwd(const void* b, const void* a, const int* types,
                                       const int* valid, const float* logits, float* out,
                                       int num_nodes, int c, int num_types, int bf16,
                                       void* stream) {
  if (bad_sizes(num_nodes, c, num_types)) return -2;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid = grid_of(num_nodes, num_types);
  if (bf16) {
    attn_aggregate_fwd<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(b), static_cast<const __nv_bfloat16*>(a), types,
        valid, logits, out, num_nodes, c, num_types);
  } else {
    attn_aggregate_fwd<float><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(b), static_cast<const float*>(a), types, valid, logits, out,
        num_nodes, c, num_types);
  }
  return static_cast<int>(cudaGetLastError());
}

// Backward (K3b), f32 only. db (E, kWidth) and dlogit (E,) must be zeroed
// by the caller (slots no group owns, the invalid ones, keep 0); da
// (N, T, kWidth) is written whole.
extern "C" int pemp_attn_aggregate_bwd(const float* b, const float* a, const int* types,
                                       const int* valid, const float* logits, const float* g,
                                       float* db, float* da, float* dlogit, int num_nodes,
                                       int c, int num_types, void* stream) {
  if (bad_sizes(num_nodes, c, num_types)) return -2;
  const size_t smem = sizeof(float) * static_cast<size_t>(c) * kWidth;
  int err = static_cast<int>(cudaFuncSetAttribute(
      attn_aggregate_bwd, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
  if (err != 0) return err;
  attn_aggregate_bwd<<<grid_of(num_nodes, num_types), kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      b, a, types, valid, logits, g, db, da, dlogit, num_nodes, c, num_types);
  return static_cast<int>(cudaGetLastError());
}
