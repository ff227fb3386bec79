// K4: the blocked per-type attention aggregate of the einsum message path,
// hand-written for Hopper (sm_90a). Forward only, as the TPU kernel.
//
// Replaces the TPU kernel pemp_tpu/ops/pallas/blocked_attn.py::_kernel (via
// blocked_per_type_attention_aggregate_pallas's pl.pallas_call). The
// messages m (E, D) are computed outside; per target node n and source
// type t, over n's valid type-t slots s:
//
//   e[s]      = exp(attn[s] - max over the group)
//   out[n, t] = sum_s e[s] m[s] / max(sum_s e[s], 1e-16)   (0 for an empty group)
//
// computed in f32 and written in m's type (f32 or bf16).
//
// What bounds it on an H100: memory. At the w48/640 eval shapes (B = 8:
// N = 5440 nodes, C = 80 slots, E = 435,200, T = 17, width 64, bf16 m)
// it must read the valid slots' m rows (~128 B each), the logit and index
// columns (~5 MB) and write out (~12 MB): a few tens of MB, a few hundredths
// of a millisecond at 3.35 TB/s.
//
// What the design does about it: K3 without the node term and the ReLU. A
// block owns one source type t and a chunk of nodes, finds each node's
// type-t group with one ballot per warp (group_softmax.cuh) and loads only
// the group's m rows, a warp per row; each m row and out row is touched by
// exactly one block. Simple CUDA-core code, no TMA or pipelining.

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
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <typename T>
__global__ void __launch_bounds__(kThreads) blocked_attn_fwd(
    const T* __restrict__ m, const float* __restrict__ attn, const int* __restrict__ types,
    const int* __restrict__ valid, T* __restrict__ out, int num_nodes, int c, int num_types) {
  __shared__ int list[kMaxSlots];
  __shared__ int warp_cnt[kWarps];
  __shared__ float logit[kMaxSlots];
  __shared__ float e[kMaxSlots];
  __shared__ float red[kWarps * kWidth];
  __shared__ float scal[2];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t = blockIdx.y;
  const int n0 = blockIdx.x * kNodeChunk;
  const int n1 = min(n0 + kNodeChunk, num_nodes);
  for (int n = n0; n < n1; ++n) {
    const long long slot0 = static_cast<long long>(n) * c;
    const long long row = (static_cast<long long>(n) * num_types + t) * kWidth;
    const int cnt = pemp::select_group(list, warp_cnt, types, valid, slot0, c, t);
    if (cnt == 0) {
      if (tid < kWidth) store(out + row + tid, 0.f);
      continue;
    }
    for (int r = tid; r < cnt; r += kThreads) logit[r] = attn[slot0 + list[r]];
    __syncthreads();
    pemp::group_softmax(logit, e, scal, cnt);
    float acc0 = 0.f, acc1 = 0.f;
    for (int r = warp; r < cnt; r += kWarps) {
      const T* mr = m + (slot0 + list[r]) * kWidth;
      acc0 += e[r] * to_f32(mr[lane]);
      acc1 += e[r] * to_f32(mr[lane + 32]);
    }
    red[warp * kWidth + lane] = acc0;
    red[warp * kWidth + lane + 32] = acc1;
    __syncthreads();
    if (tid < kWidth) store(out + row + tid, pemp::sum_partials(red, tid) / scal[1]);
  }
}

}  // namespace

// m (E, kWidth) and out (N, T, kWidth) both f32 (bf16 = 0) or both bf16
// (bf16 = 1); attn f32 (E,), types and valid int32 (E,). Returns a
// cudaError_t, or -2 for unsupported sizes.
extern "C" int pemp_blocked_attn_fwd(const void* m, const float* attn, const int* types,
                                     const int* valid, void* out, int num_nodes, int c,
                                     int num_types, int bf16, void* stream) {
  if (c < 1 || c > kMaxSlots || num_types < 1 || num_types > 65535 || num_nodes < 1) return -2;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((num_nodes + kNodeChunk - 1) / kNodeChunk, num_types);
  if (bf16) {
    blocked_attn_fwd<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(m), attn, types, valid,
        static_cast<__nv_bfloat16*>(out), num_nodes, c, num_types);
  } else {
    blocked_attn_fwd<float><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(m), attn, types, valid, static_cast<float*>(out), num_nodes,
        c, num_types);
  }
  return static_cast<int>(cudaGetLastError());
}
