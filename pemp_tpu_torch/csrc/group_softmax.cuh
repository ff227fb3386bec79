// Device functions shared by the port's per-(node, type) aggregation
// kernels. K4 (blocked_attn.cu) keeps here its group's slot selection (one
// ballot per warp), the softmax shifted by the group's largest logit, the
// 1e-16 clamp of the softmax denominator (the TPU kernels' jnp.maximum(den,
// 1e-16)) and the fixed-order sum of per-warp partials. K2 and K2b
// (typed_message.cu) batch many groups at once and take from here the block
// shape, the row width and warp_sum; K3 and K3b (attn_aggregate.cu) give
// each node a warp and take the row width, the slot bound, warp_sum and
// warp_max.
//
// K4 runs blocks of kThreads threads; a block owns one source type t and
// walks a chunk of target nodes. The group of node n is n's valid slots of
// type t among its C slots [n*C, (n+1)*C), in slot order; an empty group
// contributes 0 to every output.

#pragma once

#include <cuda_runtime.h>

namespace pemp {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kWidth = 64;           // every row the kernels read or write is 64 wide
constexpr int kMaxSlots = kThreads;  // C <= kMaxSlots: one thread per slot in the scan

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Collects the group (the valid type-t slots among the c slots from slot0)
// into list[0..cnt) as slot offsets in slot order, and returns cnt, the same
// on every thread. warp_cnt holds kWarps ints of shared memory. Starts with
// a block-wide barrier (so the caller's buffers of the previous group are
// free) and, when cnt > 0, ends with one (list is complete).
__device__ __forceinline__ int select_group(int* list, int* warp_cnt,
                                            const int* __restrict__ types,
                                            const int* __restrict__ valid, long long slot0,
                                            int c, int t) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  __syncthreads();
  int flag = 0;
  if (tid < c) flag = valid[slot0 + tid] != 0 && types[slot0 + tid] == t;
  const unsigned mask = __ballot_sync(0xffffffffu, flag);
  if (lane == 0) warp_cnt[warp] = __popc(mask);
  __syncthreads();
  int before = 0, cnt = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int cw = warp_cnt[w];
    before += w < warp ? cw : 0;
    cnt += cw;
  }
  if (cnt == 0) return 0;
  if (flag) list[before + __popc(mask & ((1u << lane) - 1u))] = tid;
  __syncthreads();
  return cnt;
}

// The group's softmax weights before normalisation: e[r] = exp(logit[r] -
// max over the group) for r < cnt (cnt > 0), computed by warp 0; scal[0]
// gets the max and scal[1] the denominator, sum of e clamped at 1e-16. Call
// once logit[0..cnt) is complete in shared memory (after a barrier); ends
// with a block-wide barrier.
__device__ __forceinline__ void group_softmax(const float* logit, float* e, float* scal,
                                              int cnt) {
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    float mx = __int_as_float(0xff800000);  // -inf
    for (int r = lane; r < cnt; r += 32) mx = fmaxf(mx, logit[r]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int r = lane; r < cnt; r += 32) {
      const float ev = expf(logit[r] - mx);
      e[r] = ev;
      sum += ev;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      scal[0] = mx;
      scal[1] = fmaxf(sum, 1e-16f);
    }
  }
  __syncthreads();
}

// Sum over the kWarps per-warp partials red[w * kWidth + col], in a fixed
// order (the same bits on every run).
__device__ __forceinline__ float sum_partials(const float* red, int col) {
  float v = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) v += red[w * kWidth + col];
  return v;
}

}  // namespace pemp
