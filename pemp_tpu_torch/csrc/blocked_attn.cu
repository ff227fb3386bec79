// K4 and K4b: the blocked per-type attention aggregate of the einsum and
// dots message paths and its backward, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel pemp_tpu/ops/pallas/blocked_attn.py::_kernel (via
// blocked_per_type_attention_aggregate_pallas's pl.pallas_call). The
// messages m (E, D) are computed outside; per target node n and source
// type t, over n's valid type-t slots s:
//
//   w[s]      = exp(attn[s] - max over the group) / max(sum of those exps, 1e-16)
//   out[n, t] = sum_s w[s] m[s]                       (0 for an empty group)
//
// computed in f32 (w first, then the weighted sum, as the TPU kernel) and
// written once in m's type (f32 or bf16).
//
// What bounds it on an H100: memory. At the w48/640 eval shapes (B = 8:
// N = 5440 nodes, C = 80 slots, E = 435,200, T = 17, width 64, bf16 m)
// with about 70 % of the slots valid it must read the valid slots' m rows
// (~38 MB), the logit and index columns (~5 MB) and write out (~12 MB):
// ~55 MB, ~0.016 ms at 3.35 TB/s. A multiply-add per element read.
//
// What the design does about it: K3 without the node term and the ReLU
// (group_softmax.cuh). A node's C slots and T output rows are contiguous,
// so a warp owns one node for all its types, kNodeWarps a block, no block
// barrier. node_scalars reads the node's type, valid and logit columns once
// (coalesced) and takes the softmax weights from the logits alone; the
// valid m rows are then read once, in the order of a stable sort by type,
// 8 in flight per warp, a lane's two columns straight into registers
// (invalid rows are never read); out[n, t] accumulates in registers in slot
// order and is written when its group ends, the empty groups as zeros, so
// every element of out is written once. Shared memory is 12 B a slot a
// warp; registers bound the warps per SM. No float atomics, fixed summation
// orders: two calls give the same bits. CUDA cores: one weight per row, no
// product for the tensor cores.
//
// K4b, the backward (f32), has no Pallas source: the JAX package trains
// these routes by differentiating its jnp aggregate
// (pemp_tpu/ops/segment.py:172-195). From the cotangent g (N, T, D), for
// each valid slot s of group (n, t):
//
//   dm[s]     = w[s] g[n, t]
//   u[s]      = <g[n, t], m[s]>
//   dlogit[s] = w[s] (u[s] - q[n, t]),   q[n, t] = sum_s w[s] u[s] = <g[n, t], out[n, t]>
//
// and zeros for the slots of no group (invalid slots; an empty group has
// none). This is K3b's factored math without the node term and the ReLU,
// so out is not read. Bound by bytes: at the model_58_4 training shapes
// (f32) with about 70 % of the slots valid it reads the valid m rows
// (~77 MB), g (24 MB) and the index and logit columns (~5 MB) and writes
// every dm row (111 MB) and dlogit (1.7 MB): ~0.065 ms at 3.35 TB/s. The
// design is K3b's: a warp per node stages g[n] by cp.async while
// node_scalars runs, zeroes the rows of no group, then reads the valid m
// rows once in sorted order, 8 in flight, writes each dm row and reduces
// the 8 rows' u over the warp in 9 shuffles (rows_sum8); write_dlogit
// ends it. No atomics, fixed orders: two calls give the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "group_softmax.cuh"

namespace {

using pemp::kNodeWarps;
using pemp::kRows;
using pemp::kSlotBytes;
using pemp::kWidth;

// Bytes of shared memory a warp uses: the per-slot scalars; 16-byte multiple.
__host__ __device__ constexpr int warp_bytes(int c) { return (c * kSlotBytes + 15) & ~15; }

template <typename T>
__global__ void __launch_bounds__(kNodeWarps * 32) blocked_attn_fwd(
    const T* __restrict__ m, const float* __restrict__ attn, const int* __restrict__ types,
    const int* __restrict__ valid, T* __restrict__ out, int num_nodes, int c, int num_types) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n = blockIdx.x * kNodeWarps + (threadIdx.x >> 5);
  if (n >= num_nodes) return;  // a whole warp; the kernel has no block barrier
  const pemp::NodeSmem sm(pemp::warp_smem(smem, warp_bytes(c)), c);
  const long long slot0 = static_cast<long long>(n) * c;
  const pemp::Scalars sc = pemp::node_scalars(sm, types, valid, attn, slot0, c, num_types);
  T* outn = out + static_cast<long long>(n) * num_types * kWidth;
  pemp::zero_empty_rows(outn, sc.present, num_types);
  pemp::sum_sorted_rows(sm, sc.count, m, slot0, outn, [](int, float2 v) { return v; });
}

// K4b's shared memory a warp uses: g[n]'s T rows, the per-slot scalars and
// u; 16-byte multiple.
__host__ __device__ constexpr int bwd_warp_bytes(int c, int num_types) {
  return (num_types * kWidth * 4 + c * (kSlotBytes + 4) + 15) & ~15;
}

__global__ void __launch_bounds__(kNodeWarps * 32) blocked_attn_bwd(
    const float* __restrict__ m, const float* __restrict__ attn, const int* __restrict__ types,
    const int* __restrict__ valid, const float* __restrict__ g, float* __restrict__ dm,
    float* __restrict__ dlogit, int num_nodes, int c, int num_types) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * kNodeWarps + (threadIdx.x >> 5);
  if (n >= num_nodes) return;  // a whole warp; the kernel has no block barrier
  unsigned char* mine = pemp::warp_smem(smem, bwd_warp_bytes(c, num_types));
  float* gs = reinterpret_cast<float*>(mine);  // g[n]: T rows
  const pemp::NodeSmem sm(mine + num_types * kWidth * 4, c);
  float* u = reinterpret_cast<float*>(sm.ord + c);
  const long long slot0 = static_cast<long long>(n) * c;
  pemp::stage(gs, g + static_cast<long long>(n) * num_types * kWidth, num_types * kWidth * 4);
  const pemp::Scalars sc = pemp::node_scalars(sm, types, valid, attn, slot0, c, num_types);
  pemp::zero_ungrouped_slots(sm, slot0, c, dm, dlogit);
  pemp::stage_wait();

  for (int p0 = 0; p0 < sc.count; p0 += kRows) {
    float2 mv[kRows];
    float up[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      mv[r] = make_float2(0.f, 0.f);
      if (p0 + r < sc.count)
        mv[r] = pemp::load_row2(m + (slot0 + sm.ord[p0 + r]) * kWidth + 2 * lane);
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      up[r] = 0.f;
      if (p0 + r < sc.count) {
        const int s = sm.ord[p0 + r];
        const float ws = sm.w[s];
        const float2 gv = pemp::smem2(gs + sm.key[s] * kWidth + 2 * lane);
        __stcs(reinterpret_cast<float2*>(dm + (slot0 + s) * kWidth + 2 * lane),
               make_float2(ws * gv.x, ws * gv.y));
        up[r] = fmaf(gv.y, mv[r].y, gv.x * mv[r].x);
      }
    }
    const float us = pemp::rows_sum8(up);  // row lane / 4's u
    if ((lane & 3) == 0 && p0 + (lane >> 2) < sc.count) u[sm.ord[p0 + (lane >> 2)]] = us;
  }
  __syncwarp();
  pemp::write_dlogit(sm, u, sc.present, slot0, c, dlogit);
}

}  // namespace

// m (E, kWidth) and out (N, T, kWidth) both f32 (bf16 = 0) or both bf16
// (bf16 = 1), each aligned to a lane's two columns (8 or 4 bytes); attn f32
// (E,), types and valid int32 (E,). out is written whole. Returns a
// cudaError_t, or -2 for sizes or alignments it does not take (C <= 256,
// T <= 32).
extern "C" int pemp_blocked_attn_fwd(const void* m, const float* attn, const int* types,
                                     const int* valid, void* out, int num_nodes, int c,
                                     int num_types, int bf16, void* stream) {
  const int pair = bf16 ? 4 : 8;
  if (pemp::bad_sizes(num_nodes, c, num_types) || pemp::misaligned(m, pair) ||
      pemp::misaligned(out, pair))
    return -2;
  if (bf16) {
    return pemp::launch(blocked_attn_fwd<__nv_bfloat16>, warp_bytes(c), num_nodes, stream,
                        static_cast<const __nv_bfloat16*>(m), attn, types, valid,
                        static_cast<__nv_bfloat16*>(out), num_nodes, c, num_types);
  }
  return pemp::launch(blocked_attn_fwd<float>, warp_bytes(c), num_nodes, stream,
                      static_cast<const float*>(m), attn, types, valid, static_cast<float*>(out),
                      num_nodes, c, num_types);
}

// Backward (K4b), f32 only: from the cotangent g (N, T, kWidth), writes dm
// (E, kWidth) and dlogit (E,) whole (zeros for the slots of no group). g
// must be 16-byte aligned, m and dm 8-byte aligned. Returns a cudaError_t,
// or -2 as the forward.
extern "C" int pemp_blocked_attn_bwd(const float* m, const float* attn, const int* types,
                                     const int* valid, const float* g, float* dm,
                                     float* dlogit, int num_nodes, int c, int num_types,
                                     void* stream) {
  if (pemp::bad_sizes(num_nodes, c, num_types) || pemp::misaligned(g, 16) ||
      pemp::misaligned(m, 8) || pemp::misaligned(dm, 8))
    return -2;
  return pemp::launch(blocked_attn_bwd, bwd_warp_bytes(c, num_types), num_nodes, stream, m,
                      attn, types, valid, g, dm, dlogit, num_nodes, c, num_types);
}

// The warps of K4 (bf16 or f32 form) that one SM holds at once at C slots,
// or -1 if the card does not say.
extern "C" int pemp_blocked_attn_resident_warps(int c, int bf16) {
  int blocks = 0;
  const int smem = warp_bytes(c) * kNodeWarps;
  const cudaError_t err =
      bf16 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                 &blocks, blocked_attn_fwd<__nv_bfloat16>, kNodeWarps * 32, smem)
           : cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, blocked_attn_fwd<float>,
                                                           kNodeWarps * 32, smem);
  return err == cudaSuccess ? blocks * kNodeWarps : -1;
}
