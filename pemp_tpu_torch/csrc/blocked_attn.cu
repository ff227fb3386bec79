// K4: the blocked per-type attention aggregate of the einsum message path,
// hand-written for Hopper (sm_90a). Forward only, as the TPU kernel.
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "group_softmax.cuh"

namespace {

using pemp::kNodeWarps;
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
