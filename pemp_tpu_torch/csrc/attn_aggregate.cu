// K3 and K3b: the slim attention aggregation of the hybrid message path,
// forward and backward, hand-written for Hopper (sm_90a).
//
// Replace the TPU kernels pemp_tpu/ops/pallas/fused_typed_message.py::
// _attn_kernel (via _attn_forward's pl.pallas_call, body _attn_tile) and
// ::_attn_bwd_kernel (via _attn_bwd_rule's pl.pallas_call). The typed edge
// projection b is computed outside, by the reverse-permutation batched
// matmul. Per slot s of target node n = s / C with source type t_s, for the
// valid slots only (a slot of no group contributes nothing):
//
//   w[s]      = exp(logit[s] - max over n's valid type-t_s slots) / den[n, t_s]
//   den[n, t] = max(sum of those exps, 1e-16)
//   pre[s]    = a[n, t_s] + b[s]
//   out[n, t] = sum_s w[s] relu(pre[s])                  (0 for an empty group)
//
// and its backward from the cotangent g (N, T, D), in one pass over the b
// rows once the scalars w are known: db[s] = w[s] g[n, t_s] 1[pre[s] > 0],
// u[s] = <g[n, t_s], relu(pre[s])>, da[n, t] = sum_s db[s] (slot order),
// q[n, t] = sum_s w[s] u[s], dlogit[s] = w[s] (u[s] - q[n, t_s]). This is
// _attn_bwd_kernel's <dm, m> - e <g, out> / den reordered: <g, out[n, t]>
// = q[n, t], so neither out nor pre is kept.
//
// Who writes what: a warp owns one node n for all its types. It writes
// out[n] (K3) or da[n] (K3b) whole, T contiguous rows, each once (zeros for
// an empty group), and K3b writes db and dlogit of all of n's C slots
// (zeros for the slots of no group). The caller allocates the outputs
// uninitialised.
//
// What bounds them on an H100: memory. At the model_58_4 training shapes
// (B = 8: N = 5440 nodes, C = 80 slots, E = 435,200, T = 17, width 64, f32)
// with about 70 % of the slots valid, K3 reads the valid slots' b rows
// (~77 MB), a (24 MB) and the index and logit columns (~5 MB) and writes out
// (24 MB): ~130 MB, ~0.039 ms at 3.35 TB/s; K3b also reads g and writes
// every db row, da and dlogit: ~266 MB, ~0.080 ms. A few flops per byte.
//
// What the design does about it. A node's C slots and T rows of a (and g)
// are contiguous, and every node carries C slots, so a warp per node gives
// every warp the same work whatever the graph does to types. The warp reads
// the node's types, valid and logits columns once (coalesced, 128 B a load)
// and computes every scalar from the logits alone: the types present as one
// OR over the warp, then per present type a warp max and a warp sum (lane t
// keeps type t's max, den and q: T <= 32), and a stable counting sort of the
// valid slots by type (ballots). Meanwhile cp.async stages a[n] (and g[n])
// in the warp's shared memory. The b rows are then read once, in that
// sorted order (invalid rows are never read), 8 rows in flight per warp,
// straight into registers; out or da accumulates in registers in slot order
// within each group and is written when the group ends. K3b reduces the 8
// rows' u partials over the warp in 9 shuffles. No block barrier, no float
// atomics, fixed summation orders: two calls give the same bits. Shared
// memory per warp is T x 256 B for a (x 128 B in bf16), as much again for g
// (K3b), and 12 to 16 B per slot; it is what bounds the warps per SM (about
// 20 for K3b at T = 17, C = 80). f32 on the CUDA cores: there is no product
// for the tensor cores. The scalars, K3's row pass and the launch are shared
// with K4 (group_softmax.cuh).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "group_softmax.cuh"

namespace {

using pemp::bad_sizes;
using pemp::kNodeWarps;
using pemp::kRows;
using pemp::kSlotBytes;
using pemp::kWidth;
using pemp::launch;
using pemp::load_row2;
using pemp::misaligned;
using pemp::node_scalars;
using pemp::rows_sum8;
using pemp::Scalars;
using pemp::smem2;
using pemp::stage;
using pemp::stage_wait;
using pemp::store2;
using pemp::sum_sorted_rows;
using pemp::warp_smem;
using pemp::write_dlogit;
using pemp::zero_ungrouped_slots;
using pemp::zero_empty_rows;

// Bytes of shared memory a warp uses: a's rows (elem_bytes each value),
// g's rows (K3b), the per-slot scalars and u (K3b); 16-byte multiple.
__host__ __device__ constexpr int warp_bytes(int c, int num_types, int elem_bytes,
                                             bool backward) {
  return (num_types * kWidth * (elem_bytes + (backward ? 4 : 0)) +
          c * (kSlotBytes + (backward ? 4 : 0)) + 15) & ~15;
}

// The warp's shared memory: a[n] (and g[n]) rows, then the per-slot scalars
// (pemp::NodeSmem) and u[s] (K3b) per slot offset s.
template <typename T>
struct AttnSmem : pemp::NodeSmem {
  T* a;
  float* g;
  float* u;

  // p: the warp's share (pemp::warp_smem)
  __device__ AttnSmem(unsigned char* p, int c, int num_types, bool backward)
      : NodeSmem(p + num_types * kWidth * (sizeof(T) + (backward ? 4 : 0)), c),
        a(reinterpret_cast<T*>(p)),
        g(reinterpret_cast<float*>(p + num_types * kWidth * sizeof(T))),
        u(reinterpret_cast<float*>(ord + c)) {}
};

template <typename T>
__global__ void __launch_bounds__(kNodeWarps * 32) attn_aggregate_fwd(
    const T* __restrict__ b, const T* __restrict__ a, const int* __restrict__ types,
    const int* __restrict__ valid, const float* __restrict__ logits, float* __restrict__ out,
    int num_nodes, int c, int num_types) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * kNodeWarps + (threadIdx.x >> 5);
  if (n >= num_nodes) return;  // a whole warp; the kernel has no block barrier
  const AttnSmem<T> sm(warp_smem(smem, warp_bytes(c, num_types, sizeof(T), false)), c,
                       num_types, false);
  const long long slot0 = static_cast<long long>(n) * c;
  const long long row0 = static_cast<long long>(n) * num_types * kWidth;
  stage(sm.a, a + row0, num_types * kWidth * static_cast<int>(sizeof(T)));
  const Scalars sc = node_scalars(sm, types, valid, logits, slot0, c, num_types);
  float* outn = out + row0;
  zero_empty_rows(outn, sc.present, num_types);
  stage_wait();
  sum_sorted_rows(sm, sc.count, b, slot0, outn, [&](int t, float2 bv) {
    const float2 av = smem2(sm.a + t * kWidth + 2 * lane);
    return make_float2(fmaxf(av.x + bv.x, 0.f), fmaxf(av.y + bv.y, 0.f));
  });
}

__global__ void __launch_bounds__(kNodeWarps * 32) attn_aggregate_bwd(
    const float* __restrict__ b, const float* __restrict__ a, const int* __restrict__ types,
    const int* __restrict__ valid, const float* __restrict__ logits,
    const float* __restrict__ g, float* __restrict__ db, float* __restrict__ da,
    float* __restrict__ dlogit, int num_nodes, int c, int num_types) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * kNodeWarps + (threadIdx.x >> 5);
  if (n >= num_nodes) return;
  const AttnSmem<float> sm(warp_smem(smem, warp_bytes(c, num_types, 4, true)), c,
                           num_types, true);
  const long long slot0 = static_cast<long long>(n) * c;
  const long long row0 = static_cast<long long>(n) * num_types * kWidth;
  stage(sm.a, a + row0, num_types * kWidth * 4);
  stage(sm.g, g + row0, num_types * kWidth * 4);
  const Scalars sc = node_scalars(sm, types, valid, logits, slot0, c, num_types);
  float* dan = da + row0;
  zero_empty_rows(dan, sc.present, num_types);
  zero_ungrouped_slots(sm, slot0, c, db, dlogit);
  stage_wait();

  int cur = -1;
  float2 acc = make_float2(0.f, 0.f);
  for (int p0 = 0; p0 < sc.count; p0 += kRows) {
    float2 bv[kRows], dbv[kRows];
    float up[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      bv[r] = make_float2(0.f, 0.f);
      if (p0 + r < sc.count) bv[r] = load_row2(b + (slot0 + sm.ord[p0 + r]) * kWidth + 2 * lane);
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      dbv[r] = make_float2(0.f, 0.f);
      up[r] = 0.f;
      if (p0 + r < sc.count) {
        const int s = sm.ord[p0 + r];
        const int t = sm.key[s];
        const float ws = sm.w[s];
        const float2 av = smem2(sm.a + t * kWidth + 2 * lane);
        const float2 gv = smem2(sm.g + t * kWidth + 2 * lane);
        const float px = av.x + bv[r].x, py = av.y + bv[r].y;
        dbv[r] = make_float2(px > 0.f ? ws * gv.x : 0.f, py > 0.f ? ws * gv.y : 0.f);
        __stcs(reinterpret_cast<float2*>(db + (slot0 + s) * kWidth + 2 * lane), dbv[r]);
        up[r] = fmaf(gv.y, fmaxf(py, 0.f), gv.x * fmaxf(px, 0.f));
      }
    }
    const float u = rows_sum8(up);  // row lane / 4's u
    if ((lane & 3) == 0 && p0 + (lane >> 2) < sc.count) sm.u[sm.ord[p0 + (lane >> 2)]] = u;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (p0 + r >= sc.count) break;
      const int t = sm.key[sm.ord[p0 + r]];
      if (t != cur) {
        if (cur >= 0) store2(dan + cur * kWidth + 2 * lane, acc);
        cur = t;
        acc = make_float2(0.f, 0.f);
      }
      acc.x += dbv[r].x;
      acc.y += dbv[r].y;
    }
  }
  if (cur >= 0) store2(dan + cur * kWidth + 2 * lane, acc);
  __syncwarp();
  write_dlogit(sm, sm.u, sc.present, slot0, c, dlogit);
}

}  // namespace

// Forward (K3). b (E, kWidth) and a (N, T, kWidth) are both f32 (bf16 = 0)
// or both bf16 (bf16 = 1); types and valid int32, logits f32 (E,); out
// (N, T, kWidth) f32, written whole. a must be 16-byte aligned and b 8-byte
// aligned. Returns a cudaError_t, or -2 for sizes or alignments it does not
// take (C <= 256, T <= 32).
extern "C" int pemp_attn_aggregate_fwd(const void* b, const void* a, const int* types,
                                       const int* valid, const float* logits, float* out,
                                       int num_nodes, int c, int num_types, int bf16,
                                       void* stream) {
  if (bad_sizes(num_nodes, c, num_types) || misaligned(a, 16) || misaligned(b, 8) ||
      misaligned(out, 8))
    return -2;
  if (bf16) {
    return launch(attn_aggregate_fwd<__nv_bfloat16>, warp_bytes(c, num_types, 2, false),
                  num_nodes, stream, static_cast<const __nv_bfloat16*>(b),
                  static_cast<const __nv_bfloat16*>(a), types, valid, logits, out, num_nodes, c,
                  num_types);
  }
  return launch(attn_aggregate_fwd<float>, warp_bytes(c, num_types, 4, false), num_nodes,
                stream, static_cast<const float*>(b), static_cast<const float*>(a), types, valid,
                logits, out, num_nodes, c, num_types);
}

// Backward (K3b), f32 only. Writes db (E, kWidth), da (N, T, kWidth) and
// dlogit (E,) whole: zeros for the slots of no group and the empty groups.
// a and g must be 16-byte aligned, b, db and da 8-byte aligned. Returns a
// cudaError_t, or -2 as the forward.
extern "C" int pemp_attn_aggregate_bwd(const float* b, const float* a, const int* types,
                                       const int* valid, const float* logits, const float* g,
                                       float* db, float* da, float* dlogit, int num_nodes,
                                       int c, int num_types, void* stream) {
  if (bad_sizes(num_nodes, c, num_types) || misaligned(a, 16) || misaligned(g, 16) ||
      misaligned(b, 8) || misaligned(db, 8) || misaligned(da, 8))
    return -2;
  return launch(attn_aggregate_bwd, warp_bytes(c, num_types, 4, true), num_nodes, stream, b,
                a, types, valid, logits, g, db, da, dlogit, num_nodes, c, num_types);
}
