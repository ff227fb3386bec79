// Device code shared by the port's per-(node, type) aggregation kernels.
// The group of (n, t) is target node n's valid slots of source type t among
// its C slots [n*C, (n+1)*C), in slot order; an empty group contributes 0 to
// every output. A group's softmax is shifted by its largest logit and its
// denominator clamped at 1e-16 (the TPU kernels' jnp.maximum(den, 1e-16)).
//
// K2 and K2b (typed_message.cu) batch many groups at once and take from here
// the block shape, the row width, the slot bound and warp_sum. K3, K3b
// (attn_aggregate.cu) and K4 (blocked_attn.cu) are node-major and take the
// rest: a warp owns one node for all its types, kNodeWarps warps a block and
// no block barrier. node_scalars reads the node's type, valid and logit
// columns once, finds the softmax weights w from the logits alone (lane t
// keeps type t's max and denominator, so T <= kMaxTypes) and sorts the
// valid slots by type, stably; sum_sorted_rows then reads each valid row
// once in that order and writes every group's output row once, summed in
// slot order, so two calls give the same bits.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace pemp {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kWidth = 64;         // every row the kernels read or write is 64 wide
constexpr int kMaxSlots = 256;     // C, the slots of a node, is at most this
constexpr int kNodeWarps = 4;      // warps of a node-major block, one node each
constexpr int kMaxTypes = 32;      // lane t keeps type t's scalars
constexpr int kRows = 8;           // rows a node-major warp has in flight
constexpr int kSlotBytes = 12;     // a node-major warp's shared memory per slot
constexpr unsigned kFull = 0xffffffffu;
static_assert(kWidth == 64, "a lane owns two columns of a row");

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// A lane's two columns of a row (streamed: each row is read once), in f32.
__device__ __forceinline__ float2 load_row2(const float* p) {
  return __ldcs(reinterpret_cast<const float2*>(p));
}
__device__ __forceinline__ float2 load_row2(const __nv_bfloat16* p) {
  return __bfloat1622float2(__ldcs(reinterpret_cast<const __nv_bfloat162*>(p)));
}
// Stores a lane's two columns, rounded once to the output's type.
__device__ __forceinline__ void store2(float* p, float2 v) {
  *reinterpret_cast<float2*>(p) = v;
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float2 v) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __float22bfloat162_rn(v);
}

// A lane's two columns of a row in shared memory, in f32.
__device__ __forceinline__ float2 smem2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 smem2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// Starts the cp.async copy of `bytes` (a multiple of 16) from src to dst, by
// the warp; stage_wait() waits for it.
__device__ __forceinline__ void stage(void* dst, const void* src, int bytes) {
  const int lane = threadIdx.x & 31;
  for (int i = lane * 16; i < bytes; i += 32 * 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     static_cast<unsigned>(__cvta_generic_to_shared(static_cast<char*>(dst) + i))),
                 "l"(static_cast<const char*>(src) + i)
                 : "memory");
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void stage_wait() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncwarp();
}

// Sums v[r] over the warp's lanes for each of the 8 rows r at once, in 9
// shuffles (each exchange halves the rows a lane carries); lanes 4r to
// 4r + 3 return row r's sum.
__device__ __forceinline__ float rows_sum8(const float (&v)[8]) {
  const int lane = threadIdx.x & 31;
  float v4[4], v2[2];
  const bool h4 = lane & 16, h2 = lane & 8, h1 = lane & 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    v4[i] = (h4 ? v[i + 4] : v[i]) + __shfl_xor_sync(kFull, h4 ? v[i] : v[i + 4], 16);
#pragma unroll
  for (int i = 0; i < 2; ++i)
    v2[i] = (h2 ? v4[i + 2] : v4[i]) + __shfl_xor_sync(kFull, h2 ? v4[i] : v4[i + 2], 8);
  float v1 = (h1 ? v2[1] : v2[0]) + __shfl_xor_sync(kFull, h1 ? v2[0] : v2[1], 4);
  v1 += __shfl_xor_sync(kFull, v1, 2);
  v1 += __shfl_xor_sync(kFull, v1, 1);
  return v1;
}
static_assert(kRows == 8, "rows_sum8 reduces 8 rows");

// The calling warp's share of the block's dynamic shared memory, `bytes` a
// warp.
__device__ __forceinline__ unsigned char* warp_smem(unsigned char* smem, int bytes) {
  return smem + (threadIdx.x >> 5) * bytes;
}

// A warp's per-slot scalars in shared memory (kSlotBytes a slot, from p):
// per slot offset s, key[s] (t_s, or -1 for a slot of no group) and w[s] (the
// logit, then the softmax weight); per sorted position p, ord[p] (the p-th
// valid slot by type, then slot).
struct NodeSmem {
  int* key;
  float* w;
  int* ord;

  __device__ NodeSmem(unsigned char* p, int c)
      : key(reinterpret_cast<int*>(p)),
        w(reinterpret_cast<float*>(p) + c),
        ord(reinterpret_cast<int*>(p) + 2 * c) {}
};

struct Scalars {
  unsigned present;  // bit t: type t has a valid slot in the node
  int count;         // valid slots, the length of ord
};

// The node's scalars, by one warp: key, the softmax weights w and the sorted
// order ord in shared memory (complete on return), the types present and
// the valid count. Lane t computes type t's max and den; the sums run in a
// fixed order.
__device__ __forceinline__ Scalars node_scalars(const NodeSmem& sm,
                                                const int* __restrict__ types,
                                                const int* __restrict__ valid,
                                                const float* __restrict__ logits,
                                                long long slot0, int c, int num_types) {
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  unsigned mask = 0;
  for (int s = lane; s < c; s += 32) {
    const int t = types[slot0 + s];
    const int k = valid[slot0 + s] != 0 && t >= 0 && t < num_types ? t : -1;
    sm.key[s] = k;
    sm.w[s] = logits[slot0 + s];
    if (k >= 0) mask |= 1u << k;
  }
  const unsigned present = __reduce_or_sync(kFull, mask);

  // per present type, in order: the group's max (lane t keeps it) and its
  // slots' places in ord, in slot order. A lane reads only its own slots'
  // key and w here.
  float gmax = 0.f;
  int count = 0;
  for (unsigned rest = present; rest; rest &= rest - 1) {
    const int t = __ffs(rest) - 1;
    float m = __int_as_float(0xff800000);  // -inf
    for (int s0 = 0; s0 < c; s0 += 32) {
      const int s = s0 + lane;
      const bool hit = s < c && sm.key[s] == t;
      if (hit) m = fmaxf(m, sm.w[s]);
      const unsigned bal = __ballot_sync(kFull, hit);
      if (hit) sm.ord[count + __popc(bal & below)] = s;
      count += __popc(bal);
    }
    m = warp_max(m);
    if (lane == t) gmax = m;
  }
  for (int s0 = 0; s0 < c; s0 += 32) {
    const int s = s0 + lane;
    const int k = s < c ? sm.key[s] : -1;
    const float mx = __shfl_sync(kFull, gmax, k & 31);
    if (s < c) sm.w[s] = k >= 0 ? expf(sm.w[s] - mx) : 0.f;
  }
  float den = 1.f;
  for (unsigned rest = present; rest; rest &= rest - 1) {
    const int t = __ffs(rest) - 1;
    float sum = 0.f;
    for (int s = lane; s < c; s += 32) sum += sm.key[s] == t ? sm.w[s] : 0.f;
    sum = warp_sum(sum);
    if (lane == t) den = fmaxf(sum, 1e-16f);
  }
  for (int s0 = 0; s0 < c; s0 += 32) {
    const int s = s0 + lane;
    const int k = s < c ? sm.key[s] : -1;
    const float d = __shfl_sync(kFull, den, k & 31);
    if (k >= 0) sm.w[s] = sm.w[s] / d;
  }
  __syncwarp();
  return {present, count};
}

// Writes a zero row (n, t) of `rows` for every type t < num_types that is
// not in `present`: the empty groups.
template <typename T>
__device__ __forceinline__ void zero_empty_rows(T* __restrict__ rows, unsigned present,
                                                int num_types) {
  const int lane = threadIdx.x & 31;
  const unsigned all = num_types == 32 ? kFull : (1u << num_types) - 1u;
  for (unsigned rest = all & ~present; rest; rest &= rest - 1)
    store2(rows + (__ffs(rest) - 1) * kWidth + 2 * lane, make_float2(0.f, 0.f));
}

// The backward kernels' zeros for the slots of no group (key -1): their
// rows of `rows` (E, kWidth) and their entries of `col` (E,).
__device__ __forceinline__ void zero_ungrouped_slots(const NodeSmem& sm, long long slot0, int c,
                                                     float* __restrict__ rows,
                                                     float* __restrict__ col) {
  const int lane = threadIdx.x & 31;
  for (int s0 = 0; s0 < c; s0 += 32) {
    const int s = s0 + lane;
    const bool none = s < c && sm.key[s] < 0;
    if (none) col[slot0 + s] = 0.f;
    for (unsigned bal = __ballot_sync(kFull, none); bal; bal &= bal - 1)
      __stcs(reinterpret_cast<float2*>(rows + (slot0 + s0 + __ffs(bal) - 1) * kWidth + 2 * lane),
             make_float2(0.f, 0.f));
  }
}

// The backward kernels' logit gradients, from u[s] = <g[n, t_s], m[s]> per
// slot offset (complete in shared memory): q[t] = sum over the type-t
// group of w u (lane t keeps it, in slot order), then dlogit[s] = w[s]
// (u[s] - q[t_s]) for every valid slot.
__device__ __forceinline__ void write_dlogit(const NodeSmem& sm, const float* u,
                                             unsigned present, long long slot0, int c,
                                             float* __restrict__ dlogit) {
  const int lane = threadIdx.x & 31;
  float q = 0.f;
  for (unsigned rest = present; rest; rest &= rest - 1) {
    const int t = __ffs(rest) - 1;
    float sum = 0.f;
    for (int s = lane; s < c; s += 32)
      if (sm.key[s] == t) sum = fmaf(sm.w[s], u[s], sum);
    sum = warp_sum(sum);
    if (lane == t) q = sum;
  }
  for (int s0 = 0; s0 < c; s0 += 32) {
    const int s = s0 + lane;
    const int k = s < c ? sm.key[s] : -1;
    const float qk = __shfl_sync(kFull, q, k & 31);
    if (k >= 0) dlogit[slot0 + s] = sm.w[s] * (u[s] - qk);
  }
}

// One pass over the node's valid rows of `in` (E, kWidth) in sorted order,
// kRows in flight: out[t] = sum over the type-t group's slots s, in slot
// order, of w[s] f(t, the lane's two columns of row s), stored to
// out + t * kWidth when the group ends. Writes only the non-empty groups.
template <typename In, typename Out, typename F>
__device__ __forceinline__ void sum_sorted_rows(const NodeSmem& sm, int count,
                                                const In* __restrict__ in, long long slot0,
                                                Out* __restrict__ out, F f) {
  const int lane = threadIdx.x & 31;
  int cur = -1;
  float2 acc = make_float2(0.f, 0.f);
  for (int p0 = 0; p0 < count; p0 += kRows) {
    float2 rows[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      rows[r] = make_float2(0.f, 0.f);
      if (p0 + r < count) rows[r] = load_row2(in + (slot0 + sm.ord[p0 + r]) * kWidth + 2 * lane);
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (p0 + r >= count) break;
      const int s = sm.ord[p0 + r];
      const int t = sm.key[s];
      if (t != cur) {  // the group of cur ends: its row is complete
        if (cur >= 0) store2(out + cur * kWidth + 2 * lane, acc);
        cur = t;
        acc = make_float2(0.f, 0.f);
      }
      const float ws = sm.w[s];
      const float2 v = f(t, rows[r]);
      acc.x = fmaf(ws, v.x, acc.x);
      acc.y = fmaf(ws, v.y, acc.y);
    }
  }
  if (cur >= 0) store2(out + cur * kWidth + 2 * lane, acc);
}

// The node-major kernels' limits: C <= kMaxSlots, T <= kMaxTypes.
inline bool bad_sizes(int num_nodes, int c, int num_types) {
  return c < 1 || c > kMaxSlots || num_types < 1 || num_types > kMaxTypes || num_nodes < 1;
}

inline bool misaligned(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes != 0;
}

// Launches a node-major `kernel`, a warp per node, with `per_warp` bytes of
// dynamic shared memory a warp. Returns a cudaError_t.
template <typename Kernel, typename... Args>
int launch(Kernel kernel, int per_warp, int num_nodes, void* stream, Args... args) {
  const int smem = per_warp * kNodeWarps;
  int err = static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
  if (err != 0) return err;
  kernel<<<(num_nodes + kNodeWarps - 1) / kNodeWarps, kNodeWarps * 32, smem,
           static_cast<cudaStream_t>(stream)>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace pemp
