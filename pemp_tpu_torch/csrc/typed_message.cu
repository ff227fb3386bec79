// K2 and K2b: the training path's typed message + attention aggregation,
// forward and backward, hand-written for Hopper (sm_90a).
//
// Replace the TPU kernels pemp_tpu/ops/pallas/fused_typed_message.py::_kernel
// (via _fused_forward's pl.pallas_call, body _tile_forward) and ::_bwd_kernel
// (via _fused_bwd_rule's pl.pallas_call). Per slot s of target node
// n = s / C with source type t_s, for the valid slots only:
//
//   pre[s]    = a[n, t_s] + ef[s] @ We_{t_s}          (We_t = we[:, t*D:(t+1)*D])
//   m[s]      = relu(pre[s])
//   logit[s]  = ef[s] . w_attn                          (its bias is dropped)
//   e[s]      = exp(logit[s] - max over n's valid type-t_s slots)
//   out[n, t] = sum_s e[s] m[s] / max(sum_s e[s], 1e-16)   (0 for an empty group)
//
// and the factored-softmax backward of _bwd_kernel's docstring, from the
// cotangent g (N, T, D): ghat = g / den, q = <g, out> / den,
// dm = e * ghat, dpre = dm * 1[pre > 0], dlogit = <dm, m> - e * q,
// da[n, t] = sum_s dpre[s], d_ef[s] = dpre[s] @ We_t^T + dlogit[s] * w_attn,
// dwe_t = sum_s ef[s]^T dpre[s], dwa = sum_s ef[s] dlogit[s].
//
// What bounds them on an H100: at the model_58_4 training shapes (B = 8:
// N = 5440 nodes, C = 80 slots, E = 435,200, T = 17, widths 64, f32), with
// about 70 % of the slots valid as at the first training step, K2 must read
// the valid slots' ef rows (~77 MB), a (24 MB) and the index columns (3.5 MB)
// and write out (24 MB): ~0.038 ms at 3.35 TB/s; its ~2.6 GFLOP of typed
// projection on the valid slots take ~0.038 ms at the 67 TFLOP/s f32 rate,
// so the two bounds meet. K2b moves ~265 MB and does ~7.6 GFLOP (the
// projection again, d_ef and dwe): ~0.114 ms, bound by operations.
//
// What the design does about it: everything happens per (node, type)
// group, and each group needs only its own type's 64x64 slice of `we`. A
// block owns one type t and a chunk of nodes: it stages We_t once in shared
// memory and, node by node, finds the node's valid type-t slots with one
// ballot per warp, loads only those ef rows, and projects them onto We_t
// alone (the TPU form projects every slot onto all 17 types and selects
// with one-hot matmuls, because Mosaic has no gather). Each ef row is read
// by exactly one block and each d_ef, out and da row written by exactly
// one, so device memory sees every input and output once.
//
// The cross-block sums dwe (278 KB in f32, more than a block's shared
// memory) and dwa are deterministic: each block keeps its type's 64x64
// partial of dwe in registers (16 entries a thread) and writes it to a
// workspace (chunk, type, 64, 64); a second launch sums the chunks in a
// fixed order. No atomics: the step gives the same bits on every run.
// This first version computes on the CUDA cores in f32 (no wgmma, TMA or
// pipelining).

#include <cuda_runtime.h>

#include "group_softmax.cuh"

namespace {

using pemp::kMaxSlots;
using pemp::kThreads;
using pemp::kWarps;
using pemp::kWidth;
using pemp::warp_sum;

constexpr int kLd = kWidth + 1;     // padded row stride: column reads hit distinct banks
constexpr int kFwdChunk = 64;       // nodes per block of the forward

// Shared memory of one block, carved from the dynamic allocation.
struct Smem {
  float* we;      // kWidth x kLd: We_t[k][o] at k * kLd + o
  float* wat;     // kWidth: w_attn
  float* ef;      // C x kLd: the group's ef rows
  float* pre;     // C x kWidth: pre, then dpre in place (backward only)
  float* red;     // kWarps x kWidth: per-warp partial sums
  float* logit;   // C: logits, then dlogit (backward)
  float* e;       // C: exp(logit - max)
  float* vec;     // 3 x kWidth: a[n, t], g[n, t], out[n, t]
  float* scal;    // 8: max, den, two halves of <g, out>
  int* list;      // C: the group's slots, in slot order
  int* warp_cnt;  // kWarps: group members per warp of the scan

  __device__ Smem(float* base, int c) {
    we = base;
    wat = we + kWidth * kLd;
    ef = wat + kWidth;
    pre = ef + c * kLd;
    red = pre + c * kWidth;
    logit = red + kWarps * kWidth;
    e = logit + c;
    vec = e + c;
    scal = vec + 3 * kWidth;
    list = reinterpret_cast<int*>(scal + 8);
    warp_cnt = list + c;
  }
};

size_t smem_bytes(int c) {
  return sizeof(float) * (kWidth * kLd + kWidth + c * kLd + c * kWidth + kWarps * kWidth +
                          2 * c + 3 * kWidth + 8) +
         sizeof(int) * (c + kWarps);
}

// Stages We_t and w_attn for the block's type t.
__device__ void stage_weights(const Smem& s, const float* __restrict__ we,
                              const float* __restrict__ w_attn, int t, int num_types) {
  const long long row = static_cast<long long>(num_types) * kWidth;
  for (int i = threadIdx.x; i < kWidth * kWidth; i += kThreads) {
    const int k = i / kWidth, o = i % kWidth;
    s.we[k * kLd + o] = we[k * row + t * kWidth + o];
  }
  for (int i = threadIdx.x; i < kWidth; i += kThreads) s.wat[i] = w_attn[i];
}

// The forward of group (n, t): collects the group's slots, its ef rows,
// logits, softmax weights and pre-activations; leaves the unnormalised
// output sum over warps in s.red. Returns the group size (0: nothing else
// was done). `keep_pre` stores pre for the backward. Starts and ends with
// a block-wide barrier.
__device__ int group_forward(const Smem& s, const float* __restrict__ ef,
                             const float* __restrict__ a, const int* __restrict__ types,
                             const int* __restrict__ valid, int n, int c, int t, int num_types,
                             bool keep_pre) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long slot0 = static_cast<long long>(n) * c;
  const int cnt = pemp::select_group(s.list, s.warp_cnt, types, valid, slot0, c, t);
  if (cnt == 0) return 0;

  for (int i = tid; i < cnt * kWidth; i += kThreads) {
    const int r = i / kWidth, k = i % kWidth;
    s.ef[r * kLd + k] = ef[(slot0 + s.list[r]) * kWidth + k];
  }
  if (tid < kWidth) s.vec[tid] = a[(static_cast<long long>(n) * num_types + t) * kWidth + tid];
  __syncthreads();

  for (int r = warp; r < cnt; r += kWarps) {
    const float* er = s.ef + r * kLd;
    const float v = warp_sum(er[lane] * s.wat[lane] + er[lane + 32] * s.wat[lane + 32]);
    if (lane == 0) s.logit[r] = v;
  }
  __syncthreads();
  pemp::group_softmax(s.logit, s.e, s.scal, cnt);

  // pre = a + ef @ We_t: a warp per row, lanes on output columns lane, lane + 32
  float acc0 = 0.f, acc1 = 0.f;
  for (int r = warp; r < cnt; r += kWarps) {
    const float* er = s.ef + r * kLd;
    float p0 = 0.f, p1 = 0.f;
#pragma unroll 8
    for (int k = 0; k < kWidth; ++k) {
      const float x = er[k];
      p0 += x * s.we[k * kLd + lane];
      p1 += x * s.we[k * kLd + lane + 32];
    }
    p0 += s.vec[lane];
    p1 += s.vec[lane + 32];
    if (keep_pre) {
      s.pre[r * kWidth + lane] = p0;
      s.pre[r * kWidth + lane + 32] = p1;
    }
    const float ev = s.e[r];
    acc0 += ev * fmaxf(p0, 0.f);
    acc1 += ev * fmaxf(p1, 0.f);
  }
  s.red[warp * kWidth + lane] = acc0;
  s.red[warp * kWidth + lane + 32] = acc1;
  __syncthreads();
  return cnt;
}

__global__ void __launch_bounds__(kThreads) typed_message_fwd(
    const float* __restrict__ ef, const float* __restrict__ a, const int* __restrict__ types,
    const int* __restrict__ valid, const float* __restrict__ we,
    const float* __restrict__ w_attn, float* __restrict__ out, int num_nodes, int c,
    int num_types) {
  extern __shared__ float smem[];
  const Smem s(smem, c);
  const int t = blockIdx.y;
  stage_weights(s, we, w_attn, t, num_types);
  const int n0 = blockIdx.x * kFwdChunk;
  const int n1 = min(n0 + kFwdChunk, num_nodes);
  for (int n = n0; n < n1; ++n) {
    const int cnt = group_forward(s, ef, a, types, valid, n, c, t, num_types, false);
    if (threadIdx.x < kWidth) {
      const long long o = (static_cast<long long>(n) * num_types + t) * kWidth + threadIdx.x;
      out[o] = cnt == 0 ? 0.f : pemp::sum_partials(s.red, threadIdx.x) / s.scal[1];
    }
  }
}

__global__ void __launch_bounds__(kThreads) typed_message_bwd(
    const float* __restrict__ ef, const float* __restrict__ a, const int* __restrict__ types,
    const int* __restrict__ valid, const float* __restrict__ we,
    const float* __restrict__ w_attn, const float* __restrict__ g, float* __restrict__ d_ef,
    float* __restrict__ da, float* __restrict__ ws_we, float* __restrict__ ws_wa,
    int num_nodes, int c, int num_types, int node_chunk) {
  extern __shared__ float smem[];
  const Smem s(smem, c);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t = blockIdx.y;
  stage_weights(s, we, w_attn, t, num_types);

  // this thread's share of the dwe_t partial: row kk, columns oo + 4j
  const int kk = tid >> 2, oo = tid & 3;
  float acc[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) acc[j] = 0.f;
  float wacc = 0.f;  // dwa[tid] partial, tid < kWidth

  const int n0 = blockIdx.x * node_chunk;
  const int n1 = min(n0 + node_chunk, num_nodes);
  for (int n = n0; n < n1; ++n) {
    const long long row = (static_cast<long long>(n) * num_types + t) * kWidth;
    const int cnt = group_forward(s, ef, a, types, valid, n, c, t, num_types, true);
    if (cnt == 0) {
      if (tid < kWidth) da[row + tid] = 0.f;
      continue;
    }
    const float den = s.scal[1];
    if (tid < kWidth) {
      const float gv = g[row + tid];
      const float ov = pemp::sum_partials(s.red, tid) / den;
      s.vec[kWidth + tid] = gv;
      const float prod = warp_sum(gv * ov);
      if (lane == 0) s.scal[2 + warp] = prod;
    }
    __syncthreads();
    const float q = (s.scal[2] + s.scal[3]) / den;
    const float gh0 = s.vec[kWidth + lane] / den;
    const float gh1 = s.vec[kWidth + lane + 32] / den;

    float da0 = 0.f, da1 = 0.f;
    const long long slot0 = static_cast<long long>(n) * c;
    for (int r = warp; r < cnt; r += kWarps) {
      const float ev = s.e[r];
      const float p0 = s.pre[r * kWidth + lane];
      const float p1 = s.pre[r * kWidth + lane + 32];
      const float dm0 = ev * gh0, dm1 = ev * gh1;
      const float dp0 = p0 > 0.f ? dm0 : 0.f;
      const float dp1 = p1 > 0.f ? dm1 : 0.f;
      const float dl = warp_sum(dm0 * fmaxf(p0, 0.f) + dm1 * fmaxf(p1, 0.f)) - ev * q;
      s.pre[r * kWidth + lane] = dp0;
      s.pre[r * kWidth + lane + 32] = dp1;
      if (lane == 0) s.logit[r] = dl;
      da0 += dp0;
      da1 += dp1;
      __syncwarp();
      // d_ef[s] = dpre @ We_t^T + dlogit * w_attn, lanes on k = lane, lane + 32
      float d0 = dl * s.wat[lane], d1 = dl * s.wat[lane + 32];
      const float* dr = s.pre + r * kWidth;
#pragma unroll 8
      for (int o = 0; o < kWidth; ++o) {
        const float dp = dr[o];
        d0 += dp * s.we[lane * kLd + o];
        d1 += dp * s.we[(lane + 32) * kLd + o];
      }
      float* dst = d_ef + (slot0 + s.list[r]) * kWidth;
      dst[lane] = d0;
      dst[lane + 32] = d1;
    }
    s.red[warp * kWidth + lane] = da0;
    s.red[warp * kWidth + lane + 32] = da1;
    __syncthreads();
    if (tid < kWidth) da[row + tid] = pemp::sum_partials(s.red, tid);
    for (int r = 0; r < cnt; ++r) {
      const float x = s.ef[r * kLd + kk];
      const float* dr = s.pre + r * kWidth + oo;
#pragma unroll
      for (int j = 0; j < 16; ++j) acc[j] += x * dr[4 * j];
    }
    if (tid < kWidth) {
      for (int r = 0; r < cnt; ++r) wacc += s.ef[r * kLd + tid] * s.logit[r];
    }
  }

  const long long part = static_cast<long long>(blockIdx.x) * num_types + t;
#pragma unroll
  for (int j = 0; j < 16; ++j) ws_we[(part * kWidth + kk) * kWidth + oo + 4 * j] = acc[j];
  if (tid < kWidth) ws_wa[part * kWidth + tid] = wacc;
}

// dwe[k, t*D + o] = sum over chunks of ws_we[chunk, t, k, o]; dwa[k] = sum
// over chunks and types of ws_wa[chunk, t, k]; both in a fixed order.
__global__ void __launch_bounds__(kThreads) typed_message_bwd_reduce(
    const float* __restrict__ ws_we, const float* __restrict__ ws_wa, float* __restrict__ dwe,
    float* __restrict__ dwa, int num_types, int chunks) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const int per_type = kWidth * kWidth;
  if (i < num_types * per_type) {
    const int t = i / per_type, k = (i / kWidth) % kWidth, o = i % kWidth;
    float v = 0.f;
    for (int ch = 0; ch < chunks; ++ch)
      v += ws_we[((static_cast<long long>(ch) * num_types + t) * kWidth + k) * kWidth + o];
    dwe[static_cast<long long>(k) * num_types * kWidth + t * kWidth + o] = v;
  }
  if (i < kWidth) {
    float v = 0.f;
    for (int ch = 0; ch < chunks; ++ch)
      for (int t = 0; t < num_types; ++t)
        v += ws_wa[(static_cast<long long>(ch) * num_types + t) * kWidth + i];
    dwa[i] = v;
  }
}

int set_smem(const void* kernel, size_t bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes)));
}

}  // namespace

// Forward (K2). Pointers are f32 except types and valid (int32); rows are
// kWidth wide. Returns a cudaError_t, or -2 for unsupported sizes.
extern "C" int pemp_typed_message_fwd(const float* ef, const float* a, const int* types,
                                      const int* valid, const float* we, const float* w_attn,
                                      float* out, int num_nodes, int c, int num_types,
                                      void* stream) {
  if (c < 1 || c > kMaxSlots || num_types < 1 || num_nodes < 1) return -2;
  const size_t smem = smem_bytes(c);
  int err = set_smem(reinterpret_cast<const void*>(typed_message_fwd), smem);
  if (err != 0) return err;
  const dim3 grid((num_nodes + kFwdChunk - 1) / kFwdChunk, num_types);
  typed_message_fwd<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      ef, a, types, valid, we, w_attn, out, num_nodes, c, num_types);
  return static_cast<int>(cudaGetLastError());
}

// Backward (K2b): d_ef must be zeroed by the caller (slots no group owns,
// the invalid ones, keep 0); ws_we holds chunks * T * kWidth * kWidth
// floats and ws_wa chunks * T * kWidth, chunks = ceil(N / node_chunk).
extern "C" int pemp_typed_message_bwd(const float* ef, const float* a, const int* types,
                                      const int* valid, const float* we, const float* w_attn,
                                      const float* g, float* d_ef, float* da, float* dwe,
                                      float* dwa, float* ws_we, float* ws_wa, int num_nodes,
                                      int c, int num_types, int node_chunk, void* stream) {
  if (c < 1 || c > kMaxSlots || num_types < 1 || num_nodes < 1 || node_chunk < 1) return -2;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = smem_bytes(c);
  int err = set_smem(reinterpret_cast<const void*>(typed_message_bwd), smem);
  if (err != 0) return err;
  const int chunks = (num_nodes + node_chunk - 1) / node_chunk;
  typed_message_bwd<<<dim3(chunks, num_types), kThreads, smem, st>>>(
      ef, a, types, valid, we, w_attn, g, d_ef, da, ws_we, ws_wa, num_nodes, c, num_types,
      node_chunk);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  const int outputs = num_types * kWidth * kWidth;
  typed_message_bwd_reduce<<<(outputs + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      ws_we, ws_wa, dwe, dwa, num_types, chunks);
  return static_cast<int>(cudaGetLastError());
}
