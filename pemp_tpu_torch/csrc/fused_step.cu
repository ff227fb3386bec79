// K1: one fully fused flagship MPN step, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel pemp_tpu/ops/pallas/fused_step.py::_step_kernel
// (reached through _step_forward's pl.pallas_call, public fused_mpn_step).
// Per edge slot s of target node n = s / C with source j = img_base + src[s]:
//
//   h[s]  = relu(p[j] + h_node[n] + q[s] + cur[s] @ w_cur)   rounded to T
//   ef[s] = relu(h[s] @ w_e1 + b_e1)                         rounded to T, -> ne
//   m[s]  = relu(a[n, t_s] + ef[s] @ we[:, t_s])
//   out[n, t] = sum over n's valid type-t slots of softmax(ef @ w_attn) * m
//
// with an empty (n, t) group giving 0 and the softmax denominator clamped
// at 1e-16 (pemp_tpu/ops/pallas/fused_step.py::step_reference).
//
// What bounds it on an H100: at the flagship eval shapes (B = 8: N = 5440
// nodes, C = 80 slots, 64-wide rows, bf16) one launch must read q, cur,
// a, the index columns and the node tables (~130 MB) and write ne and the
// f32 output (~79 MB): ~62 us at 3.35 TB/s, against ~11 us for its
// ~10.7 GFLOP at the bf16 tensor-core peak. It is memory-bound.
//
// What the design does about it: every E-sized intermediate (the gathered
// source rows, h, the typed projection, the messages and the softmax
// weights) lives in shared memory or registers, so device memory sees each
// input once and each output once. The TPU kernel's workarounds are not
// carried over: the source rows are gathered directly by index (Mosaic had
// no gather, so the TPU form contracts a one-hot matrix), and each slot is
// projected only onto its own type's 64x64 slice of `we` (the TPU form
// projects onto all 17 types and selects). Slots are grouped by type inside
// the block, so one read of a `we` column serves every slot of that type;
// `we` itself (139 KB bf16, 278 KB f32) stays in L2. This first version
// does its arithmetic on the CUDA cores in f32 (no wgmma, TMA or
// pipelining), so it is expected to sit above the memory bound.
//
// Layout: one block of 256 threads walks target nodes (grid-stride loop,
// weights staged once per block). With W = kWidth, thread (lane = tid / W,
// col = tid % W) owns output column `col` for rows lane, lane + 256/W, ...

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWidth = 64;     // every row: H == Dc == De == D, as both presets have
constexpr int kRows = 8;       // rows per thread per register tile
constexpr int kMaxTypes = 32;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// the reference casts h and ef to the working type before using them
template <typename T> __device__ __forceinline__ float round_t(float x) {
  return to_f(from_f<T>(x));
}

template <typename T, int W>
__global__ void __launch_bounds__(kThreads) fused_step_kernel(
    const T* __restrict__ p, const T* __restrict__ h_node, const T* __restrict__ q,
    const T* __restrict__ cur, const T* __restrict__ a, const int* __restrict__ src,
    const int* __restrict__ types, const int* __restrict__ valid,
    const T* __restrict__ w_cur, const T* __restrict__ w_e1, const T* __restrict__ b_e1,
    const T* __restrict__ we, const T* __restrict__ w_attn, T* __restrict__ ne,
    float* __restrict__ out, int num_nodes, int c, int t, int n_img) {
  constexpr int kLanes = kThreads / W;
  constexpr int kLd = W + 1;  // padded row stride: column reads hit distinct banks
  extern __shared__ float smem[];
  float* s_wcur = smem;               // [k][j], W x W
  float* s_we1 = s_wcur + W * W;      // [k][j], W x W
  float* s_be1 = s_we1 + W * W;       // W
  float* s_wat = s_be1 + W;           // W
  float* s_x = s_wat + W;             // C x kLd: cur rows, then ef rows
  float* s_h = s_x + c * kLd;         // C x kLd: hidden rows
  float* s_logit = s_h + c * kLd;     // C
  int* s_src = reinterpret_cast<int*>(s_logit + c);
  int* s_type = s_src + c;
  int* s_valid = s_type + c;
  int* s_order = s_valid + c;         // valid slots grouped by type
  int* s_gstart = s_order + c;        // kMaxTypes
  int* s_gcount = s_gstart + kMaxTypes;

  const int tid = threadIdx.x;
  const int col = tid % W;
  const int lane = tid / W;

  for (int i = tid; i < W * W; i += kThreads) {
    s_wcur[i] = to_f(w_cur[i]);
    s_we1[i] = to_f(w_e1[i]);
  }
  for (int i = tid; i < W; i += kThreads) {
    s_be1[i] = to_f(b_e1[i]);
    s_wat[i] = to_f(w_attn[i]);
  }

  for (int n = blockIdx.x; n < num_nodes; n += gridDim.x) {
    const long long slot0 = static_cast<long long>(n) * c;
    const long long img_base = static_cast<long long>(n / n_img) * n_img;
    __syncthreads();  // weights staged; the previous node's buffers are free
    for (int i = tid; i < c * W; i += kThreads) {
      s_x[(i / W) * kLd + i % W] = to_f(cur[slot0 * W + i]);
    }
    for (int r = tid; r < c; r += kThreads) {
      s_src[r] = src[slot0 + r];
      s_type[r] = types[slot0 + r];
      s_valid[r] = valid[slot0 + r] != 0;
    }
    __syncthreads();

    // group the valid slots by type, in slot order within a type
    for (int tt = tid; tt < t; tt += kThreads) {
      int cnt = 0;
      for (int r = 0; r < c; ++r) cnt += (s_valid[r] && s_type[r] == tt);
      s_gcount[tt] = cnt;
    }
    __syncthreads();
    if (tid == 0) {
      int acc = 0;
      for (int tt = 0; tt < t; ++tt) {
        s_gstart[tt] = acc;
        acc += s_gcount[tt];
      }
    }
    __syncthreads();
    for (int r = tid; r < c; r += kThreads) {
      if (s_valid[r]) {
        const int ty = s_type[r];
        int rank = 0;
        for (int r2 = 0; r2 < r; ++r2) rank += (s_valid[r2] && s_type[r2] == ty);
        s_order[s_gstart[ty] + rank] = r;
      }
    }

    // stage 1: h = relu(p[j] + h_node[n] + q + cur @ w_cur)
    const float hn = to_f(h_node[static_cast<long long>(n) * W + col]);
    for (int r0 = lane; r0 < c; r0 += kLanes * kRows) {
      float acc[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) acc[i] = 0.f;
      for (int k = 0; k < W; ++k) {
        const float wv = s_wcur[k * W + col];
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          const int r = r0 + i * kLanes;
          if (r < c) acc[i] += s_x[r * kLd + k] * wv;
        }
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int r = r0 + i * kLanes;
        if (r < c) {
          const float v = to_f(p[(img_base + s_src[r]) * W + col]) + hn + acc[i] +
                          to_f(q[(slot0 + r) * W + col]);
          s_h[r * kLd + col] = round_t<T>(fmaxf(v, 0.f));
        }
      }
    }
    __syncthreads();

    // stage 2: ef = relu(h @ w_e1 + b_e1), the new edge carry (every slot)
    const float bias = s_be1[col];
    for (int r0 = lane; r0 < c; r0 += kLanes * kRows) {
      float acc[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) acc[i] = 0.f;
      for (int k = 0; k < W; ++k) {
        const float wv = s_we1[k * W + col];
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          const int r = r0 + i * kLanes;
          if (r < c) acc[i] += s_h[r * kLd + k] * wv;
        }
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int r = r0 + i * kLanes;
        if (r < c) {
          const T v = from_f<T>(fmaxf(acc[i] + bias, 0.f));
          s_x[r * kLd + col] = to_f(v);
          ne[(slot0 + r) * W + col] = v;
        }
      }
    }
    __syncthreads();

    // attention logits: ef . w_attn (its bias is constant per group: dropped)
    for (int r = tid; r < c; r += kThreads) {
      float s = 0.f;
      for (int k = 0; k < W; ++k) s += s_x[r * kLd + k] * s_wat[k];
      s_logit[r] = s;
    }
    __syncthreads();

    // stage 3, per (n, type) group: typed projection onto the group's own
    // we slice, ReLU message, softmax-weighted sum. Lane `lane` owns types
    // lane, lane + kLanes, ...; its W threads share every row and we read.
    for (int tt = lane; tt < t; tt += kLanes) {
      const int cnt = s_gcount[tt];
      const int g0 = s_gstart[tt];
      const long long o = (static_cast<long long>(n) * t + tt) * W + col;
      if (cnt == 0) {
        out[o] = 0.f;
        continue;
      }
      float mx = __int_as_float(0xff800000);  // -inf
      for (int i = 0; i < cnt; ++i) mx = fmaxf(mx, s_logit[s_order[g0 + i]]);
      float den = 0.f;
      for (int i = 0; i < cnt; ++i) den += expf(s_logit[s_order[g0 + i]] - mx);
      den = fmaxf(den, 1e-16f);
      const float av = to_f(a[o]);
      const T* wcol = we + static_cast<long long>(tt) * W + col;  // we[k, tt*W + col]
      const long long wstride = static_cast<long long>(t) * W;
      float num = 0.f;
      for (int i0 = 0; i0 < cnt; i0 += kRows) {
        int rows[kRows];
        float acc[kRows];
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          rows[i] = s_order[g0 + min(i0 + i, cnt - 1)];
          acc[i] = 0.f;
        }
        for (int k = 0; k < W; ++k) {
          const float wv = to_f(wcol[k * wstride]);
#pragma unroll
          for (int i = 0; i < kRows; ++i) acc[i] += s_x[rows[i] * kLd + k] * wv;
        }
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          if (i0 + i < cnt) num += expf(s_logit[rows[i]] - mx) * fmaxf(av + acc[i], 0.f);
        }
      }
      out[o] = num / den;
    }
  }
}

template <typename T, int W>
int launch(const void* p, const void* h_node, const void* q, const void* cur, const void* a,
           const int* src, const int* types, const int* valid, const void* w_cur,
           const void* w_e1, const void* b_e1, const void* we, const void* w_attn, void* ne,
           float* out, int num_nodes, int c, int t, int n_img, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (2 * W * W + 2 * W + 2 * c * (W + 1) + c) +
                      sizeof(int) * (4 * c + 2 * kMaxTypes);
  auto kernel = fused_step_kernel<T, W>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(err);
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return static_cast<int>(err);
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem)) !=
      cudaSuccess)
    return static_cast<int>(err);
  if (per_sm < 1) per_sm = 1;
  const int grid = num_nodes < sms * per_sm ? num_nodes : sms * per_sm;
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(p), static_cast<const T*>(h_node), static_cast<const T*>(q),
      static_cast<const T*>(cur), static_cast<const T*>(a), src, types, valid,
      static_cast<const T*>(w_cur), static_cast<const T*>(w_e1), static_cast<const T*>(b_e1),
      static_cast<const T*>(we), static_cast<const T*>(w_attn), static_cast<T*>(ne), out,
      num_nodes, c, t, n_img);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; rows are kWidth wide. Returns a
// cudaError_t, or -1 for an unsupported dtype and -2 for more than 32 types.
extern "C" int pemp_fused_step(int dtype, const void* p, const void* h_node,
                               const void* q, const void* cur, const void* a, const int* src,
                               const int* types, const int* valid, const void* w_cur,
                               const void* w_e1, const void* b_e1, const void* we,
                               const void* w_attn, void* ne, float* out, int num_nodes, int c,
                               int t, int n_img, void* stream) {
  if (t > kMaxTypes) return -2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float, kWidth>(p, h_node, q, cur, a, src, types, valid, w_cur, w_e1, b_e1, we,
                                 w_attn, ne, out, num_nodes, c, t, n_img, s);
  if (dtype == 1)
    return launch<__nv_bfloat16, kWidth>(p, h_node, q, cur, a, src, types, valid, w_cur, w_e1,
                                         b_e1, we, w_attn, ne, out, num_nodes, c, t, n_img, s);
  return -1;
}
