// K1b: the backward of K1's edge MLP, hand-written for Hopper (sm_90a).
//
// It has no Pallas source of its own: the JAX package differentiates its
// fused step (pemp_tpu/ops/pallas/fused_step.py::_step_bwd_rule) by jax.vjp
// of the jnp reference. Its tail (the typed message and the attention
// aggregation) is K2's function, so the port's backward runs K2b for the
// tail, this kernel for the edge MLP, and G1 for the source gather. Per
// slot s of target node n = s / C with source j = img_base + src[s]:
//
//   pre_h  = p[j] + h_node[n] + cur[s] @ w_cur + q[s]     (recomputed)
//   d_ef   = (g_ne + g_agg)[s] * (ne[s] > 0)              (relu'(0) = 0)
//   d_pre  = (d_ef @ w_e1^T) * (pre_h > 0)
//   dq[s]  = d_pre,  dcur[s] = d_pre @ w_cur^T
//   dh_node[n] = sum over n's C slots of d_pre
//   dw_cur = sum over s of cur[s]^T d_pre,  dw_e1 = sum of relu(pre_h)^T d_ef,
//   db_e1  = sum of d_ef
//
// with g_ne the cotangent of the new edge carry and g_agg K2b's d_ef (either
// may be absent). dp, the scatter of dq onto the source rows, is G1's. Every
// slot counts, the invalid ones too: the edge MLP runs on them all, and only
// the aggregation skips them (K2b gives them a zero g_agg).
//
// The ReLU masks must be the forward's. ne > 0 is read off K1's own output.
// pre_h is recomputed in K1's float32 order (fused_step.cu, stage 1): the
// 64 products of cur[s] @ w_cur fused-multiply-added in k order from 0, then
// ((p + h_node) + that) + q. A value within rounding of 0 then falls on the
// forward's side: a mask that differs flips a whole element of d_pre.
//
// What bounds it on an H100: at the model_58_4 training shapes (B = 8:
// N = 5440 nodes, C = 80 slots, E = 435,200, widths 64, f32) it does five
// 64x64 products a slot (the recomputed cur @ w_cur, d_ef @ w_e1^T,
// d_pre @ w_cur^T, and the two weight gradients): ~17.8 GFLOP, ~0.27 ms at
// the f32 CUDA-core rate of 67 TFLOP/s. It reads q, cur, ne, g_ne and g_agg
// and writes dq and dcur (~780 MB, ~0.23 ms at 3.35 TB/s). Bound by
// operations.
//
// What the design does about it (the first, simple form): a block of 256
// threads owns one target node at a time (a persistent grid, two blocks an
// SM); its C rows of cur, d_ef and the recomputed pre_h stay in shared
// memory with both weights, so each E-sized input is read from device
// memory once and each output written once. Thread (lane = tid / 64,
// col = tid % 64) owns column col of rows lane, lane + 4, ..., eight at a
// time in registers, reading rows as float4 broadcasts. The cur rows are
// overwritten by d_pre once pre_h is formed; the weight gradients read cur
// again through L1. Each thread keeps 16 rows of one column of dw_cur and
// of dw_e1 in registers over all of its block's nodes, and writes them once
// as the block's partial; a second launch sums the partials in block order.
// No float atomics: two calls give the same bits.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWidth = 64;                    // every row: H == Dc == De
constexpr int kLanes = kThreads / kWidth;     // 4 row lanes
constexpr int kRows = 8;                      // rows a thread per register tile
constexpr int kWLd = kWidth + 1;              // padded weight stride: rows, columns conflict-free
constexpr int kOwn = kWidth / kLanes;         // weight-gradient rows a thread owns: 16
constexpr int kPartial = 2 * kWidth * kWidth + kLanes * kWidth;  // floats of a block's partial

// dynamic shared memory of the main launch for C slots a node
size_t smem_bytes(int c) {
  return sizeof(float) * (3 * static_cast<size_t>(c) * kWidth + 2 * kWidth * kWLd +
                          kLanes * kWidth) +
         sizeof(int) * c;
}

// acc with the products of x's four components and w0..w3 fused into it,
// in that order
__device__ __forceinline__ float fma4(float4 x, float w0, float w1, float w2, float w3,
                                      float acc) {
  acc = fmaf(x.x, w0, acc);
  acc = fmaf(x.y, w1, acc);
  acc = fmaf(x.z, w2, acc);
  return fmaf(x.w, w3, acc);
}

// acc[i] = rows[rr[i]] . w[:, col] for a W x kWLd weight `w` read as
// w[k * kWLd + col] (by_row) or w[col * kWLd + k] (transposed), k in order.
template <bool kByRow>
__device__ __forceinline__ void row_products(const float* rows, const int (&rr)[kRows],
                                             const float* w, int col, float (&acc)[kRows]) {
#pragma unroll
  for (int i = 0; i < kRows; ++i) acc[i] = 0.f;
  for (int k = 0; k < kWidth; k += 4) {
    float wv[4];
#pragma unroll
    for (int m = 0; m < 4; ++m)
      wv[m] = kByRow ? w[(k + m) * kWLd + col] : w[col * kWLd + k + m];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const float4 x = *reinterpret_cast<const float4*>(rows + rr[i] * kWidth + k);
      acc[i] = fma4(x, wv[0], wv[1], wv[2], wv[3], acc[i]);
    }
  }
}

__global__ void __launch_bounds__(kThreads, 2) fused_step_bwd(
    const float* __restrict__ p, const float* __restrict__ h_node, const float* __restrict__ q,
    const float* __restrict__ cur, const int* __restrict__ src, const float* __restrict__ w_cur,
    const float* __restrict__ w_e1, const float* __restrict__ ne,
    const float* __restrict__ g_ne, const float* __restrict__ g_agg, float* __restrict__ dq,
    float* __restrict__ dcur, float* __restrict__ dh_node, float* __restrict__ partial,
    int num_nodes, int c, int n_img) {
  constexpr int W = kWidth;
  extern __shared__ __align__(16) float smem[];
  float* s_a = smem;                  // C x W: cur rows, then d_pre rows
  float* s_h = s_a + c * W;           // C x W: pre_h rows
  float* s_e = s_h + c * W;           // C x W: d_ef rows
  float* s_wcur = s_e + c * W;        // W x kWLd: w_cur[k][j]
  float* s_we1 = s_wcur + W * kWLd;   // W x kWLd: w_e1[k][j]
  float* s_sum = s_we1 + W * kWLd;    // kLanes x W: each lane's share of dh_node
  int* s_src = reinterpret_cast<int*>(s_sum + kLanes * W);

  const int tid = threadIdx.x;
  const int col = tid % W;
  const int lane = tid / W;

  for (int i = tid; i < W * W; i += kThreads) {
    s_wcur[(i / W) * kWLd + i % W] = w_cur[i];
    s_we1[(i / W) * kWLd + i % W] = w_e1[i];
  }
  float dwc[kOwn], dwe[kOwn];
#pragma unroll
  for (int i = 0; i < kOwn; ++i) dwc[i] = dwe[i] = 0.f;
  float db = 0.f;

  for (int n = blockIdx.x; n < num_nodes; n += gridDim.x) {
    const long long slot0 = static_cast<long long>(n) * c;
    const long long img_base = static_cast<long long>(n / n_img) * n_img;
    __syncthreads();  // weights staged; the previous node's buffers are free
    const float4* cur4 = reinterpret_cast<const float4*>(cur + slot0 * W);
    const float4* ne4 = reinterpret_cast<const float4*>(ne + slot0 * W);
    const float4* gn4 = g_ne ? reinterpret_cast<const float4*>(g_ne + slot0 * W) : nullptr;
    const float4* ga4 = g_agg ? reinterpret_cast<const float4*>(g_agg + slot0 * W) : nullptr;
    for (int i = tid; i < c * W / 4; i += kThreads) {
      reinterpret_cast<float4*>(s_a)[i] = cur4[i];
      float4 g = gn4 ? gn4[i] : make_float4(0.f, 0.f, 0.f, 0.f);
      if (ga4) {
        const float4 b = ga4[i];
        g = gn4 ? make_float4(g.x + b.x, g.y + b.y, g.z + b.z, g.w + b.w) : b;
      }
      const float4 e = ne4[i];
      reinterpret_cast<float4*>(s_e)[i] =
          make_float4(e.x > 0.f ? g.x : 0.f, e.y > 0.f ? g.y : 0.f, e.z > 0.f ? g.z : 0.f,
                      e.w > 0.f ? g.w : 0.f);
    }
    for (int r = tid; r < c; r += kThreads) s_src[r] = src[slot0 + r];
    __syncthreads();

    // pre_h = ((p[j] + h_node[n]) + cur @ w_cur) + q, in K1's order
    const float hn = h_node[static_cast<long long>(n) * W + col];
    for (int r0 = lane; r0 < c; r0 += kLanes * kRows) {
      int rr[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) rr[i] = min(r0 + i * kLanes, c - 1);
      float acc[kRows];
      row_products<true>(s_a, rr, s_wcur, col, acc);
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int r = r0 + i * kLanes;
        if (r < c)
          s_h[r * W + col] = p[(img_base + s_src[r]) * W + col] + hn + acc[i] +
                             q[(slot0 + r) * W + col];
      }
    }
    __syncthreads();

    // d_pre = (d_ef @ w_e1^T) * (pre_h > 0), written over the cur rows and to dq
    for (int r0 = lane; r0 < c; r0 += kLanes * kRows) {
      int rr[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) rr[i] = min(r0 + i * kLanes, c - 1);
      float acc[kRows];
      row_products<false>(s_e, rr, s_we1, col, acc);
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int r = r0 + i * kLanes;
        if (r < c) {
          const float v = s_h[r * W + col] > 0.f ? acc[i] : 0.f;
          s_a[r * W + col] = v;
          dq[(slot0 + r) * W + col] = v;
        }
      }
    }
    __syncthreads();

    // dcur = d_pre @ w_cur^T
    for (int r0 = lane; r0 < c; r0 += kLanes * kRows) {
      int rr[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) rr[i] = min(r0 + i * kLanes, c - 1);
      float acc[kRows];
      row_products<false>(s_a, rr, s_wcur, col, acc);
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int r = r0 + i * kLanes;
        if (r < c) dcur[(slot0 + r) * W + col] = acc[i];
      }
    }
    // the weight gradients: rows lane * 16 .. + 16 of column col, slot by slot
    for (int r = 0; r < c; ++r) {
      const float dp = s_a[r * W + col];
      const float de = s_e[r * W + col];
      const float4* xr = reinterpret_cast<const float4*>(cur + (slot0 + r) * W + lane * kOwn);
      const float4* hr = reinterpret_cast<const float4*>(s_h + r * W + lane * kOwn);
#pragma unroll
      for (int m = 0; m < kOwn / 4; ++m) {
        const float4 x = __ldg(xr + m);
        const float4 h = hr[m];
        dwc[4 * m + 0] = fmaf(x.x, dp, dwc[4 * m + 0]);
        dwc[4 * m + 1] = fmaf(x.y, dp, dwc[4 * m + 1]);
        dwc[4 * m + 2] = fmaf(x.z, dp, dwc[4 * m + 2]);
        dwc[4 * m + 3] = fmaf(x.w, dp, dwc[4 * m + 3]);
        dwe[4 * m + 0] = fmaf(fmaxf(h.x, 0.f), de, dwe[4 * m + 0]);
        dwe[4 * m + 1] = fmaf(fmaxf(h.y, 0.f), de, dwe[4 * m + 1]);
        dwe[4 * m + 2] = fmaf(fmaxf(h.z, 0.f), de, dwe[4 * m + 2]);
        dwe[4 * m + 3] = fmaf(fmaxf(h.w, 0.f), de, dwe[4 * m + 3]);
      }
    }
    // db_e1 and dh_node: each lane sums rows lane, lane + 4, ...
    float hsum = 0.f;
    for (int r = lane; r < c; r += kLanes) {
      db += s_e[r * W + col];
      hsum += s_a[r * W + col];
    }
    s_sum[lane * W + col] = hsum;
    __syncthreads();
    if (tid < W) {
      float v = s_sum[tid];
#pragma unroll
      for (int l = 1; l < kLanes; ++l) v += s_sum[l * W + tid];
      dh_node[static_cast<long long>(n) * W + tid] = v;
    }
  }

  float* out = partial + static_cast<long long>(blockIdx.x) * kPartial;
#pragma unroll
  for (int i = 0; i < kOwn; ++i) {
    out[(lane * kOwn + i) * W + col] = dwc[i];
    out[W * W + (lane * kOwn + i) * W + col] = dwe[i];
  }
  out[2 * W * W + lane * W + col] = db;
}

// dw_cur, dw_e1 and db_e1 from the blocks' partials, a thread an output,
// each summed in block order (db_e1 also over the four lanes, in order).
__global__ void __launch_bounds__(kThreads) fused_step_bwd_reduce(
    const float* __restrict__ partial, float* __restrict__ dw_cur, float* __restrict__ dw_e1,
    float* __restrict__ db_e1, int blocks) {
  constexpr int W = kWidth;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i < 2 * W * W) {
    float v = 0.f;
    for (int b = 0; b < blocks; ++b) v += partial[static_cast<long long>(b) * kPartial + i];
    if (i < W * W)
      dw_cur[i] = v;
    else
      dw_e1[i - W * W] = v;
  } else if (i < 2 * W * W + W) {
    const int j = i - 2 * W * W;
    float v = 0.f;
    for (int b = 0; b < blocks; ++b)
      for (int l = 0; l < kLanes; ++l)
        v += partial[static_cast<long long>(b) * kPartial + 2 * W * W + l * W + j];
    db_e1[j] = v;
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// the persistent grid for num_nodes nodes of c slots (0 on an error, set in err)
int grid_for(int num_nodes, int c, cudaError_t* err) {
  const size_t smem = smem_bytes(c);
  *err = cudaFuncSetAttribute(fused_step_bwd, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
  if (*err != cudaSuccess) return 0;
  int dev = 0, sms = 0, per_sm = 0;
  if ((*err = cudaGetDevice(&dev)) != cudaSuccess) return 0;
  if ((*err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return 0;
  if ((*err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fused_step_bwd, kThreads,
                                                            smem)) != cudaSuccess)
    return 0;
  if (per_sm < 1) per_sm = 1;
  return num_nodes < sms * per_sm ? num_nodes : sms * per_sm;
}

}  // namespace

// The floats of one block's partial sums; the caller's workspace holds
// pemp_fused_step_bwd_grid(...) such partials.
extern "C" int pemp_fused_step_bwd_partial_floats() { return kPartial; }

// The main launch's grid (blocks) for num_nodes nodes of c slots, or a
// negative cudaError_t.
extern "C" int pemp_fused_step_bwd_grid(int num_nodes, int c) {
  if (num_nodes < 1 || c < 1) return -2;
  cudaError_t err;
  const int grid = grid_for(num_nodes, c, &err);
  return grid > 0 ? grid : -static_cast<int>(err);
}

// K1b: every array float32 and contiguous, rows kWidth wide; cur, ne, g_ne
// and g_agg 16-byte aligned (read in 16-byte pieces); g_ne or g_agg may be
// null (no such cotangent), not both. partial holds `blocks` (the value of
// pemp_fused_step_bwd_grid for these sizes) times
// pemp_fused_step_bwd_partial_floats() floats. Writes dq, dcur, dh_node,
// dw_cur, dw_e1 and db_e1 whole. Returns a cudaError_t, or -2 for
// unsupported sizes or alignment.
extern "C" int pemp_fused_step_bwd(const float* p, const float* h_node, const float* q,
                                   const float* cur, const int* src, const float* w_cur,
                                   const float* w_e1, const float* ne, const float* g_ne,
                                   const float* g_agg, float* dq, float* dcur, float* dh_node,
                                   float* dw_cur, float* dw_e1, float* db_e1, float* partial,
                                   int num_nodes, int c, int n_img, int blocks, void* stream) {
  if (num_nodes < 1 || c < 1 || n_img < 1 || num_nodes % n_img != 0 || blocks < 1 ||
      (g_ne == nullptr && g_agg == nullptr))
    return -2;
  if (!(aligned16(cur) && aligned16(ne) && (!g_ne || aligned16(g_ne)) &&
        (!g_agg || aligned16(g_agg))))
    return -2;
  cudaError_t err;
  const int grid = grid_for(num_nodes, c, &err);
  if (grid == 0) return static_cast<int>(err);
  if (grid != blocks) return -2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  fused_step_bwd<<<grid, kThreads, smem_bytes(c), s>>>(p, h_node, q, cur, src, w_cur, w_e1, ne,
                                                       g_ne, g_agg, dq, dcur, dh_node, partial,
                                                       num_nodes, c, n_img);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const int outputs = 2 * kWidth * kWidth + kWidth;
  fused_step_bwd_reduce<<<(outputs + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      partial, dw_cur, dw_e1, db_e1, grid);
  return static_cast<int>(cudaGetLastError());
}
