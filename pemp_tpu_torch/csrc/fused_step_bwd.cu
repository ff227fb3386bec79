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
// pre_h is recomputed in K1's float32 order (fused_step.cu, the f32 form):
// the 64 products of cur[s] @ w_cur fused-multiply-added in k order from 0,
// then ((p + h_node) + that) + q. A value within rounding of 0 then falls on
// the forward's side: a mask that differs flips a whole element of d_pre.
//
// What bounds it on an H100: at the model_58_4 training shapes (B = 8:
// N = 5440 nodes, C = 80 slots, E = 435,200, widths 64, f32) it does five
// 64x64 products a slot (the recomputed cur @ w_cur, d_ef @ w_e1^T,
// d_pre @ w_cur^T, and the two weight gradients): ~17.8 GFLOP, ~0.27 ms at
// the f32 CUDA-core rate of 67 TFLOP/s. It reads q, cur, ne, g_ne and g_agg
// and writes dq and dcur (~780 MB, ~0.23 ms at 3.35 TB/s). Bound by
// operations, so the design keeps the FMA units fed.
//
// What the design does about it. A block of 256 threads owns one target
// node at a time (a persistent grid, two blocks an SM); its C rows of cur,
// of relu(pre_h) (then d_pre) and of d_ef stay in shared memory with both
// weights, so each E-sized input is read from device memory once and each
// output written once. Per node:
//
// 1. relu(pre_h) (pre_pass), 2. dw_e1 and db_e1, 3. d_pre and dq over
//    relu(pre_h) (dpre_pass), 4. dw_cur and dh_node's lane sums, 5. dcur
//    (dcur_pass), with a block barrier between steps.
// - The three row products are register tiles: a thread owns up to 8 rows
//   x 4 columns and reads the weights and the rows as float4 from shared
//   memory, 4 + 8 loads for 128 FMAs. pre_h reads w_cur by rows of k
//   (columns c0..c0 + 3); the two transposed products read a row of
//   the weight for each of the thread's columns cg, cg + 16, cg + 32,
//   cg + 48 (dot4), so no transposed copy is kept. d_pre overwrites
//   relu(pre_h) element by element; dcur reads the row group's d_pre rows,
//   which only the 16 threads of that row group, all in one warp, write.
// - The weight gradients are tiled products over the node's rows: thread
//   (k0, o0) keeps a 4 x 4 tile of dw_cur and of dw_e1 in registers over
//   all of its block's nodes, 4 loads for 32 FMAs a row, and writes them
//   once as the block's partial. A second launch sums the partials in
//   block order. No float atomics: two calls give the same bits.
// - The next node's rows load while this one computes: its first
//   cotangent's rows by cp.async into the d_ef rows once step 3 has read
//   them (during steps 4-5), its cur rows into the cur rows once step 4
//   has read them (during step 5), and kAhead pieces a thread of its second
//   cotangent and of ne into registers during steps 4-5. d_ef is completed
//   in place after step 5; the pieces past kAhead are loaded then. More
//   pieces ahead spill registers and run slower.
//
// Shared memory: ~101 KB a block at C = 80 (the three row buffers 65 KB,
// the weights 35 KB), so two blocks share an SM and hide each other's
// barriers. A second set of row buffers would leave one block per SM.
//
// Orders of summation: every element of pre_h, d_pre (dq) and dcur is an
// fmaf chain over k = 0..63 in order, so they do not depend on the tiling,
// and pre_h is K1's. dw_cur and dw_e1 are fmaf chains over the block's
// nodes in order and each node's slots in order; db_e1 and dh_node are lane
// sums (rows lane, lane + 4, ...) taken in a fixed order. For a given grid
// every output has fixed bits.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWidth = 64;                    // every row: H == Dc == De
constexpr int kLanes = kThreads / kWidth;     // 4 row lanes of the column sums
constexpr int kLdR = kWidth + 4;              // row stride of the rows and the weights: 16-byte
                                              // rows, and rows r, r + 1.. of a quarter-warp in
                                              // distinct banks
constexpr int kPassRows = 128;                // rows of one register-tiled pass: 16 row groups x 8
constexpr int kAhead = 2;                     // d_ef pieces a thread loads a node ahead
constexpr int kPartial = 2 * kWidth * kWidth + kLanes * kWidth;  // floats of a block's partial

__host__ __device__ constexpr int rows16(int c) { return (c + 15) & ~15; }

// dynamic shared memory of the main launch for C slots a node
size_t smem_bytes(int c) {
  return sizeof(float) * (3 * static_cast<size_t>(rows16(c)) * kLdR + 2 * kWidth * kLdR +
                          kLanes * kWidth) +
         sizeof(int) * rows16(c);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }

__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

// one k of four columns: acc[j] = fmaf(x, w_j, acc[j])
__device__ __forceinline__ void fma4(float (&acc)[4], float x, const float4& w) {
  acc[0] = fmaf(x, w.x, acc[0]);
  acc[1] = fmaf(x, w.y, acc[1]);
  acc[2] = fmaf(x, w.z, acc[2]);
  acc[3] = fmaf(x, w.w, acc[3]);
}

// four ks of one column, in order: acc + x.x w.x + x.y w.y + ...
__device__ __forceinline__ float dot4(float acc, const float4& x, const float4& w) {
  return fmaf(x.w, w.w, fmaf(x.z, w.z, fmaf(x.y, w.y, fmaf(x.x, w.x, acc))));
}

// one row of a 4 x 4 tile of x^T y: acc[i][j] = fmaf(x_i, y_j, acc[i][j])
__device__ __forceinline__ void outer4(float (&acc)[4][4], const float4& x, const float4& y) {
  fma4(acc[0], x.x, y);
  fma4(acc[1], x.y, y);
  fma4(acc[2], x.z, y);
  fma4(acc[3], x.w, y);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// The c rows at src (kWidth floats each) into dst, row stride kLdR, by
// cp.async in 16-byte pieces: piece i of the rows goes to thread i mod
// kThreads.
__device__ __forceinline__ void copy_rows(float* dst, const float* __restrict__ src, int c) {
  for (int i = threadIdx.x; i < c * (kWidth / 4); i += kThreads)
    cp_async16(dst + (i >> 4) * kLdR + 4 * (i & 15), src + 4 * i);
}

// A node's d_ef = (g_ne + g_agg) * (ne > 0) in flight. `first` (g_agg
// where both cotangents are given, else the one given) comes by cp.async
// into the d_ef rows; a thread's first kAhead pieces of `second` (g_ne
// where both are given, else none) and of ne wait in registers, so that
// the loads overlap the previous node's last product.
struct DefLoad {
  float4 g[kAhead];
  float4 e[kAhead];
};

__device__ __forceinline__ void d_ef_start(DefLoad& d, float* s_e, const float* __restrict__ first,
                                           const float* __restrict__ second,
                                           const float* __restrict__ ne, int c) {
  copy_rows(s_e, first, c);
#pragma unroll
  for (int j = 0; j < kAhead; ++j) {
    const int i = threadIdx.x + j * kThreads;
    if (i < c * (kWidth / 4)) {
      d.e[j] = ldg4(ne + 4 * i);
      if (second) d.g[j] = ldg4(second + 4 * i);
    }
  }
}

// piece i of d_ef from the copy of `first` at it, second's piece g (if
// any) and ne's piece e, in place
__device__ __forceinline__ void d_ef_piece(float* s_e, int i, float4 e, bool two, float4 g) {
  float* dst = s_e + (i >> 4) * kLdR + 4 * (i & 15);
  float4 v = ld4(dst);
  if (two) v = make_float4(g.x + v.x, g.y + v.y, g.z + v.z, g.w + v.w);
  st4(dst, make_float4(e.x > 0.f ? v.x : 0.f, e.y > 0.f ? v.y : 0.f, e.z > 0.f ? v.z : 0.f,
                       e.w > 0.f ? v.w : 0.f));
}

// Completes d_ef once the thread's copies are waited for: its first kAhead
// pieces from registers, the rest (C > 4 kAhead kThreads / kWidth) loaded
// now. A thread touches only the pieces it copied.
__device__ __forceinline__ void d_ef_finish(const DefLoad& d, float* s_e,
                                            const float* __restrict__ second,
                                            const float* __restrict__ ne, int c) {
  const int pieces = c * (kWidth / 4);
#pragma unroll
  for (int j = 0; j < kAhead; ++j) {
    const int i = threadIdx.x + j * kThreads;
    if (i < pieces) d_ef_piece(s_e, i, d.e[j], second != nullptr, d.g[j]);
  }
  for (int i = threadIdx.x + kAhead * kThreads; i < pieces; i += kThreads)
    d_ef_piece(s_e, i, ldg4(ne + 4 * i), second != nullptr,
               second ? ldg4(second + 4 * i) : make_float4(0.f, 0.f, 0.f, 0.f));
}

// relu(pre_h) for rows base + rg + 16 i (i < RT) of the node, rg the
// thread's row group, at columns c0..c0 + 3: pre_h = ((p[j] + h_node[n]) +
// cur @ w_cur) + q, in K1's order. Rows at or past c are computed on
// whatever the buffer holds and never stored.
template <int RT>
__device__ void pre_pass(const float* s_wcur, const float* s_a, float* s_h, const int* s_src,
                         const float* __restrict__ p, const float* __restrict__ h_node,
                         const float* __restrict__ q, int base, int c, long long n,
                         long long img_base, long long slot0) {
  const int row0 = base + (threadIdx.x >> 4), c0 = 4 * (threadIdx.x & 15);
  float acc[RT][4];
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 2
  for (int k = 0; k < kWidth; k += 4) {
    float4 wv[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) wv[j] = ld4(s_wcur + (k + j) * kLdR + c0);
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const float4 xv = ld4(s_a + (row0 + 16 * i) * kLdR + k);
      fma4(acc[i], xv.x, wv[0]);
      fma4(acc[i], xv.y, wv[1]);
      fma4(acc[i], xv.z, wv[2]);
      fma4(acc[i], xv.w, wv[3]);
    }
  }
  const float4 hv = ldg4(h_node + n * kWidth + c0);
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int r = row0 + 16 * i;
    if (r < c) {
      const float4 pv = ldg4(p + (img_base + s_src[r]) * kWidth + c0);
      const float4 qv = ldg4(q + (slot0 + r) * kWidth + c0);
      st4(s_h + r * kLdR + c0,
          make_float4(fmaxf(((pv.x + hv.x) + acc[i][0]) + qv.x, 0.f),
                      fmaxf(((pv.y + hv.y) + acc[i][1]) + qv.y, 0.f),
                      fmaxf(((pv.z + hv.z) + acc[i][2]) + qv.z, 0.f),
                      fmaxf(((pv.w + hv.w) + acc[i][3]) + qv.w, 0.f)));
    }
  }
}

// acc[i][j] = row row0 + 16 i of x times w^T at column cg + 16 j, w a
// kWidth x kLdR weight read by rows: each element an fmaf chain over k in
// order.
template <int RT>
__device__ __forceinline__ void transposed_product(float (&acc)[RT][4], const float* w,
                                                   const float* x, int row0, int cg) {
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 2
  for (int k = 0; k < kWidth; k += 4) {
    float4 wv[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) wv[j] = ld4(w + (cg + 16 * j) * kLdR + k);
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const float4 xv = ld4(x + (row0 + 16 * i) * kLdR + k);
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = dot4(acc[i][j], xv, wv[j]);
    }
  }
}

// d_pre = (d_ef @ w_e1^T) * (pre_h > 0) over relu(pre_h) in s_h, and dq,
// for rows base + rg + 16 i (i < RT), columns cg + 16 j.
template <int RT>
__device__ void dpre_pass(const float* s_we1, const float* s_e, float* s_h,
                          float* __restrict__ dq, int base, int c, long long slot0) {
  const int row0 = base + (threadIdx.x >> 4), cg = threadIdx.x & 15;
  float acc[RT][4];
  transposed_product<RT>(acc, s_we1, s_e, row0, cg);
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int r = row0 + 16 * i;
    if (r < c) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = cg + 16 * j;
        const float v = s_h[r * kLdR + col] > 0.f ? acc[i][j] : 0.f;
        s_h[r * kLdR + col] = v;
        dq[(slot0 + r) * kWidth + col] = v;
      }
    }
  }
}

// dcur = d_pre @ w_cur^T for the rows and columns of dpre_pass.
template <int RT>
__device__ void dcur_pass(const float* s_wcur, const float* s_h, float* __restrict__ dcur,
                          int base, int c, long long slot0) {
  const int row0 = base + (threadIdx.x >> 4), cg = threadIdx.x & 15;
  float acc[RT][4];
  transposed_product<RT>(acc, s_wcur, s_h, row0, cg);
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int r = row0 + 16 * i;
    if (r < c) {
#pragma unroll
      for (int j = 0; j < 4; ++j) dcur[(slot0 + r) * kWidth + cg + 16 * j] = acc[i][j];
    }
  }
}

// Runs pass<RT> over the node's c rows in passes of kPassRows, with RT the
// fewest rows a thread needs for the pass.
#define PEMP_ROW_PASSES(pass, ...)                                              \
  for (int base = 0; base < c; base += kPassRows) {                             \
    switch ((min(c - base, kPassRows) + 15) >> 4) {                             \
      case 1: pass<1>(__VA_ARGS__); break;                                      \
      case 2: pass<2>(__VA_ARGS__); break;                                      \
      case 3: pass<3>(__VA_ARGS__); break;                                      \
      case 4: pass<4>(__VA_ARGS__); break;                                      \
      case 5: pass<5>(__VA_ARGS__); break;                                      \
      case 6: pass<6>(__VA_ARGS__); break;                                      \
      case 7: pass<7>(__VA_ARGS__); break;                                      \
      default: pass<8>(__VA_ARGS__); break;                                     \
    }                                                                           \
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
  const int rc = rows16(c);
  float* s_wcur = smem;                 // W x kLdR: w_cur[k][j]
  float* s_we1 = s_wcur + W * kLdR;     // W x kLdR: w_e1[k][j]
  float* s_a = s_we1 + W * kLdR;        // rc x kLdR: cur rows
  float* s_h = s_a + rc * kLdR;         // rc x kLdR: relu(pre_h) rows, then d_pre
  float* s_e = s_h + rc * kLdR;         // rc x kLdR: d_ef rows
  float* s_sum = s_e + rc * kLdR;       // kLanes x W: each lane's share of dh_node
  int* s_src = reinterpret_cast<int*>(s_sum + kLanes * W);

  const int tid = threadIdx.x;
  const int col = tid % W, lane = tid / W;               // the column sums
  const int k0 = 4 * (tid >> 4), o0 = 4 * (tid & 15);    // the weight gradients' 4 x 4 tile

  for (int i = tid; i < W * W / 4; i += kThreads) {
    const int k = i / (W / 4), j = 4 * (i % (W / 4));
    st4(s_wcur + k * kLdR + j, ldg4(w_cur + 4 * i));
    st4(s_we1 + k * kLdR + j, ldg4(w_e1 + 4 * i));
  }
  float dwc[4][4], dwe[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) dwc[i][j] = dwe[i][j] = 0.f;
  float db = 0.f;

  // the block's first node: its cur rows, source column and d_ef
  const float* first = g_agg ? g_agg : g_ne;
  const float* second = g_agg ? g_ne : nullptr;
  const auto rows_of = [&](const float* x, long long row0) { return x ? x + row0 * W : x; };
  DefLoad d;
  if (static_cast<int>(blockIdx.x) < num_nodes) {
    const long long row0 = static_cast<long long>(blockIdx.x) * c;
    copy_rows(s_a, cur + row0 * W, c);
    for (int r = tid; r < c; r += kThreads) s_src[r] = src[row0 + r];
    d_ef_start(d, s_e, rows_of(first, row0), rows_of(second, row0), rows_of(ne, row0), c);
    cp_async_wait_all();
    d_ef_finish(d, s_e, rows_of(second, row0), rows_of(ne, row0), c);
  }

  for (int n = blockIdx.x; n < num_nodes; n += gridDim.x) {
    const long long slot0 = static_cast<long long>(n) * c;
    const long long img_base = static_cast<long long>(n / n_img) * n_img;
    const int next = n + gridDim.x;
    const long long next0 = static_cast<long long>(next) * c;
    __syncthreads();  // the node's cur rows, source column and d_ef are in

    // 1. relu(pre_h) over the node's rows
    PEMP_ROW_PASSES(pre_pass, s_wcur, s_a, s_h, s_src, p, h_node, q, base, c, n, img_base, slot0)
    __syncthreads();

    // 2. dw_e1 += relu(pre_h)^T d_ef slot by slot; db_e1: each lane sums
    // rows lane, lane + 4, ...
    for (int r = 0; r < c; ++r) outer4(dwe, ld4(s_h + r * kLdR + k0), ld4(s_e + r * kLdR + o0));
    for (int r = lane; r < c; r += kLanes) db += s_e[r * kLdR + col];
    __syncthreads();  // relu(pre_h) is read: d_pre may overwrite it

    // 3. d_pre and dq over relu(pre_h)
    PEMP_ROW_PASSES(dpre_pass, s_we1, s_e, s_h, dq, base, c, slot0)
    __syncthreads();  // d_ef is read: the next node's may come in

    // 4. the next node's d_ef in flight; dw_cur += cur^T d_pre slot by
    // slot; dh_node: each lane sums rows lane, lane + 4, ...
    if (next < num_nodes)
      d_ef_start(d, s_e, rows_of(first, next0), rows_of(second, next0), rows_of(ne, next0), c);
    for (int r = 0; r < c; ++r) outer4(dwc, ld4(s_a + r * kLdR + k0), ld4(s_h + r * kLdR + o0));
    float hsum = 0.f;
    for (int r = lane; r < c; r += kLanes) hsum += s_h[r * kLdR + col];
    s_sum[lane * W + col] = hsum;
    __syncthreads();  // cur is read: the next node's may come in

    // 5. the next node's cur rows and source column in flight; dcur; then
    // dh_node (the lanes' sums in order) and the next node's d_ef completed
    if (next < num_nodes) {
      copy_rows(s_a, cur + next0 * W, c);
      for (int r = tid; r < c; r += kThreads) s_src[r] = src[next0 + r];
    }
    PEMP_ROW_PASSES(dcur_pass, s_wcur, s_h, dcur, base, c, slot0)
    if (tid < W) {
      float v = s_sum[tid];
#pragma unroll
      for (int l = 1; l < kLanes; ++l) v += s_sum[l * W + tid];
      dh_node[static_cast<long long>(n) * W + tid] = v;
    }
    if (next < num_nodes) {
      cp_async_wait_all();
      d_ef_finish(d, s_e, rows_of(second, next0), rows_of(ne, next0), c);
    }
  }

  float* out = partial + static_cast<long long>(blockIdx.x) * kPartial;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    st4(out + (k0 + i) * W + o0, make_float4(dwc[i][0], dwc[i][1], dwc[i][2], dwc[i][3]));
    st4(out + W * W + (k0 + i) * W + o0,
        make_float4(dwe[i][0], dwe[i][1], dwe[i][2], dwe[i][3]));
  }
  out[2 * W * W + lane * W + col] = db;
}

#undef PEMP_ROW_PASSES

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

// K1b: every array float32 and contiguous, rows kWidth wide; p, h_node, q,
// cur, w_cur, w_e1, ne, g_ne, g_agg and partial 16-byte aligned (read or
// written in 16-byte pieces); g_ne or g_agg may be null (no such
// cotangent), not both. partial holds `blocks` (the value of
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
  if (!(aligned16(p) && aligned16(h_node) && aligned16(q) && aligned16(cur) &&
        aligned16(w_cur) && aligned16(w_e1) && aligned16(ne) && (!g_ne || aligned16(g_ne)) &&
        (!g_agg || aligned16(g_agg)) && aligned16(partial)))
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
