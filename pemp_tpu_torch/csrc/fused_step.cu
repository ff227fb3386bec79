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
// projects onto all 17 types and selects). `we` itself (139 KB bf16, 278 KB
// f32) stays in L2.
//
// Two forms, chosen by dtype in pemp_fused_step at the end of this file:
//
// * float32: fused_step_kernel<float>, the first form of this kernel. It
//   serves the small CPU-against-card checks and the f32 kernel tests. It
//   does its arithmetic on the CUDA cores in f32, one block of 256 threads
//   per target node (grid-stride loop, weights staged once per block), slots
//   grouped by type so one read of a `we` column serves every slot of that
//   type. With W = kWidth, thread (lane = tid / W, col = tid % W) owns
//   output column `col` for rows lane, lane + 256/W, ...
// * bfloat16, the eval main path: tc::fused_step_bf16_kernel, the
//   tensor-core form (its own note is further down).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWidth = 64;     // every row: H == Dc == De == D, as both presets have
constexpr int kRows = 8;       // rows per thread per register tile
constexpr int kMaxTypes = 32;

__device__ __forceinline__ float to_f(float x) { return x; }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }

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

// ---------------------------------------------------------------------------
// The bf16 form: the same function on the tensor cores.
//
// A block owns a tile of whole target nodes (kTileRows / C of them, 3 at
// C = 80: 240 slot rows) and walks the tiles of a persistent grid, two
// blocks per SM. Per tile:
//
// 1. cp.async copies the tile's index columns and a rows, then its cur and q
//    rows in 16-byte pieces (ragged rows zero-filled), into shared memory.
//    While cur and q are in flight the warps sort the valid slots: one warp
//    per node ranks its slots within (type, node) with __match_any_sync and
//    popcount (stable, in slot order), warp 0 lays the types' runs out, each
//    padded to 16 rows, and every thread scatters its slot to its place. No
//    slot-by-slot loop.
// 2. Each warp takes 16-row tiles: h = relu(p[j] + h_node[n] + cur @ w_cur
//    + q) with mma.sync m16n8k16 (bf16 in, f32 sums; A and w_cur through
//    ldmatrix), rounded to bf16 in registers, which are already the A
//    fragments of ef = relu(h @ w_e1 + b_e1); ef goes back over the cur rows
//    in shared memory, and the logit ef . w_attn is summed across the four
//    lanes that hold a row.
// 3. ne is written from shared memory in 16-byte stores. A thread per
//    (node, type) group takes the group's max and sum of exp(logit - max)
//    (~3 slots a group at C = 80, T = 17). Then the warps take (type, half
//    of the columns) items: a warp projects the type's run of ef rows
//    (gathered by ldmatrix through the sorted order) onto 32 columns of that
//    type's 64x64 slice of we only, with the slice's B fragments read
//    straight from L2 in 4-byte words, all at once, and reduces the 16 rows
//    of each product tile in slot order into 128-byte halves of the out
//    rows. Every sum has a fixed order: two calls give the same bits.
//
// bf16 products are exact in f32, so h and ef round at the reference's
// points; the tensor cores add within a k16 step in another order than
// cuBLAS's f32 GEMM, so an h or ef value may land one bf16 step apart.
// `we` is not staged in shared memory: an item's words are read once per
// block tile and serve the type's one or two 16-row product tiles (~10
// valid rows per type at C = 80), and the ~100 KB a block uses keeps two
// blocks per SM. Shared memory bounds C (to ~700 at T = 17: a larger C
// makes the launch fail with an error; nothing falls back).

namespace tc {

typedef __nv_bfloat16 bf16;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kW = 64;           // every row width
constexpr int kLd = kW + 8;      // bf16 row stride in shared memory: 144 bytes, ldmatrix conflict-free
constexpr int kTileRows = 256;   // slot rows per block tile, at most
constexpr int kMaxTileNodes = 32;
constexpr int kScratchLd = kW / 2 + 4;  // f32 stride of a warp's 16-row, half-width product tile

// bf16 elements of the q region: q rows, then the warps' f32 product tiles
__host__ __device__ constexpr int q_elems(int rows_cap) {
  return rows_cap * kLd > kWarps * 16 * kScratchLd * 2 ? rows_cap * kLd
                                                       : kWarps * 16 * kScratchLd * 2;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool fill) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(fill ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

// wait until at most `pending` of this thread's copy groups are in flight
template <int pending> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(pending) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

// d += a (16x16, row-major fragment) @ b (16x8, column fragment), f32 sums
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float2 bf2_to_f2(uint32_t u) {
  __nv_bfloat162 v;
  *reinterpret_cast<uint32_t*>(&v) = u;
  return __bfloat1622float2(v);
}

__device__ __forceinline__ float2 load_bf2_shared(const bf16* p) {
  return bf2_to_f2(*reinterpret_cast<const uint32_t*>(p));
}

__device__ __forceinline__ uint32_t pack_bf2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A 16-row tile times a 64x64 weight in shared memory ([k][n], stride kLd),
// with A as four k16 fragments per row block: acc[nt] holds columns
// 8 nt .. 8 nt + 7.
__device__ __forceinline__ void tile_gemm(float (&acc)[8][4], const uint32_t (&a)[4][4],
                                          const bf16* w, int lane) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nt][i] = 0.f;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, w + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kLd + j * 16 +
                               (lane >> 4) * 8);
      mma(acc[2 * j], a[kk], b[0], b[1]);
      mma(acc[2 * j + 1], a[kk], b[2], b[3]);
    }
  }
}

__global__ void __launch_bounds__(kThreads, 2) fused_step_bf16_kernel(
    const bf16* __restrict__ p, const bf16* __restrict__ h_node, const bf16* __restrict__ q,
    const bf16* __restrict__ cur, const bf16* __restrict__ a, const int* __restrict__ src,
    const int* __restrict__ types, const int* __restrict__ valid,
    const bf16* __restrict__ w_cur, const bf16* __restrict__ w_e1,
    const bf16* __restrict__ b_e1, const bf16* __restrict__ we,
    const bf16* __restrict__ w_attn, bf16* __restrict__ ne, float* __restrict__ out,
    int num_nodes, int c, int t, int n_img, int tile_nodes, int rows_cap) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* s_wcur = reinterpret_cast<bf16*>(smem_raw);  // [k][n], stride kLd
  bf16* s_we1 = s_wcur + kW * kLd;
  bf16* s_x = s_we1 + kW * kLd;                      // cur rows, then ef rows
  bf16* s_q = s_x + rows_cap * kLd;                  // q rows, then the warps' product tiles
  bf16* s_a = s_q + q_elems(rows_cap);               // the tile's a rows, [node][type][W]
  float* s_be1 = reinterpret_cast<float*>(s_a + tile_nodes * t * kW);
  float* s_wat = s_be1 + kW;
  const int order_cap = rows_cap + 16 * t;
  float* s_e = s_wat + kW;  // per sorted place: its logit, then exp(logit - max)
  int* s_order = reinterpret_cast<int*>(s_e + order_cap);  // sorted place -> tile row
  int* s_pnode = s_order + order_cap;                // sorted place -> node in the tile
  int* s_src = s_pnode + order_cap;
  int* s_key = s_src + rows_cap;                     // types, then the type of a valid slot or -1
  int* s_valid = s_key + rows_cap;
  int* s_rank = s_valid + rows_cap;  // place within its (type, node) group, then sorted place
  int* s_cnt = s_rank + rows_cap;                    // [type][node] group sizes
  int* s_seg0 = s_cnt + t * tile_nodes;              // [type][node] first sorted place
  float* s_den = reinterpret_cast<float*>(s_seg0 + t * tile_nodes);
  int* s_run0 = reinterpret_cast<int*>(s_den + t * tile_nodes);  // per type
  int* s_runlen = s_run0 + kMaxTypes;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;   // fragment row
  const int tq = lane & 3;   // fragment column pair

  for (int i = tid; i < kW * kW; i += kThreads) {
    s_wcur[(i / kW) * kLd + i % kW] = w_cur[i];
    s_we1[(i / kW) * kLd + i % kW] = w_e1[i];
  }
  for (int i = tid; i < kW; i += kThreads) {
    s_be1[i] = __bfloat162float(b_e1[i]);
    s_wat[i] = __bfloat162float(w_attn[i]);
  }

  const int num_tiles = (num_nodes + tile_nodes - 1) / tile_nodes;
  const long long wstride = static_cast<long long>(t) * kW;
  for (int tile = blockIdx.x; tile < num_tiles; tile += gridDim.x) {
    const int n0 = tile * tile_nodes;
    const int nt = min(tile_nodes, num_nodes - n0);
    const int rows = nt * c;
    const int rows16 = (rows + 15) & ~15;
    const long long slot0 = static_cast<long long>(n0) * c;

    // 1. everything the tile reads in flight: first the index columns and
    // a, then the cur and q rows, which the sort does not wait for
    for (int r = tid; r < rows; r += kThreads) {
      cp_async4(s_src + r, src + slot0 + r);
      cp_async4(s_key + r, types + slot0 + r);
      cp_async4(s_valid + r, valid + slot0 + r);
    }
    const long long a0 = static_cast<long long>(n0) * t * kW;
    for (int i = tid; i < nt * t * 8; i += kThreads) cp_async16(s_a + i * 8, a + a0 + i * 8, true);
    cp_async_commit();
    for (int i = tid; i < rows16 * 8; i += kThreads) {
      const int r = i >> 3, ch = (i & 7) * 8;
      const bool in = r < rows;
      const long long off = (slot0 + (in ? r : 0)) * kW + ch;
      cp_async16(s_x + r * kLd + ch, cur + off, in);
      cp_async16(s_q + r * kLd + ch, q + off, in);
    }
    cp_async_commit();
    for (int i = tid; i < t * tile_nodes; i += kThreads) s_cnt[i] = 0;
    cp_async_wait<1>();
    __syncthreads();

    for (int nl = warp; nl < nt; nl += kWarps) {
      for (int b = 0; b < c; b += 32) {
        const int rl = b + lane;
        const int r = nl * c + rl;
        int key = -1;
        if (rl < c) {
          const int ty = s_key[r];
          if (s_valid[r] != 0 && ty >= 0 && ty < t) key = ty;
        }
        const unsigned peers = __match_any_sync(0xffffffffu, key);
        const int base = key >= 0 ? s_cnt[key * tile_nodes + nl] : 0;
        __syncwarp();
        if (rl < c) s_key[r] = key;
        if (key >= 0) {
          s_rank[r] = base + __popc(peers & ((1u << lane) - 1u));
          if (__ffs(peers) - 1 == lane) s_cnt[key * tile_nodes + nl] = base + __popc(peers);
        }
        __syncwarp();
      }
    }
    __syncthreads();

    if (warp == 0) {  // lay the types' runs out, each padded to 16 rows
      int run = 0;
      if (lane < t) {
        for (int nl = 0; nl < nt; ++nl) {
          s_seg0[lane * tile_nodes + nl] = run;
          run += s_cnt[lane * tile_nodes + nl];
        }
      }
      const int padded = (run + 15) & ~15;
      int incl = padded;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += v;
      }
      const int start = incl - padded;
      if (lane < t) {
        s_run0[lane] = start;
        s_runlen[lane] = run;
        for (int nl = 0; nl < nt; ++nl) s_seg0[lane * tile_nodes + nl] += start;
        for (int i = start + run; i < start + padded; ++i) s_order[i] = 0;  // pad rows read row 0
      }
    }
    __syncthreads();
    for (int r = tid; r < rows; r += kThreads) {
      const int key = s_key[r];
      if (key >= 0) {
        const int pos = s_seg0[key * tile_nodes + r / c] + s_rank[r];
        s_order[pos] = r;
        s_pnode[pos] = r / c;
        s_rank[r] = pos;
      }
    }
    cp_async_wait<0>();
    __syncthreads();

    // 2. h and ef per 16-row tile, on the tensor cores
    for (int m0 = warp * 16; m0 < rows16; m0 += kWarps * 16) {
      // the source and target rows first, so their loads overlap the product
      uint32_t pw[2][8], hw[2][8];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = m0 + g + 8 * half;
        const bool in = r < rows;
        const int n = n0 + (in ? r / c : 0);
        const long long j = static_cast<long long>(n / n_img) * n_img + (in ? s_src[r] : 0);
        const unsigned int* prow = reinterpret_cast<const unsigned int*>(p + j * kW);
        const unsigned int* hrow =
            reinterpret_cast<const unsigned int*>(h_node + static_cast<long long>(n) * kW);
#pragma unroll
        for (int nt8 = 0; nt8 < 8; ++nt8) {
          pw[half][nt8] = in ? __ldg(prow + nt8 * 4 + tq) : 0u;
          hw[half][nt8] = in ? __ldg(hrow + nt8 * 4 + tq) : 0u;
        }
      }
      uint32_t frag[4][4];
      float acc[8][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        ldmatrix_x4(frag[kk], s_x + (m0 + (lane & 15)) * kLd + kk * 16 + (lane >> 4) * 8);
      tile_gemm(acc, frag, s_wcur, lane);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = m0 + g + 8 * half;
        const bool in = r < rows;
#pragma unroll
        for (int nt8 = 0; nt8 < 8; ++nt8) {
          const int col = nt8 * 8 + 2 * tq;
          float v0 = 0.f, v1 = 0.f;
          if (in) {
            const float2 pv = bf2_to_f2(pw[half][nt8]), hv = bf2_to_f2(hw[half][nt8]);
            const float2 qv = load_bf2_shared(s_q + r * kLd + col);
            v0 = fmaxf(((pv.x + hv.x) + acc[nt8][2 * half]) + qv.x, 0.f);
            v1 = fmaxf(((pv.y + hv.y) + acc[nt8][2 * half + 1]) + qv.y, 0.f);
          }
          // the accumulator of columns 16 kk .. 16 kk + 15 is h's A fragment kk
          frag[nt8 >> 1][half + 2 * (nt8 & 1)] = pack_bf2(v0, v1);
        }
      }
      tile_gemm(acc, frag, s_we1, lane);
      __syncwarp();
      float lg[2] = {0.f, 0.f};
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = m0 + g + 8 * half;
#pragma unroll
        for (int nt8 = 0; nt8 < 8; ++nt8) {
          const int col = nt8 * 8 + 2 * tq;
          const uint32_t e = pack_bf2(fmaxf(acc[nt8][2 * half] + s_be1[col], 0.f),
                                      fmaxf(acc[nt8][2 * half + 1] + s_be1[col + 1], 0.f));
          *reinterpret_cast<uint32_t*>(s_x + r * kLd + col) = e;  // this warp's rows only
          const float2 ef = bf2_to_f2(e);
          lg[half] += ef.x * s_wat[col] + ef.y * s_wat[col + 1];
        }
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        lg[half] += __shfl_xor_sync(0xffffffffu, lg[half], 1);
        lg[half] += __shfl_xor_sync(0xffffffffu, lg[half], 2);
        const int r = m0 + g + 8 * half;
        if (tq == 0 && r < rows && s_key[r] >= 0) s_e[s_rank[r]] = lg[half];
      }
    }
    __syncthreads();

    // 3. ne in 16-byte stores, then the typed projection and the softmax
    for (int i = tid; i < rows * 8; i += kThreads) {
      const int r = i >> 3, ch = (i & 7) * 8;
      *reinterpret_cast<uint4*>(ne + (slot0 + r) * kW + ch) =
          *reinterpret_cast<const uint4*>(s_x + r * kLd + ch);
    }
    // the softmax of each (node, type) group, a thread per group (a group
    // holds C * valid share / T slots, ~3 at the flagship shapes)
    for (int i = tid; i < t * nt; i += kThreads) {
      const int tt = i / nt, nl = i % nt;
      const int cnt = s_cnt[tt * tile_nodes + nl];
      const int seg = s_seg0[tt * tile_nodes + nl];
      float mx = __int_as_float(0xff800000);  // -inf
      for (int k = 0; k < cnt; ++k) mx = fmaxf(mx, s_e[seg + k]);
      float den = 0.f;
      for (int k = 0; k < cnt; ++k) {
        const float e = expf(s_e[seg + k] - mx);
        s_e[seg + k] = e;
        den += e;
      }
      s_den[tt * tile_nodes + nl] = fmaxf(den, 1e-16f);
      if (cnt == 0) {  // an empty group gives 0
        float4* orow =
            reinterpret_cast<float4*>(out + (static_cast<long long>(n0 + nl) * t + tt) * kW);
#pragma unroll
        for (int k = 0; k < kW / 4; ++k) orow[k] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
    __syncthreads();

    // the typed projection, by (type, half of the columns): the two halves
    // of a type go to neighbouring warps
    float* scratch = reinterpret_cast<float*>(s_q) + warp * 16 * kScratchLd;
    for (int item = warp; item < 2 * t; item += kWarps) {
      const int tt = item >> 1, col0 = (item & 1) * (kW / 2);
      const int run0 = s_run0[tt];
      const int run_end = run0 + s_runlen[tt];
      if (run_end == run0) continue;
      // B of n-tile 2 jj + s (columns col0 + 16 jj ..), column g, is
      // we[:, tt W + col0 + 16 jj + 2 g + s]: one 4-byte word per k row
      // serves both n-tiles of a pair. All 32 words of the item at once.
      const unsigned int* w0 = reinterpret_cast<const unsigned int*>(
          we + (2 * tq) * wstride + tt * kW + col0 + 2 * g);
      const long long ws = wstride / 2;  // one k row, in words
      uint32_t bw[4][2][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const unsigned int* w = w0 + kk * 16 * ws + jj * 8;
          bw[kk][jj][0] = __ldg(w);
          bw[kk][jj][1] = __ldg(w + ws);
          bw[kk][jj][2] = __ldg(w + 8 * ws);
          bw[kk][jj][3] = __ldg(w + 9 * ws);
        }
      int nl = -1;  // the group being summed: node nl of type tt
      float sum = 0.f, av = 0.f;
      for (int pos0 = run0; pos0 < run_end; pos0 += 16) {
        uint32_t frag[4];
        float acc[4][4];
#pragma unroll
        for (int nt4 = 0; nt4 < 4; ++nt4)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[nt4][i] = 0.f;
        const bf16* arow = s_x + s_order[pos0 + (lane & 15)] * kLd + (lane >> 4) * 8;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          ldmatrix_x4(frag, arow + kk * 16);
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
            const uint32_t* x = bw[kk][jj];
            mma(acc[2 * jj], frag, __byte_perm(x[0], x[1], 0x5410),
                __byte_perm(x[2], x[3], 0x5410));
            mma(acc[2 * jj + 1], frag, __byte_perm(x[0], x[1], 0x7632),
                __byte_perm(x[2], x[3], 0x7632));
          }
        }
        // thread (g, tq) holds columns col0 + 16 jj + 4 tq .. + 3 of rows g, g + 8
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          *reinterpret_cast<float4*>(scratch + g * kScratchLd + 16 * jj + 4 * tq) =
              make_float4(acc[2 * jj][0], acc[2 * jj + 1][0], acc[2 * jj][1], acc[2 * jj + 1][1]);
          *reinterpret_cast<float4*>(scratch + (g + 8) * kScratchLd + 16 * jj + 4 * tq) =
              make_float4(acc[2 * jj][2], acc[2 * jj + 1][2], acc[2 * jj][3], acc[2 * jj + 1][3]);
        }
        __syncwarp();
        // lane `lane` sums column col0 + lane of each group, in slot order;
        // eight rows' loads are issued before their sums
        const int last = min(16, run_end - pos0);
        for (int i0 = 0; i0 < last; i0 += 8) {
          float xs[8], es[8];
          int ns[8];
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const bool in = i0 + i < last;
            xs[i] = in ? scratch[(i0 + i) * kScratchLd + lane] : 0.f;
            es[i] = in ? s_e[pos0 + i0 + i] : 0.f;
            ns[i] = in ? s_pnode[pos0 + i0 + i] : -1;
          }
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            if (i0 + i >= last) break;
            if (ns[i] != nl) {  // the next group starts: the last one is whole
              if (nl >= 0)
                out[(static_cast<long long>(n0 + nl) * t + tt) * kW + col0 + lane] =
                    sum / s_den[tt * tile_nodes + nl];
              nl = ns[i];
              sum = 0.f;
              av = __bfloat162float(s_a[(nl * t + tt) * kW + col0 + lane]);
            }
            sum += es[i] * fmaxf(av + xs[i], 0.f);
          }
        }
        __syncwarp();
      }
      out[(static_cast<long long>(n0 + nl) * t + tt) * kW + col0 + lane] =
          sum / s_den[tt * tile_nodes + nl];
    }
    __syncthreads();
  }
}

// Block tile: whole nodes, at most kTileRows slot rows and 16 KB of a rows.
int tile_nodes_for(int c, int t) {
  int nodes = c > 0 ? kTileRows / c : kMaxTileNodes;
  nodes = min(nodes, kMaxTileNodes);
  nodes = min(nodes, 16384 / (t * kW * 2));
  return max(nodes, 1);
}

int launch(const void* p, const void* h_node, const void* q, const void* cur, const void* a,
           const int* src, const int* types, const int* valid, const void* w_cur,
           const void* w_e1, const void* b_e1, const void* we, const void* w_attn, void* ne,
           float* out, int num_nodes, int c, int t, int n_img, cudaStream_t stream) {
  const int tile_nodes = tile_nodes_for(c, t);
  const int rows_cap = (tile_nodes * c + 15) & ~15;
  const int order_cap = rows_cap + 16 * t;
  const size_t smem =
      sizeof(bf16) * (2 * kW * kLd + rows_cap * kLd + q_elems(rows_cap) + tile_nodes * t * kW) +
      sizeof(float) * (2 * kW + order_cap) +
      sizeof(int) * (2 * order_cap + 4 * rows_cap + 3 * t * tile_nodes + 2 * kMaxTypes);
  cudaError_t err = cudaFuncSetAttribute(
      fused_step_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(err);
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return static_cast<int>(err);
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fused_step_bf16_kernel,
                                                           kThreads, smem)) != cudaSuccess)
    return static_cast<int>(err);
  if (per_sm < 1) per_sm = 1;
  const int num_tiles = (num_nodes + tile_nodes - 1) / tile_nodes;
  const int grid = num_tiles < sms * per_sm ? num_tiles : sms * per_sm;
  fused_step_bf16_kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(p), static_cast<const bf16*>(h_node), static_cast<const bf16*>(q),
      static_cast<const bf16*>(cur), static_cast<const bf16*>(a), src, types, valid,
      static_cast<const bf16*>(w_cur), static_cast<const bf16*>(w_e1),
      static_cast<const bf16*>(b_e1), static_cast<const bf16*>(we),
      static_cast<const bf16*>(w_attn), static_cast<bf16*>(ne), out, num_nodes, c, t, n_img,
      tile_nodes, rows_cap);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

}  // namespace

// dtype: 0 = float32 (the CUDA-core form), 1 = bfloat16 (the tensor-core
// form); rows are kWidth wide. Returns a cudaError_t, or -1 for an
// unsupported dtype and -2 for more than 32 types.
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
    return tc::launch(p, h_node, q, cur, a, src, types, valid, w_cur, w_e1, b_e1, we, w_attn, ne,
                      out, num_nodes, c, t, n_img, s);
  return -1;
}
