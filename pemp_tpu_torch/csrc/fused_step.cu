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
// * bfloat16, the eval main path: tc::fused_step_bf16_kernel, the
//   tensor-core form (its own note is further down).
// * float32, the forward of every fused_step training step and of the
//   small CPU-against-card checks: f32::fused_step_f32_kernel on the CUDA
//   cores (its own note is at the end of the file).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int kMaxTypes = 32;

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

using pemp::bf16mma::bf16;
using pemp::bf16mma::bf2_to_f2;
using pemp::bf16mma::cp_async16;
using pemp::bf16mma::kLd;        // bf16 row stride in shared memory: 144 bytes, ldmatrix conflict-free
using pemp::bf16mma::ldmatrix_x4;
using pemp::bf16mma::ldmatrix_x4_trans;
using pemp::bf16mma::mma;
using pemp::bf16mma::smem_addr;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kW = 64;           // every row width
static_assert(kLd == kW + 8, "the shared stride is of a 64-wide row");
constexpr int kTileRows = 256;   // slot rows per block tile, at most
constexpr int kMaxTileNodes = 32;
constexpr int kScratchLd = kW / 2 + 4;  // f32 stride of a warp's 16-row, half-width product tile

// bf16 elements of the q region: q rows, then the warps' f32 product tiles
__host__ __device__ constexpr int q_elems(int rows_cap) {
  return rows_cap * kLd > kWarps * 16 * kScratchLd * 2 ? rows_cap * kLd
                                                       : kWarps * 16 * kScratchLd * 2;
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

// ---------------------------------------------------------------------------
// The f32 form: the same function on the CUDA cores, in float32.
//
// What bounds it on an H100: at the model_58_4 training shapes (B = 8:
// N = 5440, C = 80, E = 435,200, T = 17, widths 64, ~70 % of the slots
// valid) it does ~9.7 GFLOP, two 64x64 products a slot (h, ef) and one a
// valid slot (the typed projection): ~0.144 ms at the 67 TFLOP/s f32 rate.
// It reads q, cur, a and the index columns and writes ne and out (~370 MB,
// ~0.11 ms at 3.35 TB/s). Bound by operations: the design keeps the FMA
// units fed, and registers are what runs short (two 256-thread blocks an
// SM leave 128 a thread).
//
// A block owns a tile of whole target nodes (kTileRows / C of them, 3 at
// C = 80: 240 slot rows) and walks the tiles of a persistent grid, two
// blocks per SM. Per tile:
//
// 1. cp.async brings the tile's index columns, then its cur rows in 16-byte
//    pieces. While cur is in flight the warps sort the valid slots by type
//    with the bf16 form's ballot sort: a warp per node, __match_any_sync and
//    popcount, stable in slot order. A type's run holds its slots node by
//    node, unpadded.
// 2. h and ef are register tiles (mlp_pass). A thread owns 8 rows x 4
//    columns and reads w_cur or w_e1 and the rows as float4 from shared
//    memory: 12 loads for 128 FMAs. h overwrites the cur rows and ef the h
//    rows in place. Only the 16 threads of a row group, all in one warp,
//    read those rows, so a __syncwarp orders it. ne is stored from
//    registers. Then one thread a row takes its logit ef . w_attn.
// 3. A thread per (node, type) group takes its softmax: the max, each
//    slot's e and the denominator.
// 4. A warp per (type, half of the columns) item projects the type's run of
//    ef rows onto its half of the type's 64x64 slice of `we` (project_half):
//    a lane owns one column and loads its 64 weights into registers at
//    once, one L2 round trip an item; each slice is read once a tile
//    (~278 KB, ~500 MB a launch at C = 80). The rows go kChunk at a time
//    (more spill the registers), and the lanes sum each group's messages in
//    slot order straight into out.
//
// Shared memory: ~107 KB a block at C = 80 (weights 33 KB, rows 65 KB, the
// sort ~6 KB). A second row buffer, filled with the next tile's cur while
// this one computes, would need 65 KB more and leave one block per SM. Two
// blocks per SM hide each other's copies and barriers instead. Shared
// memory bounds C (to ~700 at T = 17: a larger C makes the launch fail with
// an error; nothing falls back).
//
// Every sum has an order the tiling does not change, so ne and out do not
// depend on it. h, ef, the logit and each projection element are fmaf
// chains over k = 0..63 in order from 0; pre_h = ((p + h_node) + acc) + q;
// ef = relu(acc + b_e1); m = relu(a + acc); a group's max, denominator and
// message sum run over its valid slots in slot order. K1b recomputes pre_h
// in this order (fused_step_bwd.cu).

namespace f32 {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kW = 64;             // every row width
constexpr int kLdX = kW + 4;       // row stride of the tile's rows: 16-byte rows, and rows
                                   // r, r + 1 of one warp's two row groups in distinct banks
constexpr int kTileRows = 256;     // slot rows per block tile, at most (one node when C > 256)
constexpr int kMaxTileNodes = 32;  // nodes per block tile, at most
constexpr int kPassRows = 128;     // rows of one register-tiled pass: 16 row groups x 8
constexpr int kChunk = 2;          // rows of one projection chunk (more spill registers)

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }

__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

// one k of a thread's four columns: acc[j] = fmaf(x, w_j, acc[j])
__device__ __forceinline__ void fma4(float (&acc)[4], float x, const float4& w) {
  acc[0] = fmaf(x, w.x, acc[0]);
  acc[1] = fmaf(x, w.y, acc[1]);
  acc[2] = fmaf(x, w.z, acc[2]);
  acc[3] = fmaf(x, w.w, acc[3]);
}

int tile_nodes_for(int c) {
  return c > 0 ? max(1, min(kMaxTileNodes, kTileRows / c)) : kMaxTileNodes;
}

// Shared memory of one block, carved from the dynamic allocation; the
// float4-read arrays first, at 16-byte offsets.
struct Smem {
  float* wcur;   // kW x kW: w_cur[k][j]
  float* we1;    // kW x kW: w_e1[k][j]
  float* be1;    // kW
  float* wat;    // kW: w_attn
  float* x;      // rows16 x kLdX: the tile's cur rows, then h, then ef
  float* logit;  // rows16: by tile row
  float* e;      // rows16: by sorted place, exp(logit - the group's max)
  int* src;      // rows16
  int* key;      // rows16: types, then the type of a valid slot or -1
  int* valid;    // rows16
  int* rank;     // rows16: place within its (type, node) group
  int* order;    // rows16: sorted place -> tile row
  int* pnode;    // rows16: sorted place -> node in the tile
  int* cnt;      // t x tile_nodes: group sizes
  int* seg0;     // t x tile_nodes: each group's first sorted place
  float* den;    // t x tile_nodes: each group's softmax denominator
  int* run0;     // kMaxTypes: each type's first sorted place
  int* runlen;   // kMaxTypes

  __device__ Smem(float* base, int rows16, int t, int tn) {
    wcur = base;
    we1 = wcur + kW * kW;
    be1 = we1 + kW * kW;
    wat = be1 + kW;
    x = wat + kW;
    logit = x + rows16 * kLdX;
    e = logit + rows16;
    src = reinterpret_cast<int*>(e + rows16);
    key = src + rows16;
    valid = key + rows16;
    rank = valid + rows16;
    order = rank + rows16;
    pnode = order + rows16;
    cnt = pnode + rows16;
    seg0 = cnt + t * tn;
    den = reinterpret_cast<float*>(seg0 + t * tn);
    run0 = reinterpret_cast<int*>(den + t * tn);
    runlen = run0 + kMaxTypes;
  }
};

int rows16_for(int c) { return (tile_nodes_for(c) * c + 15) & ~15; }

size_t smem_bytes(int c, int t) {
  const size_t rows16 = rows16_for(c);
  return sizeof(float) * (2 * kW * kW + 2 * kW + rows16 * kLdX + 2 * rows16) +
         sizeof(int) * (6 * rows16 + 3 * t * tile_nodes_for(c) + 2 * kMaxTypes);
}

// acc[i] = row row0 + 16 i of x times w (kW x kW, [k][j]) at columns
// c0..c0 + 3: each element an fmaf chain over k = 0..63 in order.
template <int RT>
__device__ __forceinline__ void row_product(float (&acc)[RT][4], const float* w, const float* x,
                                            int row0, int c0) {
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 2
  for (int k = 0; k < kW; k += 4) {
    float4 wv[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) wv[j] = ld4(w + (k + j) * kW + c0);
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const float4 xv = ld4(x + (row0 + 16 * i) * kLdX + k);
      fma4(acc[i], xv.x, wv[0]);
      fma4(acc[i], xv.y, wv[1]);
      fma4(acc[i], xv.z, wv[2]);
      fma4(acc[i], xv.w, wv[3]);
    }
  }
}

// h, ef, ne and the logits of tile rows base + rg + 16 i (i < RT), rg the
// thread's row group; the thread owns columns c0..c0 + 3. Rows at or past
// `rows` are computed on whatever the buffer holds and never stored.
template <int RT>
__device__ void mlp_pass(const Smem& s, const float* __restrict__ p,
                         const float* __restrict__ h_node, const float* __restrict__ q,
                         float* __restrict__ ne, int base, int rows, int c, int n0,
                         long long slot0, int n_img) {
  const int cg = threadIdx.x & 15, c0 = 4 * cg;
  const int row0 = base + (threadIdx.x >> 4);
  float acc[RT][4];
  // h = relu(((p[j] + h_node[n]) + cur @ w_cur) + q), over the cur rows
  row_product<RT>(acc, s.wcur, s.x, row0, c0);
  __syncwarp();  // the row group's reads of cur are done before h overwrites them
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int r = row0 + 16 * i;
    if (r < rows) {
      const long long n = n0 + r / c;
      const long long j = n / n_img * n_img + s.src[r];
      const float4 pv = ldg4(p + j * kW + c0), hv = ldg4(h_node + n * kW + c0);
      const float4 qv = ldg4(q + (slot0 + r) * kW + c0);
      st4(s.x + r * kLdX + c0,
          make_float4(fmaxf(((pv.x + hv.x) + acc[i][0]) + qv.x, 0.f),
                      fmaxf(((pv.y + hv.y) + acc[i][1]) + qv.y, 0.f),
                      fmaxf(((pv.z + hv.z) + acc[i][2]) + qv.z, 0.f),
                      fmaxf(((pv.w + hv.w) + acc[i][3]) + qv.w, 0.f)));
    }
  }
  __syncwarp();
  // ef = relu(h @ w_e1 + b_e1), over the h rows, and to ne
  row_product<RT>(acc, s.we1, s.x, row0, c0);
  __syncwarp();
  const float4 bias = ld4(s.be1 + c0);
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int r = row0 + 16 * i;
    if (r < rows) {
      const float4 ef =
          make_float4(fmaxf(acc[i][0] + bias.x, 0.f), fmaxf(acc[i][1] + bias.y, 0.f),
                      fmaxf(acc[i][2] + bias.z, 0.f), fmaxf(acc[i][3] + bias.w, 0.f));
      st4(s.x + r * kLdX + c0, ef);
      st4(ne + (slot0 + r) * kW + c0, ef);
    }
  }
  __syncwarp();
  // the logit ef . w_attn (its bias is constant per group: dropped),
  // thread cg of the row group on the group's row cg
  const int r = row0 + 16 * cg;
  if (cg < RT && r < rows) {
    float v = 0.f;
#pragma unroll 4
    for (int k = 0; k < kW; k += 4) {
      const float4 xv = ld4(s.x + r * kLdX + k), wv = ld4(s.wat + k);
      v = fmaf(xv.x, wv.x, v);
      v = fmaf(xv.y, wv.y, v);
      v = fmaf(xv.z, wv.z, v);
      v = fmaf(xv.w, wv.w, v);
    }
    s.logit[r] = v;
  }
}

// The (node, type) group a warp of project_half is summing, at the lane's
// column.
struct Group {
  int nl;     // node in the tile, -1 before the first
  float av;   // a[n, tt] at the lane's column
  float den;
  float num;
};

// the offset of group (n0 + nl, tt)'s row of a and out
__device__ __forceinline__ long long group_row(int n0, int nl, int t, int tt) {
  return ((static_cast<long long>(n0) + nl) * t + tt) * kW;
}

// Sorted places pos0..pos0 + R - 1 of type tt's run: each row projected
// onto the lane's column `col` of the type's we slice (w: its 64 k), its
// message relu(a + projection) weighted by its e and summed into its
// group, in slot order.
template <int R>
__device__ __forceinline__ void project_rows(const Smem& s, const float (&w)[kW],
                                             const float* __restrict__ a, float* __restrict__ out,
                                             int pos0, int tt, int t, int tn, int n0, int col,
                                             Group& g) {
  int xo[R];  // the rows' offsets in s.x
#pragma unroll
  for (int i = 0; i < R; ++i) xo[i] = s.order[pos0 + i] * kLdX;
  float acc[R];
#pragma unroll
  for (int i = 0; i < R; ++i) acc[i] = 0.f;
#pragma unroll
  for (int k = 0; k < kW; k += 4) {
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const float4 xv = ld4(s.x + xo[i] + k);
      acc[i] = fmaf(xv.x, w[k], acc[i]);
      acc[i] = fmaf(xv.y, w[k + 1], acc[i]);
      acc[i] = fmaf(xv.z, w[k + 2], acc[i]);
      acc[i] = fmaf(xv.w, w[k + 3], acc[i]);
    }
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int pos = pos0 + i;
    const int nl = s.pnode[pos];
    if (nl != g.nl) {  // the next group starts: the last one is whole
      if (g.nl >= 0) out[group_row(n0, g.nl, t, tt) + col] = g.num / g.den;
      g.nl = nl;
      g.num = 0.f;
      g.den = s.den[tt * tn + nl];
      g.av = __ldg(a + group_row(n0, nl, t, tt) + col);
    }
    g.num = fmaf(s.e[pos], fmaxf(g.av + acc[i], 0.f), g.num);
  }
}

// Columns 32 half .. 32 half + 31 of type tt in the tile, by one warp, the
// lane on column col: zeros for the type's empty groups, then its run of
// valid rows, kChunk at a time. The column's 64 weights are loaded at once
// into registers: one L2 round trip an item.
__device__ void project_half(const Smem& s, const float* __restrict__ we,
                             const float* __restrict__ a, float* __restrict__ out, int tt,
                             int half, int t, int tn, int nt, int n0) {
  const int col = 32 * half + (threadIdx.x & 31);
  for (int nl = 0; nl < nt; ++nl)  // an empty group gives 0
    if (s.cnt[tt * tn + nl] == 0) out[group_row(n0, nl, t, tt) + col] = 0.f;
  const int run0 = s.run0[tt], run_end = run0 + s.runlen[tt];
  if (run_end == run0) return;
  const float* wcol = we + tt * kW + col;  // we[k, tt W + col] at k * wstride
  const long long wstride = static_cast<long long>(t) * kW;
  float w[kW];
#pragma unroll
  for (int k = 0; k < kW; ++k) w[k] = __ldg(wcol + k * wstride);
  Group g{-1, 0.f, 1.f, 0.f};
  int pos0 = run0;
  for (; pos0 + kChunk <= run_end; pos0 += kChunk)
    project_rows<kChunk>(s, w, a, out, pos0, tt, t, tn, n0, col, g);
  for (; pos0 < run_end; ++pos0) project_rows<1>(s, w, a, out, pos0, tt, t, tn, n0, col, g);
  out[group_row(n0, g.nl, t, tt) + col] = g.num / g.den;
}

__global__ void __launch_bounds__(kThreads, 2) fused_step_f32_kernel(
    const float* __restrict__ p, const float* __restrict__ h_node, const float* __restrict__ q,
    const float* __restrict__ cur, const float* __restrict__ a, const int* __restrict__ src,
    const int* __restrict__ types, const int* __restrict__ valid,
    const float* __restrict__ w_cur, const float* __restrict__ w_e1,
    const float* __restrict__ b_e1, const float* __restrict__ we,
    const float* __restrict__ w_attn, float* __restrict__ ne, float* __restrict__ out,
    int num_nodes, int c, int t, int n_img, int tn, int rows16) {
  extern __shared__ __align__(16) float smem_f32[];
  const Smem s(smem_f32, rows16, t, tn);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  for (int i = tid; i < kW * kW / 4; i += kThreads) {
    st4(s.wcur + 4 * i, ldg4(w_cur + 4 * i));
    st4(s.we1 + 4 * i, ldg4(w_e1 + 4 * i));
  }
  if (tid < kW) {
    s.be1[tid] = b_e1[tid];
    s.wat[tid] = w_attn[tid];
  }

  const int num_tiles = (num_nodes + tn - 1) / tn;
  for (int tile = blockIdx.x; tile < num_tiles; tile += gridDim.x) {
    const int n0 = tile * tn;
    const int nt = min(tn, num_nodes - n0);
    const int rows = nt * c;
    const long long slot0 = static_cast<long long>(n0) * c;

    // 1. the index columns, then the cur rows, in flight; the sort while
    // cur arrives
    for (int r = tid; r < rows; r += kThreads) {
      tc::cp_async4(s.src + r, src + slot0 + r);
      tc::cp_async4(s.key + r, types + slot0 + r);
      tc::cp_async4(s.valid + r, valid + slot0 + r);
    }
    tc::cp_async_commit();
    for (int i = tid; i < rows * (kW / 4); i += kThreads) {
      const int r = i >> 4, ch = 4 * (i & 15);
      tc::cp_async16(s.x + r * kLdX + ch, cur + (slot0 + r) * kW + ch, true);
    }
    tc::cp_async_commit();
    for (int i = tid; i < t * tn; i += kThreads) s.cnt[i] = 0;
    tc::cp_async_wait<1>();
    __syncthreads();

    // a warp per node ranks its valid slots within (type, node), stably in
    // slot order
    for (int nl = warp; nl < nt; nl += kWarps) {
      for (int b = 0; b < c; b += 32) {
        const int rl = b + lane;
        const int r = nl * c + rl;
        int key = -1;
        if (rl < c) {
          const int ty = s.key[r];
          if (s.valid[r] != 0 && ty >= 0 && ty < t) key = ty;
        }
        const unsigned peers = __match_any_sync(0xffffffffu, key);
        const int base = key >= 0 ? s.cnt[key * tn + nl] : 0;
        __syncwarp();
        if (rl < c) s.key[r] = key;
        if (key >= 0) {
          s.rank[r] = base + __popc(peers & ((1u << lane) - 1u));
          if (__ffs(peers) - 1 == lane) s.cnt[key * tn + nl] = base + __popc(peers);
        }
        __syncwarp();
      }
    }
    __syncthreads();
    if (warp == 0) {  // lay the types' runs out, node by node, unpadded
      int run = 0;
      if (lane < t) {
        for (int nl = 0; nl < nt; ++nl) {
          s.seg0[lane * tn + nl] = run;
          run += s.cnt[lane * tn + nl];
        }
      }
      int incl = run;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += v;
      }
      if (lane < t) {
        const int start = incl - run;
        s.run0[lane] = start;
        s.runlen[lane] = run;
        for (int nl = 0; nl < nt; ++nl) s.seg0[lane * tn + nl] += start;
      }
    }
    __syncthreads();
    for (int r = tid; r < rows; r += kThreads) {
      const int key = s.key[r];
      if (key >= 0) {
        const int nl = r / c;
        const int pos = s.seg0[key * tn + nl] + s.rank[r];
        s.order[pos] = r;
        s.pnode[pos] = nl;
      }
    }
    tc::cp_async_wait<0>();
    __syncthreads();

    // 2. h, ef, ne and the logits, kPassRows rows a pass
    for (int base = 0; base < rows; base += kPassRows) {
#define PEMP_MLP_PASS(RT) mlp_pass<RT>(s, p, h_node, q, ne, base, rows, c, n0, slot0, n_img)
      switch ((min(rows - base, kPassRows) + 15) >> 4) {
        case 1: PEMP_MLP_PASS(1); break;
        case 2: PEMP_MLP_PASS(2); break;
        case 3: PEMP_MLP_PASS(3); break;
        case 4: PEMP_MLP_PASS(4); break;
        case 5: PEMP_MLP_PASS(5); break;
        case 6: PEMP_MLP_PASS(6); break;
        case 7: PEMP_MLP_PASS(7); break;
        default: PEMP_MLP_PASS(8); break;
      }
#undef PEMP_MLP_PASS
    }
    __syncthreads();

    // 3. the softmax of each (node, type) group, a thread per group: its
    // max and denominator, and each slot's e, in slot order
    for (int i = tid; i < t * nt; i += kThreads) {
      const int grp = (i / nt) * tn + i % nt, cnt = s.cnt[grp], seg = s.seg0[grp];
      float mx = __int_as_float(0xff800000);  // -inf
      for (int k = 0; k < cnt; ++k) mx = fmaxf(mx, s.logit[s.order[seg + k]]);
      float den = 0.f;
      for (int k = 0; k < cnt; ++k) {
        const float e = expf(s.logit[s.order[seg + k]] - mx);
        s.e[seg + k] = e;
        den += e;
      }
      s.den[grp] = fmaxf(den, 1e-16f);
    }
    __syncthreads();

    // 4. the typed projection and the messages' sums, a warp per (type,
    // half of the columns)
    for (int item = warp; item < 2 * t; item += kWarps)
      project_half(s, we, a, out, item >> 1, item & 1, t, tn, nt, n0);
    __syncthreads();
  }
}

bool aligned(const void* p, int bytes) { return reinterpret_cast<uintptr_t>(p) % bytes == 0; }

int launch(const void* p, const void* h_node, const void* q, const void* cur, const void* a,
           const int* src, const int* types, const int* valid, const void* w_cur,
           const void* w_e1, const void* b_e1, const void* we, const void* w_attn, void* ne,
           float* out, int num_nodes, int c, int t, int n_img, cudaStream_t stream) {
  // rows, w_cur and w_e1 are read and ne written in 16-byte pieces, a, we and
  // out in 8-byte pieces
  if (!(aligned(p, 16) && aligned(h_node, 16) && aligned(q, 16) && aligned(cur, 16) &&
        aligned(w_cur, 16) && aligned(w_e1, 16) && aligned(ne, 16) && aligned(a, 8) &&
        aligned(we, 8) && aligned(out, 8)))
    return -2;
  const int tn = tile_nodes_for(c);
  const size_t smem = smem_bytes(c, t);
  cudaError_t err = cudaFuncSetAttribute(
      fused_step_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(err);
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return static_cast<int>(err);
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fused_step_f32_kernel,
                                                           kThreads, smem)) != cudaSuccess)
    return static_cast<int>(err);
  if (per_sm < 1) per_sm = 1;
  const int num_tiles = (num_nodes + tn - 1) / tn;
  const int grid = num_tiles < sms * per_sm ? num_tiles : sms * per_sm;
  fused_step_f32_kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(p), static_cast<const float*>(h_node),
      static_cast<const float*>(q), static_cast<const float*>(cur),
      static_cast<const float*>(a), src, types, valid, static_cast<const float*>(w_cur),
      static_cast<const float*>(w_e1), static_cast<const float*>(b_e1),
      static_cast<const float*>(we), static_cast<const float*>(w_attn),
      static_cast<float*>(ne), out, num_nodes, c, t, n_img, tn, rows16_for(c));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace f32

}  // namespace

// dtype: 0 = float32 (the CUDA-core form), 1 = bfloat16 (the tensor-core
// form); rows are 64 wide. Returns a cudaError_t, or -1 for an unsupported
// dtype and -2 for more than 32 types or (float32) misaligned arrays.
extern "C" int pemp_fused_step(int dtype, const void* p, const void* h_node,
                               const void* q, const void* cur, const void* a, const int* src,
                               const int* types, const int* valid, const void* w_cur,
                               const void* w_e1, const void* b_e1, const void* we,
                               const void* w_attn, void* ne, float* out, int num_nodes, int c,
                               int t, int n_img, void* stream) {
  if (t > kMaxTypes) return -2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return f32::launch(p, h_node, q, cur, a, src, types, valid, w_cur, w_e1, b_e1, we, w_attn,
                       ne, out, num_nodes, c, t, n_img, s);
  if (dtype == 1)
    return tc::launch(p, h_node, q, cur, a, src, types, valid, w_cur, w_e1, b_e1, we, w_attn, ne,
                      out, num_nodes, c, t, n_img, s);
  return -1;
}
