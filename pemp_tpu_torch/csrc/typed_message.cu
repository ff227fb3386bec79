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
// block owns one type t and up to 64 nodes and stages We_t once in shared
// memory; it projects only its type's slots, and onto We_t alone (the TPU
// form projects every slot onto all 17 types and selects with one-hot
// matmuls, because Mosaic has no gather). Each ef row is read by exactly one
// block and each d_ef, out and da row written by exactly one.
//
// The groups are small (at the first training step 29,337 of the 92,480
// hold a slot, 10.3 rows on average), so a block takes all of its type's
// groups in its nodes at once. A block's nodes are every chunks-th node
// (Chunk), which keeps the blocks' row counts close when some types cluster
// in the node order. One pass over their index columns (list_rows) lists
// the type-t slots in slot order with each node's first row, and the block
// works through that list in batches of whole nodes, up to 128 rows (256
// when C > 128). In each batch cp.async brings the ef rows; pre = a +
// ef @ We_t is a register tile of 8 rows x 4 columns a thread, We_t from
// shared memory (project_pass); eight-lane groups take each node's softmax
// and output sum, in slot order (node_softmax_sum).
//
// K2 keeps no pre buffer: a batch's pre overwrites its ef rows in place (a
// thread's rows are read only by its own warp), which leaves room for three
// blocks per SM to hide each other's scans and copies; three barriers a
// batch. (A second ef buffer, filled with the next batch's rows while one
// computes, fits two blocks per SM and measured slower.) K2b keeps pre (then
// dpre) beside ef, since dwe needs both: five barriers a batch, in which
// each row's dpre and dlogit, each node's da, then d_ef = dpre @ We_t^T +
// dlogit * w_attn in the same tiles, and the dwe_t (4 x 4 a thread) and dwa
// partials, kept in registers across batches; its scan also zeroes the d_ef
// rows of some invalid slots.
//
// The cross-block sums dwe (278 KB in f32, more than a block's shared
// memory) and dwa are deterministic: each block writes its type's 64x64
// partial of dwe to a workspace (chunk, type, 64, 64); a second launch sums
// the chunks in a fixed order. No atomics: the step gives the same bits on
// every run. Both compute on the CUDA cores in f32 (no tensor cores).
//
// K2's bf16 form (the pallas eval path; the TPU kernel's bf16 branch,
// _tile_forward's projection on the MXU with bf16 inputs and f32 sums): ef,
// a, we and w_attn in bf16, out in f32. It is a kernel of its own,
// tc::typed_message_fwd_bf16, on the tensor cores; its note is at the
// kernel. K2b stays f32.

#include <cuda_runtime.h>

#include <cstdint>

#include "group_softmax.cuh"
#include "mma_bf16.cuh"

namespace {

using pemp::kMaxSlots;
using pemp::kThreads;
using pemp::kWarps;
using pemp::kWidth;
using pemp::warp_sum;

constexpr int kChunkNodes = 64;     // most nodes a block owns (the wrapper's _CHUNK)
constexpr int kBatchRows = 128;     // rows of a batch; 2x when C > 128, so a group always fits
constexpr int kPassRows = 128;      // rows of one register-tiled pass: 16 row groups x 8
constexpr int kGroups = kThreads / 8;  // eight-lane groups of the per-node steps
constexpr int kLdR = kWidth + 4;    // row stride of We_t, ef and pre: 16-byte rows, and rows
                                    // r, r + 1, ... read by one quarter-warp fall in
                                    // distinct banks
static_assert(kThreads == 256, "the tiles map 16 row groups x 16 column groups of threads");
static_assert(kChunkNodes * kMaxSlots <= 64 * kThreads, "a thread scans at most 64 slots");
static_assert(kChunkNodes * kMaxSlots <= 65536, "slot offsets fit 16 bits");

__host__ __device__ constexpr int batch_rows(int c) {
  return c <= kBatchRows ? kBatchRows : 2 * kBatchRows;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void fma4(float (&acc)[4], float x, const float4& w) {
  acc[0] = fmaf(x, w.x, acc[0]);
  acc[1] = fmaf(x, w.y, acc[1]);
  acc[2] = fmaf(x, w.z, acc[2]);
  acc[3] = fmaf(x, w.w, acc[3]);
}

__device__ __forceinline__ float dot4(float acc, const float4& x, const float4& w) {
  return fmaf(x.w, w.w, fmaf(x.z, w.z, fmaf(x.y, w.y, fmaf(x.x, w.x, acc))));
}

// sum and max over the eight lanes of `mask` (0xff << a multiple of 8)
__device__ __forceinline__ float group_sum(float v, unsigned mask) {
#pragma unroll
  for (int o = 4; o > 0; o >>= 1) v += __shfl_xor_sync(mask, v, o);
  return v;
}

__device__ __forceinline__ float group_max(float v, unsigned mask) {
#pragma unroll
  for (int o = 4; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(mask, v, o));
  return v;
}

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
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

// Four values of a row of a (read-only path).
__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

// The nodes of a block: its local node j is node first + j * stride, every
// chunks-th node (the blocks of one type together own each node once).
// Spread so, a block's nodes come from every image and many node types, and
// its rows of one source type do not depend on which node types lie near each
// other in the node order (the training graph links many nodes to nodes of
// their own type). The local offset of slot k of node j is j * C + k.
struct Chunk {
  int first, stride, nodes, c, num_types, t;

  __device__ Chunk(int num_nodes, int c_, int num_types_, int t_)
      : first(blockIdx.x), stride(gridDim.x),
        nodes((num_nodes - 1 - static_cast<int>(blockIdx.x)) / static_cast<int>(gridDim.x) + 1),
        c(c_), num_types(num_types_), t(t_) {}

  __device__ long long node(int j) const { return first + static_cast<long long>(j) * stride; }
  // the slot at local offset loc
  __device__ long long slot(int loc) const {
    const int j = loc / c;
    return node(j) * c + (loc - j * c);
  }
  // local node j's row of a, out, g and da for the block's type
  __device__ long long row(int j) const { return node(j) * num_types + t; }
};

// Copies We_t (we's columns t * kWidth onwards) to dst at row stride kLdR
// by cp.async; waited for with the first batch's ef rows.
__device__ void stage_we(float* dst, const float* __restrict__ we, int t, int num_types) {
  const long long we_row = static_cast<long long>(num_types) * kWidth;
  for (int i = threadIdx.x; i < kWidth * kWidth / 4; i += kThreads) {
    const int k = i / (kWidth / 4), q = i % (kWidth / 4);
    cp_async16(dst + k * kLdR + 4 * q, we + k * we_row + t * kWidth + 4 * q);
  }
}

// Lists the chunk's type-t valid slots in slot order, as local offsets, in
// list; seg[j] gets local node j's first row, seg[nodes] the count.
// warp_tot holds kWarps ints. Each thread tests a run of up to 64
// consecutive slots (16-byte loads where C allows) into a bit mask; a prefix
// sum over the runs' counts places them. With kZeroInvalid, also writes
// zeros to the d_ef rows of the chunk's invalid slots at offsets i with
// i % T == t, so that the chunk's blocks together cover each once. Ends with
// a block-wide barrier.
template <bool kZeroInvalid>
__device__ void list_rows(int* warp_tot, uint16_t* list, int* seg,
                          const int* __restrict__ types, const int* __restrict__ valid,
                          float* __restrict__ d_ef, const Chunk& ch) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c = ch.c, t = ch.t;
  const int num_slots = ch.nodes * c;
  const int per = ((num_slots + kThreads - 1) / kThreads + 3) & ~3;  // <= 64
  const int first = min(tid * per, num_slots);
  const int last = min(first + per, num_slots);
  unsigned long long mask = 0, zero = 0;
  auto take = [&](int i, int type, int ok) {
    const unsigned long long bit = 1ull << (i - first);
    if (ok != 0 && type == t) mask |= bit;
    if (kZeroInvalid && ok == 0 && i % ch.num_types == t) zero |= bit;
  };
  if (c % 4 == 0 &&
      ((reinterpret_cast<uintptr_t>(types) | reinterpret_cast<uintptr_t>(valid)) & 15) == 0) {
    // runs of whole 16-byte pieces of one node each (per and C are multiples
    // of 4), all loads issued before any is used
#pragma unroll
    for (int q4 = 0; q4 < 16; ++q4) {
      const int i = first + 4 * q4;
      if (i < last) {
        const long long k = ch.slot(i);
        const int4 t4 = __ldg(reinterpret_cast<const int4*>(types + k));
        const int4 v4 = __ldg(reinterpret_cast<const int4*>(valid + k));
        take(i, t4.x, v4.x);
        take(i + 1, t4.y, v4.y);
        take(i + 2, t4.z, v4.z);
        take(i + 3, t4.w, v4.w);
      }
    }
  } else {
    for (int i = first; i < last; ++i) {
      const long long k = ch.slot(i);
      take(i, types[k], valid[k]);
    }
  }
  const int mine = __popcll(mask);
  int incl = mine;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) warp_tot[warp] = incl;
  for (; zero; zero &= zero - 1) {
    float4* dst = reinterpret_cast<float4*>(d_ef + ch.slot(first + __ffsll(zero) - 1) * kWidth);
#pragma unroll
    for (int q = 0; q < kWidth / 4; ++q) dst[q] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __syncthreads();
  int pos = incl - mine, total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int v = warp_tot[w];
    pos += w < warp ? v : 0;
    total += v;
  }
  for (; mask; mask &= mask - 1) list[pos++] = static_cast<uint16_t>(first + __ffsll(mask) - 1);
  __syncthreads();
  if (tid <= ch.nodes) {  // first row at or after node tid's first slot
    const int key = tid * c;
    int lo = 0, hi = total;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (list[mid] < key) lo = mid + 1;
      else hi = mid;
    }
    seg[tid] = lo;
  }
  __syncthreads();
}

// The batch from local node j0: nodes j0..j1 - 1, as many as fit in `rows`
// rows (one always does); returns j1.
__device__ int batch_end(const int* seg, int j0, int nodes, int rows) {
  const int b0 = seg[j0];
  int j1 = j0 + 1;
  for (int hi = nodes; j1 < hi;) {
    const int mid = (j1 + hi + 1) >> 1;
    if (seg[mid] - b0 <= rows) j1 = mid;
    else hi = mid - 1;
  }
  return j1;
}

// Starts the cp.async copy of the ef rows of list entries b0..b0 + nr - 1 to
// dst (stride kLdR) and writes each row's local node to row_node.
__device__ void load_rows(float* dst, int* row_node, const float* __restrict__ ef,
                          const uint16_t* list, int b0, int nr, const Chunk& ch) {
  for (int i = threadIdx.x; i < nr * (kWidth / 4); i += kThreads) {
    const int r = i / (kWidth / 4), q = i % (kWidth / 4);
    cp_async16(dst + r * kLdR + 4 * q, ef + ch.slot(list[b0 + r]) * kWidth + 4 * q);
  }
  for (int r = threadIdx.x; r < nr; r += kThreads) row_node[r] = list[b0 + r] / ch.c;
}

// pre = a[n, t] + ef @ We_t for rows base + rg + 16 i (i < RT) of the
// batch, columns c0..c0 + 3, stored to p; rows at or past nr are computed on
// whatever the buffer holds and not stored. Only the 16 threads of row group
// rg, all in one warp, read or write these rows here, so p may be ef.
template <int RT>
__device__ void project_pass(const float* we_t, const float* ef, float* p, const int* row_node,
                             const float* __restrict__ a, int base, int nr, const Chunk& ch) {
  const int rg = threadIdx.x >> 4, c0 = 4 * (threadIdx.x & 15);
  float acc[RT][4] = {};
#pragma unroll 2
  for (int k = 0; k < kWidth; k += 4) {
    float4 w[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) w[j] = ld4(we_t + (k + j) * kLdR + c0);
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const float4 x = ld4(ef + (base + rg + 16 * i) * kLdR + k);
      fma4(acc[i], x.x, w[0]);
      fma4(acc[i], x.y, w[1]);
      fma4(acc[i], x.z, w[2]);
      fma4(acc[i], x.w, w[3]);
    }
  }
  __syncwarp();  // the row group's reads of ef are done before pre may overwrite it
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int r = base + rg + 16 * i;
    if (r < nr) {
      const float4 av = load4(a + ch.row(row_node[r]) * kWidth + c0);
      *reinterpret_cast<float4*>(p + r * kLdR + c0) =
          make_float4(acc[i][0] + av.x, acc[i][1] + av.y, acc[i][2] + av.z, acc[i][3] + av.w);
    }
  }
}

// The softmax of a node's rows r0..r1 - 1 (r1 > r0) and their output sum,
// by the eight lanes of gmask, lane sub on columns c0..c0 + 3 and c1..c1 + 3:
// writes e[r] = exp(logit[r] - the node's max), leaves sum_r e[r] relu(pre[r])
// (in slot order) in o0, o1 and returns den = max(sum_r e[r], 1e-16). pre is
// p, or with kAddA (K2's bf16 form) p + a, the lane's columns of a in a0, a1.
template <bool kAddA = false>
__device__ __forceinline__ float node_softmax_sum(const float* logit, float* e, const float* p,
                                                  int r0, int r1, int sub, int c0, int c1,
                                                  unsigned gmask, float4& o0, float4& o1,
                                                  float4 a0 = {}, float4 a1 = {}) {
  float mx = __int_as_float(0xff800000);  // -inf
  for (int r = r0 + sub; r < r1; r += 8) mx = fmaxf(mx, logit[r]);
  mx = group_max(mx, gmask);
  float sum = 0.f;
  for (int r = r0 + sub; r < r1; r += 8) {
    const float ev = expf(logit[r] - mx);
    e[r] = ev;
    sum += ev;
  }
  const float den = fmaxf(group_sum(sum, gmask), 1e-16f);
  __syncwarp(gmask);
  o0 = make_float4(0.f, 0.f, 0.f, 0.f);
  o1 = o0;
  for (int r = r0; r < r1; ++r) {
    const float ev = e[r];
    float4 p0 = ld4(p + r * kLdR + c0), p1 = ld4(p + r * kLdR + c1);
    if (kAddA) {
      p0 = make_float4(p0.x + a0.x, p0.y + a0.y, p0.z + a0.z, p0.w + a0.w);
      p1 = make_float4(p1.x + a1.x, p1.y + a1.y, p1.z + a1.z, p1.w + a1.w);
    }
    o0 = make_float4(o0.x + ev * fmaxf(p0.x, 0.f), o0.y + ev * fmaxf(p0.y, 0.f),
                     o0.z + ev * fmaxf(p0.z, 0.f), o0.w + ev * fmaxf(p0.w, 0.f));
    o1 = make_float4(o1.x + ev * fmaxf(p1.x, 0.f), o1.y + ev * fmaxf(p1.y, 0.f),
                     o1.z + ev * fmaxf(p1.z, 0.f), o1.w + ev * fmaxf(p1.w, 0.f));
  }
  return den;
}

// Runs pass<RT> over the batch's nr rows in passes of kPassRows, with RT the
// fewest rows a thread needs for the pass (the same on every thread).
#define PEMP_ROW_PASSES(pass, ...)                                              \
  for (int base = 0; base < nr; base += kPassRows) {                            \
    switch ((min(nr - base, kPassRows) + 15) >> 4) {                            \
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

// ---------------------------------------------------------------- K2

// Shared memory of one forward block, carved from the dynamic allocation;
// the float4-read arrays come first, at 16-byte offsets.
struct FwdSmem {
  float* we;        // kWidth x kLdR: We_t[k][o] at k * kLdR + o
  float* buf;       // rows x kLdR: a batch's ef rows, then its pre
  float* wat;       // kWidth: w_attn
  float* logit;     // rows
  float* e;         // rows: exp(logit - the group's max)
  int* warp_tot;    // kWarps: rows found per warp of the scan
  int* row_node;    // rows: each batch row's node, from the chunk's first
  int* seg;         // kChunkNodes + 1: each node's first row in list; seg[nodes] = count
  uint16_t* list;   // kChunkNodes * C: the chunk's type-t slots as local offsets j * C + slot

  __device__ FwdSmem(float* base, int rows) {
    we = base;
    buf = we + kWidth * kLdR;
    wat = buf + rows * kLdR;
    logit = wat + kWidth;
    e = logit + rows;
    warp_tot = reinterpret_cast<int*>(e + rows);
    row_node = warp_tot + kWarps;
    seg = row_node + rows;
    list = reinterpret_cast<uint16_t*>(seg + kChunkNodes + 1);
  }
};

size_t fwd_smem_bytes(int c) {
  const int rows = batch_rows(c);
  return sizeof(float) * (kWidth * kLdR + rows * kLdR + kWidth + 2 * rows) +
         sizeof(int) * (kWarps + rows + kChunkNodes + 1) +
         sizeof(uint16_t) * static_cast<size_t>(kChunkNodes) * c;
}

// Three blocks per SM: the shared memory of one block allows three.
__global__ void __launch_bounds__(kThreads, 3) typed_message_fwd(
    const float* __restrict__ ef, const float* __restrict__ a, const int* __restrict__ types,
    const int* __restrict__ valid, const float* __restrict__ we,
    const float* __restrict__ w_attn, float* __restrict__ out, int num_nodes, int c,
    int num_types) {
  extern __shared__ float4 smem4[];
  const int rows = batch_rows(c);
  const FwdSmem s(reinterpret_cast<float*>(smem4), rows);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const Chunk ch(num_nodes, c, num_types, blockIdx.y);
  const int nodes = ch.nodes;
  stage_we(s.we, we, ch.t, num_types);
  if (tid < kWidth) s.wat[tid] = w_attn[tid];
  list_rows<false>(s.warp_tot, s.list, s.seg, types, valid, nullptr, ch);
  for (int i = tid; i < 2 * nodes; i += kThreads)  // the nodes' a rows to L2
    prefetch_l2(a + ch.row(i >> 1) * kWidth + 32 * (i & 1));

  // the logits: half a warp per row, on the row groups of project_pass
  const int rg = tid >> 4, cq = 4 * (tid & 15);
  const float4 wq = ld4(s.wat + cq);
  // the per-node step: eight-lane groups, a lane on columns c0.. and c1..
  const int grp = 4 * warp + (lane >> 3), sub = lane & 7, c0 = 4 * sub, c1 = 32 + 4 * sub;
  const unsigned gmask = 0xffu << (lane & 24);

  int j0 = 0, j1 = batch_end(s.seg, 0, nodes, rows);
  load_rows(s.buf, s.row_node, ef, s.list, 0, s.seg[j1], ch);
  float* const p = s.buf;
  while (j0 < nodes) {
    const int b0 = s.seg[j0], nr = s.seg[j1] - b0;
    const int j2 = j1 < nodes ? batch_end(s.seg, j1, nodes, rows) : j1;
    cp_async_wait_all();
    __syncthreads();  // this batch's rows are in
    if (nr > 0) {
      // a warp reads here only the rows it projects next, so pre overwrites
      // ef in place (p is both)
      for (int r0 = 0; r0 < nr; r0 += 16) {
        const int r = r0 + rg;
        float v = dot4(0.f, ld4(p + r * kLdR + cq), wq);
#pragma unroll
        for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
        if (r < nr && cq == 0) s.logit[r] = v;
      }
      PEMP_ROW_PASSES(project_pass, s.we, p, p, s.row_node, a, base, nr, ch)
    }
    __syncthreads();  // pre and the logits are complete

    // a group per node: out = sum e relu(pre) / den, 0 for an empty group
    for (int j = j0 + grp; j < j1; j += kGroups) {
      const int r0 = s.seg[j] - b0, r1 = s.seg[j + 1] - b0;
      float4 o0 = make_float4(0.f, 0.f, 0.f, 0.f), o1 = o0;
      float den = 1.f;
      if (r1 > r0) den = node_softmax_sum(s.logit, s.e, p, r0, r1, sub, c0, c1, gmask, o0, o1);
      float* dst = out + ch.row(j) * kWidth;
      *reinterpret_cast<float4*>(dst + c0) =
          make_float4(o0.x / den, o0.y / den, o0.z / den, o0.w / den);
      *reinterpret_cast<float4*>(dst + c1) =
          make_float4(o1.x / den, o1.y / den, o1.z / den, o1.w / den);
    }
    if (j1 < nodes) {
      __syncthreads();  // the buffer is read
      load_rows(s.buf, s.row_node, ef, s.list, s.seg[j1], s.seg[j2] - s.seg[j1], ch);
    }
    j0 = j1;
    j1 = j2;
  }
}

// ---------------------------------------------------------------- K2, bf16
//
// The same function with ef, a, we and w_attn in bf16 and the products on
// the tensor cores, as the TPU kernel's bf16 branch runs them on the MXU:
// bf16 x bf16 products summed in f32, then pre, the softmax and out in f32.
// What bounds it on an H100: at the flagship eval shapes (B = 8, ~70 % of
// the slots valid at MPN step 0) it must move ~69 MB (the valid ef rows
// ~38 MB, the a rows of the ~29 % of (node, type) groups that hold a slot
// ~3.4 MB, the index columns 3.5 MB, out 24 MB): ~0.021 ms at 3.35 TB/s,
// against ~3 us for its ~2.6 GFLOP at the bf16 tensor-core rate.
//
// The design keeps the f32 form's plan: a block owns one type and up to 64
// nodes (Chunk), one scan lists its type-t rows, and it takes them in
// batches of whole nodes (batch_end; 128 rows, 256 when C > 128). In K1's
// tensor-core tail (fused_step.cu: node tiles sorted by type, a warp per
// (type, half) reading its B fragments of `we` from L2) each index entry is
// read once, but every 3-node tile reads all of `we`'s fragments (~139 KB)
// again: ~250 MB from L2 at the flagship shapes, against ~60 MB for the 17
// blocks of a chunk each scanning its index columns here, with We_t (8 KB)
// staged once a block. (Blocks of three types sharing one scan were tried
// and measured slower.)
//
// The scan (scan_rows) reads the index columns in coalesced 16-byte pieces
// and places the rows by ballots; a row's entry holds its node and slot, so
// that no later step divides by C. In each batch cp.async brings the ef
// rows as bf16 in 16-byte pieces (no widening) at a stride of 144 bytes, so
// the eight rows an ldmatrix reads fall in distinct banks; rows past the
// batch's end up to the next multiple of 16 are zero-filled. A warp takes
// 16-row tiles: A by ldmatrix, B by ldmatrix.trans from We_t staged the
// same way, 8 n-tiles x 4 k-steps of mma.sync m16n8k16 (bf16 in, f32 sums;
// the helpers are K1's bf16 form's, from mma_bf16.cuh),
// and the logit ef . w_attn as an f32 dot over the same A fragments, summed
// across the four lanes of a row. The products go to an f32 buffer (stride
// kLdR) that lies over the ef rows, which fill the end of the same region,
// so a block needs ~55 KB at C = 80 and four fit an SM; a round of 8 tiles
// reads all its ef rows before the barrier after which its products are
// written (product row r covers only ef rows <= r). Eight-lane groups then
// take each node's softmax and output sum in slot order
// (node_softmax_sum), adding a[n, t] in f32 there, read once a group that
// holds a slot (those rows are prefetched to L2 after the scan; an empty
// group's 0 reads no a). The next batch's ef rows are prefetched to L2
// meanwhile. Rows past the
// batch's end are neither stored nor summed. Every sum has a fixed order:
// two calls give the same bits.

namespace tc {

using pemp::bf16mma::bf16;
using pemp::bf16mma::bf2_to_f2;
using pemp::bf16mma::cp_async16;
using pemp::bf16mma::kLd;  // bf16 row stride of We_t and ef: 144 bytes, ldmatrix conflict-free
using pemp::bf16mma::ldmatrix_x4;
using pemp::bf16mma::ldmatrix_x4_trans;
using pemp::bf16mma::mma;
static_assert(kLd == kWidth + 8, "the shared stride is of a 64-wide row");

// acc + the two bf16 values of u times w
__device__ __forceinline__ float dot2(float acc, uint32_t u, float2 w) {
  const float2 x = bf2_to_f2(u);
  return fmaf(x.y, w.y, fmaf(x.x, w.x, acc));
}

// Shared memory of one block, carved from the dynamic allocation. The ef
// rows fill the end of the products' region: product row r ends at byte
// 272 r + 256 of it and ef row r' starts at byte 128 rows + 144 r', so
// writing product row r overwrites only ef rows r' <= r.
struct Smem {
  bf16* we;         // kWidth x kLd: We_t[k][o] at k * kLd + o
  float* prod;      // rows x kLdR: a batch's products ef @ We_t
  bf16* ef;         // rows x kLd: the batch's ef rows, in the end of prod's region
  float* wat;       // kWidth: w_attn in f32
  float* logit;     // rows
  float* e;         // rows: exp(logit - the group's max)
  int* warp_tot;    // kWarps: rows found per warp of the scan
  int* seg;         // kChunkNodes + 1: each node's first row in list; seg[nodes] = count
  uint16_t* list;   // kChunkNodes * C: the chunk's type-t slots as entries (entry_slot)

  __device__ Smem(unsigned char* base, int rows) {
    we = reinterpret_cast<bf16*>(base);
    prod = reinterpret_cast<float*>(we + kWidth * kLd);
    wat = prod + rows * kLdR;
    ef = reinterpret_cast<bf16*>(wat) - rows * kLd;
    logit = wat + kWidth;
    e = logit + rows;
    warp_tot = reinterpret_cast<int*>(e + rows);
    seg = warp_tot + kWarps;
    list = reinterpret_cast<uint16_t*>(seg + kChunkNodes + 1);
  }
};
static_assert(kLdR * sizeof(float) >= kLd * sizeof(bf16) &&
                  (kLdR * sizeof(float) - kLd * sizeof(bf16)) % 16 == 0,
              "an ef row fits under a product row, and the ef rows start 16-byte aligned");

size_t smem_bytes(int c) {
  const int rows = batch_rows(c);
  return sizeof(bf16) * kWidth * kLd + sizeof(float) * (rows * kLdR + kWidth + 2 * rows) +
         sizeof(int) * (kWarps + kChunkNodes + 1) +
         sizeof(uint16_t) * static_cast<size_t>(kChunkNodes) * c;
}

// Copies We_t to dst at row stride kLd by cp.async, as bf16; waited for with
// the first batch's ef rows.
__device__ void stage_we(bf16* dst, const bf16* __restrict__ we, int t, int num_types) {
  const long long we_row = static_cast<long long>(num_types) * kWidth;
  for (int i = threadIdx.x; i < kWidth * kWidth / 8; i += kThreads) {
    const int k = i / (kWidth / 8), q = i % (kWidth / 8);
    cp_async16(dst + k * kLd + 8 * q, we + k * we_row + t * kWidth + 8 * q, true);
  }
}

// A row's entry in the list: its local node j and slot k as j << 8 | k
// (C <= 256 and j < 64: 14 bits), so that no step divides by C.
constexpr int kSlotBits = 8;
static_assert(kMaxSlots <= (1 << kSlotBits) && (kChunkNodes << kSlotBits) <= 65536,
              "an entry fits 16 bits");

__device__ __forceinline__ long long entry_slot(const Chunk& ch, int entry) {
  return ch.node(entry >> kSlotBits) * ch.c + (entry & ((1 << kSlotBits) - 1));
}

// loc / c for loc < 2^14, c <= 256: the float product lies at least 0.5 / c
// from an integer, far beyond its rounding error
__device__ __forceinline__ int div_c(int loc, float inv_c) {
  return __float2int_rz((static_cast<float>(loc) + 0.5f) * inv_c);
}

// W ints from p (W = 4: one 16-byte load).
template <int W>
__device__ __forceinline__ void load_ints(int (&v)[W], const int* p) {
  if constexpr (W == 4) {
    const int4 x = __ldg(reinterpret_cast<const int4*>(p));
    v[0] = x.x;
    v[1] = x.y;
    v[2] = x.z;
    v[3] = x.w;
  } else {
    static_assert(W == 1, "pieces of 4 ints or 1");
    v[0] = __ldg(p);
  }
}

// Lists the chunk's type-t valid slots in slot order as entries in list;
// seg[j] gets local node j's first row, seg[nodes] the count (list_rows
// does the same for the f32 form). Warp w reads the pieces of W slots
// (16 bytes of each column, or one slot where C % 4 != 0) w * P, w * P + 1,
// ..., lane l piece 32 i + l of them in its load i, so that a warp's loads
// are coalesced, kBurst loads in flight at a time. A lane keeps a bit per
// slot; a ballot per bit of a piece places the rows. Ends with a
// block-wide barrier.
template <int W>
__device__ void scan_rows(int* warp_tot, uint16_t* list, int* seg, const int* __restrict__ types,
                          const int* __restrict__ valid, const Chunk& ch) {
  constexpr int kBurst = 5;  // at C = 80 a lane's five 16-byte pieces of each column
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c = ch.c, t = ch.t;
  const int pieces = ch.nodes * c / W;
  const int per_warp = ((pieces + kWarps - 1) / kWarps + 31) & ~31;
  const int p0 = warp * per_warp, p1 = min(p0 + per_warp, pieces);
  const int loads = per_warp / 32;  // at most 64 / W: a bit per slot fits the mask
  const float inv_c = 1.f / static_cast<float>(c);
  unsigned long long mask = 0;
  for (int i0 = 0; i0 < loads; i0 += kBurst) {
    int tv[kBurst][W], vv[kBurst][W];
#pragma unroll
    for (int q = 0; q < kBurst; ++q) {
      const int p = p0 + 32 * (i0 + q) + lane;
      if (i0 + q < loads && p < p1) {
        const int loc = W * p, jj = div_c(loc, inv_c);
        const long long k = ch.node(jj) * c + (loc - jj * c);
        load_ints<W>(tv[q], types + k);
        load_ints<W>(vv[q], valid + k);
      }
    }
#pragma unroll
    for (int q = 0; q < kBurst; ++q) {
      const int p = p0 + 32 * (i0 + q) + lane;
      if (i0 + q < loads && p < p1) {
#pragma unroll
        for (int b = 0; b < W; ++b)
          if (vv[q][b] != 0 && tv[q][b] == t) mask |= 1ull << (W * (i0 + q) + b);
      }
    }
  }
  const int count = __reduce_add_sync(0xffffffffu, __popcll(mask));
  if (lane == 0) warp_tot[warp] = count;
  __syncthreads();
  int base = 0, total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int v = warp_tot[w];
    base += w < warp ? v : 0;
    total += v;
  }
  const unsigned below = (1u << lane) - 1u;
  for (int i = 0; i < loads; ++i) {
    const unsigned bits = static_cast<unsigned>(mask >> (W * i)) & ((1u << W) - 1u);
    int pos = base;
#pragma unroll
    for (int b = 0; b < W; ++b) {
      const unsigned ballot = __ballot_sync(0xffffffffu, (bits >> b) & 1u);
      pos += __popc(ballot & below);
      base += __popc(ballot);
    }
    if (bits != 0) {  // a piece lies within one node
      const int loc = W * (p0 + 32 * i + lane), j = div_c(loc, inv_c);
      const int entry = (j << kSlotBits) | (loc - j * c);
#pragma unroll
      for (int b = 0; b < W; ++b)
        if ((bits >> b) & 1u) list[pos++] = static_cast<uint16_t>(entry + b);
    }
  }
  __syncthreads();
  if (tid <= ch.nodes) {  // first row at or after node tid
    const int key = tid << kSlotBits;
    int lo = 0, hi = total;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (list[mid] < key) lo = mid + 1;
      else hi = mid;
    }
    seg[tid] = lo;
  }
  __syncthreads();
}

// Starts the cp.async copy of the ef rows of list entries b0..b0 + nr - 1 to
// dst (stride kLd, bf16) and zero-fills the rows after them up to the next
// multiple of 16 (the rest of the last mma tile).
__device__ void load_rows(bf16* dst, const bf16* __restrict__ ef, const uint16_t* list, int b0,
                          int nr, const Chunk& ch) {
  const int nr16 = (nr + 15) & ~15;
  for (int i = threadIdx.x; i < nr16 * (kWidth / 8); i += kThreads) {
    const int r = i / (kWidth / 8), q = i % (kWidth / 8);
    const bool in = r < nr;
    const int entry = in ? list[b0 + r] : 0;
    cp_async16(dst + r * kLd + 8 * q, ef + entry_slot(ch, entry) * kWidth + 8 * q, in);
  }
}

// prod = ef @ We_t and logit = ef . w_attn for the batch's nr rows: warp w
// takes the 16-row tiles w, w + kWarps, ..., in rounds of kWarps tiles. A
// round reads all its ef rows before the barrier after which its product
// rows are written over them. Thread (g, tq) of a warp holds columns 8 nt + 2 tq,
// + 1 of rows g and g + 8 of its tile in acc[nt], and columns 16 kk + 2 tq,
// + 1, + 8, + 9 of the same rows in its A fragments. Rows past nr are
// zeros and are not stored.
__device__ void project_batch(const Smem& s, int nr) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tq = lane & 3;
  for (int round = 0; round < nr; round += kWarps * 16) {
    const int m0 = round + 16 * warp;
    const bool mine = m0 < nr;  // the same on all of a warp's lanes
    float acc[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[nt][i] = 0.f;
    float lg[2] = {0.f, 0.f};
    if (mine) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t fa[4];
        ldmatrix_x4(fa, s.ef + (m0 + (lane & 15)) * kLd + kk * 16 + (lane >> 4) * 8);
        const float2 w0 = *reinterpret_cast<const float2*>(s.wat + 16 * kk + 2 * tq);
        const float2 w1 = *reinterpret_cast<const float2*>(s.wat + 16 * kk + 2 * tq + 8);
        lg[0] = dot2(dot2(lg[0], fa[0], w0), fa[2], w1);
        lg[1] = dot2(dot2(lg[1], fa[1], w0), fa[3], w1);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, s.we + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kLd +
                                   j * 16 + (lane >> 4) * 8);
          mma(acc[2 * j], fa, b[0], b[1]);
          mma(acc[2 * j + 1], fa, b[2], b[3]);
        }
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        lg[half] += __shfl_xor_sync(0xffffffffu, lg[half], 1);
        lg[half] += __shfl_xor_sync(0xffffffffu, lg[half], 2);
      }
    }
    __syncthreads();  // the round's ef rows are read
    if (mine) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = m0 + g + 8 * half;
        if (r < nr) {
          float* prow = s.prod + r * kLdR + 2 * tq;
#pragma unroll
          for (int nt = 0; nt < 8; ++nt)
            *reinterpret_cast<float2*>(prow + 8 * nt) =
                make_float2(acc[nt][2 * half], acc[nt][2 * half + 1]);
          if (tq == 0) s.logit[r] = lg[half];
        }
      }
    }
  }
}

// Four bf16 values of a row of a, in f32 (one 8-byte load).
__device__ __forceinline__ float4 load_a4(const bf16* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 lo = bf2_to_f2(u.x), hi = bf2_to_f2(u.y);
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// Four blocks an SM: ~55 KB of shared memory (at C <= 128) and 64 registers
// a thread each. __launch_bounds__(256, 4) caps a thread at 64 registers
// (65,536 a SM over four blocks of 256 threads); ptxas spills 16 bytes a
// thread under that cap, which is accepted: three blocks an SM, the cost
// of lifting the cap, hide less of a block's serial chain (scan, copy,
// products, per-node step).
__global__ void __launch_bounds__(kThreads, 4) typed_message_fwd_bf16(
    const bf16* __restrict__ ef, const bf16* __restrict__ a, const int* __restrict__ types,
    const int* __restrict__ valid, const bf16* __restrict__ we,
    const bf16* __restrict__ w_attn, float* __restrict__ out, int num_nodes, int c,
    int num_types) {
  extern __shared__ float4 smem4[];
  const int rows = batch_rows(c);
  const Smem s(reinterpret_cast<unsigned char*>(smem4), rows);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const Chunk ch(num_nodes, c, num_types, blockIdx.y);
  const int nodes = ch.nodes;
  stage_we(s.we, we, ch.t, num_types);
  if (c % 4 == 0 &&
      ((reinterpret_cast<uintptr_t>(types) | reinterpret_cast<uintptr_t>(valid)) & 15) == 0)
    scan_rows<4>(s.warp_tot, s.list, s.seg, types, valid, ch);
  else
    scan_rows<1>(s.warp_tot, s.list, s.seg, types, valid, ch);
  if (tid < kWidth) s.wat[tid] = __bfloat162float(w_attn[tid]);
  for (int j = tid; j < nodes; j += kThreads)  // the a rows (128 bytes) of non-empty groups to L2
    if (s.seg[j + 1] > s.seg[j]) prefetch_l2(a + ch.row(j) * kWidth);

  // the per-node step: eight-lane groups, a lane on columns c0.. and c1..
  const int grp = 4 * warp + (lane >> 3), sub = lane & 7, c0 = 4 * sub, c1 = 32 + 4 * sub;
  const unsigned gmask = 0xffu << (lane & 24);

  int j0 = 0, j1 = batch_end(s.seg, 0, nodes, rows);
  load_rows(s.ef, ef, s.list, 0, s.seg[j1], ch);
  while (j0 < nodes) {
    const int b0 = s.seg[j0], nr = s.seg[j1] - b0;
    const int j2 = j1 < nodes ? batch_end(s.seg, j1, nodes, rows) : j1;
    for (int r = s.seg[j1] + tid; r < s.seg[j2]; r += kThreads)  // the next batch's rows to L2
      prefetch_l2(ef + entry_slot(ch, s.list[r]) * kWidth);
    cp_async_wait_all();
    __syncthreads();  // this batch's rows (and, the first time, We_t) are in
    project_batch(s, nr);
    __syncthreads();  // the products and the logits are complete

    // a group per node: out = sum e relu(prod + a) / den, 0 for an empty group
    for (int j = j0 + grp; j < j1; j += kGroups) {
      const int r0 = s.seg[j] - b0, r1 = s.seg[j + 1] - b0;
      const long long row = ch.row(j) * kWidth;
      float4 o0 = make_float4(0.f, 0.f, 0.f, 0.f), o1 = o0;
      float den = 1.f;
      if (r1 > r0) {
        const float4 a0 = load_a4(a + row + c0), a1 = load_a4(a + row + c1);
        den = node_softmax_sum<true>(s.logit, s.e, s.prod, r0, r1, sub, c0, c1, gmask, o0, o1,
                                     a0, a1);
      }
      const float inv = __frcp_rn(den);  // a product in place of eight divisions
      *reinterpret_cast<float4*>(out + row + c0) =
          make_float4(o0.x * inv, o0.y * inv, o0.z * inv, o0.w * inv);
      *reinterpret_cast<float4*>(out + row + c1) =
          make_float4(o1.x * inv, o1.y * inv, o1.z * inv, o1.w * inv);
    }
    if (j1 < nodes) {
      __syncthreads();  // the products are read
      load_rows(s.ef, ef, s.list, s.seg[j1], s.seg[j2] - s.seg[j1], ch);
    }
    j0 = j1;
    j1 = j2;
  }
}

}  // namespace tc

// ---------------------------------------------------------------- K2b

// Shared memory of one backward block, carved from the dynamic allocation;
// the float4-read arrays come first, at 16-byte offsets.
struct BwdSmem {
  float* we;        // kWidth x kLdR: We_t[k][o] at k * kLdR + o
  float* ef;        // rows x kLdR: the batch's ef rows
  float* p;         // rows x kLdR: pre, then dpre in place
  float* wat;       // kWidth: w_attn
  float* logit;     // rows
  float* e;         // rows: exp(logit - the group's max)
  float* dlogit;    // rows
  float* red;       // kThreads: dwa partials
  float* node_den;  // kChunkNodes: each node's softmax denominator
  float* node_q;    // kChunkNodes: each node's <g, out> / den
  int* warp_tot;    // kWarps: rows found per warp of the scan
  int* row_node;    // rows: each batch row's node, from the chunk's first
  int* seg;         // kChunkNodes + 1: each node's first row in list; seg[nodes] = count
  uint16_t* list;   // node_chunk * C: the chunk's type-t slots as local offsets j * C + slot

  __device__ BwdSmem(float* base, int rows) {
    we = base;
    ef = we + kWidth * kLdR;
    p = ef + rows * kLdR;
    wat = p + rows * kLdR;
    logit = wat + kWidth;
    e = logit + rows;
    dlogit = e + rows;
    red = dlogit + rows;
    node_den = red + kThreads;
    node_q = node_den + kChunkNodes;
    warp_tot = reinterpret_cast<int*>(node_q + kChunkNodes);
    row_node = warp_tot + kWarps;
    seg = row_node + rows;
    list = reinterpret_cast<uint16_t*>(seg + kChunkNodes + 1);
  }
};

size_t bwd_smem_bytes(int c, int node_chunk) {
  const int rows = batch_rows(c);
  return sizeof(float) *
             (kWidth * kLdR + 2 * rows * kLdR + kWidth + 3 * rows + kThreads + 2 * kChunkNodes) +
         sizeof(int) * (kWarps + rows + kChunkNodes + 1) +
         sizeof(uint16_t) * static_cast<size_t>(node_chunk) * c;
}

// d_ef = dpre @ We_t^T + dlogit * w_attn for rows base + rg + 16 i (i < RT)
// of the batch, columns cg + 16 j (j < 4), stored to the rows' slots.
template <int RT>
__device__ void backproject_pass(const BwdSmem& s, float* __restrict__ d_ef, int base, int nr,
                                 int b0, const Chunk& ch) {
  const int rg = threadIdx.x >> 4, cg = threadIdx.x & 15;
  float acc[RT][4] = {};
#pragma unroll 2
  for (int o = 0; o < kWidth; o += 4) {
    float4 w[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) w[j] = ld4(s.we + (cg + 16 * j) * kLdR + o);
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const float4 d = ld4(s.p + (base + rg + 16 * i) * kLdR + o);
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = dot4(acc[i][j], d, w[j]);
    }
  }
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int r = base + rg + 16 * i;
    if (r < nr) {
      const float dl = s.dlogit[r];
      float* dst = d_ef + ch.slot(s.list[b0 + r]) * kWidth;
#pragma unroll
      for (int j = 0; j < 4; ++j) dst[cg + 16 * j] = acc[i][j] + dl * s.wat[cg + 16 * j];
    }
  }
}

__global__ void __launch_bounds__(kThreads, 2) typed_message_bwd(
    const float* __restrict__ ef, const float* __restrict__ a, const int* __restrict__ types,
    const int* __restrict__ valid, const float* __restrict__ we,
    const float* __restrict__ w_attn, const float* __restrict__ g, float* __restrict__ d_ef,
    float* __restrict__ da, float* __restrict__ ws_we, float* __restrict__ ws_wa,
    int num_nodes, int c, int num_types) {
  extern __shared__ float4 smem4[];
  const int rows = batch_rows(c);
  const BwdSmem s(reinterpret_cast<float*>(smem4), rows);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t = blockIdx.y;
  const Chunk ch(num_nodes, c, num_types, t);
  const int nodes = ch.nodes;
  stage_we(s.we, we, t, num_types);
  if (tid < kWidth) s.wat[tid] = w_attn[tid];
  list_rows<true>(s.warp_tot, s.list, s.seg, types, valid, d_ef, ch);
  // the nodes' a and g rows to L2, for the products' and softmax steps' loads
  for (int i = tid; i < 4 * nodes; i += kThreads)
    prefetch_l2(((i & 2) ? g : a) + ch.row(i >> 2) * kWidth + 32 * (i & 1));

  // this thread's share of the dwe_t partial: rows k0..k0 + 3, columns
  // o0..o0 + 3; and of dwa: entry tid % 64 over the rows tid / 64 mod 4
  const int k0 = 4 * (tid >> 4), o0 = 4 * (tid & 15);
  float dwe[4][4] = {};
  float dwa = 0.f;

  for (int j0 = 0; j0 < nodes;) {
    const int b0 = s.seg[j0];
    const int j1 = batch_end(s.seg, j0, nodes, rows);
    const int nr = s.seg[j1] - b0;

    load_rows(s.ef, s.row_node, ef, s.list, b0, nr, ch);
    cp_async_wait_all();
    __syncthreads();
    if (nr > 0) {
      for (int r = warp; r < nr; r += kWarps) {
        const float* er = s.ef + r * kLdR;
        const float v = warp_sum(er[lane] * s.wat[lane] + er[lane + 32] * s.wat[lane + 32]);
        if (lane == 0) s.logit[r] = v;
      }
      PEMP_ROW_PASSES(project_pass, s.we, s.ef, s.p, s.row_node, a, base, nr, ch)
      __syncthreads();
    }

    // softmax backward in eight-lane groups (four a warp), a lane on columns
    // c0..c0 + 3 and c1..c1 + 3; every sum over a group's rows in slot order.
    // A group per node: the softmax, out and q.
    const int grp = 4 * warp + (lane >> 3), sub = lane & 7, c0 = 4 * sub, c1 = 32 + 4 * sub;
    const unsigned gmask = 0xffu << (lane & 24);
    for (int j = j0 + grp; j < j1; j += kGroups) {
      const int r0 = s.seg[j] - b0, r1 = s.seg[j + 1] - b0;
      if (r1 == r0) continue;
      const long long row = ch.row(j) * kWidth;
      const float4 g0 = __ldg(reinterpret_cast<const float4*>(g + row + c0));
      const float4 g1 = __ldg(reinterpret_cast<const float4*>(g + row + c1));
      float4 o0, o1;
      const float den = node_softmax_sum(s.logit, s.e, s.p, r0, r1, sub, c0, c1, gmask, o0, o1);
      const float part = g0.x * (o0.x / den) + g0.y * (o0.y / den) + g0.z * (o0.z / den) +
                         g0.w * (o0.w / den) + g1.x * (o1.x / den) + g1.y * (o1.y / den) +
                         g1.z * (o1.z / den) + g1.w * (o1.w / den);
      const float q = group_sum(part, gmask) / den;
      if (sub == 0) {
        s.node_den[j] = den;
        s.node_q[j] = q;
      }
    }
    __syncthreads();

    // a group per row: dpre = e * g / den * 1[pre > 0] in place of pre, and
    // dlogit = <e * g / den, relu(pre)> - e * q
    for (int r = grp; r < nr; r += kGroups) {
      const int j = s.row_node[r];
      const float den = s.node_den[j], eq = s.e[r] * s.node_q[j], scale = s.e[r] / den;
      const long long row = ch.row(j) * kWidth;
      const float4 g0 = __ldg(reinterpret_cast<const float4*>(g + row + c0));
      const float4 g1 = __ldg(reinterpret_cast<const float4*>(g + row + c1));
      float4* pr0 = reinterpret_cast<float4*>(s.p + r * kLdR + c0);
      float4* pr1 = reinterpret_cast<float4*>(s.p + r * kLdR + c1);
      const float4 p0 = *pr0, p1 = *pr1;
      const float gv[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
      const float pv[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
      float dp[8], dot = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float dm = scale * gv[i];
        dp[i] = pv[i] > 0.f ? dm : 0.f;
        dot += dm * fmaxf(pv[i], 0.f);
      }
      const float dl = group_sum(dot, gmask) - eq;
      *pr0 = make_float4(dp[0], dp[1], dp[2], dp[3]);
      *pr1 = make_float4(dp[4], dp[5], dp[6], dp[7]);
      if (sub == 0) s.dlogit[r] = dl;
    }
    __syncthreads();

    // a group per node: da = the sum of its rows' dpre (0 for an empty group)
    for (int j = j0 + grp; j < j1; j += kGroups) {
      const int r0 = s.seg[j] - b0, r1 = s.seg[j + 1] - b0;
      float4 da0 = make_float4(0.f, 0.f, 0.f, 0.f), da1 = da0;
      for (int r = r0; r < r1; ++r) {
        const float4 p0 = ld4(s.p + r * kLdR + c0), p1 = ld4(s.p + r * kLdR + c1);
        da0 = make_float4(da0.x + p0.x, da0.y + p0.y, da0.z + p0.z, da0.w + p0.w);
        da1 = make_float4(da1.x + p1.x, da1.y + p1.y, da1.z + p1.z, da1.w + p1.w);
      }
      const long long row = ch.row(j) * kWidth;
      *reinterpret_cast<float4*>(da + row + c0) = da0;
      *reinterpret_cast<float4*>(da + row + c1) = da1;
    }
    if (nr > 0) {
      PEMP_ROW_PASSES(backproject_pass, s, d_ef, base, nr, b0, ch)
#pragma unroll 4
      for (int r = 0; r < nr; ++r) {
        const float4 x = ld4(s.ef + r * kLdR + k0);
        const float4 y = ld4(s.p + r * kLdR + o0);
        fma4(dwe[0], x.x, y);
        fma4(dwe[1], x.y, y);
        fma4(dwe[2], x.z, y);
        fma4(dwe[3], x.w, y);
      }
      for (int r = tid >> 6; r < nr; r += kThreads / kWidth)
        dwa = fmaf(s.ef[r * kLdR + (tid & 63)], s.dlogit[r], dwa);
    }
    __syncthreads();
    j0 = j1;
  }

  const long long part = static_cast<long long>(blockIdx.x) * num_types + t;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    *reinterpret_cast<float4*>(ws_we + (part * kWidth + k0 + i) * kWidth + o0) =
        make_float4(dwe[i][0], dwe[i][1], dwe[i][2], dwe[i][3]);
  s.red[tid] = dwa;
  __syncthreads();
  if (tid < kWidth)
    ws_wa[part * kWidth + tid] =
        s.red[tid] + s.red[tid + kWidth] + s.red[tid + 2 * kWidth] + s.red[tid + 3 * kWidth];
}

#undef PEMP_ROW_PASSES

// dwe[k, t*D + o] = sum over chunks of ws_we[chunk, t, k, o], a thread per
// output; dwa[k] = sum over chunks and types of ws_wa[chunk, t, k], a warp
// per output (the last kWidth / kWarps blocks): lane l adds the (chunk, type)
// partials l, l + 32, ... in turn, then the lanes' sums meet in a fixed tree.
// Both in a fixed order.
__global__ void __launch_bounds__(kThreads) typed_message_bwd_reduce(
    const float* __restrict__ ws_we, const float* __restrict__ ws_wa, float* __restrict__ dwe,
    float* __restrict__ dwa, int num_types, int chunks) {
  const int per_type = kWidth * kWidth;
  const int dwe_blocks = (num_types * per_type + kThreads - 1) / kThreads;
  if (static_cast<int>(blockIdx.x) < dwe_blocks) {
    const int i = blockIdx.x * kThreads + threadIdx.x;
    if (i >= num_types * per_type) return;
    const int t = i / per_type, k = (i / kWidth) % kWidth, o = i % kWidth;
    float v = 0.f;
    for (int ch = 0; ch < chunks; ++ch)
      v += ws_we[((static_cast<long long>(ch) * num_types + t) * kWidth + k) * kWidth + o];
    dwe[static_cast<long long>(k) * num_types * kWidth + t * kWidth + o] = v;
    return;
  }
  const int lane = threadIdx.x & 31;
  const int k = (blockIdx.x - dwe_blocks) * kWarps + (threadIdx.x >> 5);
  const int parts = chunks * num_types;
  float v = 0.f;
  for (int p = lane; p < parts; p += 32) v += ws_wa[static_cast<long long>(p) * kWidth + k];
  v = warp_sum(v);
  if (lane == 0) dwa[k] = v;
}

int set_smem(const void* kernel, size_t bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes)));
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

int launch_fwd(const float* ef, const float* a, const int* types, const int* valid,
               const float* we, const float* w_attn, float* out, int num_nodes, int c,
               int num_types, cudaStream_t stream) {
  const size_t smem = fwd_smem_bytes(c);
  int err = set_smem(reinterpret_cast<const void*>(typed_message_fwd), smem);
  if (err != 0) return err;
  const dim3 grid((num_nodes + kChunkNodes - 1) / kChunkNodes, num_types);
  typed_message_fwd<<<grid, kThreads, smem, stream>>>(ef, a, types, valid, we, w_attn, out,
                                                      num_nodes, c, num_types);
  return static_cast<int>(cudaGetLastError());
}

int launch_fwd(const tc::bf16* ef, const tc::bf16* a, const int* types, const int* valid,
               const tc::bf16* we, const tc::bf16* w_attn, float* out, int num_nodes, int c,
               int num_types, cudaStream_t stream) {
  const void* kernel = reinterpret_cast<const void*>(tc::typed_message_fwd_bf16);
  const size_t smem = tc::smem_bytes(c);
  int err = set_smem(kernel, smem);
  if (err != 0) return err;
  // all of the SM's shared memory, so that four blocks fit one
  err = static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxShared));
  if (err != 0) return err;
  const dim3 grid((num_nodes + kChunkNodes - 1) / kChunkNodes, num_types);
  tc::typed_message_fwd_bf16<<<grid, kThreads, smem, stream>>>(ef, a, types, valid, we, w_attn,
                                                               out, num_nodes, c, num_types);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Forward (K2). ef, a, we and w_attn are all f32 (bf16 = 0) or all bf16
// (bf16 = 1); types and valid int32; out f32. Rows are kWidth wide; ef, we
// and out must be 16-byte aligned and a 16-byte (f32) or 8-byte (bf16)
// aligned (they are read and written in pieces of that size). Blocks own
// kChunkNodes nodes at most. Returns a cudaError_t, or -2 for unsupported
// sizes or alignment.
extern "C" int pemp_typed_message_fwd(const void* ef, const void* a, const int* types,
                                      const int* valid, const void* we, const void* w_attn,
                                      float* out, int num_nodes, int c, int num_types, int bf16,
                                      void* stream) {
  if (c < 1 || c > kMaxSlots || num_types < 1 || num_nodes < 1) return -2;
  if (!(aligned16(ef) && aligned16(we) && aligned16(out)) ||
      pemp::misaligned(a, bf16 ? 8 : 16))
    return -2;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch_fwd(static_cast<const tc::bf16*>(ef), static_cast<const tc::bf16*>(a), types,
                      valid, static_cast<const tc::bf16*>(we),
                      static_cast<const tc::bf16*>(w_attn), out, num_nodes, c, num_types, st);
  return launch_fwd(static_cast<const float*>(ef), static_cast<const float*>(a), types, valid,
                    static_cast<const float*>(we), static_cast<const float*>(w_attn), out,
                    num_nodes, c, num_types, st);
}

// Backward (K2b): writes every row of d_ef (the invalid slots' with zeros);
// ws_we holds chunks * T * kWidth * kWidth
// floats and ws_wa chunks * T * kWidth, chunks = ceil(N / node_chunk),
// node_chunk <= kChunkNodes. ef, a, we, g, d_ef, da and ws_we must be 16-byte aligned
// (they are read and written in 16-byte pieces). Returns a cudaError_t, or
// -2 for unsupported sizes or alignment.
extern "C" int pemp_typed_message_bwd(const float* ef, const float* a, const int* types,
                                      const int* valid, const float* we, const float* w_attn,
                                      const float* g, float* d_ef, float* da, float* dwe,
                                      float* dwa, float* ws_we, float* ws_wa, int num_nodes,
                                      int c, int num_types, int node_chunk, void* stream) {
  if (c < 1 || c > kMaxSlots || num_types < 1 || num_nodes < 1 || node_chunk < 1 ||
      node_chunk > kChunkNodes)
    return -2;
  if (!(aligned16(ef) && aligned16(a) && aligned16(we) && aligned16(g) && aligned16(d_ef) &&
        aligned16(da) && aligned16(ws_we)))
    return -2;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = bwd_smem_bytes(c, node_chunk);
  int err = set_smem(reinterpret_cast<const void*>(typed_message_bwd), smem);
  if (err != 0) return err;
  const int chunks = (num_nodes + node_chunk - 1) / node_chunk;
  typed_message_bwd<<<dim3(chunks, num_types), kThreads, smem, st>>>(
      ef, a, types, valid, we, w_attn, g, d_ef, da, ws_we, ws_wa, num_nodes, c, num_types);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  const int outputs = num_types * kWidth * kWidth;
  typed_message_bwd_reduce<<<(outputs + kThreads - 1) / kThreads + kWidth / kWarps, kThreads, 0,
                             st>>>(ws_we, ws_wa, dwe, dwa, num_types, chunks);
  return static_cast<int>(cudaGetLastError());
}
