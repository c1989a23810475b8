// Fused eval-mode DeepSDF MLP for Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel hoisdf_tpu/ops/pallas/sdf_mlp.py::sdf_mlp_fused
// (body `_kernel`).  Per row of x[N, in]:
//   h = relu(x.W0 + b0); h = relu(h.W1 + b1); h = relu([h, x].W2 + b2);
//   h = relu(h.W3 + b3); out = tanh(h.W4 + b4)
// with f32 accumulation, activations recast to x's type between layers, and
// out[N] in f32.
//
// What bounds it on this card: arithmetic.  At the production dims
// (289 -> 512 -> 223 -> 512 -> 512 -> 1) a row costs 1.57 MFLOP against
// 578 bytes of input (bf16), two orders of magnitude above the card's
// operations per byte.  The 1.6 MB weight set does not fit one SM's 227 KB
// (it fits the TPU's VMEM), so every block streams it from L2: what keeps a
// kernel off the arithmetic bound here is first the latency of each streamed
// slice, when a block barrier stands behind it, and then L2's rate, since each
// block of 64 rows reads all the weights again.
//
// What the design does about it (bf16, the serving path):
//   - A block is one consumer warpgroup, which owns 64 rows, and one producer
//     warp.  The tile's input and two activation buffers stay in shared
//     memory for all five layers, as K-major panels of 64 rows x 64 k in the
//     128-byte swizzle that wgmma's descriptors read.
//   - The four hidden layers run on wgmma m64n128k16 (bf16 in, f32
//     accumulate), A and B both from shared memory.  A pass holds 256
//     output columns in two register accumulators for a whole k-range.
//   - The weights come packed by the wrapper module (prepare_weights, once
//     per forward) as the exact shared-memory image of each stage: 128
//     columns x 64 k of W^T, swizzled, 16 KB, in the order the consumer
//     walks them.  The producer brings a stage with one cp.async.bulk that
//     completes on the stage's "full" mbarrier; the consumer waits on it,
//     starts the stage's four wgmma, and releases the stage on its "empty"
//     mbarrier once the wgmma group before it has retired.  There is no block
//     barrier in the main loop, only one warpgroup barrier per layer.
//   - A block of 64 rows still reads every weight from L2 once.  Sharing a
//     stage between the two blocks of a cluster (multicast, each fetching
//     half) measured slower than independent blocks on this card, because the
//     blocks then advance in lockstep; it is not used.  Two consumer
//     warpgroups in one block would share a stage too, but 128 rows of
//     resident panels (2 x 136 KB) are more than an SM's shared memory.
//   - The epilogue adds the bias, applies ReLU, rounds to bf16 and writes the
//     next layer's A operand straight into its swizzled panels.  The skip
//     concat is a second k-range of layer 2 that reads the resident input
//     panels; nothing is copied.  Layer 3's output is never stored: the
//     512 -> 1 output layer is a dot product with w4 taken in layer 3's
//     epilogue from the accumulators (after bias, ReLU and the rounding to
//     bf16), reduced over the four lanes that share a row, then tanh.
//   - Ragged N is masked, not padded.  Padded columns of every panel are
//     zero, and so are the padded rows and columns of the packed weights.
//   - The block has 160 threads and an SM holds one block (shared memory), so
//     every thread may use 255 registers and no setmaxnreg is needed.
// f32 (parity runs, not on the serving path): CUDA-core FMAs on 32-row tiles,
// a 2 x 4 register tile per thread, weights staged in 32-row slices, so f32
// stays f32 (the tensor cores would round it to TF32); a warp-per-row dot
// product for the output layer.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;
using bf16 = __nv_bfloat16;
constexpr int kThreads = 256;  // f32 kernel

// ---- f32: CUDA cores -------------------------------------------------------

constexpr int kF32Rows = 32;
constexpr int kNT = 64;  // output columns per pass (16 column groups x 4)
constexpr int kKT = 32;  // weight rows per staged slice

// out[32, n] = relu([a1 | a2] . W + bias): a1 is [32, k1], a2 is [32, k2]
// (k2 = 0 except for the skip layer), both in shared memory; W is
// [k1 + k2, n] row-major in global memory.
__device__ void dense_relu_f32(const float* a1, int lda1, int k1, const float* a2,
                               int lda2, int k2, const float* __restrict__ w,
                               const float* __restrict__ bias, int n, float* out,
                               int ldo, float* w_s) {
  constexpr int RM = kF32Rows / 16;
  const int tx = threadIdx.x % 16;  // 4 contiguous columns
  const int ty = threadIdx.x / 16;  // rows ty, ty + 16
  const int k = k1 + k2;
  for (int n0 = 0; n0 < n; n0 += kNT) {
    float acc[RM][4] = {};
    for (int k0 = 0; k0 < k; k0 += kKT) {
      for (int i = threadIdx.x; i < kKT * kNT; i += kThreads) {
        const int kk = i / kNT, nn = i % kNT;
        const int gk = k0 + kk, gn = n0 + nn;
        w_s[i] = (gk < k && gn < n) ? w[(size_t)gk * n + gn] : 0.f;
      }
      __syncthreads();
      const int kend = min(kKT, k - k0);
      for (int kk = 0; kk < kend; ++kk) {
        const int gk = k0 + kk;
        const float* src = gk < k1 ? a1 + gk : a2 + (gk - k1);
        const int ld = gk < k1 ? lda1 : lda2;
        const float4 b = *reinterpret_cast<const float4*>(w_s + kk * kNT + 4 * tx);
#pragma unroll
        for (int r = 0; r < RM; ++r) {
          const float a = src[(ty + 16 * r) * ld];
          acc[r][0] = fmaf(a, b.x, acc[r][0]);
          acc[r][1] = fmaf(a, b.y, acc[r][1]);
          acc[r][2] = fmaf(a, b.z, acc[r][2]);
          acc[r][3] = fmaf(a, b.w, acc[r][3]);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int gn = n0 + 4 * tx + c;
      if (gn < n) {
#pragma unroll
        for (int r = 0; r < RM; ++r)
          out[(ty + 16 * r) * ldo + gn] = fmaxf(acc[r][c] + bias[gn], 0.f);
      }
    }
  }
}

// ---- bf16: wgmma, weight stages by bulk copy --------------------------------

constexpr int kRows = 64;                    // rows per block: wgmma's M
constexpr int kPanelK = 64;                  // k per panel: one 128-byte swizzled row
constexpr int kPanelBytes = kRows * 128;     // activation panel, 64 rows
constexpr int kStageN = 128;                 // weight columns per stage: wgmma's N
constexpr int kStageBytes = kStageN * 128;   // weight stage, 128 columns x 64 k
constexpr int kStages = 5;                   // stages in the ring
constexpr int kConsumers = 128;              // one warpgroup
constexpr int kBf16Threads = kConsumers + 32;

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// Stages of one layer: column halves x k panels of its one or two k-ranges.
__host__ __device__ constexpr int layer_stages(int n, int k0, int k1) {
  return cdiv(n, kStageN) * (cdiv(k0, kPanelK) + cdiv(k1, kPanelK));
}

struct Bf16Args {
  const bf16* x;
  const bf16* stages;   // every layer's weight stages, in consumption order
  const bf16* vectors;  // b0..b3 and w4, each zero-padded to a multiple of 128
  const bf16* b4;
  float* out;
  int n_rows, in_dim, h[4], n_stages, x_vec_ok;
  // byte offsets from the 1024-aligned base of dynamic shared memory
  int off_x, off_a, off_b, off_vec, off_bar;
};

// -- wgmma
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void fence_async_proxy() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void consumer_barrier() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// Descriptor of a K-major operand in the 128-byte swizzle: rows of 128 bytes,
// groups of 8 rows 1024 bytes apart (SBO); LBO is not used by this layout.
// A k-step of 16 inside the panel adds 32 bytes, 2 in the address field.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

// d[64 x 128] (+)= a[64 x 16] . b[128 x 16]^T, both operands in shared memory.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db,
                                                 int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// Byte offset of element (row, col) in a run of swizzled 64 x 64 panels.
__device__ __forceinline__ int swz(int r, int c) {
  return (c >> 6) * kPanelBytes + r * 128 + ((((c >> 3) & 7) ^ (r & 7)) << 4) + (c & 7) * 2;
}

// One k-range of a layer: its panels in shared memory and its real width.
struct Seg {
  uint32_t addr;
  int k;
};

// The consumer's walk through the ring.
struct Ring {
  uint32_t full, empty, data;  // shared addresses: barriers [kStages], stage buffers
  int stage, parity, prev;
};

// Release a stage whose wgmma group has retired: one arrival from each warp.
__device__ __forceinline__ void release_stage(const Ring& ring, int stage) {
  if (threadIdx.x % 32 == 0) mbar_arrive(ring.empty + 8 * stage);
}

// The next stage of the ring against one activation panel: four k-steps of
// 16 (the padded k of a last panel multiplies zeros).  The code between the
// wgmma of a pass is straight-line and touches no accumulator, so the tensor
// cores run one group behind the warps without being serialized.
__device__ __forceinline__ void mma_stage(Ring& ring, float (&acc)[64], uint64_t a_desc,
                                          int accumulate) {
  mbar_wait(ring.full + 8 * ring.stage, ring.parity);
  const uint64_t b_desc = make_desc(ring.data + ring.stage * kStageBytes);
  wgmma_fence();
  wgmma_m64n128k16(acc, a_desc, b_desc, accumulate);
  wgmma_m64n128k16(acc, a_desc + 2, b_desc + 2, 1);
  wgmma_m64n128k16(acc, a_desc + 4, b_desc + 4, 1);
  wgmma_m64n128k16(acc, a_desc + 6, b_desc + 6, 1);
  wgmma_commit();
  wgmma_wait<1>();  // the group before this one has retired: its stage is free
  if (ring.prev >= 0) release_stage(ring, ring.prev);
  ring.prev = ring.stage;
  if (++ring.stage == kStages) {
    ring.stage = 0;
    ring.parity ^= 1;
  }
}

// A finished accumulator of 64 rows x 128 columns (columns cb ..): this thread
// holds rows `row` and `row + 8`, columns cb + 8 j + 2 q and the next, j < 16.
// kLast = false: out panels get bf16(relu(acc + bias)), zero past the layer's
// width.  kLast = true: nothing is stored; dot[0..1] gather
// sum_c bf16(relu(acc + bias))[c] * w4[c] over this thread's columns.
template <bool kLast>
__device__ __forceinline__ void epilogue(const float (&acc)[64], int cb, int row, int q,
                                         int out_panels, const bf16* bias_s, const bf16* w4_s,
                                         unsigned char* out, float (&dot)[2]) {
  // One warp runs on each scheduler, so nothing hides a load's latency but
  // the thread's own independent work: all the vector loads first, then
  // straight-line arithmetic, one branch for each panel of eight column groups.
  __nv_bfloat162 bias[16], w4[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int c = cb + 8 * j + 2 * q;
    bias[j] = *reinterpret_cast<const __nv_bfloat162*>(bias_s + c);
    if (kLast) w4[j] = *reinterpret_cast<const __nv_bfloat162*>(w4_s + c);
  }
  const int r7 = row & 7;
#pragma unroll
  for (int p = 0; p < 2; ++p) {  // the half's two panels of 64 columns
    const int panel = (cb >> 6) + p;
    if (!kLast && panel >= out_panels) break;
    unsigned char* base = out + panel * kPanelBytes + row * 128 + q * 4;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int j = 8 * p + jj;
      const float2 b = __bfloat1622float2(bias[j]);
      const __nv_bfloat162 lo = __floats2bfloat162_rn(fmaxf(acc[4 * j] + b.x, 0.f),
                                                      fmaxf(acc[4 * j + 1] + b.y, 0.f));
      const __nv_bfloat162 hi = __floats2bfloat162_rn(fmaxf(acc[4 * j + 2] + b.x, 0.f),
                                                      fmaxf(acc[4 * j + 3] + b.y, 0.f));
      if (kLast) {
        const float2 w = __bfloat1622float2(w4[j]);
        const float2 l = __bfloat1622float2(lo), h = __bfloat1622float2(hi);
        dot[0] = fmaf(l.y, w.y, fmaf(l.x, w.x, dot[0]));
        dot[1] = fmaf(h.y, w.y, fmaf(h.x, w.x, dot[1]));
      } else {  // swz(row, c) and swz(row + 8, c): the rows share row & 7
        const int off = (jj ^ r7) << 4;
        *reinterpret_cast<__nv_bfloat162*>(base + off) = lo;
        *reinterpret_cast<__nv_bfloat162*>(base + off + 8 * 128) = hi;
      }
    }
  }
}

// One pass of a hidden layer on the consumer warpgroup: 256 output columns
// (kTwo) or 128, from column cb.  The k-ranges s0 then s1, panel by panel, the
// pass's column halves taking turns; then the epilogue of each half.  The
// accumulators start undefined: the first wgmma of each overwrites them.
template <bool kLast, bool kTwo>
__device__ __forceinline__ void layer_pass(Ring& ring, Seg s0, Seg s1, int cb, int out_panels,
                                           const bf16* bias_s, const bf16* w4_s,
                                           unsigned char* out, float (&dot)[2]) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = 16 * warp + (lane >> 2), q = lane & 3;  // this thread: row, row + 8
  float acc0[64], acc1[64];
  int accumulate = 0;
#pragma unroll
  for (int si = 0; si < 2; ++si) {
    const Seg s = si == 0 ? s0 : s1;
    const int panels = cdiv(s.k, kPanelK);
    for (int kp = 0; kp < panels; ++kp) {
      const uint64_t a_desc = make_desc(s.addr + kp * kPanelBytes);
      mma_stage(ring, acc0, a_desc, accumulate);
      if (kTwo) mma_stage(ring, acc1, a_desc, accumulate);
      accumulate = 1;
    }
  }
  wgmma_wait<0>();
  release_stage(ring, ring.prev);
  ring.prev = -1;
  epilogue<kLast>(acc0, cb, row, q, out_panels, bias_s, w4_s, out, dot);
  if (kTwo) epilogue<kLast>(acc1, cb + kStageN, row, q, out_panels, bias_s, w4_s, out, dot);
}

// One hidden layer: passes of two column halves, and one of a single half
// where the halves are odd.
template <bool kLast>
__device__ __forceinline__ void dense_layer(Ring& ring, Seg s0, Seg s1, int n,
                                            const bf16* bias_s, const bf16* w4_s,
                                            unsigned char* out, float (&dot)[2]) {
  const int halves = cdiv(n, kStageN), out_panels = cdiv(n, kPanelK);
  int h0 = 0;
  for (; h0 + 1 < halves; h0 += 2)
    layer_pass<kLast, true>(ring, s0, s1, h0 * kStageN, out_panels, bias_s, w4_s, out,
                                      dot);
  if (h0 < halves)
    layer_pass<kLast, false>(ring, s0, s1, h0 * kStageN, out_panels, bias_s, w4_s, out,
                                       dot);
  if (!kLast) {
    // the stores become visible to the next layer's wgmma, on every warp
    fence_async_proxy();
    consumer_barrier();
  }
}

// The block's 64 input rows into their swizzled panels, zero past in_dim and
// past the last row.  The tile is one contiguous run of x, read in 16-byte
// vectors when x is 16-byte aligned.
__device__ __forceinline__ void load_x_tile(const Bf16Args& A, int row0, unsigned char* x_s) {
  const int tid = threadIdx.x;
  const int x_panels = cdiv(A.in_dim, kPanelK);
  for (int i = tid; i < x_panels * kPanelBytes / 16; i += kConsumers)
    reinterpret_cast<uint4*>(x_s)[i] = make_uint4(0, 0, 0, 0);
  consumer_barrier();
  const int rows = max(0, min(kRows, A.n_rows - row0));
  const int n_el = rows * A.in_dim;
  const bf16* src = A.x + (size_t)row0 * A.in_dim;
  const int n_vec = A.x_vec_ok ? n_el / 8 : 0;
  constexpr int kBatch = 10;  // loads in flight per thread: a full tile is 19 vectors each at most
  for (int v0 = tid; v0 < n_vec; v0 += kBatch * kConsumers) {
    uint4 raw[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int v = v0 + b * kConsumers;
      if (v < n_vec) raw[b] = __ldg(reinterpret_cast<const uint4*>(src) + v);
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int v = v0 + b * kConsumers;
      if (v >= n_vec) break;
      const bf16* e = reinterpret_cast<const bf16*>(&raw[b]);
      int r = 8 * v / A.in_dim, c = 8 * v % A.in_dim;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        *reinterpret_cast<bf16*>(x_s + swz(r, c)) = e[i];
        if (++c == A.in_dim) {
          c = 0;
          ++r;
        }
      }
    }
  }
  for (int i = 8 * n_vec + tid; i < n_el; i += kConsumers)
    *reinterpret_cast<bf16*>(x_s + swz(i / A.in_dim, i % A.in_dim)) = src[i];
  fence_async_proxy();
  consumer_barrier();
}

__global__ void __launch_bounds__(kBf16Threads, 1)
sdf_mlp_bf16_kernel(const Bf16Args A) {
  extern __shared__ unsigned char smem_raw[];
  // the swizzle is a function of the address: panels and stages sit on 1024 bytes
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* x_s = smem + A.off_x;
  unsigned char* a_s = smem + A.off_a;
  unsigned char* b_s = smem + A.off_b;
  bf16* vec_s = reinterpret_cast<bf16*>(smem + A.off_vec);  // b0..b3 and w4, zero-padded
  const uint32_t full = smem_u32(smem + A.off_bar), empty = full + 8 * kStages;
  const uint32_t vec_bar = empty + 8 * kStages;
  const int tid = threadIdx.x;
  const int* h = A.h;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);                // the producer's expect_tx
      mbar_init(empty + 8 * s, kConsumers / 32);  // every consumer warp
    }
    mbar_init(vec_bar, 1);
    mbar_fence_init();
  }
  // where b0..b3 and w4 start in the vectors, each padded to 128 columns
  int vec_off[5], vec_len = 0;
#pragma unroll
  for (int l = 0; l < 5; ++l) {
    vec_off[l] = vec_len;
    vec_len += cdiv(h[l < 4 ? l : 3], kStageN) * kStageN;
  }
  __syncthreads();  // the barriers are ready

  if (tid >= kConsumers) {
    // ---- producer warp: one lane keeps the ring full
    if (tid == kConsumers) {
      mbar_expect_tx(vec_bar, vec_len * (int)sizeof(bf16));
      bulk_copy(smem_u32(vec_s), A.vectors, vec_len * (int)sizeof(bf16), vec_bar);
      const unsigned char* src = reinterpret_cast<const unsigned char*>(A.stages);
      const uint32_t data = smem_u32(smem);
      int stage = 0, parity = 1;  // a fresh barrier's "previous phase" has completed
      for (int i = 0; i < A.n_stages; ++i) {
        mbar_wait(empty + 8 * stage, parity);
        mbar_expect_tx(full + 8 * stage, kStageBytes);
        bulk_copy(data + stage * kStageBytes, src + (size_t)i * kStageBytes, kStageBytes,
                  full + 8 * stage);
        if (++stage == kStages) {
          stage = 0;
          parity ^= 1;
        }
      }
    }
  } else {
    // ---- consumer warpgroup
    const int row0 = blockIdx.x * kRows;
    load_x_tile(A, row0, x_s);
    mbar_wait(vec_bar, 0);
    Ring ring{full, empty, smem_u32(smem), 0, 0, -1};
    const Seg none{0, 0};
    const Seg sx{smem_u32(x_s), A.in_dim};
    float dot[2] = {0.f, 0.f};
    dense_layer<false>(ring, sx, none, h[0], vec_s + vec_off[0], nullptr, a_s, dot);
    dense_layer<false>(ring, Seg{smem_u32(a_s), h[0]}, none, h[1], vec_s + vec_off[1], nullptr,
                       b_s, dot);
    dense_layer<false>(ring, Seg{smem_u32(b_s), h[1]}, sx, h[2], vec_s + vec_off[2], nullptr,
                       a_s, dot);
    dense_layer<true>(ring, Seg{smem_u32(a_s), h[2]}, none, h[3], vec_s + vec_off[3],
                      vec_s + vec_off[4], nullptr, dot);
    // the four lanes of a quad hold the partial sums of rows g and g + 8
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      dot[i] += __shfl_xor_sync(0xffffffffu, dot[i], 1);
      dot[i] += __shfl_xor_sync(0xffffffffu, dot[i], 2);
    }
    const int lane = tid % 32;
    if ((lane & 3) == 0) {
      const float b4 = __bfloat162float(A.b4[0]);
      const int r = row0 + 16 * (tid / 32) + (lane >> 2);
      if (r < A.n_rows) A.out[r] = tanhf(dot[0] + b4);
      if (r + 8 < A.n_rows) A.out[r + 8] = tanhf(dot[1] + b4);
    }
  }
}

// ---- the f32 kernel -----------------------------------------------------------

// 512 -> 1 output layer: one warp per row, then tanh.
__device__ void output_layer_f32(const float* h, int ldh, int rows, int k,
                                 const float* __restrict__ w4, const float* __restrict__ b4,
                                 int row0, int n_rows, float* out) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float bias4 = b4[0];
  for (int r = warp; r < rows; r += kThreads / 32) {
    float s = 0.f;
    for (int kk = lane; kk < k; kk += 32) s = fmaf(h[r * ldh + kk], w4[kk], s);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    const int g = row0 + r;
    if (lane == 0 && g < n_rows) out[g] = tanhf(s + bias4);
  }
}

struct Weights {
  const void* p[10];  // w0, b0, w1, b1, w2, b2, w3, b3, w4, b4
  int h[4];           // hidden widths
};

__global__ void __launch_bounds__(kThreads)
sdf_mlp_f32_kernel(const float* __restrict__ x, int n_rows, int in_dim, Weights W,
                   float* __restrict__ out, int ldx, int ldh) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* w_s = reinterpret_cast<float*>(smem);
  float* x_s = w_s + kKT * kNT;
  float* ha = x_s + kF32Rows * ldx;
  float* hb = ha + kF32Rows * ldh;
  const int row0 = blockIdx.x * kF32Rows;
  auto p = [&](int i) { return static_cast<const float*>(W.p[i]); };

  for (int i = threadIdx.x; i < kF32Rows * in_dim; i += kThreads) {
    const int r = i / in_dim, c = i % in_dim, g = row0 + r;
    x_s[r * ldx + c] = g < n_rows ? x[(size_t)g * in_dim + c] : 0.f;
  }
  __syncthreads();
  dense_relu_f32(x_s, ldx, in_dim, nullptr, 0, 0, p(0), p(1), W.h[0], ha, ldh, w_s);
  __syncthreads();
  dense_relu_f32(ha, ldh, W.h[0], nullptr, 0, 0, p(2), p(3), W.h[1], hb, ldh, w_s);
  __syncthreads();
  dense_relu_f32(hb, ldh, W.h[1], x_s, ldx, in_dim, p(4), p(5), W.h[2], ha, ldh, w_s);
  __syncthreads();
  dense_relu_f32(ha, ldh, W.h[2], nullptr, 0, 0, p(6), p(7), W.h[3], hb, ldh, w_s);
  __syncthreads();
  output_layer_f32(hb, ldh, kF32Rows, W.h[3], p(8), p(9), row0, n_rows, out);
}

// ---- launch -------------------------------------------------------------------

constexpr size_t kMaxSmem = 232448;

cudaError_t set_smem(const void* kern, size_t smem) {
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace

// x: [n, in_dim]; w: the ten pointers w0, b0, ..., w4, b4; h: the four hidden
// widths.  dtype 0 = float32: w0..w3 are [in, out].  dtype 1 = bfloat16: w[0]
// is the run of n_stages weight stages and w[1] the padded vectors that the
// wrapper module's _pack_bf16 makes, w[9] is b4 (the others are not read).
// Returns a cudaError_t.
extern "C" int sdf_mlp_launch(const void* x, int dtype, int n, int in_dim,
                              const void* const* w, const int* h, int n_stages, void* out,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    Weights W;
    for (int i = 0; i < 10; ++i) W.p[i] = w[i];
    for (int i = 0; i < 4; ++i) W.h[i] = h[i];
    const int hmax = max(max(h[0], h[1]), max(h[2], h[3]));
    // odd row pitches: the two rows a warp reads at once sit in other banks
    const int ldx = in_dim | 1, ldh = hmax | 1;
    const size_t smem = sizeof(float) * (kKT * kNT + (size_t)kF32Rows * (ldx + 2 * ldh));
    if ((err = set_smem((const void*)sdf_mlp_f32_kernel, smem)) != cudaSuccess) return err;
    sdf_mlp_f32_kernel<<<(n + kF32Rows - 1) / kF32Rows, kThreads, smem, s>>>(
        static_cast<const float*>(x), n, in_dim, W, static_cast<float*>(out), ldx, ldh);
    return cudaGetLastError();
  }
  if (dtype != 1) return cudaErrorInvalidValue;
  const int want = layer_stages(h[0], in_dim, 0) + layer_stages(h[1], h[0], 0) +
                   layer_stages(h[2], h[1], in_dim) + layer_stages(h[3], h[2], 0);
  if (n_stages != want) return cudaErrorInvalidValue;
  Bf16Args A;
  A.x = static_cast<const bf16*>(x);
  A.stages = static_cast<const bf16*>(w[0]);
  A.vectors = static_cast<const bf16*>(w[1]);
  A.b4 = static_cast<const bf16*>(w[9]);
  A.out = static_cast<float*>(out);
  A.n_rows = n;
  A.in_dim = in_dim;
  for (int l = 0; l < 4; ++l) A.h[l] = h[l];
  A.n_stages = n_stages;
  A.x_vec_ok = reinterpret_cast<uintptr_t>(x) % 16 == 0;
  // the ring first, then the input, the wide buffer (layers 0 and 2 write it)
  // and the narrow one (layer 1), then the small vectors and the barriers
  int vec = 0;
  for (int l = 0; l < 4; ++l) vec += cdiv(h[l], kStageN) * kStageN;
  vec += cdiv(h[3], kStageN) * kStageN;
  A.off_x = kStages * kStageBytes;
  A.off_a = A.off_x + cdiv(in_dim, kPanelK) * kPanelBytes;
  A.off_b = A.off_a + cdiv(max(h[0], h[2]), kPanelK) * kPanelBytes;
  A.off_vec = A.off_b + cdiv(h[1], kPanelK) * kPanelBytes;
  A.off_bar = A.off_vec + (vec * (int)sizeof(bf16) + 15) / 16 * 16;
  const size_t smem = (size_t)A.off_bar + (2 * kStages + 1) * 8 + 1024;  // 1024: alignment slack
  if ((err = set_smem((const void*)sdf_mlp_bf16_kernel, smem)) != cudaSuccess) return err;
  sdf_mlp_bf16_kernel<<<cdiv(n, kRows), kBf16Threads, smem, s>>>(A);
  return cudaGetLastError();
}
