// Fused eval-mode DeepSDF MLP for Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel hoisdf_tpu/ops/pallas/sdf_mlp.py::sdf_mlp_fused
// (body `_kernel`).  Per row of x[N, in]:
//   h = relu(x.W0 + b0); h = relu(h.W1 + b1); h = relu([h, x].W2 + b2);
//   h = relu(h.W3 + b3); out = tanh(h.W4 + b4)
// with f32 accumulation, activations recast to x's type between layers, and
// out[N] in f32.  Weights are [in, out] row-major in x's type.
//
// What bounds it on this card: arithmetic.  At the production dims
// (289 -> 512 -> 223 -> 512 -> 512 -> 1) a row costs 1.57 MFLOP against
// 578 bytes of input (bf16), so the work is compute bound by two orders of
// magnitude; the 1.6 MB weight set is re-read by every block and must come
// from L2, not HBM.
//
// What the design does about it: one block owns a tile of 64 (bf16) or 32
// (f32) rows and keeps the tile's input and both activation buffers in shared
// memory for all five layers, so activations never leave the SM (the TPU
// kernel's point too).  The weights (too big for one SM's 227 KB, unlike the
// TPU's VMEM) stream through shared memory in 32-row slices, layer by layer,
// and stay resident in the 50 MB L2 across blocks.  The skip concat is a
// second k-range of layer 2's product that reads the resident input tile;
// nothing is copied.  Ragged N is masked, not padded.
//   bf16 (serving): the four hidden layers run on the tensor cores with
//     mma.sync m16n8k16 (bf16 in, f32 accumulate); 8 warps each own 16 rows x
//     64 columns of a 128-column pass.  Each weight comes packed as W^T,
//     zero-padded (once per forward, by the wrapper module's
//     prepare_weights), so a 128 x 32 slice is a run of 16-byte cp.async copies,
//     streamed three slices ahead of the MMAs through a 4-buffer ring, and a
//     B fragment is two 32-bit shared loads.
//   f32 (parity runs): CUDA-core FMAs, a 2 x 4 register tile per thread, so
//     f32 stays f32 (the tensor cores would round it to TF32).
// The 512 -> 1 output layer is a warp-per-row dot product in both.  Not yet
// done: wgmma, TMA, more rows per block (the next steps).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
constexpr int kThreads = 256;

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

// ---- bf16: tensor cores (mma.sync) ---------------------------------------

constexpr int kBf16Rows = 64;  // 4 row groups of 16
constexpr int kMmaNT = 128;    // columns per pass: 2 column groups of 64
constexpr int kMmaKT = 32;     // k per staged slice
constexpr int kWtPitch = 40;   // bf16 per staged column: 32 + 8 keeps B loads conflict-free
constexpr int kStages = 4;     // weight slices in flight
constexpr int kSliceElems = kMmaNT * kWtPitch;

__device__ __forceinline__ int round16(int v) { return (v + 15) / 16 * 16; }
__device__ __forceinline__ int round32(int v) { return (v + 31) / 32 * 32; }

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// One k-range of a layer: activation [64, k] in shared memory (row pitch lda,
// columns k .. round16(k) zero) against packed weight columns woff .. woff + k.
struct Seg {
  const bf16* a;
  int lda, k, woff;
};

// out[64, round16(n)] = bf16(relu(sum over segments of a . W + bias)); the
// columns past n come out zero, ready to be the next layer's padded k-range.
// wt is the layer's weight packed by the wrapper: W^T zero-padded to
// [round128(n), ktot], each segment's k-range starting at a multiple of 32.
// Slices of 128 columns x 32 k stream through a ring of kStages shared
// buffers with cp.async, kStages - 1 slices ahead of the tensor cores.
__device__ void dense_relu_mma(Seg s0, Seg s1, const bf16* __restrict__ wt, int ktot,
                               const bf16* __restrict__ bias, int n, bf16* out, int ldo,
                               bf16* wt_s) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int rb = (warp & 3) * 16;   // this warp's rows
  const int cb = (warp >> 2) * 64;  // this warp's columns within a pass
  const int n_pad = round16(n);
  const int nk0 = round32(s0.k) / kMmaKT, nk1 = round32(s1.k) / kMmaKT;
  const int per_pass = nk0 + nk1;
  const int slices = (n_pad + kMmaNT - 1) / kMmaNT * per_pass;

  // Every call commits one cp.async group, empty past the last slice, so
  // that waiting for "all but kStages - 2 groups" always means slice sl.
  auto stage = [&](int sl) {
    if (sl < slices) {
      const int n0 = sl / per_pass * kMmaNT, r = sl % per_pass;
      const int kcol = r < nk0 ? s0.woff + r * kMmaKT : s1.woff + (r - nk0) * kMmaKT;
      bf16* dst = wt_s + (sl % kStages) * kSliceElems;
      for (int i = threadIdx.x; i < kMmaNT * (kMmaKT / 8); i += kThreads) {
        const int col = i >> 2, q = i & 3;
        cp_async16(dst + col * kWtPitch + 8 * q, wt + (size_t)(n0 + col) * ktot + kcol + 8 * q);
      }
    }
    cp_async_commit();
  };

  float acc[8][4] = {};
  for (int sl = 0; sl < kStages - 1; ++sl) stage(sl);
  for (int sl = 0; sl < slices; ++sl) {
    cp_async_wait<kStages - 2>();
    // slice sl has landed for every thread, and every thread is done with
    // slice sl - 1, whose buffer the next line refills
    __syncthreads();
    stage(sl + kStages - 1);
    const int n0 = sl / per_pass * kMmaNT, r = sl % per_pass;
    const Seg& s = r < nk0 ? s0 : s1;
    const int k0 = (r < nk0 ? r : r - nk0) * kMmaKT;
    const int steps = min(2, (round16(s.k) - k0) / 16);
    const uint32_t* w32 =
        reinterpret_cast<const uint32_t*>(wt_s + (sl % kStages) * kSliceElems);
    for (int ks = 0; ks < steps; ++ks) {
      const int kk = k0 + 16 * ks;
      const uint32_t* r0 = reinterpret_cast<const uint32_t*>(s.a + (rb + g) * s.lda + kk);
      const uint32_t* r1 = reinterpret_cast<const uint32_t*>(s.a + (rb + g + 8) * s.lda + kk);
      const uint32_t a[4] = {r0[t], r1[t], r0[t + 4], r1[t + 4]};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const uint32_t* col = w32 + (cb + 8 * j + g) * (kWtPitch / 2) + 8 * ks;
        const uint32_t b[2] = {col[t], col[t + 4]};
        mma_bf16(acc[j], a, b);
      }
    }
    if (r == per_pass - 1) {  // the pass is complete: bias, relu, bf16, store
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = n0 + cb + 8 * j + 2 * t;
        if (c < n_pad) {
          const float b0 = c < n ? __bfloat162float(bias[c]) : 0.f;
          const float b1 = c + 1 < n ? __bfloat162float(bias[c + 1]) : 0.f;
          *reinterpret_cast<__nv_bfloat162*>(out + (rb + g) * ldo + c) =
              __floats2bfloat162_rn(fmaxf(acc[j][0] + b0, 0.f), fmaxf(acc[j][1] + b1, 0.f));
          *reinterpret_cast<__nv_bfloat162*>(out + (rb + g + 8) * ldo + c) =
              __floats2bfloat162_rn(fmaxf(acc[j][2] + b0, 0.f), fmaxf(acc[j][3] + b1, 0.f));
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[j][q] = 0.f;
      }
    }
  }
  __syncthreads();  // the ring and this layer's output are complete
}

// ---- the kernels -------------------------------------------------------------

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<bf16>(bf16 v) { return __bfloat162float(v); }

// 512 -> 1 output layer: one warp per row, then tanh.
template <typename T>
__device__ void output_layer(const T* h, int ldh, int rows, int k, const T* __restrict__ w4,
                             const T* __restrict__ b4, int row0, int n_rows, float* out) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float bias4 = to_f(b4[0]);
  for (int r = warp; r < rows; r += kThreads / 32) {
    float s = 0.f;
    for (int kk = lane; kk < k; kk += 32) s = fmaf(to_f(h[r * ldh + kk]), to_f(w4[kk]), s);
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
  output_layer<float>(hb, ldh, kF32Rows, W.h[3], p(8), p(9), row0, n_rows, out);
}

__global__ void __launch_bounds__(kThreads)
sdf_mlp_bf16_kernel(const bf16* __restrict__ x, int n_rows, int in_dim, Weights W,
                    float* __restrict__ out, int ldx, int ldh) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* wt_s = reinterpret_cast<bf16*>(smem);  // the ring of weight slices
  bf16* x_s = wt_s + kStages * kSliceElems;
  bf16* ha = x_s + kBf16Rows * ldx;
  bf16* hb = ha + kBf16Rows * ldh;
  const int row0 = blockIdx.x * kBf16Rows;
  auto p = [&](int i) { return static_cast<const bf16*>(W.p[i]); };
  const int* h = W.h;

  const int in_pad = round16(in_dim);  // zero columns complete the last k-step
  for (int i = threadIdx.x; i < kBf16Rows * in_pad; i += kThreads) {
    const int r = i / in_pad, c = i % in_pad, g = row0 + r;
    x_s[r * ldx + c] = (g < n_rows && c < in_dim) ? x[(size_t)g * in_dim + c]
                                                  : __float2bfloat16_rn(0.f);
  }
  __syncthreads();
  const Seg none{nullptr, 0, 0, 0};
  dense_relu_mma(Seg{x_s, ldx, in_dim, 0}, none, p(0), round32(in_dim), p(1), h[0], ha,
                 ldh, wt_s);
  dense_relu_mma(Seg{ha, ldh, h[0], 0}, none, p(2), round32(h[0]), p(3), h[1], hb, ldh,
                 wt_s);
  dense_relu_mma(Seg{hb, ldh, h[1], 0}, Seg{x_s, ldx, in_dim, round32(h[1])}, p(4),
                 round32(h[1]) + round32(in_dim), p(5), h[2], ha, ldh, wt_s);
  dense_relu_mma(Seg{ha, ldh, h[2], 0}, none, p(6), round32(h[2]), p(7), h[3], hb, ldh,
                 wt_s);
  output_layer<bf16>(hb, ldh, kBf16Rows, h[3], p(8), p(9), row0, n_rows, out);
}

cudaError_t set_smem(const void* kern, size_t smem) {
  if (smem > 232448) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace

// x: [n, in_dim]; w: the ten pointers w0, b0, ..., w4, b4; h: the four hidden
// widths.  dtype 0 = float32: w0..w3 are [in, out].  dtype 1 = bfloat16: w0..w3
// are packed as the wrapper module's _pack_bf16 does (W^T zero-padded to
// [round128(out), sum of round32(k) over the layer's k-ranges]).  Returns a
// cudaError_t.
extern "C" int sdf_mlp_launch(const void* x, int dtype, int n, int in_dim,
                              const void* const* w, const int* h, void* out,
                              void* stream) {
  Weights W;
  for (int i = 0; i < 10; ++i) W.p[i] = w[i];
  for (int i = 0; i < 4; ++i) W.h[i] = h[i];
  const int hmax = max(max(h[0], h[1]), max(h[2], h[3]));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    // odd row pitches: the two rows a warp reads at once sit in other banks
    const int ldx = in_dim | 1, ldh = hmax | 1;
    const size_t smem = sizeof(float) * (kKT * kNT + (size_t)kF32Rows * (ldx + 2 * ldh));
    if ((err = set_smem((const void*)sdf_mlp_f32_kernel, smem)) != cudaSuccess) return err;
    sdf_mlp_f32_kernel<<<(n + kF32Rows - 1) / kF32Rows, kThreads, smem, s>>>(
        static_cast<const float*>(x), n, in_dim, W, static_cast<float*>(out), ldx, ldh);
  } else if (dtype == 1) {
    // pitch = 8 mod 16 elements: the 8 rows of an A fragment hit 8 bank groups
    const int ldx = (in_dim + 15) / 16 * 16 + 8, ldh = (hmax + 15) / 16 * 16 + 8;
    const size_t smem = sizeof(bf16) * (kStages * kSliceElems + (size_t)kBf16Rows * (ldx + 2 * ldh));
    if ((err = set_smem((const void*)sdf_mlp_bf16_kernel, smem)) != cudaSuccess) return err;
    sdf_mlp_bf16_kernel<<<(n + kBf16Rows - 1) / kBf16Rows, kThreads, smem, s>>>(
        static_cast<const bf16*>(x), n, in_dim, W, static_cast<float*>(out), ldx, ldh);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
