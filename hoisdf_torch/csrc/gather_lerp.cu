// Multi-level bilinear feature gather for Hopper (sm_90a).
//
// Forward and backward.  The forward replaces the TPU Pallas kernel
// hoisdf_tpu/ops/pallas/gather_lerp.py::
// fused_gather_lerp3 (body `_kernel`), widened from its three levels to the
// whole pyramid (up to five NHWC maps), so one launch serves
// multiscale_point_features.  For each point of grid[B, P, 2] in [-1, 1] and
// each level (H, W, C):
//   x = clip((gx + 1) / 2 * (W - 1), 0, W - 1), and the same for y
//   corners (y0, x0) (y0, x1) (y1, x0) (y1, x1), x1 = min(x0 + 1, W - 1)
//   lerp in x, then in y, in f32; levels concatenated along channels.
// Output: [B, P, sum C] in the maps' type.
//
// What bounds it on this card: memory.  The compulsory bytes are the output
// plus each map once, but a point pulls four corner rows, four times its
// output, through L1 and L2; three quarters of those bytes belong to the two
// coarsest levels, whose maps are small (64 KB and 128 KB per image in bf16 at
// the production pyramid).  And a warp that walks the levels one after the
// other waits out a load's latency at each, with most lanes idle on the narrow
// fine levels.
//
// What the design does about it:
//   - A block serves a run of consecutive points of one image, and an image's
//     points are split over just enough blocks to fill the card once.  The
//     coarse levels that fit are copied whole into shared memory, once per
//     block, by bulk copies that complete on an mbarrier (coarsest first, a
//     level only when the block's points would otherwise read more than the
//     map); their corner rows then come from shared memory, not from L2.
//   - A warp takes a point at a time and its lanes walk the concatenated
//     channel axis in 16-byte vectors (4 f32 or 8 bf16 channels), each lane
//     finding its level from a small table, so every lane has work in every
//     round, neighbouring lanes read neighbouring addresses of a corner row,
//     and the output row leaves in full 16-byte coalesced stores.
//   - Corner indices and weights are computed in the kernel from the grid (the
//     TPU's host-side precompute into SMEM was a Mosaic workaround).  The lerp
//     uses explicitly rounded f32 multiplies and adds (no FMA contraction), so
//     the result is bit-identical to the plain PyTorch version.  Maps whose
//     channel counts are not multiples of the vector width take the same
//     kernel with one channel per lane.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kMaxLevels = 5;
constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kCopyChunk = 32768;       // bytes per bulk copy
constexpr size_t kMaxStaged = 229376;   // shared memory for staged maps: 224 KB

struct Level {
  const void* ptr;
  int h, w, c, c_off;
  int v_begin;   // the level's first lane slot on the concatenated channel axis
  int staged;    // byte offset of the image's map in shared memory, or -1
};

struct Levels {
  Level lv[kMaxLevels];
  int n, c_total, v_total;
};

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Vec {
  T v[VEC];
};

__device__ __forceinline__ float lerp2(float a, float b, float w) {
  // a * (1 - w) + b * w, rounded at every step like the elementwise version
  return __fadd_rn(__fmul_rn(a, __fsub_rn(1.f, w)), __fmul_rn(b, w));
}

// Block (i, b) serves points [i * ppb, (i + 1) * ppb) of image b.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads, 1)
gather_lerp_kernel(const float* __restrict__ grid, int p, int ppb, const Levels L,
                   T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char staged_s[];
  __shared__ Level lv_s[kMaxLevels];       // L's levels, for lookup by lane
  __shared__ const T* base_s[kMaxLevels];  // image b's map: in shared memory or global
  __shared__ __align__(8) uint64_t bar_s;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int b = blockIdx.y;
  const uint32_t bar = smem_u32(&bar_s);

  int staged_bytes = 0;
  for (int l = 0; l < L.n; ++l)
    if (L.lv[l].staged >= 0) staged_bytes += L.lv[l].h * L.lv[l].w * L.lv[l].c * (int)sizeof(T);
  if (tid == 0 && staged_bytes > 0) {
    mbar_init(bar, 1);
    mbar_fence_init();
    mbar_expect_tx(bar, staged_bytes);
    for (int l = 0; l < L.n; ++l) {
      if (L.lv[l].staged < 0) continue;
      const int bytes = L.lv[l].h * L.lv[l].w * L.lv[l].c * (int)sizeof(T);
      const unsigned char* src = static_cast<const unsigned char*>(L.lv[l].ptr) + (size_t)b * bytes;
      for (int o = 0; o < bytes; o += kCopyChunk)
        bulk_copy(smem_u32(staged_s + L.lv[l].staged + o), src + o, min(kCopyChunk, bytes - o),
                  bar);
    }
  }
  if (tid < L.n) {
    const Level lv = L.lv[tid];
    lv_s[tid] = lv;
    base_s[tid] = lv.staged >= 0
                      ? reinterpret_cast<const T*>(staged_s + lv.staged)
                      : static_cast<const T*>(lv.ptr) + (size_t)b * lv.h * lv.w * lv.c;
  }
  __syncthreads();
  if (staged_bytes > 0) mbar_wait(bar, 0);

  const int p_end = min(p, (blockIdx.x + 1) * ppb);
  for (int pt = blockIdx.x * ppb + warp; pt < p_end; pt += kWarps) {
    const size_t point = (size_t)b * p + pt;
    const float gx = grid[2 * point], gy = grid[2 * point + 1];
    T* orow = out + point * L.c_total;
    for (int v = lane; v < L.v_total; v += 32) {
      int l = 0;
#pragma unroll
      for (int i = 1; i < kMaxLevels; ++i) l += (i < L.n && v >= L.lv[i].v_begin);
      const Level lv = lv_s[l];
      const float wm1 = (float)(lv.w - 1), hm1 = (float)(lv.h - 1);
      const float x = fminf(fmaxf(__fmul_rn(__fmul_rn(__fadd_rn(gx, 1.f), 0.5f), wm1), 0.f), wm1);
      const float y = fminf(fmaxf(__fmul_rn(__fmul_rn(__fadd_rn(gy, 1.f), 0.5f), hm1), 0.f), hm1);
      const float x0f = floorf(x), y0f = floorf(y);
      const int x0 = (int)x0f, y0 = (int)y0f;
      const int x1 = min(x0 + 1, lv.w - 1), y1 = min(y0 + 1, lv.h - 1);
      const float wx = __fsub_rn(x, x0f), wy = __fsub_rn(y, y0f);
      const int c = (v - lv.v_begin) * VEC;
      const T* base = base_s[l] + c;
      const Vec<T, VEC> f00 = *reinterpret_cast<const Vec<T, VEC>*>(base + (y0 * lv.w + x0) * lv.c);
      const Vec<T, VEC> f01 = *reinterpret_cast<const Vec<T, VEC>*>(base + (y0 * lv.w + x1) * lv.c);
      const Vec<T, VEC> f10 = *reinterpret_cast<const Vec<T, VEC>*>(base + (y1 * lv.w + x0) * lv.c);
      const Vec<T, VEC> f11 = *reinterpret_cast<const Vec<T, VEC>*>(base + (y1 * lv.w + x1) * lv.c);
      Vec<T, VEC> res;
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float top = lerp2(to_f(f00.v[i]), to_f(f01.v[i]), wx);
        const float bot = lerp2(to_f(f10.v[i]), to_f(f11.v[i]), wx);
        res.v[i] = from_f<T>(lerp2(top, bot, wy));
      }
      *reinterpret_cast<Vec<T, VEC>*>(orow + lv.c_off + c) = res;
    }
  }
}

// ---- backward --------------------------------------------------------------
//
// d/dfeat of the gather: for each point and level, the 4-corner scatter-add of
// g * weight, with the corners and weights of the forward (the JAX package's
// hand-written VJP hoisdf_tpu/ops/grid_sample.py::_gsb_fast_bwd; no gradient
// for the grid, which every caller detaches).  A warp takes a point; its lanes
// walk the concatenated channel axis of g in 16-byte vectors, as the forward
// does, and each lane adds its four weighted vectors into a zeroed f32 buffer
// with f32 atomics (red.global.add).  The wrapper casts the buffer to the
// maps' type.
//
// What bounds it on this card: the atomics, not the bytes.  A point issues
// 4 x C atomic adds; on the coarse levels (stride32 is 8 x 8 cells) every
// point of an image lands on the same few cells, so the adds to one address
// serialise in L2.  The order of the adds changes from run to run, so d/dfeat
// is not bitwise repeatable.  Accumulating a block's points in shared memory
// first is the next design.

struct BwdLevel {
  int h, w, c, c_off;
  int v_begin;      // the level's first lane slot on the concatenated channel axis
  long long a_off;  // the level's offset in the f32 buffer, in floats
};

struct BwdLevels {
  BwdLevel lv[kMaxLevels];
  int n, c_total, v_total;
};

constexpr int kBwdThreads = 256;
constexpr int kBwdWarps = kBwdThreads / 32;

// Block (i, b) serves points [i * kBwdWarps, (i + 1) * kBwdWarps) of image b.
template <typename T, int VEC>
__global__ void __launch_bounds__(kBwdThreads)
gather_lerp_bwd_kernel(const float* __restrict__ grid, const T* __restrict__ g, int p,
                       const BwdLevels L, float* __restrict__ acc) {
  __shared__ BwdLevel lv_s[kMaxLevels];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int b = blockIdx.y;
  if (tid < L.n) lv_s[tid] = L.lv[tid];
  __syncthreads();
  const int pt = blockIdx.x * kBwdWarps + warp;
  if (pt >= p) return;
  const size_t point = (size_t)b * p + pt;
  const float gx = grid[2 * point], gy = grid[2 * point + 1];
  const T* grow = g + point * L.c_total;
  for (int v = lane; v < L.v_total; v += 32) {
    int l = 0;
#pragma unroll
    for (int i = 1; i < kMaxLevels; ++i) l += (i < L.n && v >= L.lv[i].v_begin);
    const BwdLevel lv = lv_s[l];
    const float wm1 = (float)(lv.w - 1), hm1 = (float)(lv.h - 1);
    const float x = fminf(fmaxf(__fmul_rn(__fmul_rn(__fadd_rn(gx, 1.f), 0.5f), wm1), 0.f), wm1);
    const float y = fminf(fmaxf(__fmul_rn(__fmul_rn(__fadd_rn(gy, 1.f), 0.5f), hm1), 0.f), hm1);
    const float x0f = floorf(x), y0f = floorf(y);
    const int x0 = (int)x0f, y0 = (int)y0f;
    const int x1 = min(x0 + 1, lv.w - 1), y1 = min(y0 + 1, lv.h - 1);
    const float wx = __fsub_rn(x, x0f), wy = __fsub_rn(y, y0f);
    const float ux = __fsub_rn(1.f, wx), uy = __fsub_rn(1.f, wy);
    const float w00 = __fmul_rn(ux, uy), w01 = __fmul_rn(wx, uy);
    const float w10 = __fmul_rn(ux, wy), w11 = __fmul_rn(wx, wy);
    const int c = (v - lv.v_begin) * VEC;
    const Vec<T, VEC> gv = *reinterpret_cast<const Vec<T, VEC>*>(grow + lv.c_off + c);
    float* base = acc + lv.a_off + (size_t)b * lv.h * lv.w * lv.c + c;
    float* a00 = base + (size_t)(y0 * lv.w + x0) * lv.c;
    float* a01 = base + (size_t)(y0 * lv.w + x1) * lv.c;
    float* a10 = base + (size_t)(y1 * lv.w + x0) * lv.c;
    float* a11 = base + (size_t)(y1 * lv.w + x1) * lv.c;
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const float gi = to_f(gv.v[i]);
      atomicAdd(a00 + i, __fmul_rn(gi, w00));
      atomicAdd(a01 + i, __fmul_rn(gi, w01));
      atomicAdd(a10 + i, __fmul_rn(gi, w10));
      atomicAdd(a11 + i, __fmul_rn(gi, w11));
    }
  }
}

template <typename T>
cudaError_t launch_bwd(const float* grid, const void* g, int b, int p, BwdLevels L, float* acc,
                       cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  bool vec_ok = reinterpret_cast<uintptr_t>(g) % 16 == 0 && L.c_total % kVec == 0;
  for (int l = 0; l < L.n; ++l) vec_ok = vec_ok && L.lv[l].c % kVec == 0;
  const int vec = vec_ok ? kVec : 1;
  int v = 0;
  for (int l = 0; l < L.n; ++l) {
    L.lv[l].v_begin = v;
    v += L.lv[l].c / vec;
  }
  L.v_total = v;
  const dim3 blocks((p + kBwdWarps - 1) / kBwdWarps, b);
  const T* gt = static_cast<const T*>(g);
  if (vec_ok)
    gather_lerp_bwd_kernel<T, kVec><<<blocks, kBwdThreads, 0, stream>>>(grid, gt, p, L, acc);
  else
    gather_lerp_bwd_kernel<T, 1><<<blocks, kBwdThreads, 0, stream>>>(grid, gt, p, L, acc);
  return cudaGetLastError();
}

// SMs of the current device.  The attribute query costs tens of microseconds,
// as much as a small launch, so the answer is kept, per device.
cudaError_t sm_count(int* sms) {
  constexpr int kMaxDevices = 64;
  static int cached[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices)
    return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (cached[dev] == 0) {
    int n = 0;
    err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    cached[dev] = n;
  }
  *sms = cached[dev];
  return cudaSuccess;
}

template <typename T>
cudaError_t launch(const float* grid, int b, int p, Levels L, void* out, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  int sms = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  bool vec_ok = reinterpret_cast<uintptr_t>(out) % 16 == 0;
  for (int l = 0; l < L.n; ++l)
    vec_ok = vec_ok && L.lv[l].c % kVec == 0 &&
             reinterpret_cast<uintptr_t>(L.lv[l].ptr) % 16 == 0;
  const int vec = vec_ok ? kVec : 1;
  int v = 0;
  for (int l = 0; l < L.n; ++l) {
    L.lv[l].v_begin = v;
    v += L.lv[l].c / vec;
  }
  L.v_total = v;

  // One wave of blocks: each image's points over just enough blocks to give
  // every SM one.  Coarsest level first, a map is staged when it fits and the
  // block's points would otherwise read more than the map (4 corners each).
  const int blocks_per_image = (sms + b - 1) / b;
  int ppb = (p + blocks_per_image - 1) / blocks_per_image;
  size_t smem = 0;
  for (int l = L.n - 1; l >= 0; --l) {
    const size_t bytes = (size_t)L.lv[l].h * L.lv[l].w * L.lv[l].c * sizeof(T);
    if (bytes % 16 == 0 && reinterpret_cast<uintptr_t>(L.lv[l].ptr) % 16 == 0 &&
        smem + bytes <= kMaxStaged && 4 * (size_t)ppb >= (size_t)L.lv[l].h * L.lv[l].w) {
      L.lv[l].staged = (int)smem;
      smem += bytes;
    }
  }
  if (smem == 0) ppb = min(ppb, 2 * kWarps);  // nothing to share: smaller blocks balance better
  const dim3 blocks((p + ppb - 1) / ppb, b);
  T* o = static_cast<T*>(out);
  if (vec_ok) {
    auto kern = gather_lerp_kernel<T, kVec>;
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kMaxStaged);
    if (err != cudaSuccess) return err;
    kern<<<blocks, kThreads, smem, stream>>>(grid, p, ppb, L, o);
  } else {
    auto kern = gather_lerp_kernel<T, 1>;
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kMaxStaged);
    if (err != cudaSuccess) return err;
    kern<<<blocks, kThreads, smem, stream>>>(grid, p, ppb, L, o);
  }
  return cudaGetLastError();
}

}  // namespace

// grid: [b, p, 2] f32; ptrs: n_levels NHWC maps [b, h, w, c]; dims: n_levels x
// (h, w, c); out: [b, p, sum c].  dtype 0 = float32, 1 = bfloat16.  Returns a
// cudaError_t.
extern "C" int gather_lerp_launch(const void* grid, int b, int p, int n_levels,
                                  const void* const* ptrs, const int* dims,
                                  int dtype, void* out, void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels) return cudaErrorInvalidValue;
  if (b * p == 0) return cudaSuccess;
  if (b > 65535) return cudaErrorInvalidValue;  // images ride the grid's y axis
  Levels L;
  L.n = n_levels;
  int off = 0;
  for (int l = 0; l < n_levels; ++l) {
    L.lv[l] = Level{ptrs[l], dims[3 * l], dims[3 * l + 1], dims[3 * l + 2], off, 0, -1};
    off += dims[3 * l + 2];
  }
  L.c_total = off;
  const float* g = static_cast<const float*>(grid);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(g, b, p, L, out, s);
  if (dtype == 1) return launch<__nv_bfloat16>(g, b, p, L, out, s);
  return cudaErrorInvalidValue;
}

// grid: [b, p, 2] f32; g: [b, p, sum c] in g_dtype (0 = float32, 1 = bfloat16);
// dims: n_levels x (h, w, c); acc: the n_levels f32 maps [b, h, w, c] laid end
// to end, zeroed by the caller.  Adds d/dfeat into acc.  Returns a cudaError_t.
extern "C" int gather_lerp_bwd_launch(const void* grid, const void* g, int b, int p,
                                      int n_levels, const int* dims, int g_dtype, void* acc,
                                      void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels) return cudaErrorInvalidValue;
  if (b * p == 0) return cudaSuccess;
  if (b > 65535) return cudaErrorInvalidValue;  // images ride the grid's y axis
  BwdLevels L;
  L.n = n_levels;
  int off = 0;
  long long a_off = 0;
  for (int l = 0; l < n_levels; ++l) {
    const int h = dims[3 * l], w = dims[3 * l + 1], c = dims[3 * l + 2];
    L.lv[l] = BwdLevel{h, w, c, off, 0, a_off};
    off += c;
    a_off += (long long)b * h * w * c;
  }
  L.c_total = off;
  const float* gr = static_cast<const float*>(grid);
  float* a = static_cast<float*>(acc);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (g_dtype == 0) return launch_bwd<float>(gr, g, b, p, L, a, s);
  if (g_dtype == 1) return launch_bwd<__nv_bfloat16>(gr, g, b, p, L, a, s);
  return cudaErrorInvalidValue;
}
