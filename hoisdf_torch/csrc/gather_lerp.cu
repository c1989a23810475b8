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
//     On DecoderBig's pyramid (the ho3d preset, 3,968 channels) no level fits
//     (stride32 alone is 256 KB an image in bf16): every corner row comes
//     from L2 and a block takes at most 2 * kWarps points, so that the
//     blocks balance.
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
constexpr int kMaxSmem = 232448;        // a block's shared memory at most: 227 KB

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
// for the grid, which every caller detaches), accumulated in f32 and written
// in the maps' type.
//
// What bounds it on this card: contention, then bytes.  A point adds 4 x C
// weighted values; on the coarse levels (stride32 is 8 x 8 cells, stride16
// 16 x 16) all of an image's points land on a few cells, and f32 atomics into
// global memory to one address serialise in L2 (with atomics alone, three
// quarters of the time went to those two levels).  The compulsory bytes are
// g and the grid read once and d/dfeat written once.
//
// What the design does about it: one launch, two kinds of block, as the
// wrapper module's plan (bwd_plan) assigns the levels.
//   - Coarse levels (few cells per image) take the shared route: a block owns
//     one (image, level, slice of 16 channels).  Each group of 16 lanes keeps
//     a private copy of the slice's map in shared memory and adds a share of
//     the image's points into it, a lane per channel, with plain loads and
//     stores from g staged in shared memory: no atomics, and no
//     serialisation however the points crowd.  The copies are summed in a
//     fixed order and the slice is written once, in the maps' type, with
//     coalesced stores: no global atomics, no zero-fill, no cast, and these
//     levels are bitwise repeatable.  What sets this route's time is each
//     group's chain of dependent shared loads and stores, a point after the
//     other, and not its bytes.
//   - Fine levels keep the global route, where contention is low: a warp
//     takes a point, its lanes walk those levels' channels in 16-byte vectors
//     as the forward does, and each lane adds its four weighted vectors into
//     a zeroed f32 buffer with 16-byte vector atomics (four f32 adds each);
//     the wrapper casts the buffer.
// The order of the global route's adds changes from run to run, so its
// levels' d/dfeat is not bitwise repeatable.

struct BwdLevel {
  int h, w, c, c_off;
  int v_begin;      // global route: the level's first lane slot on its channel axis
  long long a_off;  // global route: the level's offset in the f32 buffer, in floats
  int slice;        // shared route: channels per block (0: the global route)
  int copies;       // shared route: groups of 16 lanes, each with its own copy of the slice
  void* out;        // shared route: d/dfeat [b, h, w, c] in the maps' type
};

struct BwdLevels {
  BwdLevel lv[kMaxLevels];  // every level
  BwdLevel gl[kMaxLevels];  // the global route's levels, in order
  int n, c_total, n_global, v_total;
  int global_blocks, out_bf16;  // blocks per image before the shared ones; d/dfeat's type
};

constexpr int kBwdThreads = 256;
constexpr int kBwdWarps = kBwdThreads / 32;

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

constexpr int kBwdChunk = 256;   // shared route: points tabulated and staged at a time
constexpr int kGroupLanes = 16;  // shared route: lanes of a group, one per channel of a slice
constexpr int kStagePerThread = kBwdChunk * kGroupLanes / kBwdThreads;  // g values staged
static_assert(kBwdChunk <= kBwdThreads, "a thread tabulates one point of a chunk");

// Shared memory of a shared-route block: one copy of the slice's map per
// group, then a chunk's slice of g (f32, 16 channels a point), its corner
// cells (int4) and weights (float4).  The copies take at most
// HOISDF_BWD_COPIES_BYTES, the budget that the wrapper's plan sizes them to
// (a macro from the build, so that the two agree).
#ifndef HOISDF_BWD_COPIES_BYTES
#error "build with -DHOISDF_BWD_COPIES_BYTES (hoisdf_torch/ops/kernels/build.py)"
#endif
constexpr int kBwdCopiesBytes = HOISDF_BWD_COPIES_BYTES;
__host__ __device__ constexpr int copies_bytes(int cells, int slice, int copies) {
  return (copies * cells * slice * 4 + 15) / 16 * 16;
}
__host__ __device__ constexpr int shared_bytes(int copy_bytes) {
  return copy_bytes + kBwdChunk * (kGroupLanes * 4 + 32);
}
static_assert(shared_bytes(kBwdCopiesBytes) <= kMaxSmem && kBwdCopiesBytes % 16 == 0,
              "a shared-route block must fit the card's 227 KB");

struct Corners {
  int i00, i01, i10, i11;  // cell indices
  float w00, w01, w10, w11;
};

__device__ __forceinline__ Corners corners(float gx, float gy, int h, int w) {
  const float wm1 = (float)(w - 1), hm1 = (float)(h - 1);
  const float x = fminf(fmaxf(__fmul_rn(__fmul_rn(__fadd_rn(gx, 1.f), 0.5f), wm1), 0.f), wm1);
  const float y = fminf(fmaxf(__fmul_rn(__fmul_rn(__fadd_rn(gy, 1.f), 0.5f), hm1), 0.f), hm1);
  const float x0f = floorf(x), y0f = floorf(y);
  const int x0 = (int)x0f, y0 = (int)y0f;
  const int x1 = min(x0 + 1, w - 1), y1 = min(y0 + 1, h - 1);
  const float wx = __fsub_rn(x, x0f), wy = __fsub_rn(y, y0f);
  const float ux = __fsub_rn(1.f, wx), uy = __fsub_rn(1.f, wy);
  return Corners{y0 * w + x0, y0 * w + x1, y1 * w + x0, y1 * w + x1,
                 __fmul_rn(ux, uy), __fmul_rn(wx, uy), __fmul_rn(ux, wy), __fmul_rn(wx, wy)};
}

// dst[i] += g[i] * w, i < VEC, by atomics in global memory: one 16-byte
// vector reduction (red.global.add.v4.f32, sm_90) per four channels where
// VEC allows it.
template <int VEC>
__device__ __forceinline__ void red_weighted(float* dst, const float (&g)[VEC], float w) {
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int i = 0; i < VEC; i += 4)
      atomicAdd(reinterpret_cast<float4*>(dst + i),
                make_float4(__fmul_rn(g[i], w), __fmul_rn(g[i + 1], w), __fmul_rn(g[i + 2], w),
                            __fmul_rn(g[i + 3], w)));
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) atomicAdd(dst + i, __fmul_rn(g[i], w));
  }
}

// Global route, block (i, b): points [i * kBwdWarps, (i + 1) * kBwdWarps) of
// image b, every global-route level.
template <typename T, int VEC>
__device__ __forceinline__ void bwd_global(const float* __restrict__ grid, const T* __restrict__ g,
                                           int p, const BwdLevels& L, float* __restrict__ acc) {
  __shared__ BwdLevel gl_s[kMaxLevels];  // L.gl, for lookup by lane
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, b = blockIdx.y;
  if (threadIdx.x < L.n_global) gl_s[threadIdx.x] = L.gl[threadIdx.x];
  __syncthreads();
  const int pt = blockIdx.x * kBwdWarps + warp;
  if (pt >= p) return;
  const size_t point = (size_t)b * p + pt;
  const float gx = grid[2 * point], gy = grid[2 * point + 1];
  const T* grow = g + point * L.c_total;
  for (int v = lane; v < L.v_total; v += 32) {
    int k = 0;
#pragma unroll
    for (int i = 1; i < kMaxLevels; ++i) k += (i < L.n_global && v >= L.gl[i].v_begin);
    const BwdLevel lv = gl_s[k];
    const Corners q = corners(gx, gy, lv.h, lv.w);
    const int c = (v - lv.v_begin) * VEC;
    const Vec<T, VEC> gv = *reinterpret_cast<const Vec<T, VEC>*>(grow + lv.c_off + c);
    float* base = acc + lv.a_off + (size_t)b * lv.h * lv.w * lv.c + c;
    float gf[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) gf[i] = to_f(gv.v[i]);
    red_weighted<VEC>(base + (size_t)q.i00 * lv.c, gf, q.w00);
    red_weighted<VEC>(base + (size_t)q.i01 * lv.c, gf, q.w01);
    red_weighted<VEC>(base + (size_t)q.i10 * lv.c, gf, q.w10);
    red_weighted<VEC>(base + (size_t)q.i11 * lv.c, gf, q.w11);
  }
}

// Shared route, block (global_blocks + j, b): the j-th (level, channel slice)
// of the shared-route levels, image b.  The block's threads form groups of 16
// lanes, a lane per channel of the slice; each of the level's first `copies`
// groups owns a private copy of the slice's map in shared memory and a
// contiguous share of every chunk of points.  Per chunk the whole block
// first tabulates each point's corners and weights and stages the slice of g
// in shared memory (loaded a chunk ahead); a group then adds its points in
// order with plain loads and stores.  A corner that repeats another (on the
// clamped border) has weight 0 and is left out, so the four cells a point
// touches are distinct.  The copies are summed in a fixed order and the slice
// is written once, so these levels are bitwise repeatable.
template <typename T>
__device__ __forceinline__ void bwd_shared(const float* __restrict__ grid, const T* __restrict__ g,
                                           int p, const BwdLevels& L, unsigned char* smem) {
  const int tid = threadIdx.x, group = tid / kGroupLanes, lane = tid % kGroupLanes;
  const int b = blockIdx.y;
  int j = blockIdx.x - L.global_blocks;
  BwdLevel lv = L.lv[0];
  bool found = false;
#pragma unroll
  for (int i = 0; i < kMaxLevels; ++i) {  // constant indices: L stays in parameter space
    if (found || i >= L.n || L.lv[i].slice == 0) continue;
    const int blocks = cdiv(L.lv[i].c, L.lv[i].slice);
    if (j < blocks) {
      lv = L.lv[i];
      found = true;
    } else {
      j -= blocks;
    }
  }
  const int s = lv.slice, c0 = j * s, width = min(s, lv.c - c0);
  const int cells = lv.h * lv.w, copy = cells * s;
  float* copies = reinterpret_cast<float*>(smem);
  float* g_s = reinterpret_cast<float*>(smem + copies_bytes(cells, s, lv.copies));
  int4* cell_t = reinterpret_cast<int4*>(g_s + kBwdChunk * kGroupLanes);
  float4* wt_t = reinterpret_cast<float4*>(cell_t + kBwdChunk);
  for (int i = tid; i < lv.copies * copy; i += kBwdThreads) copies[i] = 0.f;
  const T* gb = g + (size_t)b * p * L.c_total + lv.c_off + c0;
  float* acc = copies + group * copy + lane;
  // A chunk's loads (its points' grid coordinates, its slice of g) are issued
  // into registers one chunk ahead, so they are in flight while the groups
  // walk the chunk before.
  float gv[kStagePerThread], gx = 0.f, gy = 0.f;
  auto load_chunk = [&](int q0) {
    const int m = min(kBwdChunk, p - q0);
    if (tid < m) {
      gx = grid[2 * ((size_t)b * p + q0 + tid)];
      gy = grid[2 * ((size_t)b * p + q0 + tid) + 1];
    }
#pragma unroll
    for (int r = 0; r < kStagePerThread; ++r) {
      const int pt = (tid + r * kBwdThreads) / kGroupLanes;
      gv[r] = pt < m && lane < width ? to_f(gb[(size_t)(q0 + pt) * L.c_total + lane]) : 0.f;
    }
  };
  load_chunk(0);
  for (int p0 = 0; p0 < p; p0 += kBwdChunk) {
    const int n = min(kBwdChunk, p - p0);
    __syncthreads();  // the copies are zeroed; the previous chunk is used up
    if (tid < n) {
      const Corners q = corners(gx, gy, lv.h, lv.w);
      cell_t[tid] = make_int4(q.i00, q.i01 == q.i00 ? -1 : q.i01, q.i10 == q.i00 ? -1 : q.i10,
                              q.i11 == q.i01 || q.i11 == q.i10 ? -1 : q.i11);
      wt_t[tid] = make_float4(q.w00, q.w01, q.w10, q.w11);
    }
#pragma unroll
    for (int r = 0; r < kStagePerThread; ++r) g_s[tid + r * kBwdThreads] = gv[r];
    __syncthreads();
    if (p0 + kBwdChunk < p) load_chunk(p0 + kBwdChunk);
    if (group < lv.copies && lane < width) {
      const int end = (group + 1) * n / lv.copies;
      for (int i = group * n / lv.copies; i < end; ++i) {
        const int4 c = cell_t[i];
        const float4 w = wt_t[i];
        const float gi = g_s[i * kGroupLanes + lane];
        // the four cells are distinct: load all, then store all
        const float v0 = acc[c.x * s];
        const float v1 = c.y >= 0 ? acc[c.y * s] : 0.f;
        const float v2 = c.z >= 0 ? acc[c.z * s] : 0.f;
        const float v3 = c.w >= 0 ? acc[c.w * s] : 0.f;
        acc[c.x * s] = __fadd_rn(v0, __fmul_rn(gi, w.x));
        if (c.y >= 0) acc[c.y * s] = __fadd_rn(v1, __fmul_rn(gi, w.y));
        if (c.z >= 0) acc[c.z * s] = __fadd_rn(v2, __fmul_rn(gi, w.z));
        if (c.w >= 0) acc[c.w * s] = __fadd_rn(v3, __fmul_rn(gi, w.w));
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < cells * width; i += kBwdThreads) {
    const int cell = i / width, ch = i % width;
    float v = copies[cell * s + ch];
    for (int k = 1; k < lv.copies; ++k) v = __fadd_rn(v, copies[k * copy + cell * s + ch]);
    const size_t o = ((size_t)b * cells + cell) * lv.c + c0 + ch;
    if (L.out_bf16)
      static_cast<__nv_bfloat16*>(lv.out)[o] = __float2bfloat16_rn(v);
    else
      static_cast<float*>(lv.out)[o] = v;
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kBwdThreads)
gather_lerp_bwd_kernel(const float* __restrict__ grid, const T* __restrict__ g, int p,
                       const BwdLevels L, float* __restrict__ acc) {
  extern __shared__ __align__(16) unsigned char bwd_smem[];
  if ((int)blockIdx.x < L.global_blocks)
    bwd_global<T, VEC>(grid, g, p, L, acc);
  else
    bwd_shared<T>(grid, g, p, L, bwd_smem);
}

template <typename T>
cudaError_t launch_bwd(const float* grid, const void* g, int b, int p, BwdLevels L, float* acc,
                       cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  bool vec_ok = reinterpret_cast<uintptr_t>(g) % 16 == 0 && L.c_total % kVec == 0;
  for (int l = 0; l < L.n; ++l) vec_ok = vec_ok && L.lv[l].c % kVec == 0;
  const int vec = vec_ok ? kVec : 1;
  int v = 0, shared_blocks = 0, smem = 0;
  L.n_global = 0;
  for (int l = 0; l < L.n; ++l) {
    BwdLevel& lv = L.lv[l];
    if (lv.slice == 0) {
      lv.v_begin = v;
      v += lv.c / vec;
      L.gl[L.n_global++] = lv;
    } else {
      shared_blocks += cdiv(lv.c, lv.slice);
      smem = max(smem, shared_bytes(copies_bytes(lv.h * lv.w, lv.slice, lv.copies)));
    }
  }
  L.v_total = v;
  L.global_blocks = L.n_global > 0 ? cdiv(p, kBwdWarps) : 0;
  const dim3 blocks(L.global_blocks + shared_blocks, b);
  const T* gt = static_cast<const T*>(g);
  auto kern = vec_ok ? gather_lerp_bwd_kernel<T, kVec> : gather_lerp_bwd_kernel<T, 1>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kern<<<blocks, kBwdThreads, smem, stream>>>(grid, gt, p, L, acc);
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
// dims: n_levels x (h, w, c); plan: n_levels x (channels per block,
// copies per block) of the shared route, or (0, 0) for the global route (the
// wrapper module's bwd_plan).
// acc: the global-route levels' f32 maps [b, h, w, c] laid end to end, zeroed
// by the caller; the kernel adds their d/dfeat into it.  outs: per level, the
// shared route's d/dfeat [b, h, w, c] in out_dtype (0 = float32, 1 =
// bfloat16), written whole (not read; null on the global route).  Returns a
// cudaError_t.
extern "C" int gather_lerp_bwd_launch(const void* grid, const void* g, int b, int p,
                                      int n_levels, const int* dims, int g_dtype,
                                      const int* plan, void* acc, void* const* outs,
                                      int out_dtype, void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels) return cudaErrorInvalidValue;
  if (out_dtype != 0 && out_dtype != 1) return cudaErrorInvalidValue;
  if (b * p == 0) return cudaSuccess;
  if (b > 65535) return cudaErrorInvalidValue;  // images ride the grid's y axis
  BwdLevels L;
  L.n = n_levels;
  L.out_bf16 = out_dtype;
  int off = 0;
  long long a_off = 0;
  for (int l = 0; l < n_levels; ++l) {
    const int h = dims[3 * l], w = dims[3 * l + 1], c = dims[3 * l + 2];
    const int slice = plan[2 * l], copies = plan[2 * l + 1];
    if (slice < 0 || (slice > 0 && (slice > kGroupLanes || copies < 1 ||
                                    copies > kBwdThreads / kGroupLanes || outs[l] == nullptr ||
                                    copies_bytes(h * w, slice, copies) > kBwdCopiesBytes)))
      return cudaErrorInvalidValue;
    L.lv[l] = BwdLevel{h, w, c, off, 0, a_off, slice, copies, outs[l]};
    off += c;
    if (slice == 0) a_off += (long long)b * h * w * c;
  }
  L.c_total = off;
  const float* gr = static_cast<const float*>(grid);
  float* a = static_cast<float*>(acc);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (g_dtype == 0) return launch_bwd<float>(gr, g, b, p, L, a, s);
  if (g_dtype == 1) return launch_bwd<__nv_bfloat16>(gr, g, b, p, L, a, s);
  return cudaErrorInvalidValue;
}
