// Multi-level bilinear feature gather for Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel hoisdf_tpu/ops/pallas/gather_lerp.py::
// fused_gather_lerp3 (body `_kernel`), widened from its three levels to the
// whole pyramid (up to five NHWC maps), so one launch serves
// multiscale_point_features.  For each point of grid[B, P, 2] in [-1, 1] and
// each level (H, W, C):
//   x = clip((gx + 1) / 2 * (W - 1), 0, W - 1), and the same for y
//   corners (y0, x0) (y0, x1) (y1, x0) (y1, x1), x1 = min(x0 + 1, W - 1)
//   lerp in x, then in y, in f32; levels concatenated along channels.
// Output: [B, P, sum C] in the maps' type.
//
// What bounds it on this card: memory.  A point reads 4 x sum(C) map values
// and writes sum(C); there is no arithmetic to speak of.  The compulsory
// bytes are the output plus each map once; the four-corner reads come mostly
// from L2, since the production pyramid (44.7 MB at batch 22 in bf16) is about
// the size of the 50 MB L2.
//
// What the design does about it: one warp per point; its lanes walk the
// concatenated channel axis in 16-byte vectors (4 f32 or 8 bf16 channels), so
// neighbouring lanes read neighbouring addresses of a corner's channel row and
// write neighbouring addresses of the output row.  Corner indices and weights
// are computed in the kernel from the grid (the TPU's host-side precompute
// into SMEM was a Mosaic workaround).  The lerp uses explicitly rounded f32
// multiplies and adds (no FMA contraction), so the result is bit-identical to
// the plain PyTorch version.  Maps whose channel counts are not multiples of
// the vector width take a scalar path.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 5;
constexpr int kThreads = 256;  // 8 points per block

struct Level {
  const void* ptr;
  int h, w, c, c_off;
};

struct Levels {
  Level lv[kMaxLevels];
  int n;
  int c_total;
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

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
gather_lerp_kernel(const float* __restrict__ grid, int n_points, int p, Levels L,
                   T* __restrict__ out) {
  const int point = blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (point >= n_points) return;
  const int b = point / p;
  const float gx = grid[2 * point], gy = grid[2 * point + 1];
  T* orow = out + (size_t)point * L.c_total;

  for (int l = 0; l < L.n; ++l) {
    const Level lv = L.lv[l];
    const float wm1 = (float)(lv.w - 1), hm1 = (float)(lv.h - 1);
    const float x = fminf(fmaxf(__fmul_rn(__fmul_rn(__fadd_rn(gx, 1.f), 0.5f), wm1), 0.f), wm1);
    const float y = fminf(fmaxf(__fmul_rn(__fmul_rn(__fadd_rn(gy, 1.f), 0.5f), hm1), 0.f), hm1);
    const float x0f = floorf(x), y0f = floorf(y);
    const int x0 = (int)x0f, y0 = (int)y0f;
    const int x1 = min(x0 + 1, lv.w - 1), y1 = min(y0 + 1, lv.h - 1);
    const float wx = __fsub_rn(x, x0f), wy = __fsub_rn(y, y0f);
    const T* base = static_cast<const T*>(lv.ptr) + (size_t)b * lv.h * lv.w * lv.c;
    const T* r00 = base + ((size_t)y0 * lv.w + x0) * lv.c;
    const T* r01 = base + ((size_t)y0 * lv.w + x1) * lv.c;
    const T* r10 = base + ((size_t)y1 * lv.w + x0) * lv.c;
    const T* r11 = base + ((size_t)y1 * lv.w + x1) * lv.c;
    T* o = orow + lv.c_off;
    for (int c = lane * VEC; c < lv.c; c += 32 * VEC) {
      const Vec<T, VEC> f00 = *reinterpret_cast<const Vec<T, VEC>*>(r00 + c);
      const Vec<T, VEC> f01 = *reinterpret_cast<const Vec<T, VEC>*>(r01 + c);
      const Vec<T, VEC> f10 = *reinterpret_cast<const Vec<T, VEC>*>(r10 + c);
      const Vec<T, VEC> f11 = *reinterpret_cast<const Vec<T, VEC>*>(r11 + c);
      Vec<T, VEC> res;
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float top = lerp2(to_f(f00.v[i]), to_f(f01.v[i]), wx);
        const float bot = lerp2(to_f(f10.v[i]), to_f(f11.v[i]), wx);
        res.v[i] = from_f<T>(lerp2(top, bot, wy));
      }
      *reinterpret_cast<Vec<T, VEC>*>(o + c) = res;
    }
  }
}

template <typename T>
cudaError_t launch(const float* grid, int b, int p, const Levels& L, void* out,
                   cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  bool vec_ok = reinterpret_cast<uintptr_t>(out) % 16 == 0;
  for (int l = 0; l < L.n; ++l)
    vec_ok = vec_ok && L.lv[l].c % kVec == 0 &&
             reinterpret_cast<uintptr_t>(L.lv[l].ptr) % 16 == 0;
  const int n_points = b * p;
  const int blocks = (n_points + kThreads / 32 - 1) / (kThreads / 32);
  T* o = static_cast<T*>(out);
  if (vec_ok)
    gather_lerp_kernel<T, kVec><<<blocks, kThreads, 0, stream>>>(grid, n_points, p, L, o);
  else
    gather_lerp_kernel<T, 1><<<blocks, kThreads, 0, stream>>>(grid, n_points, p, L, o);
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
  Levels L;
  L.n = n_levels;
  int off = 0;
  for (int l = 0; l < n_levels; ++l) {
    L.lv[l] = Level{ptrs[l], dims[3 * l], dims[3 * l + 1], dims[3 * l + 2], off};
    off += dims[3 * l + 2];
  }
  L.c_total = off;
  const float* g = static_cast<const float*>(grid);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(g, b, p, L, out, s);
  if (dtype == 1) return launch<__nv_bfloat16>(g, b, p, L, out, s);
  return cudaErrorInvalidValue;
}
