// Analytic MANO inverse kinematics, the solve between the two MANO forwards,
// for Hopper (sm_90a).
//
// The counterpart of ops/kernels/ik.py::ik_solve_plain (hoisdf_tpu/ops/ik.py,
// the original's common/utils/inverse_kinematics.py:15-150).  Per frame, from
// the root-relative target joints X [21, 3] and the template joints T
// [21, 3] (MANO at zero pose and the frame's shape), both in metres:
//   - Kabsch: h = A B^T of the five knuckle directions (A the template's, B
//     the target's, joint k minus the root, k in 1, 5, 9, 13, 17), its SVD
//     h = U S V^T, the global rotation R = V U^T, and the frame's flag:
//     0 where det R < 0 (a reflection), whose pose stays zero (the sign, as
//     the plain version tests it: the original's |det R + 1| > 1e-6 sits
//     inside f32 rounding);
//   - R to axis-angle with ops/rotations.py::mat2aa's conventions (the
//     branch-free Shepperd quaternion, then quat2aa; NaN lanes to 0);
//   - each finger's chain of three bones: the bone's template direction and
//     its target direction in the parent's frame give an axis (their cross
//     product, normalised with + 1e-7) and an angle (arccos of their
//     clamped cosine); the bone's Rodrigues matrix (batch_rodrigues'
//     quaternion map) turns the next bone's frame.
// Output: the axis-angle pose [48] (root, then the fingers' bones in the
// order of FINGER_LIST) and the flag.
//
// What the port's plain path did about it on the card, and why a kernel: its
// torch.linalg.svd checks LAPACK's `info` on the host, so the eval step
// synchronised with the card there and could not be enqueued ahead of it;
// and the solve is hundreds of tiny launches a step.  Here one launch solves
// every frame and nothing returns to the host.
//
// The design:
//   - One warp per frame, four frames a block.  The warp stages the frame's
//     two joint sets (126 floats) in shared memory in one coalesced pass.
//   - The SVD is a one-sided (Hestenes) Jacobi SVD of h with a fixed number
//     of sweeps: each rotation orthogonalises a pair of h's columns and
//     accumulates into V, so h V = U S column by column.  It works on h
//     itself, not on h^T h, so it keeps the small singular value's sign and
//     accuracy.  U's columns are the two largest columns normalised and the
//     third their cross product, signed like the third column: that keeps
//     det U = sign(det h) even where h is nearly singular, as an exact SVD
//     has it.  There is no convergence test and no `info`: six sweeps take a
//     3 x 3 matrix to f32 round-off.
//   - Every lane computes the SVD (the same values, no divergence, no
//     broadcast); then lanes 0-4 each solve one finger's chain, which depends
//     only on R, and lane 5 converts R and writes the flag.
//   - Full f32: no fast-math intrinsics, IEEE division and square roots.

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>

namespace {

constexpr int kWarps = 4;  // frames a block
constexpr int kJoints = 21;
constexpr int kSweeps = 6;
// the first joint of each finger's chain in FINGER_LIST's order; the chain is
// (root, base, base + 1, base + 2, base + 3)
__device__ __forceinline__ int finger_base(int g) {
  return g == 0 ? 5 : g == 1 ? 9 : g == 2 ? 17 : g == 3 ? 13 : 1;
}

__device__ __forceinline__ float dot3(const float* a, const float* b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

__device__ __forceinline__ void cross3(const float* a, const float* b, float* c) {
  c[0] = a[1] * b[2] - a[2] * b[1];
  c[1] = a[2] * b[0] - a[0] * b[2];
  c[2] = a[0] * b[1] - a[1] * b[0];
}

// h V = W column by column; -> R = V U^T.
__device__ void kabsch_rotation(const float h[3][3], float rot[3][3]) {
  float w[3][3], v[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      w[i][j] = h[i][j];
      v[i][j] = i == j ? 1.f : 0.f;
    }
  for (int sweep = 0; sweep < kSweeps; ++sweep) {
#pragma unroll
    for (int pair = 0; pair < 3; ++pair) {
      const int p = pair == 2 ? 1 : 0, q = pair == 0 ? 1 : 2;
      float a = 0.f, b = 0.f, g = 0.f;
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        a += w[i][p] * w[i][p];
        b += w[i][q] * w[i][q];
        g += w[i][p] * w[i][q];
      }
      if (g == 0.f) continue;
      const float zeta = (b - a) / (2.f * g);
      const float t = copysignf(1.f, zeta) / (fabsf(zeta) + sqrtf(1.f + zeta * zeta));
      const float c = 1.f / sqrtf(1.f + t * t);
      const float s = c * t;
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const float wp = w[i][p], wq = w[i][q];
        w[i][p] = c * wp - s * wq;
        w[i][q] = s * wp + c * wq;
        const float vp = v[i][p], vq = v[i][q];
        v[i][p] = c * vp - s * vq;
        v[i][q] = s * vp + c * vq;
      }
    }
  }
  float n[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) n[k] = sqrtf(w[0][k] * w[0][k] + w[1][k] * w[1][k] + w[2][k] * w[2][k]);
  // the smallest column (the first of equals) takes the cross product
  const int k3 = (n[0] <= n[1] && n[0] <= n[2]) ? 0 : (n[1] <= n[2] ? 1 : 2);
  const int k1 = k3 == 0 ? 1 : 0, k2 = k3 == 2 ? 1 : 2;
  float u1[3], u2[3], u3[3], w3[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    u1[i] = w[i][k1] / n[k1];
    u2[i] = w[i][k2] / n[k2];
    w3[i] = w[i][k3];
  }
  cross3(u1, u2, u3);
  const float sg = dot3(w3, u3) < 0.f ? -1.f : 1.f;
#pragma unroll
  for (int i = 0; i < 3; ++i) u3[i] *= sg;
  // R = V U^T = sum_k v_k u_k^T
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      rot[i][j] = v[i][k1] * u1[j] + v[i][k2] * u2[j] + v[i][k3] * u3[j];
}

__device__ __forceinline__ float nan_to_num(float x) {
  if (x != x) return 0.f;
  if (isinf(x)) return copysignf(FLT_MAX, x);
  return x;
}

// ops/rotations.py::mat2aa: mat2quat (r = R^T, Shepperd's four cases chosen
// by r22 < 1e-6, r00 > r11 and r00 < -r11), then quat2aa.
__device__ void mat2aa(const float R[3][3], float aa[3]) {
  float r[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) r[i][j] = R[j][i];
  float t, q[4];
  if (r[2][2] < 1e-6f) {
    if (r[0][0] > r[1][1]) {
      t = 1.f + r[0][0] - r[1][1] - r[2][2];
      q[0] = r[1][2] - r[2][1]; q[1] = t; q[2] = r[0][1] + r[1][0]; q[3] = r[2][0] + r[0][2];
    } else {
      t = 1.f - r[0][0] + r[1][1] - r[2][2];
      q[0] = r[2][0] - r[0][2]; q[1] = r[0][1] + r[1][0]; q[2] = t; q[3] = r[1][2] + r[2][1];
    }
  } else {
    if (r[0][0] < -r[1][1]) {
      t = 1.f - r[0][0] - r[1][1] + r[2][2];
      q[0] = r[0][1] - r[1][0]; q[1] = r[2][0] + r[0][2]; q[2] = r[1][2] + r[2][1]; q[3] = t;
    } else {
      t = 1.f + r[0][0] + r[1][1] + r[2][2];
      q[0] = t; q[1] = r[1][2] - r[2][1]; q[2] = r[2][0] - r[0][2]; q[3] = r[0][1] - r[1][0];
    }
  }
  const float den = sqrtf(t);
#pragma unroll
  for (int k = 0; k < 4; ++k) q[k] = q[k] / den * 0.5f;
  const float sin_sq = q[1] * q[1] + q[2] * q[2] + q[3] * q[3];
  const float sin_t = sqrtf(sin_sq);
  const float cos_t = q[0];
  const float two_theta = 2.f * (cos_t < 0.f ? atan2f(-sin_t, -cos_t) : atan2f(sin_t, cos_t));
  const float k = sin_sq > 0.f ? two_theta / (sin_t > 0.f ? sin_t : 1.f) : 2.f;
#pragma unroll
  for (int i = 0; i < 3; ++i) aa[i] = nan_to_num(q[i + 1] * k);
}

// ops/rotations.py::batch_rodrigues: norm(theta + 1e-8), the half-angle
// quaternion, normalised, to a matrix.
__device__ void rodrigues(const float th[3], float m[3][3]) {
  const float e0 = th[0] + 1e-8f, e1 = th[1] + 1e-8f, e2 = th[2] + 1e-8f;
  const float angle = sqrtf(e0 * e0 + e1 * e1 + e2 * e2);
  const float half = angle * 0.5f;
  const float sh = sinf(half);
  float q[4] = {cosf(half), sh * (th[0] / angle), sh * (th[1] / angle), sh * (th[2] / angle)};
  const float qn = sqrtf(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]);
#pragma unroll
  for (int k = 0; k < 4; ++k) q[k] = q[k] / qn;
  const float w = q[0], x = q[1], y = q[2], z = q[3];
  const float w2 = w * w, x2 = x * x, y2 = y * y, z2 = z * z;
  const float wx = w * x, wy = w * y, wz = w * z, xy = x * y, xz = x * z, yz = y * z;
  m[0][0] = w2 + x2 - y2 - z2; m[0][1] = 2.f * xy - 2.f * wz; m[0][2] = 2.f * wy + 2.f * xz;
  m[1][0] = 2.f * wz + 2.f * xy; m[1][1] = w2 - x2 + y2 - z2; m[1][2] = 2.f * yz - 2.f * wx;
  m[2][0] = 2.f * xz - 2.f * wy; m[2][1] = 2.f * wx + 2.f * yz; m[2][2] = w2 - x2 - y2 + z2;
}

// One finger's three bones; writes its nine pose values (zero for a
// reflected frame).
__device__ void finger_chain(const float* X, const float* T, const float rot[3][3], int g,
                             bool ok, float* pose) {
  const int base = finger_base(g);
  int chain[5] = {0, base, base + 1, base + 2, base + 3};
  float rpa[3][3], recon[3] = {0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) rpa[i][j] = rot[i][j];
#pragma unroll
  for (int j = 2; j < 5; ++j) {
    const float* t0 = T + 3 * chain[j - 2];
    const float* t1 = T + 3 * chain[j - 1];
    const float* t2 = T + 3 * chain[j];
    const float* x2 = X + 3 * chain[j];
    float vt[3], bone[3], d[3], vx[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      vt[i] = t2[i] - t1[i];
      bone[i] = t1[i] - t0[i];
    }
#pragma unroll
    for (int i = 0; i < 3; ++i)
      recon[i] = (rpa[i][0] * bone[0] + rpa[i][1] * bone[1] + rpa[i][2] * bone[2]) + recon[i];
#pragma unroll
    for (int i = 0; i < 3; ++i) d[i] = x2[i] - recon[i];
#pragma unroll
    for (int i = 0; i < 3; ++i) vx[i] = rpa[0][i] * d[0] + rpa[1][i] * d[1] + rpa[2][i] * d[2];
    float axis[3];
    cross3(vt, vx, axis);
    const float an = sqrtf(dot3(axis, axis)) + 1e-7f;
#pragma unroll
    for (int i = 0; i < 3; ++i) axis[i] = axis[i] / an;
    float cosang = dot3(vt, vx) / (sqrtf(dot3(vt, vt)) + 1e-7f) / (sqrtf(dot3(vx, vx)) + 1e-7f);
    cosang = fminf(fmaxf(cosang, -1.f + 1e-7f), 1.f - 1e-7f);
    const float angle = acosf(cosang);
    float aa[3] = {angle * axis[0], angle * axis[1], angle * axis[2]};
    float* out = pose + 3 * (g * 3 + j - 1);
#pragma unroll
    for (int i = 0; i < 3; ++i) out[i] = ok ? aa[i] : 0.f;
    if (j < 4) {  // the next bone's parent frame: rpa @ rodrigues(aa)
      float m[3][3], nxt[3][3];
      rodrigues(aa, m);
#pragma unroll
      for (int r = 0; r < 3; ++r)
#pragma unroll
        for (int c = 0; c < 3; ++c)
          nxt[r][c] = rpa[r][0] * m[0][c] + rpa[r][1] * m[1][c] + rpa[r][2] * m[2][c];
#pragma unroll
      for (int r = 0; r < 3; ++r)
#pragma unroll
        for (int c = 0; c < 3; ++c) rpa[r][c] = nxt[r][c];
    }
  }
}

__global__ void __launch_bounds__(kWarps * 32)
ik_solve_kernel(const float* __restrict__ target, const float* __restrict__ tmpl, int b,
                float* __restrict__ pose, int* __restrict__ valid) {
  __shared__ float xs[kWarps][kJoints * 3];
  __shared__ float ts[kWarps][kJoints * 3];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int f = blockIdx.x * kWarps + warp;
  if (f >= b) return;  // the whole warp leaves together
  const long long off = (long long)f * kJoints * 3;
  for (int i = lane; i < kJoints * 3; i += 32) {
    xs[warp][i] = target[off + i];
    ts[warp][i] = tmpl[off + i];
  }
  __syncwarp();
  const float* X = xs[warp];
  const float* T = ts[warp];

  float h[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < 5; ++k) {
        const int kn = 4 * k + 1;  // 1, 5, 9, 13, 17
        acc += (T[3 * kn + i] - T[i]) * (X[3 * kn + j] - X[j]);
      }
      h[i][j] = acc;
    }
  float rot[3][3];
  kabsch_rotation(h, rot);
  const float det = rot[0][0] * (rot[1][1] * rot[2][2] - rot[1][2] * rot[2][1])
                  - rot[0][1] * (rot[1][0] * rot[2][2] - rot[1][2] * rot[2][0])
                  + rot[0][2] * (rot[1][0] * rot[2][1] - rot[1][1] * rot[2][0]);
  const bool ok = det > 0.f;
  float* out = pose + (long long)f * 48;
  if (lane < 5) {
    finger_chain(X, T, rot, lane, ok, out);
  } else if (lane == 5) {
    float aa[3];
    mat2aa(rot, aa);
#pragma unroll
    for (int i = 0; i < 3; ++i) out[i] = ok ? aa[i] : 0.f;
    valid[f] = ok ? 1 : 0;
  }
}

}  // namespace

// target, tmpl: [b, 21, 3] f32 (root-relative target joints; template joints);
// pose: [b, 48] f32 out; valid: [b] i32 out.  Returns a cudaError_t.
extern "C" int ik_solve_launch(const void* target, const void* tmpl, int b, void* pose,
                               void* valid, void* stream) {
  if (b < 0) return cudaErrorInvalidValue;
  if (b == 0) return cudaSuccess;
  const int blocks = (b + kWarps - 1) / kWarps;
  ik_solve_kernel<<<blocks, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(target), static_cast<const float*>(tmpl), b,
      static_cast<float*>(pose), static_cast<int*>(valid));
  return cudaGetLastError();
}
