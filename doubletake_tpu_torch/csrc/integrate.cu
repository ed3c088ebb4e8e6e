// One TSDF fusion step, in place, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel doubletake_tpu/ops/pallas/integrate.py
// (fused_integrate / _kernel / _row_group / _sample_tile). Per voxel: project
// its corner with P = K @ cam_T_world, take the nearest depth pixel at
// rint(p - 0.5) (half to even), weight it by the InfiniTAM confidence
// clip(1 - (d - min)/(max - min), 0.25, 1)^2, clamp the TSDF to the
// truncation band, and update the running weighted mean (weights clamped to
// 1) exactly as doubletake_tpu/tools/tsdf.py _voxel_update does. Invalid
// voxels (outside the image or the depth range, behind the band, NaN depth)
// are not written at all, which is the same as writing their old values.
//
// What bounds it on this card: bytes, counted for the voxels a frame
// updates (16 B each: value and weight read and written) plus the depth
// image; on the synthetic room that is 2.84 M of 9.24 M voxels, ~14 us at
// 3.35 TB/s. So the kernel works where the camera sees:
//   * a warp owns a box of 8 x 1 x 32 voxels (x, y, z; z the fastest axis,
//     so loads and stores coalesce; a block is 8 warps at 8 y rows) and
//     first decides from the box's 8 corners whether any of its voxels can
//     update (block_culled). A box is skipped when every
//     corner lies at or beyond max_depth, or when every corner lies in
//     front of the camera and the corners' projections, widened by 2
//     pixels, miss the image. zc and the projection are affine in the voxel
//     coordinates and the projection of a box in front of the camera lies
//     inside the hull of its corners' projections; the corners are taken
//     with a margin of 1e-5 of each sum's magnitude (~80 ulps) on either
//     side, so rounding in the per-voxel arithmetic cannot carry a voxel
//     out of the bound. Any corner at zc <= 0, and any NaN, keeps the box.
//   * inside a kept box a voxel stops as soon as it fails a test (zc out of
//     (0, max_depth), outside the image, no positive depth), before the
//     divisions it would not need; the result is the same;
//   * index math is 32-bit from a 3-D grid: no 64-bit division or modulo.
//
// Every product, sum and quotient of the voxel update is rounded on its own
// (__fmul_rn, __fadd_rn, __fdiv_rn, and -fmad=false at build time): the
// plain torch version (ops/integrate.py integrate_plain) runs the same
// operations in the same order, so the two agree bit for bit, including the
// rint ties that an fma would flip. Culled voxels are exactly the ones the
// plain version leaves as they were.
//
// Not carried over from the TPU kernel: the one-hot depth-sampling matmuls,
// the bf16 hi/lo split of the depth image, the 32-lane z sub-tiles, the
// host-side band flags and the scalar-prefetch block-sparse grid. A Hopper
// thread reads its depth pixel directly.

#include <cuda_runtime.h>

namespace {

constexpr int BZ = 32, BY = 8, BX = 8;   // a block: BX x BY x BZ voxels; a warp: BX x 1 x BZ
constexpr float CULL_REL = 1e-5f;        // corner margin, relative to the sums' magnitude
constexpr float CULL_PIX = 2.f;          // image widening, pixels

struct Proj {
  float cam0, cam1, zc;
};

__device__ __forceinline__ Proj project(const float* __restrict__ P,
                                        const float* __restrict__ origin, int i, int j, int k,
                                        float voxel_size, float& cx, float& cy, float& cz) {
  cx = __fadd_rn(origin[0], __fmul_rn(float(i), voxel_size));
  cy = __fadd_rn(origin[1], __fmul_rn(float(j), voxel_size));
  cz = __fadd_rn(origin[2], __fmul_rn(float(k), voxel_size));
  Proj p;
  p.cam0 = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(P[0], cx), __fmul_rn(P[1], cy)),
                               __fmul_rn(P[2], cz)), P[3]);
  p.cam1 = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(P[4], cx), __fmul_rn(P[5], cy)),
                               __fmul_rn(P[6], cz)), P[7]);
  p.zc = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(P[8], cx), __fmul_rn(P[9], cy)),
                             __fmul_rn(P[10], cz)), P[11]);
  return p;
}

__device__ __forceinline__ float magnitude(const float* __restrict__ Pr, float cx, float cy,
                                           float cz) {
  return fabsf(Pr[0] * cx) + fabsf(Pr[1] * cy) + fabsf(Pr[2] * cz) + fabsf(Pr[3]);
}

// Whether no voxel of the box [i0, i1] x [j0, j1] x [k0, k1] can update,
// decided by one warp (lane & 7 is a corner) for all its lanes.
__device__ bool block_culled(const float* __restrict__ P, const float* __restrict__ origin,
                             int i0, int i1, int j0, int j1, int k0, int k1, int H, int W,
                             float voxel_size, float max_depth) {
  const int l = threadIdx.x & 7;
  float cx, cy, cz;
  const Proj p = project(P, origin, (l & 1) ? i1 : i0, (l & 2) ? j1 : j0, (l & 4) ? k1 : k0,
                         voxel_size, cx, cy, cz);
  float e0 = CULL_REL * magnitude(P, cx, cy, cz);
  float e1 = CULL_REL * magnitude(P + 4, cx, cy, cz);
  float ez = CULL_REL * magnitude(P + 8, cx, cy, cz);
#pragma unroll
  for (int off = 1; off < 8; off <<= 1) {
    e0 = fmaxf(e0, __shfl_xor_sync(0xffffffffu, e0, off));
    e1 = fmaxf(e1, __shfl_xor_sync(0xffffffffu, e1, off));
    ez = fmaxf(ez, __shfl_xor_sync(0xffffffffu, ez, off));
  }
  const float znear = p.zc - ez;
  // zc < max_depth fails for every voxel
  if (__all_sync(0xffffffffu, znear >= max_depth)) return true;
  // in front of the camera: bound the projections over the corners +- margin
  if (!__all_sync(0xffffffffu, znear > 0.f)) return false;
  const float zfar = p.zc + ez;
  const float u0 = (p.cam0 - e0) / znear, u1 = (p.cam0 - e0) / zfar;
  const float u2 = (p.cam0 + e0) / znear, u3 = (p.cam0 + e0) / zfar;
  const float v0 = (p.cam1 - e1) / znear, v1 = (p.cam1 - e1) / zfar;
  const float v2 = (p.cam1 + e1) / znear, v3 = (p.cam1 + e1) / zfar;
  const float umin = fminf(fminf(u0, u1), fminf(u2, u3)), umax = fmaxf(fmaxf(u0, u1), fmaxf(u2, u3));
  const float vmin = fminf(fminf(v0, v1), fminf(v2, v3)), vmax = fmaxf(fmaxf(v0, v1), fmaxf(v2, v3));
  return __all_sync(0xffffffffu, umax < -CULL_PIX) ||
         __all_sync(0xffffffffu, umin > float(W) + CULL_PIX) ||
         __all_sync(0xffffffffu, vmax < -CULL_PIX) ||
         __all_sync(0xffffffffu, vmin > float(H) + CULL_PIX);
}

__global__ void __launch_bounds__(BZ * BY) integrate_kernel(
    float* __restrict__ values, float* __restrict__ weights,
    const float* __restrict__ depth,   // (H, W)
    const float* __restrict__ P,       // (3, 4) row-major
    const float* __restrict__ origin,  // (3,)
    int X, int Y, int Z, int H, int W,
    float voxel_size, float min_depth, float depth_range, float max_depth,
    float truncation, float trunc_check, float update_rate, float max_weight) {
  const int k0 = blockIdx.x * BZ, i0 = blockIdx.z * BX;
  const int j = blockIdx.y * BY + threadIdx.y;   // one y row per warp
  if (j >= Y) return;
  if (block_culled(P, origin, i0, min(i0 + BX, X) - 1, j, j, k0, min(k0 + BZ, Z) - 1, H, W,
                   voxel_size, max_depth))
    return;
  const int k = k0 + threadIdx.x;
  if (k >= Z) return;

#pragma unroll
  for (int ii = 0; ii < BX; ++ii) {
    const int i = i0 + ii;
    if (i >= X) break;
    float cx, cy, cz;
    const Proj p = project(P, origin, i, j, k, voxel_size, cx, cy, cz);
    const float zc = p.zc;
    // every test below is part of `valid`; failing one early changes nothing
    if (!(zc > 0.f && zc < max_depth)) continue;
    const float ix = rintf(__fsub_rn(__fdiv_rn(p.cam0, zc), 0.5f));
    const float iy = rintf(__fsub_rn(__fdiv_rn(p.cam1, zc), 0.5f));
    const bool in_img = ix >= 0.f && ix < float(W) && iy >= 0.f && iy < float(H);
    if (!in_img) continue;
    const float sampled = __ldg(depth + int(iy) * W + int(ix));
    if (!(sampled > 0.f)) continue;

    float conf = __fsub_rn(1.f, __fdiv_rn(__fsub_rn(sampled, min_depth), depth_range));
    conf = fminf(fmaxf(conf, 0.25f), 1.f);
    conf = __fmul_rn(conf, conf);
    const float dist = __fsub_rn(sampled, zc);
    const float tsdf = fminf(fmaxf(__fdiv_rn(dist, truncation), -1.f), 1.f);
    // (NaN depth failed `sampled > 0` above, as on the dense path)
    if (!(dist > trunc_check && conf > 0.f)) continue;

    const int idx = (i * Y + j) * Z + k;
    const float new_w = __fdiv_rn(__fmul_rn(conf, update_rate), max_weight);
    const float old_w = weights[idx];
    const float old_v = values[idx];
    const float total = __fadd_rn(old_w, new_w);
    values[idx] = __fdiv_rn(__fadd_rn(__fmul_rn(old_v, old_w), __fmul_rn(tsdf, new_w)), total);
    weights[idx] = fminf(total, 1.f);
  }
}

}  // namespace

extern "C" int integrate_launch(void* values, void* weights, const void* depth, const void* P,
                                const void* origin, int X, int Y, int Z, int H, int W,
                                float voxel_size, float min_depth, float depth_range,
                                float max_depth, float truncation, float trunc_check,
                                float update_rate, float max_weight, void* stream) {
  const dim3 grid((Z + BZ - 1) / BZ, (Y + BY - 1) / BY, (X + BX - 1) / BX);
  integrate_kernel<<<grid, dim3(BZ, BY), 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(values), static_cast<float*>(weights),
      static_cast<const float*>(depth), static_cast<const float*>(P),
      static_cast<const float*>(origin), X, Y, Z, H, W, voxel_size, min_depth, depth_range,
      max_depth, truncation, trunc_check, update_rate, max_weight);
  return int(cudaGetLastError());
}
