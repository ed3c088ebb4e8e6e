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
// What bounds it on this card: bytes. Each voxel reads and writes its value
// and weight (16 B), 148 MB for the 304x200x152 synthetic room, ~44 us at
// 3.35 TB/s; the 196 KB depth image stays in L2 and the arithmetic is ~40
// flops a voxel. One thread per voxel with z the fastest axis, so loads and
// stores coalesce.
//
// Every product, sum and quotient is rounded on its own (__fmul_rn,
// __fadd_rn, __fdiv_rn, and -fmad=false at build time): the plain torch
// version (ops/integrate.py integrate_plain) runs the same operations in the
// same order, so the two agree bit for bit, including the rint ties that an
// fma would flip.
//
// Not carried over from the TPU kernel: the one-hot depth-sampling matmuls,
// the bf16 hi/lo split of the depth image, the 32-lane z sub-tiles, the
// host-side band flags and the scalar-prefetch block-sparse grid. A Hopper
// thread reads its depth pixel directly.

#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;

__global__ void __launch_bounds__(NT) integrate_kernel(
    float* __restrict__ values, float* __restrict__ weights,
    const float* __restrict__ depth,   // (H, W)
    const float* __restrict__ P,       // (3, 4) row-major
    const float* __restrict__ origin,  // (3,)
    long long X, long long Y, long long Z, int H, int W,
    float voxel_size, float min_depth, float depth_range, float max_depth,
    float truncation, float trunc_check, float update_rate, float max_weight) {
  const long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (idx >= X * Y * Z) return;
  const long long k = idx % Z;
  const long long ij = idx / Z;
  const long long j = ij % Y;
  const long long i = ij / Y;

  const float cx = __fadd_rn(origin[0], __fmul_rn(float(i), voxel_size));
  const float cy = __fadd_rn(origin[1], __fmul_rn(float(j), voxel_size));
  const float cz = __fadd_rn(origin[2], __fmul_rn(float(k), voxel_size));
  const float cam0 = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(P[0], cx), __fmul_rn(P[1], cy)),
                                         __fmul_rn(P[2], cz)), P[3]);
  const float cam1 = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(P[4], cx), __fmul_rn(P[5], cy)),
                                         __fmul_rn(P[6], cz)), P[7]);
  const float zc = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(P[8], cx), __fmul_rn(P[9], cy)),
                                       __fmul_rn(P[10], cz)), P[11]);

  const float ix = rintf(__fsub_rn(__fdiv_rn(cam0, zc), 0.5f));
  const float iy = rintf(__fsub_rn(__fdiv_rn(cam1, zc), 0.5f));
  const bool in_img = ix >= 0.f && ix < float(W) && iy >= 0.f && iy < float(H) && zc > 0.f;
  const float sampled = in_img ? __ldg(depth + int(iy) * W + int(ix)) : 0.f;

  float conf = __fsub_rn(1.f, __fdiv_rn(__fsub_rn(sampled, min_depth), depth_range));
  conf = fminf(fmaxf(conf, 0.25f), 1.f);
  conf = __fmul_rn(conf, conf);
  const float dist = __fsub_rn(sampled, zc);
  const float tsdf = fminf(fmaxf(__fdiv_rn(dist, truncation), -1.f), 1.f);
  // NaN depth fails `sampled > 0` here, as on the dense path
  const bool valid = zc > 0.f && dist > trunc_check && sampled > 0.f && zc < max_depth &&
                     conf > 0.f;
  if (!valid) return;

  const float new_w = __fdiv_rn(__fmul_rn(conf, update_rate), max_weight);
  const float old_w = weights[idx];
  const float old_v = values[idx];
  const float total = __fadd_rn(old_w, new_w);
  values[idx] = __fdiv_rn(__fadd_rn(__fmul_rn(old_v, old_w), __fmul_rn(tsdf, new_w)), total);
  weights[idx] = fminf(total, 1.f);
}

}  // namespace

extern "C" int integrate_launch(void* values, void* weights, const void* depth, const void* P,
                                const void* origin, long long X, long long Y, long long Z,
                                int H, int W, float voxel_size, float min_depth,
                                float depth_range, float max_depth, float truncation,
                                float trunc_check, float update_rate, float max_weight,
                                void* stream) {
  const long long n = X * Y * Z;
  const unsigned blocks = static_cast<unsigned>((n + NT - 1) / NT);
  integrate_kernel<<<blocks, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(values), static_cast<float*>(weights),
      static_cast<const float*>(depth), static_cast<const float*>(P),
      static_cast<const float*>(origin), X, Y, Z, H, W, voxel_size, min_depth, depth_range,
      max_depth, truncation, trunc_check, update_rate, max_weight);
  return int(cudaGetLastError());
}
