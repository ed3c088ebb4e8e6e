// Fused plane-sweep metadata feature volume, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel doubletake_tpu/ops/pallas/fused_volume.py
// (fused_feature_volume / _kernel / _process_rowblock). For every batch
// element b, depth plane d and matching pixel n it
//   1. projects the plane point into each of the K source views and
//      bilinearly samples their 16-channel features (grid_sample,
//      align_corners=False, zeros padding, the torch coordinate chain
//      g = 2px/w - 1; i = ((g + 1)w - 1)/2);
//   2. takes the masked dot with the current view's features;
//   3. assembles the (26K + 20)-channel metadata vector in the checkpoint's
//      channel order (202 channels at K = 7);
//   4. runs the matching MLP [nin, 128, 128, 1] (LeakyReLU 0.01) and the hint
//      MLP [3, 12, 12, 1] on [score, |hint - plane| or -1, weight].
// Only the (B, D, N) scores leave the kernel: the warped features and the
// metadata matrix live in shared memory and registers.
//
// What bounds it on this card: the two MLP layers, 42,368 multiply-adds per
// pixel and plane (66.9 GFLOP a frame at 512x384, 64 planes, 7 views),
// against ~9 MB of inputs: operations, not bytes. This first kernel runs
// them as fp32 FMA from a shared-memory tile (each thread a 4-pixel x
// 8-unit register tile, weights through the read-only cache), so it is held
// to the fp32 peak outside the tensor cores; wgmma/bf16 is later work.
//
// Not carried over from the TPU kernel: the MXU one-hot warps, the BAND row
// window (and its zeros outside the band), bf16 source features and bf16
// MLP operands, the (8, 128) row blocking. A Hopper thread reads its
// bilinear taps directly as contiguous 64-byte NHWC rows, and everything is
// fp32, so the kernel is held to the JAX XLA path.
//
// Layout: one block of 256 threads per (64-pixel tile, plane, batch).

#include <cuda_runtime.h>

namespace {

constexpr int C = 16;                      // matching feature channels
constexpr int HID = 128;                   // matching MLP hidden width
constexpr int HH = 12;                     // hint MLP hidden width
constexpr int KMAX = 8;                    // most source views
constexpr int TP = 64;                     // pixels per block
constexpr int NT = 256;                    // threads per block
constexpr int NIN_MAX = KMAX * C + C + 10 * KMAX + 4;
constexpr size_t SMEM_BYTES = size_t(NIN_MAX + HID) * TP * sizeof(float);

__device__ __forceinline__ float leaky(float x) { return x >= 0.f ? x : 0.01f * x; }

__device__ __forceinline__ void add_tap(const float* __restrict__ feats, float xf, float yf,
                                        float wt, int H, int W, float acc[C]) {
  if (!(xf >= 0.f && xf <= float(W - 1) && yf >= 0.f && yf <= float(H - 1))) return;
  const float4* row = reinterpret_cast<const float4*>(feats + (size_t(yf) * W + size_t(xf)) * C);
#pragma unroll
  for (int q = 0; q < C / 4; ++q) {
    const float4 v = __ldg(row + q);
    acc[4 * q + 0] += v.x * wt;
    acc[4 * q + 1] += v.y * wt;
    acc[4 * q + 2] += v.z * wt;
    acc[4 * q + 3] += v.w * wt;
  }
}

// One 64-pixel x 128-unit layer: out[h][p] = leaky(sum_k in[k][p] w[k][h] + b[h])
// into registers; thread (ty, tx) owns pixels 4ty..4ty+3, units 8tx..8tx+7.
__device__ __forceinline__ void dense_tile(const float* __restrict__ in_s, int nin,
                                           const float* __restrict__ wt,
                                           const float* __restrict__ bias,
                                           int ty, int tx, float acc[4][8]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  const float4* w4 = reinterpret_cast<const float4*>(wt) + tx * 2;
#pragma unroll 4
  for (int k = 0; k < nin; ++k) {
    const float4 x = *reinterpret_cast<const float4*>(in_s + k * TP + ty * 4);
    const float4 wa = __ldg(w4 + k * (HID / 4));
    const float4 wb = __ldg(w4 + k * (HID / 4) + 1);
    const float xs[4] = {x.x, x.y, x.z, x.w};
    const float ws[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] += xs[i] * ws[j];
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float bj = __ldg(bias + tx * 8 + j);
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[i][j] = leaky(acc[i][j] + bj);
  }
}

__global__ void __launch_bounds__(NT) fused_volume_kernel(
    const float* __restrict__ cur,      // (B, N, C)
    const float* __restrict__ src,      // (B, K, N, C)
    const float* __restrict__ rays,     // (B, 3, N) unit-depth rays of the current view
    const float* __restrict__ proj,     // (B, K, 12) rows of src_K @ src_T_cur, [:3, :4]
    const float* __restrict__ centers,  // (B, K, 3) source camera centres, current frame
    const float* __restrict__ pose,     // (B, 3K) [pose distance, R measure, t measure]
    const float* __restrict__ planes,   // (D,)
    const float* __restrict__ hint,     // (B, N, 3) [depth, valid, weight] or null
    const float* __restrict__ w1t, const float* __restrict__ b1,   // (nin, HID), (HID,)
    const float* __restrict__ w2t, const float* __restrict__ b2,   // (HID, HID), (HID,)
    const float* __restrict__ w3, const float* __restrict__ b3,    // (HID,), (1,)
    const float* __restrict__ hw1t, const float* __restrict__ hb1, // (3, HH), (HH,)
    const float* __restrict__ hw2t, const float* __restrict__ hb2, // (HH, HH), (HH,)
    const float* __restrict__ hw3, const float* __restrict__ hb3,  // (HH,), (1,)
    float* __restrict__ out,            // (B, D, N)
    int K, int H, int W, int D) {
  extern __shared__ float4 smem4[];
  float* X = reinterpret_cast<float*>(smem4);   // [nin][TP] metadata, pixel-minor
  float* H1 = X + NIN_MAX * TP;                 // [HID][TP] first hidden layer
  __shared__ float score_s[TP];

  const int N = H * W;
  const int tile0 = blockIdx.x * TP;
  const int d = blockIdx.y;
  const int b = blockIdx.z;
  const float plane = planes[d];

  // channel offsets of the metadata vector (doubletake_tpu cost_volume.py:298-301)
  const int cur_off = K * C;
  const int mask_off = cur_off + C;
  const int depth_off = mask_off + K;
  const int plane_off = depth_off + K;
  const int dot_off = plane_off + 1;
  const int angle_off = dot_off + K;
  const int rays_off = angle_off + K;
  const int pose_off = rays_off + 3 * (K + 1);
  const int nin = pose_off + 3 * K;

  // ---- stage 1: metadata, thread (p, g): pixel p, views g, g+4, ... ----
  const int t = threadIdx.x;
  const int p = t % TP;
  const int g = t / TP;
  const int n = tile0 + p;
  const bool live = n < N;
  const float* ray_b = rays + size_t(b) * 3 * N;
  const float rx = live ? ray_b[n] : 0.f;
  const float ry = live ? ray_b[N + n] : 0.f;
  const float rz = live ? ray_b[2 * N + n] : 0.f;
  const float ptx = plane * rx, pty = plane * ry, ptz = plane * rz;
  const float cnorm = fmaxf(sqrtf(ptx * ptx + pty * pty + ptz * ptz), 1e-12f);
  const float crx = ptx / cnorm, cry = pty / cnorm, crz = ptz / cnorm;
  const float* cur_n = cur + (size_t(b) * N + (live ? n : 0)) * C;

  if (g == 0) {
#pragma unroll
    for (int c = 0; c < C; ++c) X[(cur_off + c) * TP + p] = live ? cur_n[c] : 0.f;
    X[plane_off * TP + p] = plane;
    X[(rays_off + 0) * TP + p] = crx;
    X[(rays_off + 1) * TP + p] = cry;
    X[(rays_off + 2) * TP + p] = crz;
    for (int j = 0; j < 3 * K; ++j) X[(pose_off + j) * TP + p] = pose[size_t(b) * 3 * K + j];
  }
  for (int v = g; v < K; v += NT / TP) {
    const float* P = proj + (size_t(b) * K + v) * 12;
    const float cx = P[0] * ptx + P[1] * pty + P[2] * ptz + P[3];
    const float cy = P[4] * ptx + P[5] * pty + P[6] * ptz + P[7];
    const float cz = P[8] * ptx + P[9] * pty + P[10] * ptz + P[11];
    const float z = cz + 1e-8f;
    const float scale = fabsf(cz) > 1e-8f ? 1.f / z : 1.f;
    const float gx = 2.f * (cx * scale) / float(W) - 1.f;
    const float gy = 2.f * (cy * scale) / float(H) - 1.f;
    const float ix = ((gx + 1.f) * float(W) - 1.f) / 2.f;
    const float iy = ((gy + 1.f) * float(H) - 1.f) / 2.f;
    const float x0 = floorf(ix), y0 = floorf(iy);
    const float wx1 = ix - x0, wy1 = iy - y0;
    const float wx0 = 1.f - wx1, wy0 = 1.f - wy1;

    float acc[C];
#pragma unroll
    for (int c = 0; c < C; ++c) acc[c] = 0.f;
    const float* feats = src + (size_t(b) * K + v) * size_t(N) * C;
    if (live) {
      add_tap(feats, x0, y0, wx0 * wy0, H, W, acc);
      add_tap(feats, x0 + 1.f, y0, wx1 * wy0, H, W, acc);
      add_tap(feats, x0, y0 + 1.f, wx0 * wy1, H, W, acc);
      add_tap(feats, x0 + 1.f, y0 + 1.f, wx1 * wy1, H, W, acc);
    }
    const float mask = z > 0.f ? 1.f : 0.f;
    float dot = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      X[(v * C + c) * TP + p] = acc[c];
      dot += acc[c] * (live ? cur_n[c] : 0.f);
    }
    const float* ctr = centers + (size_t(b) * K + v) * 3;
    const float sx = ptx - ctr[0], sy = pty - ctr[1], sz = ptz - ctr[2];
    const float snorm = fmaxf(sqrtf(sx * sx + sy * sy + sz * sz), 1e-12f);
    const float srx = sx / snorm, sry = sy / snorm, srz = sz / snorm;
    X[(mask_off + v) * TP + p] = mask;
    X[(depth_off + v) * TP + p] = z;
    X[(dot_off + v) * TP + p] = dot * mask;
    X[(angle_off + v) * TP + p] = crx * srx + cry * sry + crz * srz;
    X[(rays_off + 3 + 3 * v + 0) * TP + p] = srx;
    X[(rays_off + 3 + 3 * v + 1) * TP + p] = sry;
    X[(rays_off + 3 + 3 * v + 2) * TP + p] = srz;
  }
  __syncthreads();

  // ---- stage 2: H1 = leaky(X^T W1 + b1) ----
  const int tx = t % 16, ty = t / 16;
  float acc[4][8];
  dense_tile(X, nin, w1t, b1, ty, tx, acc);
#pragma unroll
  for (int j = 0; j < 8; ++j)
    *reinterpret_cast<float4*>(H1 + (tx * 8 + j) * TP + ty * 4) =
        make_float4(acc[0][j], acc[1][j], acc[2][j], acc[3][j]);
  __syncthreads();

  // ---- stage 3: H2 = leaky(H1^T W2 + b2), score = H2 . w3 + b3 ----
  dense_tile(H1, HID, w2t, b2, ty, tx, acc);
  float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float w3j = __ldg(w3 + tx * 8 + j);
#pragma unroll
    for (int i = 0; i < 4; ++i) part[i] += acc[i][j] * w3j;
  }
  // the 16 tx lanes of one ty sit in one half-warp: reduce across them
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
#pragma unroll
    for (int i = 0; i < 4; ++i) part[i] += __shfl_xor_sync(0xffffffffu, part[i], off);
  if (tx == 0) {
    const float bias3 = __ldg(b3);
#pragma unroll
    for (int i = 0; i < 4; ++i) score_s[ty * 4 + i] = part[i] + bias3;
  }
  __syncthreads();

  // ---- stage 4: hint MLP and store ----
  if (t < TP) {
    const int nn = tile0 + t;
    if (nn < N) {
      float s = score_s[t];
      if (hint != nullptr) {
        const float* hn = hint + (size_t(b) * N + nn) * 3;
        const bool valid = hn[1] > 0.5f;
        const float in3[3] = {s, valid ? fabsf(hn[0] - plane) : -1.f, valid ? hn[2] : 0.f};
        float g1[HH], g2[HH];
#pragma unroll
        for (int j = 0; j < HH; ++j) {
          float a = __ldg(hb1 + j);
#pragma unroll
          for (int i = 0; i < 3; ++i) a += in3[i] * __ldg(hw1t + i * HH + j);
          g1[j] = leaky(a);
        }
#pragma unroll
        for (int j = 0; j < HH; ++j) {
          float a = __ldg(hb2 + j);
#pragma unroll
          for (int i = 0; i < HH; ++i) a += g1[i] * __ldg(hw2t + i * HH + j);
          g2[j] = leaky(a);
        }
        float a = __ldg(hb3);
#pragma unroll
        for (int i = 0; i < HH; ++i) a += g2[i] * __ldg(hw3 + i);
        s = a;
      }
      out[(size_t(b) * D + d) * N + nn] = s;
    }
  }
}

}  // namespace

extern "C" int fused_volume_launch(
    const void* cur, const void* src, const void* rays, const void* proj,
    const void* centers, const void* pose, const void* planes, const void* hint,
    const void* w1t, const void* b1, const void* w2t, const void* b2,
    const void* w3, const void* b3,
    const void* hw1t, const void* hb1, const void* hw2t, const void* hb2,
    const void* hw3, const void* hb3,
    void* out, int B, int K, int H, int W, int D, void* stream) {
  if (K < 1 || K > KMAX) return int(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      fused_volume_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(SMEM_BYTES));
  if (err != cudaSuccess) return int(err);
  const dim3 grid((H * W + TP - 1) / TP, D, B);
  fused_volume_kernel<<<grid, NT, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(cur), static_cast<const float*>(src),
      static_cast<const float*>(rays), static_cast<const float*>(proj),
      static_cast<const float*>(centers), static_cast<const float*>(pose),
      static_cast<const float*>(planes), static_cast<const float*>(hint),
      static_cast<const float*>(w1t), static_cast<const float*>(b1),
      static_cast<const float*>(w2t), static_cast<const float*>(b2),
      static_cast<const float*>(w3), static_cast<const float*>(b3),
      static_cast<const float*>(hw1t), static_cast<const float*>(hb1),
      static_cast<const float*>(hw2t), static_cast<const float*>(hb2),
      static_cast<const float*>(hw3), static_cast<const float*>(hb3),
      static_cast<float*>(out), K, H, W, D);
  return int(cudaGetLastError());
}
