// Fused plane-sweep metadata feature volume, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel doubletake_tpu/ops/pallas/fused_volume.py
// (fused_feature_volume / _kernel / _process_rowblock). For every batch
// element b, depth plane d and matching pixel n it
//   1. projects the plane point into each of the K source views and
//      bilinearly samples their 16-channel features (grid_sample,
//      align_corners=False, zeros padding);
//   2. takes the masked dot with the current view's features;
//   3. builds the (26K + 20)-channel metadata vector (202 at K = 7);
//   4. runs the matching MLP [nin, 128, 128, 1] (LeakyReLU 0.01) and the hint
//      MLP [3, 12, 12, 1] on [score, |hint - plane| or -1, weight].
// Only the (B, D, N) scores leave the kernel.
//
// What bounds it on this card: the two 128-wide MLP layers (~37k
// multiply-adds per pixel and plane against ~10 MB of inputs), so
// operations. They run on the tensor cores in bf16 with fp32 sums. One bf16
// product keeps 8 bits and misses the port's fp32 contract (max error 1e-3
// against feature_volume_plain), so every operand is split into
// hi = bf16(x) and lo = bf16(x - hi) and each product is taken as
// lo*hi + hi*lo + hi*hi (about 16 bits; lo*lo is below them): three bf16
// products, still ~5x the fp32 SIMT rate per product.
//
// Design (ops/fused_volume.py packs the weights once per module):
//   * persistent grid, one block per SM of two warpgroups (4 warps each);
//     each block copies the per-plane layer-1 rows and W2 (bf16 hi and lo,
//     in wgmma's no-swizzle K-major tiles, up to 160 KB) into shared memory
//     once. The rest of the 227 KB holds each warp's u (below);
//   * the MLP layers are wgmma (m64n128k16; layer 2 as two m64n64k16
//     halves) with A from registers and B from shared memory: a warpgroup
//     owns 64 pixels (16 a warp) and walks a run
//     of planes (the wrapper picks the run so the items fill the
//     warpgroups evenly). The tensor cores read each weight tile once per
//     64 pixels, and run asynchronously while the warps gather the next
//     view (mma.sync from registers, tried first, spent its time on the
//     shared-memory loads of the weight fragments, 16 pixels at a time);
//   * the 40 channels shared by all planes of a pixel (current features,
//     current ray = r/|r|, pose metadata) go through W1 once per item into
//     u = b1 + W x (mma.sync, weights from global memory: it runs once per
//     item); each plane starts from u + plane * w_plane, so layer 1 per
//     plane has K = 23 per view instead of 202 (161 at K = 7, 176 padded);
//   * no metadata tile: the four lanes of a quad share two pixel rows; each
//     computes the projection and gathers only the 4 channels of each tap
//     that its A fragment holds (one 16-byte load a tap), so the warped
//     features go from the gather straight into the MMA. Each view is one
//     16-wide K step; its 7 scalars take half of a step shared with the next
//     view. A view's taps are loaded a view ahead (the next plane's first
//     view during the last one) and finished while the tensor cores work on
//     the view before. The kernel is instantiated per view count K, so the
//     view loop unrolls and the scalar pairing is fixed at compile time.
//     (Loading two views ahead needs ~40 more registers than the 255 a
//     thread has here and spilled: it measured slower.)
//   * layer 1's accumulators become layer 2's A fragments in registers;
//     layer 2 runs as two m64n64 halves, so only 32 accumulators are live
//     beside them and the taps in flight; the hint MLP's weights are launch
//     parameters, read as FMA operands.
//
// Not carried over from the TPU kernel: the MXU one-hot warps, the BAND row
// window (and its zeros outside the band) and the (8, 128) row blocking.
//
// The bf16 mode (template flag BF, taken for bf16 features under the bf16
// compute dtype) computes what the TPU kernel computes there: bf16 current and
// source features (each tap one 8-byte load, half the fp32 mode's bytes),
// every MLP operand rounded to bf16 and each product ONE bf16 product with
// fp32 sums, layer 1's activations rounded to bf16 as layer 2's A operand,
// fp32 scores. It samples at the bf16-rounded grid coordinate
// g = bf16(2 px / W - 1), as its plain version (the XLA bf16 path, which
// casts the sampling grid to the feature type) does. The fp32 mode is
// unchanged by it: the flag only removes work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>
#include <type_traits>

namespace {

constexpr int C = 16;          // matching feature channels
constexpr int HID = 128;       // matching MLP hidden width
constexpr int NT16 = HID / 8;  // n8 column groups across the hidden width
constexpr int HH = 12;         // hint MLP hidden width
constexpr int KMAX = 8;        // most source views
constexpr int WARPS = 8;       // two warpgroups
constexpr int NT = WARPS * 32;
constexpr int GROUPS = WARPS / 4;
// the small-weights vector (ops/fused_volume.py VEC_*)
constexpr int V_B1 = 0, V_WP = 128, V_B2 = 256, V_W3 = 384, V_B3 = 512;
constexpr int VEC_LEN = 520;
// one K step of B (16 x 128 bf16) as wgmma reads it without swizzle: 8 x 8
// core matrices of 128 contiguous bytes, the two K halves of a column group
// LBO bytes apart, column groups SBO bytes apart (ops/fused_volume.py
// wgmma_tiles); hi then lo
constexpr int TILE_BYTES = 16 * HID * 2;
constexpr int LBO = 128, SBO = 256;
// the invariant rows' mma.sync fragments (ops/fused_volume.py mma_fragments)
constexpr int FRAG_STEP = NT16 * 32;

// The hint MLP's weights, passed by value: a kernel parameter every lane
// reads at the same address is an operand of the FMA itself, with no load
// (ops/fused_volume.py HINT_LEN floats, this order).
struct HintWeights {
  float w1[3][HH];   // w1[i][j] = first layer's weight[j, i]
  float b1[HH];
  float w2[HH][HH];  // w2[i][j] = second layer's weight[j, i]
  float b2[HH];
  float w3[HH];
  float b3;
};

__host__ __device__ constexpr int plane_steps(int k) { return k + (k + 1) / 2; }
__host__ __device__ constexpr int inv_steps(int k) { return 1 + (3 + 3 * k + 15) / 16; }
// weights (per-plane layer-1 rows, W2), small weights, each warp's u
constexpr size_t smem_bytes(int k) {
  return size_t(plane_steps(k) + HID / 16) * 2 * TILE_BYTES +
         (VEC_LEN + WARPS * NT16 * 4 * 32) * sizeof(float);
}
static_assert(smem_bytes(KMAX) <= 232448, "more shared memory than a Hopper block has");
static_assert(sizeof(HintWeights) == 217 * sizeof(float), "ops/fused_volume.py HINT_LEN");

__device__ __forceinline__ float leaky(float x) { return x >= 0.f ? x : 0.01f * x; }

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// x rounded to the nearest bf16
__device__ __forceinline__ float bf16r(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }

// four consecutive channels as loaded: fp32, or bf16 pairs (low half first)
__device__ __forceinline__ float4 unpack(float4 v) { return v; }
__device__ __forceinline__ float4 unpack(uint2 v) {
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// hi/lo bf16 pairs of (x, y): x in the low half, as the fragments hold them
__device__ __forceinline__ void split2(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = pack_bf16(h);
  lo = pack_bf16(__floats2bfloat162_rn(x - hf.x, y - hf.y));
}

// A fragment of 16 rows x 16 columns (rows g and g+8; r0 = row g, r1 = row
// g+8, each {col 2t, 2t+1, 2t+8, 2t+9}), split
__device__ __forceinline__ void split_a(const float r0[4], const float r1[4], uint32_t ah[4],
                                        uint32_t al[4]) {
  split2(r0[0], r0[1], ah[0], al[0]);
  split2(r1[0], r1[1], ah[1], al[1]);
  split2(r0[2], r0[3], ah[2], al[2]);
  split2(r1[2], r1[3], ah[3], al[3]);
}

// the same fragment rounded to bf16 (the bf16 mode's one product)
__device__ __forceinline__ void round_a(const float r0[4], const float r1[4], uint32_t ah[4]) {
  ah[0] = pack_bf16(__floats2bfloat162_rn(r0[0], r0[1]));
  ah[1] = pack_bf16(__floats2bfloat162_rn(r1[0], r1[1]));
  ah[2] = pack_bf16(__floats2bfloat162_rn(r0[2], r0[3]));
  ah[3] = pack_bf16(__floats2bfloat162_rn(r1[2], r1[3]));
}

// ---- mma.sync, for u (once per item)

__device__ __forceinline__ void mma(float c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc += A . B for one 16-row K step, B as mma.sync fragments in global
// memory ({hi k0k1, hi k8k9, lo k0k1, lo k8k9} per lane and column group);
// the bf16 mode takes the hi parts only
template <bool BF>
__device__ __forceinline__ void kstep_sync(float acc[NT16][4], const float r0[4],
                                           const float r1[4], const uint4* __restrict__ bstep,
                                           int lane) {
  uint32_t ah[4], al[4];
  if constexpr (BF) {
    round_a(r0, r1, ah);
  } else {
    split_a(r0, r1, ah, al);
  }
#pragma unroll
  for (int j = 0; j < NT16; ++j) {
    const uint4 b = __ldg(bstep + j * 32 + lane);
    if constexpr (!BF) {
      mma(acc[j], al, b.x, b.y);
      mma(acc[j], ah, b.z, b.w);
    }
    mma(acc[j], ah, b.x, b.y);
  }
}

// ---- wgmma

__device__ __forceinline__ uint64_t tile_desc(uint32_t saddr) {
  return uint64_t((saddr & 0x3FFFF) >> 4) | (uint64_t(LBO >> 4) << 16) |
         (uint64_t(SBO >> 4) << 32);
}

// d (this warp's 16 rows x 8 NJ columns of the warpgroup's 64 rows) += A . B
template <int NJ>
__device__ __forceinline__ void wgmma(float (&d)[NJ][4], const uint32_t a[4], uint64_t desc) {
  static_assert(NJ == 16 || NJ == 8, "m64n128k16 or m64n64k16");
  if constexpr (NJ == 16) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
          "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
          "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
          "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
          "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
          "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
          "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
          "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
          "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
          "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
          "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
          "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
          "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
          "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
          "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
          "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
          "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc));
  }
}

// the three products of one K step; the tile at saddr is hi, saddr +
// TILE_BYTES lo
template <int NJ>
__device__ __forceinline__ void wgmma3(float (&d)[NJ][4], const uint32_t ah[4],
                                       const uint32_t al[4], uint32_t saddr) {
  wgmma(d, al, tile_desc(saddr));
  wgmma(d, ah, tile_desc(saddr + TILE_BYTES));
  wgmma(d, ah, tile_desc(saddr));
}

// one K step in either mode: three products (fp32), or the hi parts' one (bf16)
template <bool BF, int NJ>
__device__ __forceinline__ void wgmma_step(float (&d)[NJ][4], const uint32_t ah[4],
                                           const uint32_t al[4], uint32_t saddr) {
  if constexpr (BF) {
    wgmma(d, ah, tile_desc(saddr));
  } else {
    wgmma3(d, ah, al, saddr);
  }
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keep the compiler from moving accesses of these registers across a wgmma
// issue or wait
template <int NJ>
__device__ __forceinline__ void pin(float (&d)[NJ][4]) {
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[j][e])::"memory");
}
__device__ __forceinline__ void pin(uint32_t (&a)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[e])::"memory");
}

// ---- the gathers

// The bilinear taps of one (pixel row, view, plane): this lane's 4 channels
// 4t..4t+3 of each of the 4 taps, one 16-byte load a tap, and their weights
// (0 for a tap outside the image). The packed weights order each 16-channel
// K step so that A columns 2t, 2t+1, 2t+8, 2t+9 are channels 4t..4t+3
// (ops/fused_volume.py FRAGMENT_CHANNELS). Apart from finish_row so that the
// loads are in flight a view ahead. The bf16 mode keeps the raw bf16 pairs
// (8 bytes a tap) until finish_row.
template <bool BF>
struct Taps {
  typename std::conditional<BF, uint2, float4>::type a[4];
  float wt[4];
  float z;         // projected depth + 1e-8
};

template <bool BF>
__device__ __forceinline__ Taps<BF> fetch_row(const void* __restrict__ feats,
                                              const float* __restrict__ Pv, float ptx, float pty,
                                              float ptz, bool live, int H, int W, int t) {
  Taps<BF> o;
  const float cx = Pv[0] * ptx + Pv[1] * pty + Pv[2] * ptz + Pv[3];
  const float cy = Pv[4] * ptx + Pv[5] * pty + Pv[6] * ptz + Pv[7];
  const float cz = Pv[8] * ptx + Pv[9] * pty + Pv[10] * ptz + Pv[11];
  o.z = cz + 1e-8f;
  const float scale = fabsf(cz) > 1e-8f ? __frcp_rn(o.z) : 1.f;
  float ix, iy;
  if constexpr (BF) {
    // grid_sample's chain g = 2px/W - 1, i = ((g + 1)W - 1)/2 on the grid
    // rounded to bf16, as the XLA bf16 path samples
    const float gx = bf16r(2.f * (cx * scale) / float(W) - 1.f);
    const float gy = bf16r(2.f * (cy * scale) / float(H) - 1.f);
    ix = ((gx + 1.f) * float(W) - 1.f) * 0.5f;
    iy = ((gy + 1.f) * float(H) - 1.f) * 0.5f;
  } else {
    // the same chain in fp32 is i = px - 1/2
    ix = cx * scale - 0.5f;
    iy = cy * scale - 0.5f;
  }
  const float x0 = floorf(ix), y0 = floorf(iy);
  const float wx1 = ix - x0, wy1 = iy - y0;
  const float wx0 = 1.f - wx1, wy0 = 1.f - wy1;
  // taps (x0, y0), (x0+1, y0), (x0, y0+1), (x0+1, y0+1); NaN fails every test
  const bool vx0 = x0 >= 0.f && x0 <= float(W - 1), vx1 = x0 >= -1.f && x0 <= float(W - 2);
  const bool vy0 = live && y0 >= 0.f && y0 <= float(H - 1);
  const bool vy1 = live && y0 >= -1.f && y0 <= float(H - 2);
  const bool in[4] = {vx0 && vy0, vx1 && vy0, vx0 && vy1, vx1 && vy1};
  const float wts[4] = {wx0 * wy0, wx1 * wy0, wx0 * wy1, wx1 * wy1};
  const int xi = int(fminf(fmaxf(x0, -1.f), float(W))), yi = int(fminf(fmaxf(y0, -1.f), float(H)));
  const int offs[4] = {0, C, W * C, W * C + C};
  const int base = (yi * W + xi) * C + 4 * t;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    o.wt[q] = in[q] ? wts[q] : 0.f;
    if constexpr (BF) {
      const __nv_bfloat16* p = static_cast<const __nv_bfloat16*>(feats) + base + offs[q];
      o.a[q] = in[q] ? __ldg(reinterpret_cast<const uint2*>(p)) : make_uint2(0u, 0u);
    } else {
      const float* p = static_cast<const float*>(feats) + base + offs[q];
      o.a[q] = in[q] ? __ldg(reinterpret_cast<const float4*>(p))
                     : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  return o;
}

struct ViewOut {
  float f[4];      // this lane's 4 warped channels
  float lo, hi;    // this lane's two scalars of [mask, depth, dot, angle, rx, ry, rz, 0]
};

// The rest of one (pixel row, view, plane): the warped channels, the dot
// with the current features (over the quad), and this lane's scalars. In
// the bf16 mode the warped channels are rounded to bf16 before the dot, as
// the plain path's bf16 warp is.
template <bool BF>
__device__ __forceinline__ ViewOut finish_row(const Taps<BF>& tp, const float* __restrict__ ctr,
                                              float ptx, float pty, float ptz,
                                              const float cr[3], const float cf[4], int t) {
  ViewOut o;
#pragma unroll
  for (int i = 0; i < 4; ++i) o.f[i] = 0.f;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float4 a = unpack(tp.a[q]);
    o.f[0] += a.x * tp.wt[q];
    o.f[1] += a.y * tp.wt[q];
    o.f[2] += a.z * tp.wt[q];
    o.f[3] += a.w * tp.wt[q];
  }
  if constexpr (BF) {
#pragma unroll
    for (int i = 0; i < 4; ++i) o.f[i] = bf16r(o.f[i]);
  }
  float dot = o.f[0] * cf[0] + o.f[1] * cf[1] + o.f[2] * cf[2] + o.f[3] * cf[3];
  dot += __shfl_xor_sync(0xffffffffu, dot, 1);
  dot += __shfl_xor_sync(0xffffffffu, dot, 2);
  const float mask = tp.z > 0.f ? 1.f : 0.f;
  const float sx = ptx - ctr[0], sy = pty - ctr[1], sz = ptz - ctr[2];
  const float rn = rsqrtf(fmaxf(sx * sx + sy * sy + sz * sz, 1e-24f));   // 1 / max(|s|, 1e-12)
  const float srx = sx * rn, sry = sy * rn, srz = sz * rn;
  const float angle = cr[0] * srx + cr[1] * sry + cr[2] * srz;
  o.lo = t == 0 ? mask : t == 1 ? dot * mask : t == 2 ? srx : srz;
  o.hi = t == 0 ? tp.z : t == 1 ? angle : t == 2 ? sry : 0.f;
  return o;
}

template <int K, bool BF>
__global__ void __launch_bounds__(NT, 1) fused_volume_kernel(
    const void* __restrict__ cur,       // (B, N, C), fp32 or (BF) bf16
    const void* __restrict__ src,       // (B, K, N, C), the same type
    const float* __restrict__ rays,     // (B, 3, N) unit-depth rays of the current view
    const float* __restrict__ proj,     // (B, K, 12) rows of src_K @ src_T_cur, [:3, :4]
    const float* __restrict__ centers,  // (B, K, 3) source camera centres, current frame
    const float* __restrict__ pose,     // (B, 3K) [pose distance, R measure, t measure]
    const float* __restrict__ planes,   // (D,)
    const float* __restrict__ hint,     // (B, N, 3) [depth, valid, weight]; read if use_hint
    const uint4* __restrict__ w1i,      // invariant layer-1 rows, mma.sync fragments
    const uint4* __restrict__ w1p,      // per-plane layer-1 rows, wgmma tiles
    const uint4* __restrict__ w2,       // layer 2, wgmma tiles
    const float* __restrict__ vec,      // small weights (VEC_LEN)
    const __grid_constant__ HintWeights hw,
    float* __restrict__ out,            // (B, D, N)
    int B, int H, int W, int D, int run, int use_hint) {
  extern __shared__ __align__(128) uint4 smem[];
  constexpr int psteps = plane_steps(K);
  uint4* w1p_s = smem;
  uint4* w2_s = smem + psteps * (2 * TILE_BYTES / 16);
  float* vec_s = reinterpret_cast<float*>(w2_s + (HID / 16) * (2 * TILE_BYTES / 16));
  // each warp's u (its 16 pixels' shared-channel pre-activations), held
  // as the accumulator fragments: [column group][lane][element]
  float4* u_s = reinterpret_cast<float4*>(vec_s + VEC_LEN) + (threadIdx.x >> 5) * (NT16 * 32);
  for (int i = threadIdx.x; i < psteps * (2 * TILE_BYTES / 16); i += NT) w1p_s[i] = w1p[i];
  for (int i = threadIdx.x; i < (HID / 16) * (2 * TILE_BYTES / 16); i += NT) w2_s[i] = w2[i];
  for (int i = threadIdx.x; i < VEC_LEN; i += NT) vec_s[i] = vec[i];
  __syncthreads();
  const uint32_t w1p_a = static_cast<uint32_t>(__cvta_generic_to_shared(w1p_s));
  const uint32_t w2_a = static_cast<uint32_t>(__cvta_generic_to_shared(w2_s));

  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wq = (threadIdx.x >> 5) & 3;   // warp within the warpgroup
  const int N = H * W;
  const int groups = (N + 63) / 64;
  const int runs = (D + run - 1) / run;
  const int items = B * groups * runs;
  constexpr int isteps = inv_steps(K);

  for (int item = blockIdx.x * GROUPS + (threadIdx.x >> 7); item < items;
       item += gridDim.x * GROUPS) {
    const int gb = item % (B * groups);
    const int b = gb / groups;
    const int d0 = (item / (B * groups)) * run;
    const int d1 = min(D, d0 + run);
    const int row0 = (gb % groups) * 64 + wq * 16 + g;
    const int nrow[2] = {row0, row0 + 8};
    const bool live[2] = {nrow[0] < N, nrow[1] < N};
    // this lane's hint and output row: g for even t, g + 8 for odd t
    const int hr = t & 1;
    const int nh = hr ? nrow[1] : nrow[0];
    const bool live_h = hr ? live[1] : live[0];

    // per-pixel state of rows g and g + 8
    float ray[2][3], cr[2][3], cf[2][4];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int n = live[r] ? nrow[r] : 0;
      const float* rb = rays + size_t(b) * 3 * N + n;
      const size_t cn = (size_t(b) * N + n) * C + 4 * t;
#pragma unroll
      for (int q = 0; q < 3; ++q) ray[r][q] = live[r] ? rb[q * N] : 0.f;
      const float nrm = fmaxf(sqrtf(ray[r][0] * ray[r][0] + ray[r][1] * ray[r][1] +
                                    ray[r][2] * ray[r][2]), 1e-12f);
#pragma unroll
      for (int q = 0; q < 3; ++q) cr[r][q] = ray[r][q] / nrm;
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
      if (live[r]) {
        if constexpr (BF) {
          a = unpack(*reinterpret_cast<const uint2*>(static_cast<const __nv_bfloat16*>(cur) + cn));
        } else {
          a = *reinterpret_cast<const float4*>(static_cast<const float*>(cur) + cn);
        }
      }
      cf[r][0] = a.x; cf[r][1] = a.y; cf[r][2] = a.z; cf[r][3] = a.w;
    }
    float hdep = 0.f, hval = 0.f, hwt = 0.f;
    if (use_hint && live_h) {
      const float* hn = hint + (size_t(b) * N + nh) * 3;
      hdep = hn[0]; hval = hn[1]; hwt = hn[2];
    }

    // u = b1 + W1[shared channels] . x, once for the run of planes
    float acc[NT16][4];
#pragma unroll
    for (int j = 0; j < NT16; ++j) {
      const float2 bj = *reinterpret_cast<const float2*>(vec_s + V_B1 + 8 * j + 2 * t);
      acc[j][0] = bj.x; acc[j][1] = bj.y; acc[j][2] = bj.x; acc[j][3] = bj.y;
    }
    kstep_sync<BF>(acc, cf[0], cf[1], w1i, lane);
    const float* pb = pose + size_t(b) * 3 * K;
    for (int s = 1; s < isteps; ++s) {
      float r0[4], r1[4];
      const int cols[4] = {16 * (s - 1) + 2 * t, 16 * (s - 1) + 2 * t + 1,
                           16 * (s - 1) + 2 * t + 8, 16 * (s - 1) + 2 * t + 9};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ch = cols[e];
        const float pv = (ch >= 3 && ch < 3 + 3 * K) ? pb[ch - 3] : 0.f;
        r0[e] = ch == 0 ? cr[0][0] : ch == 1 ? cr[0][1] : ch == 2 ? cr[0][2] : pv;
        r1[e] = ch == 0 ? cr[1][0] : ch == 1 ? cr[1][1] : ch == 2 ? cr[1][2] : pv;
      }
      kstep_sync<BF>(acc, r0, r1, w1i + s * FRAG_STEP, lane);
    }
#pragma unroll
    for (int j = 0; j < NT16; ++j) u_s[j * 32 + lane] = make_float4(acc[j][0], acc[j][1],
                                                                    acc[j][2], acc[j][3]);

    // the taps of the next view, loaded one view ahead
    const size_t esz = BF ? sizeof(__nv_bfloat16) : sizeof(float);
    const char* src_b = static_cast<const char*>(src) + size_t(b) * K * N * C * esz;
    const float* proj_b = proj + size_t(b) * K * 12;
    const float* ctr_b = centers + size_t(b) * K * 3;
    Taps<BF> tp[2];   // [row]
    auto fetch = [&](int dd, int vv) {
#pragma unroll
      for (int r = 0; r < 2; ++r)
        tp[r] = fetch_row<BF>(src_b + size_t(vv) * N * C * esz, proj_b + vv * 12,
                              planes[dd] * ray[r][0], planes[dd] * ray[r][1],
                              planes[dd] * ray[r][2], live[r], H, W, t);
    };
    fetch(d0, 0);

    uint32_t fh[4] = {0, 0, 0, 0}, fl[4] = {0, 0, 0, 0}, sh[4] = {0, 0, 0, 0},
             sl[4] = {0, 0, 0, 0};
    for (int d = d0; d < d1; ++d) {
      const float plane = planes[d];
      // the plane channel's product: bf16 operands in the bf16 mode
      const float plane_a = BF ? bf16r(plane) : plane;
#pragma unroll
      for (int j = 0; j < NT16; ++j) {
        float2 wp = *reinterpret_cast<const float2*>(vec_s + V_WP + 8 * j + 2 * t);
        if constexpr (BF) { wp.x = bf16r(wp.x); wp.y = bf16r(wp.y); }
        const float4 uj = u_s[j * 32 + lane];
        acc[j][0] = uj.x + plane_a * wp.x;
        acc[j][1] = uj.y + plane_a * wp.y;
        acc[j][2] = uj.z + plane_a * wp.x;
        acc[j][3] = uj.w + plane_a * wp.y;
      }
      // layer 1, per-plane rows: view v's features are K step v; the
      // scalars of views 2p and 2p+1 share step K + p. Each view's taps are
      // finished into its A fragment while the previous view's wgmmas run.
      float s0[4] = {0.f, 0.f, 0.f, 0.f}, s1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int v = 0; v < K; ++v) {
        ViewOut o[2];
#pragma unroll
        for (int r = 0; r < 2; ++r)
          o[r] = finish_row<BF>(tp[r], ctr_b + v * 3, plane * ray[r][0], plane * ray[r][1],
                                plane * ray[r][2], cr[r], cf[r], t);
        if (v + 1 < K) {
          fetch(d, v + 1);
        } else if (d + 1 < d1) {
          fetch(d + 1, 0);
        }
        if (v & 1) {   // odd view: cols 2t+8, 2t+9 of the shared step
          s0[2] = o[0].lo; s0[3] = o[0].hi; s1[2] = o[1].lo; s1[3] = o[1].hi;
        } else {       // even view: cols 2t, 2t+1
          s0[0] = o[0].lo; s0[1] = o[0].hi; s1[0] = o[1].lo; s1[1] = o[1].hi;
        }
        // the previous view's wgmmas must be done before their A registers
        // are written again
        wg_wait();
        pin(acc);
        pin(fh); pin(fl); pin(sh); pin(sl);
        const bool pair = (v & 1) || v == K - 1;
        if constexpr (BF) {
          round_a(o[0].f, o[1].f, fh);
          if (pair) round_a(s0, s1, sh);
        } else {
          split_a(o[0].f, o[1].f, fh, fl);
          if (pair) split_a(s0, s1, sh, sl);
        }
        if (pair) s0[2] = s0[3] = s1[2] = s1[3] = 0.f;
        wg_fence();
        wgmma_step<BF>(acc, fh, fl, w1p_a + v * 2 * TILE_BYTES);
        if (pair) wgmma_step<BF>(acc, sh, sl, w1p_a + (K + v / 2) * 2 * TILE_BYTES);
        wg_commit();
        pin(acc);
      }
      wg_wait();
      pin(acc);
      pin(fh); pin(fl); pin(sh); pin(sl);

      // H1 = leaky(acc) as layer 2's A fragments (hi, lo; the bf16 mode
      // rounds to hi only), K step s = hidden units 16s..16s+15 = column
      // groups 2s and 2s+1
      uint32_t hh[HID / 16][4], hl[BF ? 1 : HID / 16][4];
#pragma unroll
      for (int s = 0; s < HID / 16; ++s) {
        if constexpr (BF) {
          const float r0[4] = {leaky(acc[2 * s][0]), leaky(acc[2 * s][1]),
                               leaky(acc[2 * s + 1][0]), leaky(acc[2 * s + 1][1])};
          const float r1[4] = {leaky(acc[2 * s][2]), leaky(acc[2 * s][3]),
                               leaky(acc[2 * s + 1][2]), leaky(acc[2 * s + 1][3])};
          round_a(r0, r1, hh[s]);
        } else {
          split2(leaky(acc[2 * s][0]), leaky(acc[2 * s][1]), hh[s][0], hl[s][0]);
          split2(leaky(acc[2 * s][2]), leaky(acc[2 * s][3]), hh[s][1], hl[s][1]);
          split2(leaky(acc[2 * s + 1][0]), leaky(acc[2 * s + 1][1]), hh[s][2], hl[s][2]);
          split2(leaky(acc[2 * s + 1][2]), leaky(acc[2 * s + 1][3]), hh[s][3], hl[s][3]);
        }
      }
      // layer 2 in two halves of 64 units (half the accumulators):
      // score += leaky(b2 + H1 . W2) . w3
      float part0 = 0.f, part1 = 0.f;
#pragma unroll
      for (int nh2 = 0; nh2 < 2; ++nh2) {
        float a2[NT16 / 2][4];
#pragma unroll
        for (int j = 0; j < NT16 / 2; ++j) {
          const float2 bb =
              *reinterpret_cast<const float2*>(vec_s + V_B2 + 64 * nh2 + 8 * j + 2 * t);
          a2[j][0] = bb.x; a2[j][1] = bb.y; a2[j][2] = bb.x; a2[j][3] = bb.y;
        }
        pin(a2);
        wg_fence();
#pragma unroll
        for (int s = 0; s < HID / 16; ++s)
          wgmma_step<BF>(a2, hh[s], hl[BF ? 0 : s], w2_a + s * 2 * TILE_BYTES + nh2 * (NT16 / 2) * SBO);
        wg_commit();
        wg_wait();
        pin(a2);
#pragma unroll
        for (int s = 0; s < HID / 16; ++s) {
          pin(hh[s]);
          if constexpr (!BF) pin(hl[s]);
        }
#pragma unroll
        for (int j = 0; j < NT16 / 2; ++j) {
          float2 ww = *reinterpret_cast<const float2*>(vec_s + V_W3 + 64 * nh2 + 8 * j + 2 * t);
          if constexpr (BF) {   // the last product's operands in bf16, too
            ww.x = bf16r(ww.x); ww.y = bf16r(ww.y);
            part0 += bf16r(leaky(a2[j][0])) * ww.x + bf16r(leaky(a2[j][1])) * ww.y;
            part1 += bf16r(leaky(a2[j][2])) * ww.x + bf16r(leaky(a2[j][3])) * ww.y;
          } else {
            part0 += leaky(a2[j][0]) * ww.x + leaky(a2[j][1]) * ww.y;
            part1 += leaky(a2[j][2]) * ww.x + leaky(a2[j][3]) * ww.y;
          }
        }
      }
      part0 += __shfl_xor_sync(0xffffffffu, part0, 1);
      part0 += __shfl_xor_sync(0xffffffffu, part0, 2);
      part1 += __shfl_xor_sync(0xffffffffu, part1, 1);
      part1 += __shfl_xor_sync(0xffffffffu, part1, 2);
      float s = (hr ? part1 : part0) + vec_s[V_B3];

      if (use_hint) {
        const bool valid = hval > 0.5f;
        const float in3[3] = {s, valid ? fabsf(hdep - plane) : -1.f, valid ? hwt : 0.f};
        float g1[HH];
#pragma unroll
        for (int j = 0; j < HH; ++j) {
          float a = hw.b1[j];
#pragma unroll
          for (int i = 0; i < 3; ++i) a += in3[i] * hw.w1[i][j];
          g1[j] = leaky(a);
        }
        float a3 = hw.b3;
#pragma unroll
        for (int j = 0; j < HH; ++j) {
          float a = hw.b2[j];
#pragma unroll
          for (int i = 0; i < HH; ++i) a += g1[i] * hw.w2[i][j];
          a3 += leaky(a) * hw.w3[j];
        }
        s = a3;
      }
      if (t < 2 && live_h) out[(size_t(b) * D + d) * N + nh] = s;
    }
  }
}

// one instantiation per view count and mode: the view loop is unrolled, so
// the scalar pairing and the offsets are fixed at compile time
template <int K, bool BF>
int launch_mode(const void* cur, const void* src, const void* rays, const void* proj,
                const void* centers, const void* pose, const void* planes, const void* hint,
                const void* w1i, const void* w1p, const void* w2, const void* vec,
                const HintWeights& hw, void* out, int B, int H, int W, int D, int run,
                int blocks, int use_hint, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      fused_volume_kernel<K, BF>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem_bytes(K)));
  if (err != cudaSuccess) return int(err);
  fused_volume_kernel<K, BF><<<blocks, NT, smem_bytes(K), static_cast<cudaStream_t>(stream)>>>(
      cur, src, static_cast<const float*>(rays), static_cast<const float*>(proj),
      static_cast<const float*>(centers), static_cast<const float*>(pose),
      static_cast<const float*>(planes), static_cast<const float*>(hint),
      static_cast<const uint4*>(w1i), static_cast<const uint4*>(w1p),
      static_cast<const uint4*>(w2), static_cast<const float*>(vec), hw,
      static_cast<float*>(out), B, H, W, D, run, use_hint);
  return int(cudaGetLastError());
}

// the mode, then the view count
template <int K>
int launch(const void* cur, const void* src, const void* rays, const void* proj,
           const void* centers, const void* pose, const void* planes, const void* hint,
           const void* w1i, const void* w1p, const void* w2, const void* vec,
           const HintWeights& hw, void* out, int B, int H, int W, int D, int run, int blocks,
           int use_hint, int bf16, void* stream) {
  if (bf16)
    return launch_mode<K, true>(cur, src, rays, proj, centers, pose, planes, hint, w1i, w1p, w2,
                                vec, hw, out, B, H, W, D, run, blocks, use_hint, stream);
  return launch_mode<K, false>(cur, src, rays, proj, centers, pose, planes, hint, w1i, w1p, w2,
                               vec, hw, out, B, H, W, D, run, blocks, use_hint, stream);
}

}  // namespace

// cur and src are bf16 when bf16 != 0 (the bf16 mode), fp32 otherwise
extern "C" int fused_volume_launch(
    const void* cur, const void* src, const void* rays, const void* proj,
    const void* centers, const void* pose, const void* planes, const void* hint,
    const void* w1i, const void* w1p, const void* w2, const void* vec, const float* hint_w,
    void* out, int B, int K, int H, int W, int D, int run, int blocks, int use_hint, int bf16,
    void* stream) {
  if (K < 1 || K > KMAX || run < 1 || blocks < 1) return int(cudaErrorInvalidValue);
  HintWeights hw;   // host memory, copied into the launch's parameters
  memset(&hw, 0, sizeof(hw));
  if (use_hint) memcpy(&hw, hint_w, sizeof(hw));
#define DT_LAUNCH(KK)                                                                       \
  launch<KK>(cur, src, rays, proj, centers, pose, planes, hint, w1i, w1p, w2, vec, hw, out, B, \
             H, W, D, run, blocks, use_hint, bf16, stream)
  switch (K) {
    case 1: return DT_LAUNCH(1);
    case 2: return DT_LAUNCH(2);
    case 3: return DT_LAUNCH(3);
    case 4: return DT_LAUNCH(4);
    case 5: return DT_LAUNCH(5);
    case 6: return DT_LAUNCH(6);
    case 7: return DT_LAUNCH(7);
    default: return DT_LAUNCH(8);
  }
#undef DT_LAUNCH
}
