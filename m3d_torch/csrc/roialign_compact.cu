// Compact pyramid ROIAlign for Hopper (sm_90a), the mask stage of adaptive
// inference (and, through the padded entry, of the monolithic graph).
//
// Replaces the TPU kernel m3d/ops/pallas_roialign.py:_kernel_vmem_compact
// (entry pallas_pyramid_roi_align_vmem_compact). Same function, other
// mechanics: the TPU kernel keeps one image's whole pyramid resident in VMEM
// and contracts dense [p, Smax] weight matrices on the MXU; here each output
// sample is the clamped trilinear interpolation those dense weights reduce
// to, computed separably.
//
// Contract, per flat ROI row i (rows grouped by image, live rows first):
//   i <  *total: out[i, y, x, z, :] = sum over the 8 corners of
//                F_lvl[i][bat[i], yc, xc, zc, :] * wy * wx * wz,
//                with pos clamped to [0, dim-1], i0 = floor(pos),
//                i1 = min(i0 + 1, dim - 1), w1 = pos - i0. A sample whose
//                unclamped position lies outside [0, dim-1] on any axis is 0,
//                and so is a non-finite sum (the JAX wrapper's NaN scrub).
//   i >= *total: zeros. `total` is read here, on the device: no host sync.
// Features are [B, H, W, D, C] channels-last bf16 (C % 8 == 0); the sums are
// taken in f32 and rounded once to bf16.
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16): memory. At the bench
// step (N = 200 rows, 159 live, p = 14, C = 256, bf16) the live rows write
// 159 * 14^3 * 256 * 2 B = 223 MB, the zeroed rows 58 MB more, and the taps
// the live rows touch are 41 MB: 322 MB, ~96 us at 3.35 TB/s. The
// arithmetic, ~16 flops per output element, is far below.
//
// Design: every byte moves once, 16 bytes at a time, with no shared memory
// and no barrier. One warp per output x-line (row, y, x): 32 lanes x 8
// channels cover 256 channels, so each load and store of the warp is one
// contiguous 512-byte run. The warp interpolates in y and then in x from the
// four (y, x) corner lines at each z coordinate its samples touch, keeping
// the last two in registers: samples walk z upwards, so every distinct z
// coordinate is loaded and interpolated once (a line of p samples reads
// about p + 1 of them, not 2p). Each output sample is then the z
// interpolation of the two cached values, written with a 16-byte streaming
// store. Dead rows, and lines whose y or x sample lies outside the level,
// are written as zeros the same way, without reading anything. Many warps
// per SM (no shared memory limits them) keep enough loads in flight to
// cover memory latency. The f32 rounding follows the separable order
// (y, x, z), not the JAX gather's (wy * wx) * wz order; the difference
// stays far inside one bf16 rounding of the output.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;   // 8 warps, 8 output lines

struct Levels {
  const void* ptr[4];
  int h[4], w[4], d[4];
};

struct Corner {
  int i0, i1;
  float w0, w1;
  bool in;
};

__device__ __forceinline__ Corner corner(float pos, int dim) {
  Corner c;
  float hi = (float)(dim - 1);
  c.in = (pos >= 0.f) && (pos <= hi);  // false for NaN, as in JAX
  float pc = fminf(fmaxf(pos, 0.f), hi);
  float f0 = floorf(pc);
  c.w1 = pc - f0;
  c.w0 = 1.f - c.w1;
  c.i0 = (int)f0;
  c.i1 = min(c.i0 + 1, dim - 1);
  if (!c.in) {  // keep reads in range; the sample is zeroed
    c.i0 = 0;
    c.i1 = 0;
  }
  return c;
}

__device__ __forceinline__ void lerp8(float* acc, uint4 u, float w) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 v = __bfloat1622float2(h[j]);
    acc[2 * j] += w * v.x;
    acc[2 * j + 1] += w * v.y;
  }
}

__device__ __forceinline__ uint32_t pack2(float a, float b) {
  __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&h);
}

// G(z) for 8 channels: the y-then-x interpolation at z coordinate z.
__device__ __forceinline__ void yx_lerp(const __nv_bfloat16* r00,
                                        const __nv_bfloat16* r01,
                                        const __nv_bfloat16* r10,
                                        const __nv_bfloat16* r11, float wy0,
                                        float wy1, float wx0, float wx1,
                                        size_t off, float* g) {
  const uint4 a00 = __ldg(reinterpret_cast<const uint4*>(r00 + off));
  const uint4 a01 = __ldg(reinterpret_cast<const uint4*>(r01 + off));
  const uint4 a10 = __ldg(reinterpret_cast<const uint4*>(r10 + off));
  const uint4 a11 = __ldg(reinterpret_cast<const uint4*>(r11 + off));
  float x0[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  float x1[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  lerp8(x0, a00, wy0);  // (y0, x0)
  lerp8(x0, a10, wy1);  // (y1, x0)
  lerp8(x1, a01, wy0);  // (y0, x1)
  lerp8(x1, a11, wy1);  // (y1, x1)
#pragma unroll
  for (int j = 0; j < 8; ++j) g[j] = wx0 * x0[j] + wx1 * x1[j];
}

__global__ void __launch_bounds__(THREADS)
roialign_compact_kernel(const __grid_constant__ Levels L,
                        const int* __restrict__ lvl,
                        const int* __restrict__ bat,
                        const int* __restrict__ total_ptr,
                        const float* __restrict__ pos,
                        __nv_bfloat16* __restrict__ out, int n, int p, int c) {
  const long long wid = (long long)blockIdx.x * (THREADS / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (wid >= (long long)n * p * p) return;
  const int row = (int)(wid / (p * p));
  const int iy = (int)(wid / p) % p, ix = (int)(wid % p);
  const int cvs = c / 8;
  uint4* o = reinterpret_cast<uint4*>(out) + wid * p * cvs;
  const uint4 zero = make_uint4(0, 0, 0, 0);
  const float* pr = pos + (size_t)row * 3 * p;
  const int l = row < *total_ptr ? lvl[row] : 0;
  const int H = L.h[l], W = L.w[l], D = L.d[l];
  const Corner cy = corner(pr[iy], H), cx = corner(pr[p + ix], W);
  if (row >= *total_ptr || !cy.in || !cx.in) {  // a line of zeros
    for (int i = lane; i < p * cvs; i += 32) __stcs(o + i, zero);
    return;
  }
  const __nv_bfloat16* f = static_cast<const __nv_bfloat16*>(L.ptr[l]) +
                           (size_t)bat[row] * H * W * D * c;
  const __nv_bfloat16* r00 = f + ((size_t)cy.i0 * W + cx.i0) * D * c;
  const __nv_bfloat16* r01 = f + ((size_t)cy.i0 * W + cx.i1) * D * c;
  const __nv_bfloat16* r10 = f + ((size_t)cy.i1 * W + cx.i0) * D * c;
  const __nv_bfloat16* r11 = f + ((size_t)cy.i1 * W + cx.i1) * D * c;
  for (int cv = lane; cv < cvs; cv += 32) {
    // Two cached z rows of G; samples walk z upwards, so each distinct
    // coordinate is interpolated once.
    float ga[8], gb[8];
    int za = -1, zb = -1;
    for (int iz = 0; iz < p; ++iz) {
      const Corner z = corner(pr[2 * p + iz], D);
      uint4 r = zero;
      if (z.in) {
        if (z.i0 == zb) {
#pragma unroll
          for (int j = 0; j < 8; ++j) ga[j] = gb[j];
          za = zb;
        }
        if (z.i0 != za) {
          yx_lerp(r00, r01, r10, r11, cy.w0, cy.w1, cx.w0, cx.w1,
                  (size_t)z.i0 * c + cv * 8, ga);
          za = z.i0;
        }
        if (z.i1 != za && z.i1 != zb) {
          yx_lerp(r00, r01, r10, r11, cy.w0, cy.w1, cx.w0, cx.w1,
                  (size_t)z.i1 * c + cv * 8, gb);
          zb = z.i1;
        }
        float s[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          s[j] = z.w0 * ga[j] + z.w1 * (z.i1 == za ? ga[j] : gb[j]);
          if (!isfinite(s[j])) s[j] = 0.f;
        }
        r = make_uint4(pack2(s[0], s[1]), pack2(s[2], s[3]),
                       pack2(s[4], s[5]), pack2(s[6], s[7]));
      }
      __stcs(o + iz * cvs + cv, r);
    }
  }
}

}  // namespace

// Returns the cudaError_t of the launch (0 = ok).
extern "C" int roialign_compact_launch(
    const void* f2, const void* f3, const void* f4, const void* f5,
    int h2, int w2, int d2, int h3, int w3, int d3,
    int h4, int w4, int d4, int h5, int w5, int d5,
    const void* lvl, const void* bat, const void* total, const void* pos,
    void* out, int n, int p, int c, void* stream) {
  if (n <= 0 || p <= 0 || c <= 0 || c % 8)
    return (int)cudaErrorInvalidValue;
  Levels L;
  L.ptr[0] = f2; L.ptr[1] = f3; L.ptr[2] = f4; L.ptr[3] = f5;
  L.h[0] = h2; L.w[0] = w2; L.d[0] = d2;
  L.h[1] = h3; L.w[1] = w3; L.d[1] = d3;
  L.h[2] = h4; L.w[2] = w4; L.d[2] = d4;
  L.h[3] = h5; L.w[3] = w5; L.d[3] = d5;
  const long long lines = (long long)n * p * p;
  const int blocks = (int)((lines + THREADS / 32 - 1) / (THREADS / 32));
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  roialign_compact_kernel<<<blocks, THREADS, 0, s>>>(
      L, static_cast<const int*>(lvl), static_cast<const int*>(bat),
      static_cast<const int*>(total), static_cast<const float*>(pos),
      static_cast<__nv_bfloat16*>(out), n, p, c);
  return (int)cudaGetLastError();
}
