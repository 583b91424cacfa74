// Compact pyramid ROIAlign for Hopper (sm_90a), the mask stage of adaptive
// inference.
//
// Replaces the TPU kernel m3d/ops/pallas_roialign.py:_kernel_vmem_compact
// (entry pallas_pyramid_roi_align_vmem_compact). Same function, other
// mechanics: the TPU kernel keeps one image's whole pyramid resident in VMEM
// and contracts dense [p, Smax] weight matrices on the MXU; here each output
// sample is the 8-tap clamped trilinear sum those dense weights reduce to.
//
// Contract, per flat ROI row i (rows grouped by image, live rows first):
//   i <  *total: out[i, y, x, z, :] = sum over the 8 corners of
//                F_lvl[i][bat[i], yc, xc, zc, :] * wy * wx * wz,
//                with pos clamped to [0, dim-1], i0 = floor(pos),
//                i1 = min(i0 + 1, dim - 1), w1 = pos - i0. A sample whose
//                unclamped position lies outside [0, dim-1] on any axis is 0,
//                and so is a non-finite sum (the JAX wrapper's NaN scrub).
//   i >= *total: zeros. `total` is read here, on the device: no host sync.
// Features are [B, H, W, D, C] channels-last bf16; the sum is taken in f32
// and rounded once to bf16.
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16): memory. At the bench
// step (N = 200 rows, 159 live, p = 14, C = 256, bf16) the live rows write
// 159 * 14^3 * 256 * 2 B = 223 MB, the zeroed rows 58 MB more, and the taps
// the live rows touch are 41 MB: 322 MB, ~96 us at 3.35 TB/s. The
// arithmetic, ~16 flops per output element, is far below.
// Design: one block per (row, output y-plane); threads run along the channel
// axis two channels at a time, so every tap read and every output write of a
// warp is one contiguous, coalesced 128-byte run. Neighbouring samples share
// most taps, which then come from L1/L2; the output is written exactly once,
// with streaming stores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Levels {
  const void* ptr[4];
  int h[4], w[4], d[4];
};

__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  unsigned int u = __ldg(reinterpret_cast<const unsigned int*>(p));
  __nv_bfloat162 v = *reinterpret_cast<__nv_bfloat162*>(&u);
  return __bfloat1622float2(v);
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  __stcs(reinterpret_cast<unsigned int*>(p),
         *reinterpret_cast<unsigned int*>(&v));
}

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
  if (!c.in) {  // keep reads in range; the sample is zeroed below
    c.i0 = 0;
    c.i1 = 0;
  }
  return c;
}

__global__ void roialign_compact_kernel(Levels L, const int* __restrict__ lvl,
                                        const int* __restrict__ bat,
                                        const int* __restrict__ total_ptr,
                                        const float* __restrict__ pos,
                                        __nv_bfloat16* __restrict__ out, int p,
                                        int c) {
  const int row = blockIdx.y;
  const int iy = blockIdx.x;
  const int plane = p * p;
  __nv_bfloat16* o = out + ((size_t)row * p + iy) * plane * c;
  const int tid_c = threadIdx.x;
  const int tid_q = threadIdx.y;

  if (row >= *total_ptr) {
    for (int q = tid_q; q < plane; q += blockDim.y)
      for (int cc = 2 * tid_c; cc < c; cc += 2 * blockDim.x)
        store2(o + (size_t)q * c + cc, 0.f, 0.f);
    return;
  }

  const int l = lvl[row];
  const int b = bat[row];
  const int H = L.h[l], W = L.w[l], D = L.d[l];
  const __nv_bfloat16* f =
      static_cast<const __nv_bfloat16*>(L.ptr[l]) + (size_t)b * H * W * D * c;
  const float* py = pos + (size_t)row * 3 * p;
  const float* px = py + p;
  const float* pz = px + p;

  const Corner cy = corner(py[iy], H);
  const size_t ry0 = (size_t)cy.i0 * W * D * c;
  const size_t ry1 = (size_t)cy.i1 * W * D * c;

  for (int q = tid_q; q < plane; q += blockDim.y) {
    const Corner cx = corner(px[q / p], W);
    const Corner cz = corner(pz[q % p], D);
    const bool in = cy.in && cx.in && cz.in;
    const size_t rx0 = (size_t)cx.i0 * D * c, rx1 = (size_t)cx.i1 * D * c;
    const size_t rz0 = (size_t)cz.i0 * c, rz1 = (size_t)cz.i1 * c;
    // Weights in the JAX gather's order: (wy * wx) * wz.
    const float w000 = cy.w0 * cx.w0 * cz.w0, w001 = cy.w0 * cx.w0 * cz.w1;
    const float w010 = cy.w0 * cx.w1 * cz.w0, w011 = cy.w0 * cx.w1 * cz.w1;
    const float w100 = cy.w1 * cx.w0 * cz.w0, w101 = cy.w1 * cx.w0 * cz.w1;
    const float w110 = cy.w1 * cx.w1 * cz.w0, w111 = cy.w1 * cx.w1 * cz.w1;
    const __nv_bfloat16* t000 = f + ry0 + rx0 + rz0;
    const __nv_bfloat16* t001 = f + ry0 + rx0 + rz1;
    const __nv_bfloat16* t010 = f + ry0 + rx1 + rz0;
    const __nv_bfloat16* t011 = f + ry0 + rx1 + rz1;
    const __nv_bfloat16* t100 = f + ry1 + rx0 + rz0;
    const __nv_bfloat16* t101 = f + ry1 + rx0 + rz1;
    const __nv_bfloat16* t110 = f + ry1 + rx1 + rz0;
    const __nv_bfloat16* t111 = f + ry1 + rx1 + rz1;
    for (int cc = 2 * tid_c; cc < c; cc += 2 * blockDim.x) {
      float2 v000 = load2(t000 + cc), v001 = load2(t001 + cc);
      float2 v010 = load2(t010 + cc), v011 = load2(t011 + cc);
      float2 v100 = load2(t100 + cc), v101 = load2(t101 + cc);
      float2 v110 = load2(t110 + cc), v111 = load2(t111 + cc);
      float a = 0.f, bb = 0.f;
      a += v000.x * w000; bb += v000.y * w000;
      a += v001.x * w001; bb += v001.y * w001;
      a += v010.x * w010; bb += v010.y * w010;
      a += v011.x * w011; bb += v011.y * w011;
      a += v100.x * w100; bb += v100.y * w100;
      a += v101.x * w101; bb += v101.y * w101;
      a += v110.x * w110; bb += v110.y * w110;
      a += v111.x * w111; bb += v111.y * w111;
      if (!in) { a = 0.f; bb = 0.f; }
      if (!isfinite(a)) a = 0.f;
      if (!isfinite(bb)) bb = 0.f;
      store2(o + (size_t)q * c + cc, a, bb);
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
  if (n <= 0 || p <= 0 || c <= 0 || (c & 1)) return (int)cudaErrorInvalidValue;
  Levels L;
  L.ptr[0] = f2; L.ptr[1] = f3; L.ptr[2] = f4; L.ptr[3] = f5;
  L.h[0] = h2; L.w[0] = w2; L.d[0] = d2;
  L.h[1] = h3; L.w[1] = w3; L.d[1] = d3;
  L.h[2] = h4; L.w[2] = w4; L.d[2] = d4;
  L.h[3] = h5; L.w[3] = w5; L.d[3] = d5;
  int bx = c / 2 < 128 ? c / 2 : 128;
  int by = 256 / bx;
  if (by < 1) by = 1;
  dim3 block(bx, by);
  dim3 grid(p, n);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  roialign_compact_kernel<<<grid, block, 0, s>>>(
      L, static_cast<const int*>(lvl), static_cast<const int*>(bat),
      static_cast<const int*>(total), static_cast<const float*>(pos),
      static_cast<__nv_bfloat16*>(out), p, c);
  return (int)cudaGetLastError();
}
