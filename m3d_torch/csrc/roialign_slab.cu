// Slab pyramid ROIAlign for Hopper (sm_90a): per-axis weights acting on a
// slab of a pyramid level, for the rows inside `bounds`.
//
// Replaces the TPU kernel m3d/ops/pallas_roialign.py:_kernel (entry
// pallas_pyramid_roi_align). Same contract, other mechanics: the TPU kernel
// DMAs each ROI's [Sy, Sx, SZ, Ck] slab into VMEM and contracts it with
// three dense [p, S] weight matrices on the MXU; here each output sample is
// a sum over the nonzero weight entries only.
//
// Contract, per row i (levels, batch, origins [N, 3], wy [N, p, sy],
// wx [N, p, sx], wz [N, p, sz] f32, bounds = (offset, count) on the device):
//   offset <= i < offset + count:
//     out[i, y, x, z, :] = sum_{a, b, k} wy[i, y, a] * wx[i, x, b]
//                          * wz[i, z, k] * F_lvl[bat, oy + a, ox + b, oz + k, :]
//     where a voxel at or beyond the level's extent reads 0 (the TPU entry
//     zero-pads its levels to the slab; here the bound is checked instead).
//   other rows: zeros (the TPU kernel leaves them unwritten).
// Exact for any weights: each row's nonzero (coordinate, weight) pairs are
// compacted into shared memory first (at most 2 per sample position from
// _axis_slab_weights, so an 8-tap sum in practice). Features are
// [B, H, W, D, C] channels-last bf16; the sum is f32, rounded once to bf16.
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16): memory. Every row of
// the output is written (rows outside `bounds` as zeros), p^3 * C * 2 bytes
// a row; the live rows read at most their 8-tap footprint. The arithmetic,
// ~16 flops per live output element, is far below.
// Design: one block per (row, output y-plane), as the compact kernel;
// threads run along C two channels at a time, so tap reads and output
// writes are coalesced 128-byte runs; the output is written once with
// streaming stores. `bounds` is read on the device: no host sync.

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

// Compacts the nonzero in-extent entries of one weight row w[0..s) into
// (coordinate, weight) pairs; returns their count.
__device__ int compact_row(const float* w, int s, int origin, int dim,
                           int* col, float* wt) {
  int n = 0;
  for (int k = 0; k < s; ++k) {
    float v = w[k];
    int coord = origin + k;
    if (v != 0.f && coord >= 0 && coord < dim) {
      col[n] = coord;
      wt[n] = v;
      ++n;
    }
  }
  return n;
}

__global__ void roialign_slab_kernel(Levels L, const int* __restrict__ lvl,
                                     const int* __restrict__ bat,
                                     const int* __restrict__ origins,
                                     const float* __restrict__ wy,
                                     const float* __restrict__ wx,
                                     const float* __restrict__ wz,
                                     const int* __restrict__ bounds,
                                     __nv_bfloat16* __restrict__ out, int p,
                                     int sy, int sx, int sz, int c) {
  const int row = blockIdx.y;
  const int iy = blockIdx.x;
  const int plane = p * p;
  __nv_bfloat16* o = out + ((size_t)row * p + iy) * plane * c;
  const int tid_c = threadIdx.x;
  const int tid_q = threadIdx.y;
  const int off = bounds[0], cnt = bounds[1];

  if (row < off || row >= off + cnt) {
    for (int q = tid_q; q < plane; q += blockDim.y)
      for (int cc = 2 * tid_c; cc < c; cc += 2 * blockDim.x)
        store2(o + (size_t)q * c + cc, 0.f, 0.f);
    return;
  }

  // Shared memory: compacted taps of this row's y entry and of every x and
  // z sample position.
  extern __shared__ unsigned char smem[];
  int* ny = reinterpret_cast<int*>(smem);            // [1]
  int* nx = ny + 1;                                  // [p]
  int* nz = nx + p;                                  // [p]
  int* cy = nz + p;                                  // [sy]
  int* cx = cy + sy;                                 // [p * sx]
  int* cz = cx + p * sx;                             // [p * sz]
  float* wyc = reinterpret_cast<float*>(cz + p * sz);  // [sy]
  float* wxc = wyc + sy;                             // [p * sx]
  float* wzc = wxc + p * sx;                         // [p * sz]

  const int l = lvl[row];
  const int H = L.h[l], W = L.w[l], D = L.d[l];
  const int tid = tid_q * blockDim.x + tid_c;
  if (tid == 0)
    ny[0] = compact_row(wy + ((size_t)row * p + iy) * sy, sy,
                        origins[row * 3 + 0], H, cy, wyc);
  else if (tid <= p) {
    const int i = tid - 1;
    nx[i] = compact_row(wx + ((size_t)row * p + i) * sx, sx,
                        origins[row * 3 + 1], W, cx + i * sx, wxc + i * sx);
  } else if (tid <= 2 * p) {
    const int i = tid - 1 - p;
    nz[i] = compact_row(wz + ((size_t)row * p + i) * sz, sz,
                        origins[row * 3 + 2], D, cz + i * sz, wzc + i * sz);
  }
  __syncthreads();

  const __nv_bfloat16* f = static_cast<const __nv_bfloat16*>(L.ptr[l]) +
                           (size_t)bat[row] * H * W * D * c;
  const size_t sY = (size_t)W * D * c, sX = (size_t)D * c;
  const int nyy = ny[0];

  for (int q = tid_q; q < plane; q += blockDim.y) {
    const int ix = q / p, iz = q % p;
    const int nxx = nx[ix], nzz = nz[iz];
    const int* cxr = cx + ix * sx;
    const float* wxr = wxc + ix * sx;
    const int* czr = cz + iz * sz;
    const float* wzr = wzc + iz * sz;
    for (int cc = 2 * tid_c; cc < c; cc += 2 * blockDim.x) {
      float a = 0.f, b = 0.f;
      for (int ty = 0; ty < nyy; ++ty) {
        const __nv_bfloat16* fy = f + cy[ty] * sY + cc;
        for (int tx = 0; tx < nxx; ++tx) {
          const float wyx = wyc[ty] * wxr[tx];
          const __nv_bfloat16* fyx = fy + cxr[tx] * sX;
          for (int tz = 0; tz < nzz; ++tz) {
            const float w = wyx * wzr[tz];
            const float2 v = load2(fyx + (size_t)czr[tz] * c);
            a += w * v.x;
            b += w * v.y;
          }
        }
      }
      store2(o + (size_t)q * c + cc, a, b);
    }
  }
}

}  // namespace

// Returns the cudaError_t of the launch (0 = ok).
extern "C" int roialign_slab_launch(
    const void* f2, const void* f3, const void* f4, const void* f5,
    int h2, int w2, int d2, int h3, int w3, int d3,
    int h4, int w4, int d4, int h5, int w5, int d5,
    const void* lvl, const void* bat, const void* origins, const void* wy,
    const void* wx, const void* wz, const void* bounds, void* out, int n,
    int p, int sy, int sx, int sz, int c, void* stream) {
  if (n <= 0 || p <= 0 || c <= 0 || (c & 1) || sy <= 0 || sx <= 0 ||
      sz <= 0)
    return (int)cudaErrorInvalidValue;
  Levels L;
  L.ptr[0] = f2; L.ptr[1] = f3; L.ptr[2] = f4; L.ptr[3] = f5;
  L.h[0] = h2; L.w[0] = w2; L.d[0] = d2;
  L.h[1] = h3; L.w[1] = w3; L.d[1] = d3;
  L.h[2] = h4; L.w[2] = w4; L.d[2] = d4;
  L.h[3] = h5; L.w[3] = w5; L.d[3] = d5;
  int bx = c / 2 < 128 ? c / 2 : 128;
  int by = 256 / bx;
  if (by < 1) by = 1;
  if (bx * by < 2 * p + 1) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(1 + 2 * p + sy + p * sx + p * sz) * 4 +
                      (size_t)(sy + p * sx + p * sz) * 4;
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  dim3 block(bx, by);
  dim3 grid(p, n);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  roialign_slab_kernel<<<grid, block, smem, s>>>(
      L, static_cast<const int*>(lvl), static_cast<const int*>(bat),
      static_cast<const int*>(origins), static_cast<const float*>(wy),
      static_cast<const float*>(wx), static_cast<const float*>(wz),
      static_cast<const int*>(bounds), static_cast<__nv_bfloat16*>(out), p,
      sy, sx, sz, c);
  return (int)cudaGetLastError();
}
