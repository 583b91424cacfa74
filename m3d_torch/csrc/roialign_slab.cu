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
//     zero-pads its levels to the slab; here the bound is checked instead)
//     and no voxel is read whose taps all have weight 0.
//   other rows: zeros (the TPU kernel leaves them unwritten).
// Exact for any weights. Features are [B, H, W, D, C] channels-last bf16
// (any even C); the sum is f32, rounded once to bf16.
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16): memory. At the bench
// step (N = 2000 rows, p = 7, C = 256, bf16) every row is written, 2000 *
// 7^3 * 256 * 2 B = 351 MB, ~0.105 ms at 3.35 TB/s; the forced-fallback
// batch's ~1930 live rows read ~62 MB of distinct voxels and weights more
// (0.123 ms in all), the monolithic path's 43 live rows ~21 MB (0.111 ms).
// The arithmetic, ~16 flops per output element over 8 scattered taps, is
// far below, and it is no matrix product: tensor cores and TMA have nothing
// to take here. What the bound does not count: the live rows overlap (ROIs
// cluster on objects), and each row reads its own footprint, so the
// forced-fallback batch moves ~40x its distinct voxels from L2 to the SMs.
//
// Design: one block per row, two warps per output y plane (14 at p = 7),
// each walking output x-lines (row, y, x).
//  - Rows in bounds take the first blocks, so on a batch of few live rows
//    their loads overlap the dead rows' stores instead of trailing them.
//  - Dead rows: the block writes zeros with 16-byte streaming stores and
//    reads nothing else.
//  - Prologue: the block stages the row's weights in shared memory, one
//    coalesced load each; then each warp compacts whole weight rows (axis,
//    sample) in place: lane k tests column k (nonzero and inside the
//    level), and a ballot with popc gives each kept tap its slot in a table
//    of (coordinate, weight) entries. The same barrier ORs one flag: the
//    row is *general* if some (sample, axis) keeps more than 2 taps, *fast*
//    otherwise (axis_slab_weights always gives the fast form: taps i0 and
//    i0 + 1).
//  - Fast rows, the compact kernel's line walk: 32 lanes x 8 channels, so
//    each load and store of the warp is one 512-byte run. At each distinct
//    z coordinate the line's samples touch, the warp forms G(z), the y-x
//    interpolation of the four corner lines (one FMA per corner, the four
//    loads issued together; eight when a sample needs two new coordinates,
//    as samples more than a voxel apart do), and keeps the last two in
//    registers, so each coordinate is read once per line. Each output
//    sample is the z interpolation of the cached values, written with a
//    16-byte streaming store.
//  - General rows: the same warp-per-line layout, looping over the
//    compacted taps (rare; speed does not matter).
//  - C % 8 != 0 (or unaligned features): the same code with 4-byte, two-
//    channel accesses.
// The f32 rounding follows the separable order (y-x, then z), not the plain
// version's; the difference stays far inside one bf16 rounding.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_WARPS = 14;
constexpr size_t MAX_SMEM = 227 * 1024;

struct Levels {
  const void* ptr[4];
  int h[4], w[4], d[4];
};

// V bf16 channels per lane access: 8 (16 bytes) or 2 (4 bytes).
template <int V>
struct Vec;

template <>
struct Vec<8> {
  using T = uint4;
  static __device__ __forceinline__ T load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  static __device__ __forceinline__ T zero() { return make_uint4(0, 0, 0, 0); }
};

template <>
struct Vec<2> {
  using T = unsigned int;
  static __device__ __forceinline__ T load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const unsigned int*>(p));
  }
  static __device__ __forceinline__ T zero() { return 0u; }
};

template <int V>
__device__ __forceinline__ void fma_v(float* acc, typename Vec<V>::T u,
                                      float w) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int j = 0; j < V / 2; ++j) {
    const float2 v = __bfloat1622float2(h[j]);
    acc[2 * j] += w * v.x;
    acc[2 * j + 1] += w * v.y;
  }
}

template <int V>
__device__ __forceinline__ typename Vec<V>::T pack(const float* s) {
  typename Vec<V>::T u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int j = 0; j < V / 2; ++j)
    h[j] = __floats2bfloat162_rn(s[2 * j], s[2 * j + 1]);
  return u;
}

// One output x-line's y and x taps (fast form: at most two each): its
// four corner lines and their weights wy * wx. An absent second tap
// repeats the first tap's line with weight 0, so no other voxel is read
// and, for finite features, the sum is the same to the bit.
struct LineTaps {
  const __nv_bfloat16 *r00, *r01, *r10, *r11;  // corner lines (y, x)
  float w00, w01, w10, w11;
};

// G(z) for V channels at K z coordinates (element offsets off[k] of z and
// channel into the corner lines): the y-x interpolation, one FMA per
// corner. All 4K loads are unconditional and issued before the sums, so
// they are in flight together (loads under a condition were issued apart).
template <int V, int K>
__device__ __forceinline__ void yx_lerp(const LineTaps& t,
                                        const unsigned* off, float (*g)[V]) {
  typename Vec<V>::T a[K][4];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    a[k][0] = Vec<V>::load(t.r00 + off[k]);
    a[k][1] = Vec<V>::load(t.r01 + off[k]);
    a[k][2] = Vec<V>::load(t.r10 + off[k]);
    a[k][3] = Vec<V>::load(t.r11 + off[k]);
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int j = 0; j < V; ++j) g[k][j] = 0.f;
    fma_v<V>(g[k], a[k][0], t.w00);
    fma_v<V>(g[k], a[k][2], t.w10);
    fma_v<V>(g[k], a[k][1], t.w01);
    fma_v<V>(g[k], a[k][3], t.w11);
  }
}

// A fast line: zt[iz] holds sample iz's z taps (c0, c1, w0, w1); c0 < 0
// for none, c1 == c0 and w1 == 0 for one.
template <int V>
__device__ __forceinline__ void fast_line(const LineTaps& t, const int4* zt,
                                          int p, int c, int cvs, int lane,
                                          typename Vec<V>::T* ol) {
  for (int cv = lane; cv < cvs; cv += 32) {
    // Two cached z coordinates of G, g[0] at za and g[1] at zb; samples
    // usually walk z upwards, so each distinct coordinate is interpolated
    // once.
    float g[2][V];
    int za = -1, zb = -1;
    for (int iz = 0; iz < p; ++iz) {
      const int4 e = zt[iz];
      typename Vec<V>::T r = Vec<V>::zero();
      if (e.x >= 0) {
        const int c0 = e.x, c1 = e.y;
        const bool two = c1 != c0;
        const float w0 = __int_as_float(e.z), w1 = __int_as_float(e.w);
        // In-line element offsets of the two coordinates (32-bit: one
        // z line of one level).
        const unsigned o[2] = {(unsigned)(c0 * c + cv * V),
                               (unsigned)(c1 * c + cv * V)};
        if (two && c0 != za && c0 != zb && c1 != za && c1 != zb) {
          // Both coordinates new (samples more than a voxel apart).
          yx_lerp<V, 2>(t, o, g);
          za = c0;
          zb = c1;
        } else {
          if (c0 == zb) {
#pragma unroll
            for (int j = 0; j < V; ++j) g[0][j] = g[1][j];
            za = zb;
          }
          if (c0 != za) {
            yx_lerp<V, 1>(t, o, g);
            za = c0;
          }
          if (c1 != za && c1 != zb) {
            yx_lerp<V, 1>(t, o + 1, g + 1);
            zb = c1;
          }
        }
        // Here g[0] = G(c0) and, with two taps (c1 != c0), g[1] = G(c1).
        float s[V];
#pragma unroll
        for (int j = 0; j < V; ++j) {
          s[j] = w0 * g[0][j];
          if (two) s[j] += w1 * g[1][j];
        }
        r = pack<V>(s);
      }
      __stcs(ol + iz * cvs + cv, r);
    }
  }
}

// A general line: any number of taps on each axis.
template <int V>
__device__ __forceinline__ void general_line(
    const __nv_bfloat16* f, size_t sY, size_t sX, const int* cy,
    const float* wy, int ny, const int* cx, const float* wx, int nx,
    const int* cz, const float* wz, const int* nz, int sz, int p, int c,
    int cvs, int lane, typename Vec<V>::T* ol) {
  for (int cv = lane; cv < cvs; cv += 32) {
    for (int iz = 0; iz < p; ++iz) {
      float acc[V];
#pragma unroll
      for (int j = 0; j < V; ++j) acc[j] = 0.f;
      for (int tz = 0; tz < nz[iz]; ++tz) {
        const float wzt = wz[iz * sz + tz];
        const __nv_bfloat16* fz = f + (size_t)cz[iz * sz + tz] * c + cv * V;
        for (int ty = 0; ty < ny; ++ty) {
          const float wyz = wy[ty] * wzt;
          const __nv_bfloat16* fy = fz + cy[ty] * sY;
          for (int tx = 0; tx < nx; ++tx)
            fma_v<V>(acc, Vec<V>::load(fy + cx[tx] * sX), wyz * wx[tx]);
        }
      }
      __stcs(ol + iz * cvs + cv, pack<V>(acc));
    }
  }
}

template <int V>
__global__ void __launch_bounds__(MAX_WARPS * 32)
roialign_slab_kernel(const __grid_constant__ Levels L,
                     const int* __restrict__ lvl, const int* __restrict__ bat,
                     const int* __restrict__ origins,
                     const float* __restrict__ wy,
                     const float* __restrict__ wx,
                     const float* __restrict__ wz,
                     const int* __restrict__ bounds,
                     __nv_bfloat16* __restrict__ out, int n, int p, int sy,
                     int sx, int sz, int c) {
  using VT = typename Vec<V>::T;
  // Rows in bounds [lo, hi) take the first blocks, so their loads overlap
  // the dead rows' stores instead of trailing them.
  const long long off = bounds[0], cnt = bounds[1];
  const long long lo = off < 0 ? 0 : off > n ? n : off;
  const int row = (int)((lo + blockIdx.x) % n);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nw = blockDim.x >> 5;
  const int cvs = c / V;
  const int plane = p * p;
  VT* o = reinterpret_cast<VT*>(out + (size_t)row * plane * p * c);

  if (row < off || row >= off + cnt) {  // a dead row: zeros, nothing read
    const int nv = plane * p * cvs;
    for (int i = threadIdx.x; i < nv; i += blockDim.x)
      __stcs(o + i, Vec<V>::zero());
    return;
  }

  // Shared table of this row's taps: per axis a and sample i, up to s_a
  // (coordinate, weight) entries at tab_a + i * s_a, and their count. The
  // weights are first staged there by the whole block, one load each. The
  // fast path reads each sample's z taps as one int4 of zt.
  extern __shared__ int4 smem[];
  const int per_row = p * (sy + sx + sz);
  int4* zt = smem;                                // [p]
  int* cnt_s = reinterpret_cast<int*>(zt + p);    // [3p]
  int* col = cnt_s + 3 * p;                       // [per_row]
  float* wt = reinterpret_cast<float*>(col + per_row);
  for (int i = threadIdx.x; i < per_row; i += blockDim.x) {
    const int ty = p * sy, tx = p * (sy + sx);
    wt[i] = __ldg(i < ty   ? wy + (size_t)row * ty + i
                  : i < tx ? wx + (size_t)row * p * sx + (i - ty)
                           : wz + (size_t)row * p * sz + (i - tx));
  }
  const int l = lvl[row];
  const int H = L.h[l], W = L.w[l], D = L.d[l];
  const int oy = origins[row * 3], ox = origins[row * 3 + 1],
            oz = origins[row * 3 + 2];
  const __nv_bfloat16* f = static_cast<const __nv_bfloat16*>(L.ptr[l]) +
                           (size_t)bat[row] * H * W * D * c;
  __syncthreads();

  // Each warp compacts whole weight rows in place: lane k tests column k,
  // a ballot gives each kept tap its slot (slots never pass the column).
  int general = 0;
  for (int r = warp; r < 3 * p; r += nw) {
    const int a = r / p, i = r - a * p;
    const int s = a == 0 ? sy : a == 1 ? sx : sz;
    const int dim = a == 0 ? H : a == 1 ? W : D;
    const int org = a == 0 ? oy : a == 1 ? ox : oz;
    const int at0 = (a == 0 ? 0 : a == 1 ? p * sy : p * (sy + sx)) + i * s;
    int k_kept = 0;
    for (int k0 = 0; k0 < s; k0 += 32) {
      const int k = k0 + lane;
      const float v = k < s ? wt[at0 + k] : 0.f;
      const int coord = org + k;
      const bool keep = v != 0.f && coord >= 0 && coord < dim;
      const unsigned m = __ballot_sync(0xffffffffu, keep);
      if (keep) {
        const int at = at0 + k_kept + __popc(m & ((1u << lane) - 1u));
        col[at] = coord;
        wt[at] = v;
      }
      k_kept += __popc(m);
    }
    if (lane == 0) cnt_s[r] = k_kept;
    general |= k_kept > 2;
    if (a == 2) {
      __syncwarp();
      if (lane == 0) {
        int4 e;
        e.x = k_kept > 0 ? col[at0] : -1;
        e.y = k_kept > 1 ? col[at0 + 1] : e.x;
        e.z = __float_as_int(k_kept > 0 ? wt[at0] : 0.f);
        e.w = __float_as_int(k_kept > 1 ? wt[at0 + 1] : 0.f);
        zt[i] = e;
      }
    }
  }
  general = __syncthreads_or(general);

  const size_t sY = (size_t)W * D * c, sX = (size_t)D * c;
  const int* cz = col + p * (sy + sx);
  const float* wzt = wt + p * (sy + sx);
  const int* nz = cnt_s + 2 * p;

  for (int line = warp; line < plane; line += nw) {
    const int iy = line / p, ix = line - iy * p;
    VT* ol = o + (size_t)line * p * cvs;
    const int ny = cnt_s[iy], nx = cnt_s[p + ix];
    const int* cy = col + iy * sy;
    const float* wyr = wt + iy * sy;
    const int* cx = col + p * sy + ix * sx;
    const float* wxr = wt + p * sy + ix * sx;
    if (ny == 0 || nx == 0) {  // a line of zeros
      for (int i = lane; i < p * cvs; i += 32) __stcs(ol + i, Vec<V>::zero());
    } else if (!general) {
      LineTaps t;
      const bool y2 = ny == 2, x2 = nx == 2;
      const int cy0 = cy[0], cy1 = y2 ? cy[1] : cy0;
      const int cx0 = cx[0], cx1 = x2 ? cx[1] : cx0;
      const float wy0 = wyr[0], wy1 = y2 ? wyr[1] : 0.f;
      const float wx0 = wxr[0], wx1 = x2 ? wxr[1] : 0.f;
      t.w00 = wy0 * wx0;
      t.w01 = wy0 * wx1;
      t.w10 = wy1 * wx0;
      t.w11 = wy1 * wx1;
      t.r00 = f + cy0 * sY + cx0 * sX;
      t.r01 = f + cy0 * sY + cx1 * sX;
      t.r10 = f + cy1 * sY + cx0 * sX;
      t.r11 = f + cy1 * sY + cx1 * sX;
      fast_line<V>(t, zt, p, c, cvs, lane, ol);
    } else {
      general_line<V>(f, sY, sX, cy, wyr, ny, cx, wxr, nx, cz, wzt, nz, sz, p,
                      c, cvs, lane, ol);
    }
  }
}

template <int V>
int launch(const Levels& L, const int* lvl, const int* bat,
           const int* origins, const float* wy, const float* wx,
           const float* wz, const int* bounds, __nv_bfloat16* out, int n,
           int p, int sy, int sx, int sz, int c, cudaStream_t s) {
  const size_t smem =
      (size_t)p * 16 + (size_t)3 * p * 4 + (size_t)p * (sy + sx + sz) * 8;
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        roialign_slab_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  // Two warps per output y plane, at most 14: with that launch bound
  // ptxas gives the 16-byte path 72 registers without spills, 2 blocks of
  // 448 threads per SM (at 512 it capped it at 64 and spilled).
  const int warps = min(min(2 * p, p * p), MAX_WARPS);
  roialign_slab_kernel<V><<<n, warps * 32, smem, s>>>(
      L, lvl, bat, origins, wy, wx, wz, bounds, out, n, p, sy, sx, sz, c);
  return (int)cudaGetLastError();
}

bool aligned16(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
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
  const bool wide = c % 8 == 0 && aligned16(f2) && aligned16(f3) &&
                    aligned16(f4) && aligned16(f5) && aligned16(out);
  auto* a_lvl = static_cast<const int*>(lvl);
  auto* a_bat = static_cast<const int*>(bat);
  auto* a_org = static_cast<const int*>(origins);
  auto* a_wy = static_cast<const float*>(wy);
  auto* a_wx = static_cast<const float*>(wx);
  auto* a_wz = static_cast<const float*>(wz);
  auto* a_bounds = static_cast<const int*>(bounds);
  auto* a_out = static_cast<__nv_bfloat16*>(out);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  return wide ? launch<8>(L, a_lvl, a_bat, a_org, a_wy, a_wx, a_wz, a_bounds,
                          a_out, n, p, sy, sx, sz, c, s)
              : launch<2>(L, a_lvl, a_bat, a_org, a_wy, a_wx, a_wz, a_bounds,
                          a_out, n, p, sy, sx, sz, c, s);
}
