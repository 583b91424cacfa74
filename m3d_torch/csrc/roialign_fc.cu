// Slab pyramid ROIAlign fused with the classifier's pool-cube FC conv, for
// Hopper (sm_90a).
//
// Replaces two TPU kernels of m3d/ops/pallas_roialign.py that compute one
// function from the same inputs: _kernel_slab_fc_kron (entry
// pallas_pyramid_roi_align_fc_kron) and _kernel_slab_fc (entry
// pallas_pyramid_roi_align_fc). The TPU kernels DMA each ROI's slab into
// VMEM, contract it with the separable (or Kronecker y*x) weights on the MXU,
// park the pooled rows in a VMEM ring and multiply the ring by the FC
// weight. Here the pooled rows never exist outside shared memory either, but
// they are built by tap sums, a K-chunk at a time, and multiplied on the
// tensor cores (WMMA bf16 m16n16k16, f32 accumulation).
//
// Contract, per row i (levels, batch, origins [N, 3], wy [N, p, sy],
// wx [N, p, sx], wz [N, p, sz] f32, bounds = (offset, count) on the device):
//   offset <= i < offset + count:
//     pooled[i, y, x, z, c] = bf16(sum_{a, b, k} wy[i, y, a] * wx[i, x, b]
//                             * wz[i, z, k] * F_lvl[bat, oy+a, ox+b, oz+k, c])
//     (a voxel at or beyond the level's extent reads 0, as the TPU entry's
//     zero-padded levels give), and
//     out[i, f] = sum_K pooled[i, K] * wk[K, f] in f32, K = ((y*p + x)*p + z)*C + c.
//   other rows: out[i, :] = 0.
// No bias. Features and wk are bf16; out is f32.
//
// Bound on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s): at the bench
// step (N = 2000, p = 7, C = 256, F = 512) the product is 2 * N * p^3 * C * F
// = 1.8e11 flops, ~0.18 ms; its bytes (90 MB of weight, the pyramid level,
// 4 MB of output) take ~0.05 ms. So it is bound by operations.
// Design (simple first): a block owns BM = 64 rows x BN = 128 outputs and
// walks K in chunks of 64 channels x one sample point (sample points inner,
// so neighbouring chunks share taps in L1). Per chunk it builds the pooled A
// tile [64, 64] bf16 in shared memory by 8-tap sums (each row's taps
// compacted into shared memory once, at the block's start; the tap loads of
// the next chunk are issued before this chunk's MMAs), loads the [64, 128]
// weight tile with cp.async into the other half of a double buffer, and
// eight warps run WMMA on the tile ready. The gather is repeated once per
// 128-wide output tile (4 times at F = 512), and the weight is read once per
// 64-row tile: both are later work (wgmma, TMA, a larger N tile).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int BM = 64;    // rows per block
constexpr int BN = 128;   // outputs per block
constexpr int BK = 64;    // channels per K chunk
constexpr int LDA = BK + 8;
constexpr int LDB = BN + 8;
constexpr int THREADS = 256;

struct Levels {
  const void* ptr[4];
  int h[4], w[4], d[4];
};

// Two taps of one (row, axis, sample position); absent taps carry weight 0.
struct Tap {
  int c0, c1;
  float w0, w1;
};

struct RowInfo {
  const __nv_bfloat16* base;  // this row's level and image
  long long sy, sx;           // element strides of y and x
  int live;                   // inside bounds
  int general;                // some position has more than 2 taps
  int row;
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

__device__ __forceinline__ void fma8(float* acc, uint4 u, float w) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float2 v = __bfloat1622float2(h[j]);
    acc[2 * j] += w * v.x;
    acc[2 * j + 1] += w * v.y;
  }
}

__global__ void __launch_bounds__(THREADS)
roialign_fc_kernel(Levels L, const int* __restrict__ lvl,
                   const int* __restrict__ bat,
                   const int* __restrict__ origins,
                   const float* __restrict__ wy, const float* __restrict__ wx,
                   const float* __restrict__ wz,
                   const int* __restrict__ bounds,
                   const __nv_bfloat16* __restrict__ wk,
                   float* __restrict__ out, int n, int p, int sy, int sx,
                   int sz, int c, int f) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);  // [2][BM][LDA]
  __nv_bfloat16* Bs = As + 2 * BM * LDA;                       // [2][BK][LDB]
  float* Cs = reinterpret_cast<float*>(Bs + 2 * BK * LDB);     // [8][16][16]
  RowInfo* rows = reinterpret_cast<RowInfo*>(Cs + 8 * 256);    // [BM]
  Tap* taps = reinterpret_cast<Tap*>(rows + BM);               // [BM][3][p]

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int row0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int off = bounds[0], cnt = bounds[1];
  const int lo = max(row0, off), hi = min(min(row0 + BM, n), off + cnt);

  if (lo >= hi) {  // no live row in this tile: its outputs are zeros
    for (int i = tid; i < BM * BN; i += THREADS) {
      const int r = row0 + i / BN, col = n0 + i % BN;
      if (r < n && col < f) out[(size_t)r * f + col] = 0.f;
    }
    return;
  }

  // Row metadata and compacted taps ---------------------------------------
  if (tid < BM) {
    RowInfo ri;
    const int row = row0 + tid;
    ri.row = row;
    ri.live = row >= lo && row < hi;
    ri.general = 0;
    ri.base = nullptr;
    ri.sy = ri.sx = 0;
    if (ri.live) {
      const int l = lvl[row];
      const int H = L.h[l], W = L.w[l], D = L.d[l];
      ri.base = static_cast<const __nv_bfloat16*>(L.ptr[l]) +
                (size_t)bat[row] * H * W * D * c;
      ri.sy = (long long)W * D * c;
      ri.sx = (long long)D * c;
    }
    rows[tid] = ri;
  }
  __syncthreads();
  for (int t = tid; t < BM * 3 * p; t += THREADS) {
    const int r = t / (3 * p), axis = (t / p) % 3, i = t % p;
    const int row = row0 + r;
    Tap tp = {0, 0, 0.f, 0.f};
    if (rows[r].live) {
      const int l = lvl[row];
      const int dim = axis == 0 ? L.h[l] : axis == 1 ? L.w[l] : L.d[l];
      const int s = axis == 0 ? sy : axis == 1 ? sx : sz;
      const float* w = (axis == 0 ? wy : axis == 1 ? wx : wz) +
                       ((size_t)row * p + i) * s;
      const int o = origins[row * 3 + axis];
      int k = 0;
      for (int j = 0; j < s; ++j) {
        const float v = w[j];
        const int coord = o + j;
        if (v != 0.f && coord >= 0 && coord < dim) {
          if (k == 0) { tp.c0 = coord; tp.w0 = v; }
          else if (k == 1) { tp.c1 = coord; tp.w1 = v; }
          ++k;
        }
      }
      if (k > 2) rows[r].general = 1;  // benign race: every writer stores 1
    }
    taps[t] = tp;
  }
  __syncthreads();

  // One K chunk: channels [c0, c0 + BK) of sample point pt. Steps walk the
  // sample points inside each channel chunk, so neighbouring steps share
  // taps (z and z + 1 share four of eight) while they are still in L1.
  const int p3 = p * p * p;
  const int steps = p3 * (c / BK);
  constexpr int ITEMS = BM * (BK / 8) / THREADS;  // 8-channel items a thread

  // Tap loads of a step's A tile go to registers first, all issued before
  // any is used, and before the previous tile's MMAs: their latency hides
  // behind the tensor cores instead of serializing.
  uint4 v[ITEMS][8];
  float wt[ITEMS][8];

  auto gather_a = [&](int step) {
    const int pt = step % p3;
    const int c0 = (step / p3) * BK;
    const int y = pt / (p * p), x = (pt / p) % p, z = pt % p;
#pragma unroll
    for (int it = 0; it < ITEMS; ++it) {
      const int item = tid + it * THREADS;
      const int r = item / (BK / 8), g = item % (BK / 8);
      const RowInfo& ri = rows[r];
      if (ri.live && !ri.general) {
        const Tap ty = taps[(r * 3 + 0) * p + y];
        const Tap tx = taps[(r * 3 + 1) * p + x];
        const Tap tz = taps[(r * 3 + 2) * p + z];
        const __nv_bfloat16* b = ri.base + c0 + g * 8;
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          const int a = t >> 2, bb = (t >> 1) & 1, k = t & 1;
          wt[it][t] = (a ? ty.w1 : ty.w0) * (bb ? tx.w1 : tx.w0) *
                      (k ? tz.w1 : tz.w0);
          v[it][t] = __ldg(reinterpret_cast<const uint4*>(
              b + (a ? ty.c1 : ty.c0) * ri.sy + (bb ? tx.c1 : tx.c0) * ri.sx +
              (long long)(k ? tz.c1 : tz.c0) * c));
        }
      } else {
#pragma unroll
        for (int t = 0; t < 8; ++t) wt[it][t] = 0.f;
      }
    }
  };

  auto combine_a = [&](int step, __nv_bfloat16* A) {
    const int pt = step % p3;
    const int c0 = (step / p3) * BK;
    const int y = pt / (p * p), x = (pt / p) % p, z = pt % p;
#pragma unroll
    for (int it = 0; it < ITEMS; ++it) {
      const int item = tid + it * THREADS;
      const int r = item / (BK / 8), g = item % (BK / 8);
      const RowInfo& ri = rows[r];
      float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (ri.live && !ri.general) {
#pragma unroll
        for (int t = 0; t < 8; ++t) fma8(acc, v[it][t], wt[it][t]);
      } else if (ri.live) {  // exact for any weights: every nonzero entry
        const int row = ri.row;
        const int l = lvl[row];
        const int H = L.h[l], W = L.w[l], D = L.d[l];
        const int* o = origins + row * 3;
        const float* wyr = wy + ((size_t)row * p + y) * sy;
        const float* wxr = wx + ((size_t)row * p + x) * sx;
        const float* wzr = wz + ((size_t)row * p + z) * sz;
        const __nv_bfloat16* b = ri.base + c0 + g * 8;
        for (int a = 0; a < sy; ++a) {
          const int ya = o[0] + a;
          if (wyr[a] == 0.f || ya < 0 || ya >= H) continue;
          for (int bb = 0; bb < sx; ++bb) {
            const int xb = o[1] + bb;
            const float wyx = wyr[a] * wxr[bb];
            if (wyx == 0.f || xb < 0 || xb >= W) continue;
            for (int k = 0; k < sz; ++k) {
              const int zk = o[2] + k;
              const float w = wyx * wzr[k];
              if (w == 0.f || zk < 0 || zk >= D) continue;
              fma8(acc, __ldg(reinterpret_cast<const uint4*>(
                            b + ya * ri.sy + xb * ri.sx + (long long)zk * c)),
                   w);
            }
          }
        }
      }
      __align__(16) __nv_bfloat162 h[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        h[j] = __floats2bfloat162_rn(acc[2 * j], acc[2 * j + 1]);
      *reinterpret_cast<uint4*>(A + r * LDA + g * 8) =
          *reinterpret_cast<const uint4*>(h);
    }
  };

  auto load_b = [&](int step, __nv_bfloat16* B) {
    const size_t k0 = (size_t)(step % p3) * c + (step / p3) * BK;
    for (int item = tid; item < BK * (BN / 8); item += THREADS) {
      const int kr = item / (BN / 8), seg = item % (BN / 8);
      const int col = n0 + seg * 8;
      __nv_bfloat16* dst = B + kr * LDB + seg * 8;
      if (col < f)
        cp_async16(dst, wk + (k0 + kr) * f + col);
      else
        *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
    }
    cp_async_commit();
  };

  const int wr = warp % 4;  // 16-row slice of the tile
  const int wc = warp / 4;  // 64-column half of the tile
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[j], 0.f);

  load_b(0, Bs);
  gather_a(0);
  combine_a(0, As);
  cp_async_wait_all();
  __syncthreads();

  for (int step = 0; step < steps; ++step) {
    const int cur = step & 1;
    const __nv_bfloat16* A = As + cur * BM * LDA;
    const __nv_bfloat16* B = Bs + cur * BK * LDB;
    if (step + 1 < steps) {
      load_b(step + 1, Bs + (cur ^ 1) * BK * LDB);
      gather_a(step + 1);
    }
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> af;
      wmma::load_matrix_sync(af, A + wr * 16 * LDA + kk * 16, LDA);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> bf;
        wmma::load_matrix_sync(bf, B + kk * 16 * LDB + wc * 64 + j * 16, LDB);
        wmma::mma_sync(acc[j], af, bf, acc[j]);
      }
    }
    if (step + 1 < steps) combine_a(step + 1, As + (cur ^ 1) * BM * LDA);
    cp_async_wait_all();
    __syncthreads();
  }

  // Epilogue: each warp stages its fragments and writes the rows and
  // columns that exist (rows outside bounds hold zeros: their A rows were 0).
  float* cw = Cs + warp * 256;
  const int lane = tid % 32;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    wmma::store_matrix_sync(cw, acc[j], 16, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32) {
      const int r = row0 + wr * 16 + e / 16;
      const int col = n0 + wc * 64 + j * 16 + e % 16;
      if (r < n && col < f) out[(size_t)r * f + col] = cw[e];
    }
    __syncwarp();
  }
}

}  // namespace

// Shared memory the launch needs for pool size p.
static size_t fc_smem_bytes(int p) {
  return (size_t)2 * BM * LDA * 2 + (size_t)2 * BK * LDB * 2 + 8 * 256 * 4 +
         BM * sizeof(RowInfo) + (size_t)BM * 3 * p * sizeof(Tap);
}

// Returns the cudaError_t of the launch (0 = ok).
extern "C" int roialign_fc_launch(
    const void* f2, const void* f3, const void* f4, const void* f5,
    int h2, int w2, int d2, int h3, int w3, int d3,
    int h4, int w4, int d4, int h5, int w5, int d5,
    const void* lvl, const void* bat, const void* origins, const void* wy,
    const void* wx, const void* wz, const void* bounds, const void* wk,
    void* out, int n, int p, int sy, int sx, int sz, int c, int f,
    void* stream) {
  if (n <= 0 || p <= 0 || c <= 0 || c % BK || f <= 0 || f % 8 || sy <= 0 ||
      sx <= 0 || sz <= 0)
    return (int)cudaErrorInvalidValue;
  Levels L;
  L.ptr[0] = f2; L.ptr[1] = f3; L.ptr[2] = f4; L.ptr[3] = f5;
  L.h[0] = h2; L.w[0] = w2; L.d[0] = d2;
  L.h[1] = h3; L.w[1] = w3; L.d[1] = d3;
  L.h[2] = h4; L.w[2] = w4; L.d[2] = d4;
  L.h[3] = h5; L.w[3] = w5; L.d[3] = d5;
  const size_t smem = fc_smem_bytes(p);
  cudaError_t e = cudaFuncSetAttribute(
      roialign_fc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((f + BN - 1) / BN, (n + BM - 1) / BM);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  roialign_fc_kernel<<<grid, THREADS, smem, s>>>(
      L, static_cast<const int*>(lvl), static_cast<const int*>(bat),
      static_cast<const int*>(origins), static_cast<const float*>(wy),
      static_cast<const float*>(wx), static_cast<const float*>(wz),
      static_cast<const int*>(bounds),
      static_cast<const __nv_bfloat16*>(wk), static_cast<float*>(out), n, p,
      sy, sx, sz, c, f);
  return (int)cudaGetLastError();
}
