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
// tensor cores with wgmma (bf16 in, f32 accumulation in registers).
//
// Contract, per row i (levels, batch, origins [N, 3], wy [N, p, sy],
// wx [N, p, sx], wz [N, p, sz] f32, bounds = (offset, count) on the device):
//   offset <= i < offset + count:
//     pooled[i, y, x, z, c] = bf16(sum_{a, b, k} wy[i, y, a] * wx[i, x, b]
//                             * wz[i, z, k] * F_lvl[bat, oy+a, ox+b, oz+k, c])
//     (a voxel at or beyond the level's extent reads 0, as the TPU entry's
//     zero-padded levels give), and
//     out[i, f] = sum_K pooled[i, K] * wk[f, K] in f32, K = ((y*p + x)*p + z)*C + c.
//   other rows: out[i, :] = 0.
// No bias. Features and wk ([F, K], K contiguous) are bf16; out is f32.
//
// Bound on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s): at the
// monolithic classifier's 2000 rows (p = 7, C = 256, F = 512) the product is
// 2 * N * p^3 * C * F = 1.8e11 flops, ~0.18 ms; its bytes (90 MB of weight,
// the pyramid level, 4 MB of output) take ~0.03 ms. So it is bound by
// operations; on a few rows (70, 125) it is bound by reading the weight
// once, ~0.03 ms.
//
// Design. A work item is (row tile of BM = 64 rows, F group of 512, K
// slice). Its block gathers each pooled A tile [64 rows, 64 channels of one
// sample point] once and multiplies it by all 512 outputs of the F group:
// two consumer warpgroups each run wgmma m64n256k16 on their 256 columns,
// so the gather is not repeated per output tile.
//   - Warp specialisation: warpgroups 0-1 consume (wgmma; the m64n256
//     accumulators take 128 of their registers), warpgroup 2 produces: it
//     builds each A tile by 8-tap sums into shared memory, two 8-channel
//     items a thread in flight (four spill at the 168-register cap), in the
//     128-byte swizzled K-major layout wgmma reads. A ring of STAGES (A, B) stages, each with a full and an
//     empty mbarrier, connects the two. The gather, not the tensor cores,
//     paces a step, so the consumers release a stage as soon as its product
//     completes, and one consumer thread, idle otherwise, issues the weight
//     tile's TMA STAGES steps ahead into the stage just freed: neither the
//     copies nor their issue sit on the producers' path.
//   - Registers: every warp is compiled under the launch's cap, 168 at 384
//     threads. ptxas does not raise it for warps that ask for more with
//     setmaxnreg (a 512-thread version with two producer warpgroups, cap
//     128, failed to compile its m64n256 wgmma), so the kernel does not use
//     setmaxnreg and has one producer warpgroup. That warpgroup's gather,
//     about 32 16-byte loads a thread per step in two rounds, is what bounds
//     a step (PERF.md records the measurements).
//   - Weight tiles by TMA multicast: blocks run in clusters of CL = 2 that
//     take neighbouring row tiles of the same F group and K slice. Each
//     block loads half of the [512 outputs, 64 K] weight tile ([256, 64]
//     boxes of wk with the 128-byte swizzle, cuTensorMapEncodeTiled on the
//     host, libcuda) and multicasts it to both blocks, so L2 serves each
//     weight tile once per cluster; a consumer warp releases a stage in
//     every block of its cluster (remote mbarrier arrive). Step time is set
//     by L2 traffic (the gather's taps and the weight, ~6 TB/s together),
//     so halving the weight's share matters.
//   - Filling the card whatever `bounds` holds: the grid is persistent, as
//     many clusters as the card holds at once. Every block reads `bounds`,
//     derives the live row tiles (rounded up to whole clusters) and the F
//     groups, and splits K into S = min(clusters / jobs, K steps) slices
//     when there are fewer cluster jobs than clusters (else S = 1).
//   - The split is summed in a fixed order, so results repeat bit for bit:
//     with S > 1 each item writes its partial [64, 512] f32 tile to a
//     workspace slot, and a second kernel sums the S slots of each row in
//     slice order. That kernel also writes the zero rows outside `bounds`
//     (and, with S = 1, leaves the rows the main kernel wrote directly).
//   - Exact for any weights: each row's two taps per axis and position are
//     compacted into shared memory per item; a row with more than two
//     nonzero taps at a position takes a slow loop over the dense weights.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;                       // rows per tile (wgmma M)
constexpr int BN = 256;                      // outputs per consumer warpgroup
constexpr int CONSUMERS = 2;                 // consumer warpgroups
constexpr int FG = CONSUMERS * BN;           // outputs per work item
constexpr int BK = 64;                       // K per stage: 128-byte rows
constexpr int STAGES = 2;
constexpr int GATHER = 128;                  // producer threads
constexpr int THREADS = 128 * CONSUMERS + GATHER;
constexpr int A_BYTES = BM * BK * 2;         // 8 KB
constexpr int B_BYTES = FG * BK * 2;         // 64 KB
constexpr int CL = 2;                        // blocks per cluster
constexpr int SHARE = FG / CL;               // weight rows each block loads
constexpr int BOX_ROWS = SHARE < 256 ? SHARE : 256;  // rows per TMA box
constexpr int BOX_BYTES = BOX_ROWS * BK * 2;
constexpr int ITEMS = BM * (BK / 8) / GATHER;  // 8-channel items a producer
constexpr int FULL_ARRIVALS = GATHER + 1;    // + the TMA thread's expect_tx
constexpr int EMPTY_ARRIVALS = CONSUMERS * 4 * CL;  // consumer warps, cluster

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

// How the work splits, derived from `bounds` on the device by both kernels.
// A cluster job is CL neighbouring row tiles of one F group; its CL items
// (one per block of the cluster) share each K slice and its weight tiles.
struct Plan {
  int lo, hi;     // rows [lo, hi) are computed
  int groups;     // F groups of FG outputs
  int jobs;       // cluster jobs: ceil(row tiles / CL) x groups
  int splits;     // K slices per job
  int items;      // jobs x splits x CL
};

__device__ __forceinline__ Plan make_plan(const int* bounds, int n, int f,
                                          int steps, int grid) {
  Plan P;
  const long long off = bounds[0], cnt = bounds[1];
  long long lo = off < 0 ? 0 : (off > n ? n : off);
  long long hi = off + cnt > n ? n : off + cnt;
  if (hi < lo) hi = lo;
  P.lo = (int)lo;
  P.hi = (int)hi;
  P.groups = (f + FG - 1) / FG;
  const int tiles = (int)((hi - lo + BM - 1) / BM);
  P.jobs = (tiles + CL - 1) / CL * P.groups;
  const int clusters = grid / CL;
  P.splits = (P.jobs == 0 || P.jobs >= clusters)
                 ? 1 : min(clusters / P.jobs, steps);
  P.items = P.jobs * P.splits * CL;
  return P;
}

// Item w: the block's rows, outputs and K steps [kb, ke).
struct Item {
  int row0, fcol0, kb, ke;
};

__device__ __forceinline__ Item item_of(const Plan& P, int w, int steps) {
  const int q = w / CL, rank = w % CL;
  const int job = q / P.splits, s = q % P.splits;
  Item I;
  I.row0 = P.lo + ((job / P.groups) * CL + rank) * BM;
  I.fcol0 = (job % P.groups) * FG;
  I.kb = (int)((long long)s * steps / P.splits);
  I.ke = (int)((long long)(s + 1) * steps / P.splits);
  return I;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count));
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Arrive on the barrier at the same offset in block `cta` of the cluster.
__device__ __forceinline__ void mbar_arrive_cluster(uint64_t* bar,
                                                    uint32_t cta) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(smem_u32(bar)), "r"(cta));
  asm volatile(
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(
          remote)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Wait for the completion of the barrier's phase with parity `parity`.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// A TMA box of the weight into this block's and every cluster peer's
// shared memory at dst, completing on each block's barrier at bar.
__device__ __forceinline__ void tma_load_multicast(void* dst,
                                                   const CUtensorMap* map,
                                                   int c0, int c1,
                                                   uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.multicast::cluster [%0], [%1, {%2, %3}], [%4], %5;\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(smem_u32(bar)), "h"((uint16_t)((1 << CL) - 1))
      : "memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::
          : "memory");
}

// wgmma shared-memory descriptor: K-major operand in the 128-byte swizzle,
// 8-row groups 1024 bytes apart.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void fence_operands(float* d) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64 x 256] += A[64 x 16] * B[256 x 16]^T, both from shared memory.
__device__ __forceinline__ void wgmma_m64n256k16(float* d, uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127},"
      " %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
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

struct Args {
  Levels L;
  const int* lvl;
  const int* bat;
  const int* origins;
  const float* wy;
  const float* wx;
  const float* wz;
  const int* bounds;
  float* out;
  float* ws;  // [grid, BM, FG] partial tiles when K is split
  int n, p, sy, sx, sz, c, f;
};

// Producers: per item, the rows' metadata and compacted taps, then per K
// step the weight tile's TMA and the pooled A tile.
__device__ __forceinline__ void produce(const Args& a, unsigned char* As,
                                        uint64_t* full, uint64_t* empty,
                                        RowInfo* rows, Tap* taps,
                                        const Plan& P, int steps) {
  const int gt = threadIdx.x - 128 * CONSUMERS;
  const int p = a.p, c = a.c;
  const int p3 = p * p * p;
  uint32_t it = 0;
  for (int w = blockIdx.x; w < P.items; w += gridDim.x) {
    const Item I = item_of(P, w, steps);
    const int row0 = I.row0, kb = I.kb, ke = I.ke;

    named_sync(1, GATHER);  // every producer is done with the last item
    for (int i = gt; i < BM; i += GATHER) {
      RowInfo ri;
      const int row = row0 + i;
      ri.row = row;
      ri.live = row < P.hi;
      ri.general = 0;
      ri.base = nullptr;
      ri.sy = ri.sx = 0;
      if (ri.live) {
        const int l = a.lvl[row];
        const int H = a.L.h[l], W = a.L.w[l], D = a.L.d[l];
        ri.base = static_cast<const __nv_bfloat16*>(a.L.ptr[l]) +
                  (size_t)a.bat[row] * H * W * D * c;
        ri.sy = (long long)W * D * c;
        ri.sx = (long long)D * c;
      }
      rows[i] = ri;
    }
    named_sync(1, GATHER);
    for (int t = gt; t < BM * 3 * p; t += GATHER) {
      const int r = t / (3 * p), axis = (t / p) % 3, i = t % p;
      const int row = row0 + r;
      Tap tp = {0, 0, 0.f, 0.f};
      if (rows[r].live) {
        const int l = a.lvl[row];
        const int dim = axis == 0 ? a.L.h[l] : axis == 1 ? a.L.w[l] : a.L.d[l];
        const int sw = axis == 0 ? a.sy : axis == 1 ? a.sx : a.sz;
        const float* wt = (axis == 0 ? a.wy : axis == 1 ? a.wx : a.wz) +
                          ((size_t)row * p + i) * sw;
        const int o = a.origins[row * 3 + axis];
        int k = 0;
#pragma unroll 8
        for (int j = 0; j < sw; ++j) {
          const float v = wt[j];
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
    named_sync(1, GATHER);

    for (int st = kb; st < ke; ++st, ++it) {
      const int stage = it % STAGES;
      const uint32_t parity = (it / STAGES) & 1;
      mbar_wait(&empty[stage], parity ^ 1);
      const int pt = st % p3, c0 = (st / p3) * BK;
      const int y = pt / (p * p), x = (pt / p) % p, z = pt % p;
      unsigned char* A = As + stage * A_BYTES;
#pragma unroll 1
      for (int j = 0; j < ITEMS; j += 2) {
        // Two items' tap loads in flight before either is summed.
        uint4 v[2][8];
        float wt[2][8];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int item = gt + (j + u) * GATHER;
          const int r = item >> 3, g = item & 7;
          const RowInfo& ri = rows[r];
          if (ri.live && !ri.general) {
            const Tap ty = taps[(r * 3 + 0) * p + y];
            const Tap tx = taps[(r * 3 + 1) * p + x];
            const Tap tz = taps[(r * 3 + 2) * p + z];
            const __nv_bfloat16* b = ri.base + c0 + g * 8;
#pragma unroll
            for (int t = 0; t < 8; ++t) {
              const int ia = t >> 2, ib = (t >> 1) & 1, ik = t & 1;
              wt[u][t] = (ia ? ty.w1 : ty.w0) * (ib ? tx.w1 : tx.w0) *
                         (ik ? tz.w1 : tz.w0);
              v[u][t] = __ldg(reinterpret_cast<const uint4*>(
                  b + (ia ? ty.c1 : ty.c0) * ri.sy +
                  (ib ? tx.c1 : tx.c0) * ri.sx +
                  (long long)(ik ? tz.c1 : tz.c0) * c));
            }
          } else {
#pragma unroll
            for (int t = 0; t < 8; ++t) {
              wt[u][t] = 0.f;
              v[u][t] = make_uint4(0, 0, 0, 0);
            }
          }
        }
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int item = gt + (j + u) * GATHER;
          const int r = item >> 3, g = item & 7;
          const RowInfo& ri = rows[r];
          float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int t = 0; t < 8; ++t) fma8(acc, v[u][t], wt[u][t]);
          if (ri.live && ri.general) {  // exact for any weights
            const int row = ri.row;
            const int l = a.lvl[row];
            const int H = a.L.h[l], W = a.L.w[l], D = a.L.d[l];
            const int* o = a.origins + row * 3;
            const float* wyr = a.wy + ((size_t)row * p + y) * a.sy;
            const float* wxr = a.wx + ((size_t)row * p + x) * a.sx;
            const float* wzr = a.wz + ((size_t)row * p + z) * a.sz;
            const __nv_bfloat16* b = ri.base + c0 + g * 8;
            for (int ia = 0; ia < a.sy; ++ia) {
              const int ya = o[0] + ia;
              if (wyr[ia] == 0.f || ya < 0 || ya >= H) continue;
              for (int ib = 0; ib < a.sx; ++ib) {
                const int xb = o[1] + ib;
                const float wyx = wyr[ia] * wxr[ib];
                if (wyx == 0.f || xb < 0 || xb >= W) continue;
                for (int ik = 0; ik < a.sz; ++ik) {
                  const int zk = o[2] + ik;
                  const float wv = wyx * wzr[ik];
                  if (wv == 0.f || zk < 0 || zk >= D) continue;
                  fma8(acc, __ldg(reinterpret_cast<const uint4*>(
                                b + ya * ri.sy + xb * ri.sx +
                                (long long)zk * c)),
                       wv);
                }
              }
            }
          }
          __align__(16) __nv_bfloat162 h[4];
#pragma unroll
          for (int j2 = 0; j2 < 4; ++j2)
            h[j2] = __floats2bfloat162_rn(acc[2 * j2], acc[2 * j2 + 1]);
          // 128-byte swizzle: 16-byte chunk g of row r lands at g ^ (r % 8).
          *reinterpret_cast<uint4*>(A + r * 128 + ((g ^ (r & 7)) << 4)) =
              *reinterpret_cast<const uint4*>(h);
        }
      }
      // Make the generic-proxy stores visible to wgmma (async proxy).
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_arrive(&full[stage]);
    }
  }
}

// This block's share of the weight tile of K step `st` (F group at fcol0)
// into stage `stage` of every block of the cluster, by TMA multicast; the
// stage's full barrier expects the whole tile (boxes wholly past F are not
// loaded).
__device__ __forceinline__ void load_weight(const CUtensorMap* wmap,
                                           unsigned char* Bs, uint64_t* full,
                                           int stage, int st, int fcol0,
                                           int rank, int p3, int c, int f) {
  int boxes = 0;
  for (int b = 0; b < FG / BOX_ROWS; ++b) boxes += fcol0 + b * BOX_ROWS < f;
  mbar_arrive_expect_tx(&full[stage], boxes * BOX_BYTES);
  for (int b = rank * SHARE / BOX_ROWS; b < (rank + 1) * SHARE / BOX_ROWS; ++b)
    if (fcol0 + b * BOX_ROWS < f)
      tma_load_multicast(Bs + stage * B_BYTES + b * BOX_BYTES, wmap,
                         (st % p3) * c + (st / p3) * BK, fcol0 + b * BOX_ROWS,
                         &full[stage]);
}

// Consumers: wgmma over the ring, each stage released as soon as its
// product completes (the gather, not the tensor cores, paces a step), then
// the tile's accumulators to `out` (S = 1) or to the item's workspace slot.
// One consumer thread also issues the weight TMA STAGES steps ahead, as
// soon as a stage is free: it keeps the copies off the producers' path.
__device__ __forceinline__ void consume(const Args& a, const CUtensorMap* wmap,
                                        unsigned char* As, unsigned char* Bs,
                                        uint64_t* full, uint64_t* empty,
                                        const Plan& P, int steps) {
  const int wg = threadIdx.x / 128;
  const int lt = threadIdx.x % 128;
  const int lane = lt % 32;
  const bool loader = threadIdx.x == 128 * (CONSUMERS - 1);
  const int p3 = a.p * a.p * a.p;
  // The loader's cursor: item lw, step lst, STAGES steps ahead of `it`.
  int lw = blockIdx.x, lst = 0, lke = 0, lf = 0;
  uint32_t lit = 0;
  auto load_ahead = [&](uint32_t until) {
    while (lit < until && lw < P.items) {
      if (lst >= lke) {
        const Item I = item_of(P, lw, steps);
        lst = I.kb;
        lke = I.ke;
        lf = I.fcol0;
      }
      const int stage = lit % STAGES;
      mbar_wait(&empty[stage], ((lit / STAGES) & 1) ^ 1);
      load_weight(wmap, Bs, full, stage, lst, lf, lw % CL, p3, a.c, a.f);
      ++lit;
      if (++lst >= lke) lw += gridDim.x;
    }
  };
  if (loader) {
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(
        reinterpret_cast<uint64_t>(wmap)) : "memory");
    load_ahead(STAGES);
  }
  float d[128];
  uint32_t it = 0;
  for (int w = blockIdx.x; w < P.items; w += gridDim.x) {
    const Item I = item_of(P, w, steps);
#pragma unroll
    for (int i = 0; i < 128; ++i) d[i] = 0.f;
    for (int st = I.kb; st < I.ke; ++st, ++it) {
      const int stage = it % STAGES;
      mbar_wait(&full[stage], (it / STAGES) & 1);
      const uint32_t sa = smem_u32(As + stage * A_BYTES);
      const uint32_t sb = smem_u32(Bs + stage * B_BYTES + wg * (B_BYTES / 2));
      fence_operands(d);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_m64n256k16(d, sw128_desc(sa + kk * 32), sw128_desc(sb + kk * 32));
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fence_operands(d);
      if (lane == 0)  // the stage is free in this block for every peer
        for (int r = 0; r < CL; ++r) mbar_arrive_cluster(&empty[stage], r);
      if (loader) load_ahead(it + 1 + STAGES);
    }

    // Accumulator layout of m64nNk16: d[4j + 2h + e] is row
    // warp*16 + lane/4 + 8h, column 8j + 2*(lane%4) + e.
    const int r0 = (lt / 32) * 16 + lane / 4;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = wg * BN + j * 8 + (lane % 4) * 2;  // within the group
      if (I.fcol0 + col >= a.f) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + 8 * h;
        const float2 v = make_float2(d[4 * j + 2 * h], d[4 * j + 2 * h + 1]);
        if (P.splits == 1) {
          if (I.row0 + r < P.hi)
            *reinterpret_cast<float2*>(a.out + (size_t)(I.row0 + r) * a.f +
                                       I.fcol0 + col) = v;
        } else {
          *reinterpret_cast<float2*>(a.ws + ((size_t)w * BM + r) * FG + col) =
              v;
        }
      }
    }
  }
}

__global__ void __launch_bounds__(THREADS, 1)
roialign_fc_kernel(const __grid_constant__ CUtensorMap wmap, const Args a) {
  extern __shared__ unsigned char smem_raw[];
  // Swizzled tiles need 1024-byte alignment; the launch adds the slack.
  const uint32_t pad = (1024 - (smem_u32(smem_raw) & 1023)) & 1023;
  unsigned char* Bs = smem_raw + pad;                      // [STAGES][B]
  unsigned char* As = Bs + STAGES * B_BYTES;               // [STAGES][A]
  uint64_t* full = reinterpret_cast<uint64_t*>(As + STAGES * A_BYTES);
  uint64_t* empty = full + STAGES;
  RowInfo* rows = reinterpret_cast<RowInfo*>(empty + STAGES);
  Tap* taps = reinterpret_cast<Tap*>(rows + BM);           // [BM][3][p]

  const int steps = a.p * a.p * a.p * (a.c / BK);
  const Plan P = make_plan(a.bounds, a.n, a.f, steps, gridDim.x);
  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&full[i], FULL_ARRIVALS);
      mbar_init(&empty[i], EMPTY_ARRIVALS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();  // every block's barriers exist before any peer uses them

  if (threadIdx.x >= 128 * CONSUMERS)
    produce(a, As, full, empty, rows, taps, P, steps);
  else
    consume(a, &wmap, As, Bs, full, empty, P, steps);
  cluster_sync();  // no peer still arrives on, or multicasts into, this block
}

// Sums each row's K slices in slice order (S > 1) and writes zeros outside
// bounds; with S = 1 the rows in bounds were written by the main kernel.
__global__ void roialign_fc_finish(const int* __restrict__ bounds,
                                   const float* __restrict__ ws,
                                   float* __restrict__ out, int n, int f,
                                   int steps, int grid) {
  const Plan P = make_plan(bounds, n, f, steps, grid);
  const long long quads = (long long)n * f / 4;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < quads; i += (long long)gridDim.x * blockDim.x) {
    const long long e = i * 4;
    const int row = (int)(e / f), col = (int)(e % f);
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row >= P.lo && row < P.hi) {
      if (P.splits == 1) continue;
      const int t = (row - P.lo) / BM;
      const int job = (t / CL) * P.groups + col / FG;
      const int r = (row - P.lo) % BM;
      for (int s = 0; s < P.splits; ++s) {
        const int w = (job * P.splits + s) * CL + t % CL;
        const float4 u = *reinterpret_cast<const float4*>(
            ws + ((size_t)w * BM + r) * FG + col % FG);
        v.x += u.x; v.y += u.y; v.z += u.z; v.w += u.w;
      }
    }
    *reinterpret_cast<float4*>(out + e) = v;
  }
}

}  // namespace

// Shared memory the launch needs for pool size p (with alignment slack).
static size_t fc_smem_bytes(int p) {
  return 1024 + (size_t)STAGES * (B_BYTES + A_BYTES) +
         2 * STAGES * sizeof(uint64_t) + BM * sizeof(RowInfo) +
         (size_t)BM * 3 * p * sizeof(Tap);
}

// Returns the cudaError_t of the launches (0 = ok); a tensor map that
// cuTensorMapEncodeTiled refuses returns cudaErrorInvalidValue.
extern "C" int roialign_fc_launch(
    const void* f2, const void* f3, const void* f4, const void* f5,
    int h2, int w2, int d2, int h3, int w3, int d3,
    int h4, int w4, int d4, int h5, int w5, int d5,
    const void* lvl, const void* bat, const void* origins, const void* wy,
    const void* wx, const void* wz, const void* bounds, const void* wk,
    void* out, void* ws, int n, int p, int sy, int sx, int sz, int c, int f,
    int grid, void* stream) {
  if (n <= 0 || p <= 0 || c <= 0 || c % BK || f <= 0 || f % 8 || sy <= 0 ||
      sx <= 0 || sz <= 0 || grid < CL)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.L.ptr[0] = f2; a.L.ptr[1] = f3; a.L.ptr[2] = f4; a.L.ptr[3] = f5;
  a.L.h[0] = h2; a.L.w[0] = w2; a.L.d[0] = d2;
  a.L.h[1] = h3; a.L.w[1] = w3; a.L.d[1] = d3;
  a.L.h[2] = h4; a.L.w[2] = w4; a.L.d[2] = d4;
  a.L.h[3] = h5; a.L.w[3] = w5; a.L.d[3] = d5;
  a.lvl = static_cast<const int*>(lvl);
  a.bat = static_cast<const int*>(bat);
  a.origins = static_cast<const int*>(origins);
  a.wy = static_cast<const float*>(wy);
  a.wx = static_cast<const float*>(wx);
  a.wz = static_cast<const float*>(wz);
  a.bounds = static_cast<const int*>(bounds);
  a.out = static_cast<float*>(out);
  a.ws = static_cast<float*>(ws);
  a.n = n; a.p = p; a.sy = sy; a.sx = sx; a.sz = sz; a.c = c; a.f = f;

  // wk [F, K] bf16, K contiguous: boxes of [BN outputs, BK] in the 128-byte
  // swizzle, which is the K-major layout wgmma reads.
  const cuuint64_t k = (cuuint64_t)p * p * p * c;
  CUtensorMap wmap;
  cuuint64_t dims[2] = {k, (cuuint64_t)f};
  cuuint64_t strides[1] = {k * 2};
  cuuint32_t box[2] = {BK, BOX_ROWS};
  cuuint32_t estr[2] = {1, 1};
  if (cuTensorMapEncodeTiled(&wmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                             const_cast<void*>(wk), dims, strides, box, estr,
                             CU_TENSOR_MAP_INTERLEAVE_NONE,
                             CU_TENSOR_MAP_SWIZZLE_128B,
                             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;

  const size_t smem = fc_smem_bytes(p);
  cudaError_t e = cudaFuncSetAttribute(
      roialign_fc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // Persistent: only as many clusters as are resident at once, or blocks
  // would wait for a second wave.
  cfg.gridDim = dim3(grid / CL * CL);
  int clusters = 0;
  e = cudaOccupancyMaxActiveClusters(&clusters, roialign_fc_kernel, &cfg);
  if (e != cudaSuccess) return (int)e;
  if (clusters < 1) return (int)cudaErrorInvalidConfiguration;
  grid = (clusters * CL < grid ? clusters * CL : grid) / CL * CL;
  cfg.gridDim = dim3(grid);
  e = cudaLaunchKernelEx(&cfg, roialign_fc_kernel, wmap, a);
  if (e != cudaSuccess) return (int)e;
  const int steps = p * p * p * (c / BK);
  const long long quads = (long long)n * f / 4;
  const int blocks = (int)((quads + 255) / 256 < 4 * grid ? (quads + 255) / 256
                                                          : 4 * grid);
  roialign_fc_finish<<<blocks, 256, 0, s>>>(a.bounds, a.ws, a.out, n, f,
                                            steps, grid);
  return (int)cudaGetLastError();
}
