// m3d_native — C++ host-side data-path kernels (plain C ABI, ctypes-loaded).
//
// The port's own copy of the JAX package's host library, the native host
// runtime around the model:
//   - multi-page TIFF volume IO (the dataset hot path; uncompressed,
//     little-endian, 8/16-bit grayscale — the formats the pipeline writes)
//   - pairwise 3D IoU (the O(A*G) core of RPN target assignment,
//     reference: core/data_generators.py:2093)
//   - greedy 3D NMS (host-side eval filter cascade,
//     reference: core/utils.py:505-578)
//
// Build (m3d_torch/native.py, at first use, into m3d_torch/_build/):
//   g++ -O3 -std=c++17 -shared -fPIC -o m3d_native_<hash>.so m3d_native.cpp -lpthread
// The same flags as the JAX package's build, so both libraries compute the
// same IoU bits.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Pairwise 3D IoU: a [A,6], b [G,6] row-major (y1,x1,z1,y2,x2,z2) -> out [A,G]
// Multithreaded over rows of `a`.
// ---------------------------------------------------------------------------
void iou_matrix_3d(const float* a, int64_t A, const float* b, int64_t G,
                   float* out, int n_threads) {
  if (A <= 0 || G <= 0) return;
  std::vector<float> vol_b(G);
  for (int64_t j = 0; j < G; ++j) {
    const float* bj = b + j * 6;
    float y1 = std::min(bj[0], bj[3]), y2 = std::max(bj[0], bj[3]);
    float x1 = std::min(bj[1], bj[4]), x2 = std::max(bj[1], bj[4]);
    float z1 = std::min(bj[2], bj[5]), z2 = std::max(bj[2], bj[5]);
    vol_b[j] = (y2 - y1) * (x2 - x1) * (z2 - z1);
  }
  auto worker = [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      const float* ai = a + i * 6;
      float ay1 = std::min(ai[0], ai[3]), ay2 = std::max(ai[0], ai[3]);
      float ax1 = std::min(ai[1], ai[4]), ax2 = std::max(ai[1], ai[4]);
      float az1 = std::min(ai[2], ai[5]), az2 = std::max(ai[2], ai[5]);
      float va = (ay2 - ay1) * (ax2 - ax1) * (az2 - az1);
      float* row = out + i * G;
      for (int64_t j = 0; j < G; ++j) {
        const float* bj = b + j * 6;
        float by1 = std::min(bj[0], bj[3]), by2 = std::max(bj[0], bj[3]);
        float bx1 = std::min(bj[1], bj[4]), bx2 = std::max(bj[1], bj[4]);
        float bz1 = std::min(bj[2], bj[5]), bz2 = std::max(bj[2], bj[5]);
        float ih = std::max(0.f, std::min(ay2, by2) - std::max(ay1, by1));
        float iw = std::max(0.f, std::min(ax2, bx2) - std::max(ax1, bx1));
        float id = std::max(0.f, std::min(az2, bz2) - std::max(az1, bz1));
        float inter = ih * iw * id;
        float uni = va + vol_b[j] - inter;
        float iou = inter / std::max(uni, 1e-10f);
        row[j] = iou < 0.f ? 0.f : (iou > 1.f ? 1.f : iou);
      }
    }
  };
  int nt = n_threads > 0
               ? n_threads
               : std::max(1u, std::thread::hardware_concurrency());
  nt = (int)std::min<int64_t>(nt, std::max<int64_t>(1, A / 4096));
  if (nt <= 1) {
    worker(0, A);
    return;
  }
  std::vector<std::thread> threads;
  int64_t chunk = (A + nt - 1) / nt;
  for (int t = 0; t < nt; ++t) {
    int64_t lo = t * chunk, hi = std::min<int64_t>(A, lo + chunk);
    if (lo < hi) threads.emplace_back(worker, lo, hi);
  }
  for (auto& th : threads) th.join();
}

// ---------------------------------------------------------------------------
// Greedy 3D NMS. boxes [N,6], scores [N]; returns count of kept, indices in
// keep_out (caller allocates >= max_output). Semantics of the reference numpy
// fallback: keep while IoU <= threshold.
// ---------------------------------------------------------------------------
int64_t nms_3d_host(const float* boxes, const float* scores, int64_t N,
                    float iou_threshold, int64_t max_output,
                    int32_t* keep_out) {
  if (N <= 0 || max_output <= 0) return 0;
  std::vector<int64_t> order(N);
  for (int64_t i = 0; i < N; ++i) order[i] = i;
  std::stable_sort(order.begin(), order.end(), [&](int64_t l, int64_t r) {
    return scores[l] > scores[r];
  });
  std::vector<float> vol(N);
  for (int64_t i = 0; i < N; ++i) {
    const float* b = boxes + i * 6;
    vol[i] = (b[3] - b[0]) * (b[4] - b[1]) * (b[5] - b[2]);
  }
  std::vector<char> suppressed(N, 0);
  int64_t kept = 0;
  for (int64_t oi = 0; oi < N && kept < max_output; ++oi) {
    int64_t i = order[oi];
    if (suppressed[i]) continue;
    keep_out[kept++] = (int32_t)i;
    const float* bi = boxes + i * 6;
    for (int64_t oj = oi + 1; oj < N; ++oj) {
      int64_t j = order[oj];
      if (suppressed[j]) continue;
      const float* bj = boxes + j * 6;
      float ih = std::max(0.f, std::min(bi[3], bj[3]) - std::max(bi[0], bj[0]));
      float iw = std::max(0.f, std::min(bi[4], bj[4]) - std::max(bi[1], bj[1]));
      float id = std::max(0.f, std::min(bi[5], bj[5]) - std::max(bi[2], bj[2]));
      float inter = ih * iw * id;
      float uni = std::max(vol[i] + vol[j] - inter, 1e-10f);
      if (inter / uni > iou_threshold) suppressed[j] = 1;
    }
  }
  return kept;
}

// ---------------------------------------------------------------------------
// Minimal multi-page TIFF reader (uncompressed, little-endian, grayscale
// 8/16-bit — the format the pipeline's writer emits and typical microscopy
// exports). Two-call protocol: dims first, then data into caller buffer.
// Returns 0 on success, negative error codes otherwise.
// ---------------------------------------------------------------------------
namespace {
struct TiffPage {
  uint32_t width = 0, height = 0, bits = 8, rows_per_strip = 0;
  std::vector<uint32_t> strip_offsets, strip_byte_counts;
  uint32_t compression = 1;
};

struct TiffFile {
  std::vector<uint8_t> data;
  std::vector<TiffPage> pages;
};

static uint16_t rd16(const uint8_t* p) { return (uint16_t)(p[0] | p[1] << 8); }
static uint32_t rd32(const uint8_t* p) {
  return (uint32_t)(p[0] | p[1] << 8 | p[2] << 16 | (uint32_t)p[3] << 24);
}

static int parse_tiff(const char* path, TiffFile& tf) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  fseek(f, 0, SEEK_END);
  long size = ftell(f);
  fseek(f, 0, SEEK_SET);
  tf.data.resize(size);
  if (fread(tf.data.data(), 1, size, f) != (size_t)size) {
    fclose(f);
    return -2;
  }
  fclose(f);
  const uint8_t* d = tf.data.data();
  if (size < 8 || d[0] != 'I' || d[1] != 'I' || rd16(d + 2) != 42) return -3;
  uint32_t ifd = rd32(d + 4);
  while (ifd != 0 && ifd + 2 <= (uint32_t)size) {
    uint16_t n = rd16(d + ifd);
    TiffPage page;
    for (uint16_t e = 0; e < n; ++e) {
      const uint8_t* ent = d + ifd + 2 + e * 12;
      uint16_t tag = rd16(ent), type = rd16(ent + 2);
      uint32_t count = rd32(ent + 4);
      uint32_t val = type == 3 ? rd16(ent + 8) : rd32(ent + 8);
      auto read_array = [&](std::vector<uint32_t>& out) {
        out.resize(count);
        uint32_t elem = type == 3 ? 2 : 4;
        const uint8_t* src =
            (count * elem <= 4) ? ent + 8 : d + rd32(ent + 8);
        for (uint32_t i = 0; i < count; ++i)
          out[i] = type == 3 ? rd16(src + i * 2) : rd32(src + i * 4);
      };
      switch (tag) {
        case 256: page.width = val; break;
        case 257: page.height = val; break;
        case 258: page.bits = val; break;
        case 259: page.compression = val; break;
        case 273: read_array(page.strip_offsets); break;
        case 278: page.rows_per_strip = val; break;
        case 279: read_array(page.strip_byte_counts); break;
        default: break;
      }
    }
    if (page.compression != 1) return -4;  // uncompressed only
    tf.pages.push_back(std::move(page));
    ifd = rd32(d + ifd + 2 + n * 12);
  }
  return tf.pages.empty() ? -5 : 0;
}
}  // namespace

int tiff_read_dims(const char* path, int64_t* pages, int64_t* height,
                   int64_t* width, int64_t* bits) {
  TiffFile tf;
  int rc = parse_tiff(path, tf);
  if (rc) return rc;
  *pages = (int64_t)tf.pages.size();
  *height = tf.pages[0].height;
  *width = tf.pages[0].width;
  *bits = tf.pages[0].bits;
  return 0;
}

int tiff_read_data(const char* path, uint8_t* out, int64_t out_bytes) {
  TiffFile tf;
  int rc = parse_tiff(path, tf);
  if (rc) return rc;
  int64_t pos = 0;
  for (auto& page : tf.pages) {
    int64_t page_bytes = (int64_t)page.width * page.height * (page.bits / 8);
    int64_t copied = 0;
    for (size_t s = 0; s < page.strip_offsets.size(); ++s) {
      int64_t nb = page.strip_byte_counts.empty()
                       ? page_bytes
                       : page.strip_byte_counts[s];
      if (pos + copied + nb > out_bytes) return -6;
      std::memcpy(out + pos + copied, tf.data.data() + page.strip_offsets[s],
                  nb);
      copied += nb;
    }
    if (copied != page_bytes) return -7;
    pos += page_bytes;
  }
  return 0;
}

}  // extern "C"
