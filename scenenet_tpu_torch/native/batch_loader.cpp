// Native batch loader: .npy crop files → padded point batches, in real
// threads (no GIL). The port's own copy of the JAX package's
// scenenet_tpu/native/batch_loader.cpp.
//
// The round-2 pipeline rehearsal measured the Python loader at
// ~425 samples/s *per core* with thread-pool prefetch collapsing on the
// GIL (benchmarks/RESULTS.md). This loader does the whole per-sample hot
// path in C++ — npy header parse, fread, f64→f32, xyz min-centering,
// subsample, pad — across a real std::thread pool, so host prep scales
// with cores from a single Python call (ctypes releases the GIL).
//
// Input files are TS40K/KITTI crop .npy arrays: shape (N, 4) float32 or
// float64, C-order (xyz + class). Subsampling beyond max_points uses a
// deterministic LCG permutation (documented deviation from PointPadding's
// numpy Generator draw — same uniform-without-replacement distribution,
// different member).

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

struct NpyInfo {
  int64_t rows = 0;
  int64_t cols = 0;
  bool f64 = false;
  int64_t data_offset = 0;
};

// minimal .npy v1/v2 header parser for C-order float32/float64 2D arrays
bool parse_npy_header(FILE* f, NpyInfo* info) {
  unsigned char magic[8];
  if (fread(magic, 1, 8, f) != 8) return false;
  if (memcmp(magic, "\x93NUMPY", 6) != 0) return false;
  int major = magic[6];
  uint32_t hlen = 0;
  if (major == 1) {
    unsigned char b[2];
    if (fread(b, 1, 2, f) != 2) return false;
    hlen = b[0] | (b[1] << 8);
    info->data_offset = 10 + hlen;
  } else {
    unsigned char b[4];
    if (fread(b, 1, 4, f) != 4) return false;
    hlen = b[0] | (b[1] << 8) | (b[2] << 16) | (uint32_t(b[3]) << 24);
    info->data_offset = 12 + hlen;
  }
  std::string hdr(hlen, '\0');
  if (fread(&hdr[0], 1, hlen, f) != hlen) return false;
  if (hdr.find("'fortran_order': True") != std::string::npos) return false;
  if (hdr.find("<f8") != std::string::npos) info->f64 = true;
  else if (hdr.find("<f4") != std::string::npos) info->f64 = false;
  else return false;
  auto sp = hdr.find("'shape':");
  if (sp == std::string::npos) return false;
  auto lp = hdr.find('(', sp);
  auto rp = hdr.find(')', sp);
  if (lp == std::string::npos || rp == std::string::npos) return false;
  std::string shape = hdr.substr(lp + 1, rp - lp - 1);
  if (sscanf(shape.c_str(), "%ld , %ld", &info->rows, &info->cols) != 2 &&
      sscanf(shape.c_str(), "%ld, %ld", &info->rows, &info->cols) != 2)
    return false;
  return info->rows > 0 && info->cols >= 4;
}

// deterministic uniform subsample without replacement: partial
// Fisher-Yates driven by splitmix64 seeded with n (like PointPadding's
// default_rng(n), modulo the generator family)
void subsample_indices(int64_t n, int64_t k, std::vector<int64_t>* out) {
  std::vector<int64_t> idx(n);
  for (int64_t i = 0; i < n; ++i) idx[i] = i;
  uint64_t s = uint64_t(n) + 0x9E3779B97F4A7C15ull;
  auto next = [&s]() {
    s += 0x9E3779B97F4A7C15ull;
    uint64_t z = s;
    z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
    z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
    return z ^ (z >> 31);
  };
  out->resize(k);
  for (int64_t i = 0; i < k; ++i) {
    int64_t j = i + int64_t(next() % uint64_t(n - i));
    std::swap(idx[i], idx[j]);
    (*out)[i] = idx[i];
  }
}

// one sample: read, (maybe) subsample, min-center xyz, pad into slot b
bool load_one(const char* path, int64_t max_points, float* pts,
              int32_t* labels, uint8_t* mask) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  NpyInfo info;
  if (!parse_npy_header(f, &info)) {
    fclose(f);
    return false;
  }
  const int64_t n_raw = info.rows;
  const int64_t cols = info.cols;
  const size_t elem = info.f64 ? 8 : 4;
  std::vector<unsigned char> buf(size_t(n_raw) * cols * elem);
  if (fseek(f, long(info.data_offset), SEEK_SET) != 0 ||
      fread(buf.data(), 1, buf.size(), f) != buf.size()) {
    fclose(f);
    return false;
  }
  fclose(f);

  auto get = [&](int64_t r, int64_t c) -> double {
    if (info.f64) {
      double v;
      memcpy(&v, buf.data() + (size_t(r) * cols + c) * 8, 8);
      return v;
    }
    float v;
    memcpy(&v, buf.data() + (size_t(r) * cols + c) * 4, 4);
    return double(v);
  };

  std::vector<int64_t> sel;
  int64_t n = n_raw;
  const int64_t* sel_ptr = nullptr;
  if (n_raw > max_points) {
    subsample_indices(n_raw, max_points, &sel);
    sel_ptr = sel.data();
    n = max_points;
  }

  double mn[3] = {1e300, 1e300, 1e300};
  for (int64_t i = 0; i < n; ++i) {
    int64_t r = sel_ptr ? sel_ptr[i] : i;
    for (int c = 0; c < 3; ++c) {
      double v = get(r, c);
      if (v < mn[c]) mn[c] = v;
    }
  }
  for (int64_t i = 0; i < n; ++i) {
    int64_t r = sel_ptr ? sel_ptr[i] : i;
    for (int c = 0; c < 3; ++c)
      pts[i * 3 + c] = float(get(r, c) - mn[c]);
    labels[i] = int32_t(get(r, 3));
    mask[i] = 1;
  }
  for (int64_t i = n; i < max_points; ++i) {
    pts[i * 3] = pts[i * 3 + 1] = pts[i * 3 + 2] = 0.0f;
    labels[i] = 0;
    mask[i] = 0;
  }
  return true;
}

}  // namespace

extern "C" {

// paths: n_files NUL-terminated strings, concatenated.
// pts (n_files*max_points*3 f32), labels (n_files*max_points i32),
// mask (n_files*max_points u8) — caller-allocated.
// Returns 0 on success, or (1-based) index of the first failing file.
int snt_load_batch(const char* paths, int n_files, int64_t max_points,
                   int n_threads, float* pts, int32_t* labels,
                   uint8_t* mask) {
  std::vector<const char*> files(n_files);
  const char* p = paths;
  for (int i = 0; i < n_files; ++i) {
    files[i] = p;
    p += strlen(p) + 1;
  }
  std::atomic<int> next(0);
  std::atomic<int> failed(0);
  int workers = n_threads > 0 ? n_threads : 1;
  if (workers > n_files) workers = n_files;
  auto run = [&]() {
    while (true) {
      int i = next.fetch_add(1);
      if (i >= n_files) break;
      bool ok = load_one(files[i], max_points, pts + size_t(i) * max_points * 3,
                         labels + size_t(i) * max_points,
                         mask + size_t(i) * max_points);
      if (!ok) {
        int expected = 0;
        failed.compare_exchange_strong(expected, i + 1);
      }
    }
  };
  std::vector<std::thread> pool;
  for (int t = 0; t < workers; ++t) pool.emplace_back(run);
  for (auto& th : pool) th.join();
  return failed.load();
}

}  // extern "C"
