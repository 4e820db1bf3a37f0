// maa3 native batch loader: parallel .npy mel/feature loading + crop/tile/pad.
//
// The port's own copy of the JAX package's loader (the same source): the
// trainer's collate reads a batch of .npy files in C++ threads (no GIL, no
// pickling), filling a caller-provided float32 batch buffer in place. The
// threads are joined before maa3_load_batch returns.
//
// Supports .npy files: little-endian float32/float64, C-order, 1-D or 2-D.
// Collate semantics match maa3_tpu_torch/native/io.py `load_batch_numpy`:
// crop to target_len, 'tile' repeats the clip, 'pad' fills pad_value; an
// unreadable file or one with another row count is filled with pad_value.
//
// Built at first use by maa3_tpu_torch/native/io.py:
//   g++ -O3 -shared -fPIC -std=c++17 -pthread loader.cpp -o libmaa3io.so

#include <atomic>
#include <cstdint>
#include <cstring>
#include <fstream>
#include <string>
#include <thread>
#include <vector>

namespace {

struct NpyInfo {
  int64_t rows = 0;
  int64_t cols = 0;
  int64_t word = 4;       // bytes per element (4=f4, 8=f8)
  int64_t offset = 0;     // data start
  bool ok = false;
};

// Minimal .npy header parser (format spec v1/v2, C-order only).
NpyInfo parse_npy_header(std::ifstream& f) {
  NpyInfo info;
  char magic[8];
  f.read(magic, 8);
  if (!f || std::memcmp(magic, "\x93NUMPY", 6) != 0) return info;
  uint8_t major = magic[6];
  uint32_t hlen = 0;
  if (major >= 2) {
    uint8_t b[4];
    f.read(reinterpret_cast<char*>(b), 4);
    hlen = b[0] | (b[1] << 8) | (b[2] << 16) | (b[3] << 24);
    info.offset = 12 + hlen;
  } else {
    uint8_t b[2];
    f.read(reinterpret_cast<char*>(b), 2);
    hlen = b[0] | (b[1] << 8);
    info.offset = 10 + hlen;
  }
  std::string header(hlen, '\0');
  f.read(header.data(), hlen);
  if (!f) return info;

  if (header.find("'fortran_order': True") != std::string::npos) return info;
  if (header.find("<f4") != std::string::npos) info.word = 4;
  else if (header.find("<f8") != std::string::npos) info.word = 8;
  else return info;

  auto sp = header.find("'shape':");
  if (sp == std::string::npos) return info;
  auto lp = header.find('(', sp);
  auto rp = header.find(')', lp);
  if (lp == std::string::npos || rp == std::string::npos) return info;
  std::string dims = header.substr(lp + 1, rp - lp - 1);
  int64_t vals[2] = {0, 1};
  int n = 0;
  const char* p = dims.c_str();
  while (*p && n < 2) {
    while (*p == ' ' || *p == ',') ++p;
    if (*p < '0' || *p > '9') break;
    int64_t v = 0;
    while (*p >= '0' && *p <= '9') v = v * 10 + (*p++ - '0');
    vals[n++] = v;
  }
  if (n == 0) return info;
  if (n == 1) { info.rows = 1; info.cols = vals[0]; }
  else        { info.rows = vals[0]; info.cols = vals[1]; }
  info.ok = true;
  return info;
}

// Load one npy into out (rows x target_len), crop/tile/pad along cols.
// Returns 0 on success, negative error code otherwise.
int load_one(const char* path, float* out, int64_t expect_rows,
             int64_t target_len, int mode /*0=pad 1=tile*/, float pad_value) {
  std::ifstream f(path, std::ios::binary);
  if (!f) return -1;
  NpyInfo info = parse_npy_header(f);
  if (!info.ok || info.rows != expect_rows) return -2;

  int64_t src_cols = info.cols;
  int64_t copy_cols = src_cols < target_len ? src_cols : target_len;
  std::vector<char> rowbuf(src_cols * info.word);

  for (int64_t r = 0; r < info.rows; ++r) {
    f.seekg(info.offset + r * src_cols * info.word);
    f.read(rowbuf.data(), src_cols * info.word);
    if (!f) return -3;
    float* dst = out + r * target_len;
    if (info.word == 4) {
      std::memcpy(dst, rowbuf.data(), copy_cols * sizeof(float));
    } else {
      const double* src = reinterpret_cast<const double*>(rowbuf.data());
      for (int64_t c = 0; c < copy_cols; ++c) dst[c] = float(src[c]);
    }
    if (copy_cols < target_len) {
      if (mode == 1 && copy_cols > 0) {  // tile
        for (int64_t c = copy_cols; c < target_len; ++c)
          dst[c] = dst[c % copy_cols];
      } else {                            // pad
        for (int64_t c = copy_cols; c < target_len; ++c) dst[c] = pad_value;
      }
    }
  }
  return 0;
}

}  // namespace

extern "C" {

// Fill batch (n, rows, target_len) float32 from n npy paths, in parallel.
// paths: array of n C strings. statuses: per-item result codes (0 = ok).
// Returns number of failed items.
int maa3_load_batch(const char** paths, int n, float* batch,
                    int64_t rows, int64_t target_len, int mode,
                    float pad_value, int num_threads, int* statuses) {
  if (num_threads <= 0) num_threads = std::thread::hardware_concurrency();
  if (num_threads > n) num_threads = n;
  std::atomic<int> next(0);
  std::atomic<int> failures(0);

  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) return;
      int rc = load_one(paths[i], batch + int64_t(i) * rows * target_len,
                        rows, target_len, mode, pad_value);
      statuses[i] = rc;
      if (rc != 0) {
        failures.fetch_add(1);
        // corruption tolerance: fill with pad_value (loader-level fault
        // tolerance, matching the reference datasets)
        float* dst = batch + int64_t(i) * rows * target_len;
        for (int64_t k = 0; k < rows * target_len; ++k) dst[k] = pad_value;
      }
    }
  };

  std::vector<std::thread> threads;
  for (int t = 0; t < num_threads; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
  return failures.load();
}

// Probe a npy's shape without loading data. Returns 0 on success.
int maa3_npy_shape(const char* path, int64_t* rows, int64_t* cols) {
  std::ifstream f(path, std::ios::binary);
  if (!f) return -1;
  NpyInfo info = parse_npy_header(f);
  if (!info.ok) return -2;
  *rows = info.rows;
  *cols = info.cols;
  return 0;
}

}  // extern "C"
