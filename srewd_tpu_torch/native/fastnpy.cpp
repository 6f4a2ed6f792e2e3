// fastnpy — parallel .npy batch reader for the WeatherBench store.
//
// The data layer reads thousands of small per-hour .npy files per epoch and
// for the scaler-fit cold start (reference: data/npy_reader.py loads them
// one Python np.load at a time, SURVEY.md §3.5). This reader parses the npy
// header in C, preads payloads straight into one preallocated batch buffer,
// and fans files out over a thread pool. Called through ctypes (the call
// releases the GIL, so reads overlap Python work and each other).
//
// ABI (stable, minimal):
//   fastnpy_read_batch(paths, n, out, item_floats, threads) -> int
//     paths        n NUL-terminated file paths
//     out          float32 buffer of n * item_floats elements
//     item_floats  expected element count per file
//     threads      worker threads (<=1 means serial)
//   returns 0 on success, i+1 if file i failed (short/odd header, wrong
//   dtype/count, io error).
//
// Supported payloads: little-endian '<f4' (memcpy) and '<f8' (converted),
// C-order, npy format v1.0/v2.0.

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

constexpr char kMagic[6] = {'\x93', 'N', 'U', 'M', 'P', 'Y'};

// Reads one .npy file into out[0..item_floats). Returns true on success.
bool read_one(const char* path, float* out, int64_t item_floats) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  bool ok = false;
  std::vector<double> tmp;
  do {
    unsigned char pre[10];
    if (std::fread(pre, 1, 10, f) != 10) break;
    if (std::memcmp(pre, kMagic, 6) != 0) break;
    const unsigned major = pre[6];
    uint32_t hlen = 0;
    size_t hstart = 0;
    if (major == 1) {
      hlen = static_cast<uint32_t>(pre[8]) | (static_cast<uint32_t>(pre[9]) << 8);
      hstart = 10;
    } else if (major >= 2) {
      unsigned char ext[2];
      if (std::fread(ext, 1, 2, f) != 2) break;
      hlen = static_cast<uint32_t>(pre[8]) | (static_cast<uint32_t>(pre[9]) << 8) |
             (static_cast<uint32_t>(ext[0]) << 16) | (static_cast<uint32_t>(ext[1]) << 24);
      hstart = 12;
    } else {
      break;
    }
    std::string header(hlen, '\0');
    if (std::fread(&header[0], 1, hlen, f) != hlen) break;
    if (header.find("'fortran_order': True") != std::string::npos) break;

    const size_t dpos = header.find("'descr'");
    if (dpos == std::string::npos) break;
    const size_t q1 = header.find('\'', dpos + 7);
    const size_t q2 = (q1 == std::string::npos) ? std::string::npos : header.find('\'', q1 + 1);
    if (q2 == std::string::npos) break;
    const std::string descr = header.substr(q1 + 1, q2 - q1 - 1);

    int itemsize;
    if (descr == "<f4") {
      itemsize = 4;
    } else if (descr == "<f8") {
      itemsize = 8;
    } else {
      break;  // unsupported dtype -> caller falls back to numpy
    }

    // Element count from payload size (avoids parsing the shape tuple).
    if (std::fseek(f, 0, SEEK_END) != 0) break;
    const long fsize = std::ftell(f);
    const long payload = fsize - static_cast<long>(hstart + hlen);
    if (payload != item_floats * itemsize) break;
    if (std::fseek(f, static_cast<long>(hstart + hlen), SEEK_SET) != 0) break;

    if (itemsize == 4) {
      if (std::fread(out, 4, static_cast<size_t>(item_floats), f) !=
          static_cast<size_t>(item_floats))
        break;
    } else {
      tmp.resize(static_cast<size_t>(item_floats));
      if (std::fread(tmp.data(), 8, static_cast<size_t>(item_floats), f) !=
          static_cast<size_t>(item_floats))
        break;
      for (int64_t i = 0; i < item_floats; ++i) out[i] = static_cast<float>(tmp[i]);
    }
    ok = true;
  } while (false);
  std::fclose(f);
  return ok;
}

}  // namespace

extern "C" int fastnpy_read_batch(const char* const* paths, int n, float* out,
                                  int64_t item_floats, int threads) {
  std::atomic<int> failed{0};  // 0 = ok, else 1-based index of first failure
  if (threads <= 1 || n <= 1) {
    for (int i = 0; i < n; ++i) {
      if (!read_one(paths[i], out + static_cast<int64_t>(i) * item_floats, item_floats))
        return i + 1;
    }
    return 0;
  }
  std::atomic<int> next{0};
  auto worker = [&]() {
    for (;;) {
      const int i = next.fetch_add(1);
      if (i >= n || failed.load(std::memory_order_relaxed)) return;
      if (!read_one(paths[i], out + static_cast<int64_t>(i) * item_floats, item_floats)) {
        int expected = 0;
        failed.compare_exchange_strong(expected, i + 1);
        return;
      }
    }
  };
  const int nw = std::min(threads, n);
  std::vector<std::thread> pool;
  pool.reserve(static_cast<size_t>(nw));
  for (int t = 0; t < nw; ++t) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
  return failed.load();
}

extern "C" int fastnpy_version() { return 1; }
