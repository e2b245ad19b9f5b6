// flowio - native host-side volume IO for tpuflow3d_torch.
//
// The port's own copy of the JAX package's native/flowio.cpp (the same C
// ABI and the same results): headerless raw volume IO, Z-slab reads and
// writes at an offset, and multi-threaded dtype widening (tomography
// volumes are commonly uint8/uint16 on disk but solve in float32).
//
// Host IO, not a device kernel. Built with g++ at first use and bound
// through ctypes by tpuflow3d_torch/utils/native.py. All functions return
// 0 on success, negative errno-style codes on failure.

#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fcntl.h>
#include <sys/stat.h>
#include <sys/types.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

constexpr int64_t kMinBytesPerThread = 8 << 20;  // 8 MiB

int num_threads_for(int64_t nbytes) {
  int hw = static_cast<int>(std::thread::hardware_concurrency());
  if (hw <= 0) hw = 4;
  int64_t want = (nbytes + kMinBytesPerThread - 1) / kMinBytesPerThread;
  if (want < 1) want = 1;
  if (want > hw) want = hw;
  return static_cast<int>(want);
}

// Run fn(lo, hi) over [0, n) split across threads.
template <typename Fn>
void parallel_ranges(int64_t n, int nthreads, Fn fn) {
  if (nthreads <= 1 || n < 2) {
    fn(static_cast<int64_t>(0), n);
    return;
  }
  std::vector<std::thread> ts;
  int64_t chunk = (n + nthreads - 1) / nthreads;
  for (int t = 0; t < nthreads; ++t) {
    int64_t lo = t * chunk;
    int64_t hi = lo + chunk < n ? lo + chunk : n;
    if (lo >= hi) break;
    ts.emplace_back([=] { fn(lo, hi); });
  }
  for (auto& th : ts) th.join();
}

int full_pread(int fd, char* dst, int64_t nbytes, int64_t offset) {
  int64_t done = 0;
  while (done < nbytes) {
    ssize_t r = ::pread(fd, dst + done, nbytes - done, offset + done);
    if (r < 0) {
      if (errno == EINTR) continue;
      return -errno;
    }
    if (r == 0) return -EIO;  // short file
    done += r;
  }
  return 0;
}

int full_pwrite(int fd, const char* src, int64_t nbytes, int64_t offset) {
  int64_t done = 0;
  while (done < nbytes) {
    ssize_t r = ::pwrite(fd, src + done, nbytes - done, offset + done);
    if (r < 0) {
      if (errno == EINTR) continue;
      return -errno;
    }
    done += r;
  }
  return 0;
}

}  // namespace

extern "C" {

// Read [offset, offset+nbytes) of a file into dst, multi-threaded.
int flowio_read(const char* path, int64_t offset, int64_t nbytes, void* dst) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return -errno;
  int err = 0;
  parallel_ranges(nbytes, num_threads_for(nbytes), [&](int64_t lo, int64_t hi) {
    int e = full_pread(fd, static_cast<char*>(dst) + lo, hi - lo, offset + lo);
    if (e != 0) __atomic_store_n(&err, e, __ATOMIC_RELAXED);
  });
  ::close(fd);
  return err;
}

// Write src into [offset, offset+nbytes) of a file, creating/extending it
// to total_bytes first (so out-of-order slab writes from multiple hosts
// compose). total_bytes < 0 skips the truncate.
int flowio_write(const char* path, int64_t offset, int64_t nbytes,
                 const void* src, int64_t total_bytes) {
  int fd = ::open(path, O_WRONLY | O_CREAT, 0644);
  if (fd < 0) return -errno;
  if (total_bytes >= 0) {
    struct stat st;
    if (::fstat(fd, &st) != 0) {
      int e = -errno;
      ::close(fd);
      return e;
    }
    if (st.st_size < total_bytes && ::ftruncate(fd, total_bytes) != 0) {
      int e = -errno;
      ::close(fd);
      return e;
    }
  }
  int err = 0;
  parallel_ranges(nbytes, num_threads_for(nbytes), [&](int64_t lo, int64_t hi) {
    int e = full_pwrite(fd, static_cast<const char*>(src) + lo, hi - lo,
                        offset + lo);
    if (e != 0) __atomic_store_n(&err, e, __ATOMIC_RELAXED);
  });
  ::close(fd);
  return err;
}

// Widen integer voxels to f32, multi-threaded. kind: 0=u8, 1=u16, 2=i16.
int flowio_to_f32(const void* src, float* dst, int64_t n, int kind) {
  parallel_ranges(n, num_threads_for(n * 4), [&](int64_t lo, int64_t hi) {
    switch (kind) {
      case 0: {
        const uint8_t* s = static_cast<const uint8_t*>(src);
        for (int64_t i = lo; i < hi; ++i) dst[i] = s[i];
        break;
      }
      case 1: {
        const uint16_t* s = static_cast<const uint16_t*>(src);
        for (int64_t i = lo; i < hi; ++i) dst[i] = s[i];
        break;
      }
      case 2: {
        const int16_t* s = static_cast<const int16_t*>(src);
        for (int64_t i = lo; i < hi; ++i) dst[i] = s[i];
        break;
      }
    }
  });
  return (kind >= 0 && kind <= 2) ? 0 : -EINVAL;
}

// Global min/max of an f32 buffer (for intensity normalization prescans
// without device round-trips), multi-threaded.
int flowio_minmax_f32(const float* src, int64_t n, float* out_min,
                      float* out_max) {
  if (n <= 0) return -EINVAL;
  int nt = num_threads_for(n * 4);
  std::vector<float> mins(nt, src[0]), maxs(nt, src[0]);
  std::vector<std::thread> ts;
  int64_t chunk = (n + nt - 1) / nt;
  for (int t = 0; t < nt; ++t) {
    int64_t lo = t * chunk;
    int64_t hi = lo + chunk < n ? lo + chunk : n;
    if (lo >= hi) break;
    ts.emplace_back([=, &mins, &maxs] {
      float mn = src[lo], mx = src[lo];
      for (int64_t i = lo; i < hi; ++i) {
        float v = src[i];
        if (v < mn) mn = v;
        if (v > mx) mx = v;
      }
      mins[t] = mn;
      maxs[t] = mx;
    });
  }
  for (auto& th : ts) th.join();
  float mn = mins[0], mx = maxs[0];
  for (int t = 1; t < nt; ++t) {
    if (mins[t] < mn) mn = mins[t];
    if (maxs[t] > mx) mx = maxs[t];
  }
  *out_min = mn;
  *out_max = mx;
  return 0;
}

int flowio_version() { return 1; }

}  // extern "C"
