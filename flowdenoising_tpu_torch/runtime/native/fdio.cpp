// flowdenoising_tpu_torch native runtime: volume I/O and dtype conversion.
//
// The host-side data path of the port's CLI (MRC payload decode with dtype
// conversion, raw writes, single-pass volume statistics), a copy of the JAX
// package's runtime source with a plain C interface, loaded via ctypes.
//
// Build: flowdenoising_tpu_torch/runtime/__init__.py compiles it at first
// use with g++ -O3 -fPIC -shared -std=c++17 -pthread into
// build/flowdenoising_tpu_torch/libfdio-<hash of this source>.so.

#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cmath>
#include <thread>
#include <vector>
#include <algorithm>

#include <fcntl.h>
#include <unistd.h>

extern "C" {

// MRC modes: 0=int8, 1=int16, 2=float32, 6=uint16, 12=float16
enum FdMode { FD_INT8 = 0, FD_INT16 = 1, FD_FLOAT32 = 2, FD_UINT16 = 6, FD_FLOAT16 = 12 };

static inline float half_to_float(uint16_t h) {
    uint32_t sign = (uint32_t)(h & 0x8000u) << 16;
    uint32_t exp = (h >> 10) & 0x1Fu;
    uint32_t man = h & 0x3FFu;
    uint32_t bits;
    if (exp == 0) {
        if (man == 0) {
            bits = sign;
        } else {  // subnormal
            int e = -1;
            do { man <<= 1; ++e; } while (!(man & 0x400u));
            man &= 0x3FFu;
            bits = sign | ((uint32_t)(127 - 15 - e) << 23) | (man << 13);
        }
    } else if (exp == 31) {
        bits = sign | 0x7F800000u | (man << 13);
    } else {
        bits = sign | ((exp + 112u) << 23) | (man << 13);
    }
    float f;
    std::memcpy(&f, &bits, sizeof(f));
    return f;
}

static void convert_span(const uint8_t* src, float* dst, int64_t n, int mode) {
    switch (mode) {
        case FD_INT8: {
            const int8_t* p = (const int8_t*)src;
            for (int64_t i = 0; i < n; ++i) dst[i] = (float)p[i];
            break;
        }
        case FD_INT16: {
            const int16_t* p = (const int16_t*)src;
            for (int64_t i = 0; i < n; ++i) dst[i] = (float)p[i];
            break;
        }
        case FD_FLOAT32: {
            std::memcpy(dst, src, (size_t)n * 4);
            break;
        }
        case FD_UINT16: {
            const uint16_t* p = (const uint16_t*)src;
            for (int64_t i = 0; i < n; ++i) dst[i] = (float)p[i];
            break;
        }
        case FD_FLOAT16: {
            const uint16_t* p = (const uint16_t*)src;
            for (int64_t i = 0; i < n; ++i) dst[i] = half_to_float(p[i]);
            break;
        }
    }
}

static int64_t mode_itemsize(int mode) {
    switch (mode) {
        case FD_INT8: return 1;
        case FD_INT16: return 2;
        case FD_FLOAT32: return 4;
        case FD_UINT16: return 2;
        case FD_FLOAT16: return 2;
    }
    return 0;
}

// Read an MRC payload and convert it to float32, multithreaded.
// Returns 0 on success, negative errno-style codes on failure.
int fd_read_convert(const char* path, int64_t offset, int64_t count, int mode,
                    float* out, int n_threads) {
    int64_t isz = mode_itemsize(mode);
    if (isz == 0) return -22;  // EINVAL
    FILE* f = std::fopen(path, "rb");
    if (!f) return -2;  // ENOENT
    if (std::fseek(f, (long)offset, SEEK_SET) != 0) { std::fclose(f); return -5; }

    const int64_t CHUNK = 16 << 20;  // 16 MiB read granularity
    std::vector<uint8_t> buf((size_t)std::min<int64_t>(CHUNK, count * isz));
    int64_t done = 0;
    int nt = std::max(1, n_threads);
    while (done < count) {
        int64_t items = std::min<int64_t>(count - done, CHUNK / isz);
        size_t want = (size_t)(items * isz);
        if (std::fread(buf.data(), 1, want, f) != want) { std::fclose(f); return -5; }
        if (nt <= 1 || items < (1 << 18)) {
            convert_span(buf.data(), out + done, items, mode);
        } else {
            std::vector<std::thread> th;
            int64_t per = (items + nt - 1) / nt;
            for (int t = 0; t < nt; ++t) {
                int64_t s = t * per;
                int64_t e = std::min<int64_t>(items, s + per);
                if (s >= e) break;
                th.emplace_back([&, s, e]() {
                    convert_span(buf.data() + s * isz, out + done + s, e - s, mode);
                });
            }
            for (auto& t : th) t.join();
        }
        done += items;
    }
    std::fclose(f);
    return 0;
}

// Write raw bytes (header + payload) contiguously.  Uses unbuffered POSIX
// write() -- stdio fwrite copies every chunk through the FILE buffer, which
// measured ~4x slower than a direct write of the mapped payload.
static int write_all(int fd, const uint8_t* p, int64_t n) {
    while (n > 0) {
        ssize_t w = ::write(fd, p, (size_t)std::min<int64_t>(n, 1 << 30));
        if (w <= 0) {
            if (w < 0 && errno == EINTR) continue;
            return -5;
        }
        p += w;
        n -= w;
    }
    return 0;
}

int fd_write_raw(const char* path, const uint8_t* header, int64_t header_len,
                 const float* data, int64_t count) {
    int fd = ::open(path, O_WRONLY | O_CREAT | O_TRUNC, 0644);
    if (fd < 0) return -2;
    int rc = 0;
    if (header_len > 0) rc = write_all(fd, header, header_len);
    if (rc == 0) rc = write_all(fd, (const uint8_t*)data, count * 4);
    ::close(fd);
    return rc;
}

// Single-pass min/max/sum/sum-of-squares (for MRC header stats):
// out4 = {min, max, mean, rms-about-mean}.
int fd_stats_f32(const float* data, int64_t count, double* out4) {
    if (count <= 0) return -22;
    double mn = data[0], mx = data[0], s = 0.0, s2 = 0.0;
    for (int64_t i = 0; i < count; ++i) {
        double v = data[i];
        if (v < mn) mn = v;
        if (v > mx) mx = v;
        s += v;
        s2 += v * v;
    }
    double mean = s / (double)count;
    double var = s2 / (double)count - mean * mean;
    out4[0] = mn;
    out4[1] = mx;
    out4[2] = mean;
    out4[3] = var > 0 ? std::sqrt(var) : 0.0;
    return 0;
}

}  // extern "C"
