// Native data-plane: KITTI/SemanticKITTI ingestion + voxel downsampling.
//
// A copy of the JAX package's semicp/data/native/loader.cpp: host code
// with no device in it. Binary parsing straight into planar buffers,
// label remap through a LUT, and a hash-based voxel downsample, run by
// the scan prefetch thread while the previous scan is on the device.
//
// Exposed via a plain C ABI for ctypes.
//
// Build (semicp_torch/data/native/__init__.py does this on first use):
//   g++ -O3 -march=native -shared -fPIC loader.cpp -o libsemicp_loader.so

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <unordered_map>
#include <vector>

extern "C" {

// Parse a KITTI velodyne .bin (float32 x,y,z,reflectance) straight into
// caller-provided planar buffers. Returns point count, or -1 on error.
// Caller sizes buffers via semicp_bin_count().
long semicp_bin_count(const char* path) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  std::fseek(f, 0, SEEK_END);
  long bytes = std::ftell(f);
  std::fclose(f);
  if (bytes < 0 || bytes % 16 != 0) return -1;
  return bytes / 16;
}

long semicp_load_bin_planar(const char* path, float* xs, float* ys, float* zs,
                            float* intensity, long cap) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  std::vector<float> buf(4096 * 4);
  long n = 0;
  size_t got;
  while ((got = std::fread(buf.data(), sizeof(float) * 4, 4096, f)) > 0) {
    if (n + (long)got > cap) { std::fclose(f); return -1; }
    for (size_t i = 0; i < got; ++i) {
      xs[n + i] = buf[i * 4 + 0];
      ys[n + i] = buf[i * 4 + 1];
      zs[n + i] = buf[i * 4 + 2];
      if (intensity) intensity[n + i] = buf[i * 4 + 3];
    }
    n += (long)got;
  }
  std::fclose(f);
  return n;
}

// Parse a SemanticKITTI .label file and remap through a caller-provided
// 65536-entry LUT (raw id -> train id). Returns count or -1.
long semicp_load_labels(const char* path, const int32_t* lut,
                        int32_t* out, long cap) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  std::vector<uint32_t> buf(8192);
  long n = 0;
  size_t got;
  while ((got = std::fread(buf.data(), sizeof(uint32_t), buf.size(), f)) > 0) {
    if (n + (long)got > cap) { std::fclose(f); return -1; }
    for (size_t i = 0; i < got; ++i)
      out[n + i] = lut[buf[i] & 0xFFFFu];
    n += (long)got;
  }
  std::fclose(f);
  return n;
}

// Voxel downsample keeping the first point per (cell, no centroid — label
// integrity, matches semicp.data.kitti.voxel_downsample semantics).
// In/out planar arrays; returns the kept count.
long semicp_voxel_downsample(const float* xs, const float* ys, const float* zs,
                             const int32_t* labels, long n, float voxel,
                             float* oxs, float* oys, float* ozs,
                             int32_t* olabels) {
  if (voxel <= 0.f) return -1;
  std::unordered_map<uint64_t, char> seen;
  seen.reserve((size_t)n);
  const double inv = 1.0 / voxel;
  long m = 0;
  for (long i = 0; i < n; ++i) {
    int64_t cx = (int64_t)std::floor(xs[i] * inv);
    int64_t cy = (int64_t)std::floor(ys[i] * inv);
    int64_t cz = (int64_t)std::floor(zs[i] * inv);
    uint64_t key = (uint64_t)(cx * 73856093LL) ^ (uint64_t)(cy * 19349663LL) ^
                   (uint64_t)(cz * 83492791LL);
    auto ins = seen.emplace(key, 1);
    if (!ins.second) continue;
    oxs[m] = xs[i];
    oys[m] = ys[i];
    ozs[m] = zs[i];
    if (olabels) olabels[m] = labels ? labels[i] : 0;
    ++m;
  }
  return m;
}

}  // extern "C"
