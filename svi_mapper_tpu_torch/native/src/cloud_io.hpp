// Binary keyframe-cloud codec.
//
// Native counterpart of the reference's .cloud files (written by
// CKeyFrame::saveCloudToFile, CKeyFrame.cpp:138-185, re-read by the file
// constructor :102-119 via the CLogger binary datum helpers CLogger.h:36-46).
// Fresh format, not the reference's: fixed little-endian header + contiguous
// column arrays so the Python side can read straight into NumPy buffers.
//
// Layout (all little-endian):
//   magic  "SVIC"            4 bytes
//   version u32              (=1)
//   keyframe_id i64, frame_idx i64
//   T_wc    16 x f32         (row-major 4x4)
//   n       u32              landmark count
//   uids        n x i64
//   points_w    n x 3 x f32
//   points_cam  n x 3 x f32
//   uv_left     n x 2 x f32
//   uv_right    n x 2 x f32
//   descriptors n x 4 x u64  (256-bit packed BRIEF)
#pragma once

#include <cstdint>
#include <cstdio>
#include <cstring>

namespace svi {

constexpr uint32_t kCloudMagic = 0x43495653u;  // "SVIC"
constexpr uint32_t kCloudVersion = 1;

struct CloudHeader {
  int64_t keyframe_id;
  int64_t frame_idx;
  float T_wc[16];
  uint32_t n;
};

inline bool cloud_write(const char* path, const CloudHeader& h,
                        const int64_t* uids, const float* points_w,
                        const float* points_cam, const float* uv_left,
                        const float* uv_right, const uint64_t* descriptors) {
  std::FILE* f = std::fopen(path, "wb");
  if (!f) return false;
  bool ok = true;
  auto put = [&](const void* p, size_t bytes) {
    ok = ok && std::fwrite(p, 1, bytes, f) == bytes;
  };
  put(&kCloudMagic, 4);
  put(&kCloudVersion, 4);
  put(&h.keyframe_id, 8);
  put(&h.frame_idx, 8);
  put(h.T_wc, 16 * 4);
  put(&h.n, 4);
  const size_t n = h.n;
  put(uids, n * 8);
  put(points_w, n * 3 * 4);
  put(points_cam, n * 3 * 4);
  put(uv_left, n * 2 * 4);
  put(uv_right, n * 2 * 4);
  put(descriptors, n * 4 * 8);
  std::fclose(f);
  return ok;
}

// Read just the header (so the caller can size its buffers).
inline bool cloud_read_header(const char* path, CloudHeader* h) {
  std::FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  uint32_t magic = 0, version = 0;
  bool ok = std::fread(&magic, 1, 4, f) == 4 && magic == kCloudMagic &&
            std::fread(&version, 1, 4, f) == 4 && version == kCloudVersion &&
            std::fread(&h->keyframe_id, 1, 8, f) == 8 &&
            std::fread(&h->frame_idx, 1, 8, f) == 8 &&
            std::fread(h->T_wc, 1, 64, f) == 64 &&
            std::fread(&h->n, 1, 4, f) == 4;
  std::fclose(f);
  return ok;
}

inline bool cloud_read(const char* path, CloudHeader* h, int64_t* uids,
                       float* points_w, float* points_cam, float* uv_left,
                       float* uv_right, uint64_t* descriptors) {
  std::FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  uint32_t magic = 0, version = 0;
  bool ok = std::fread(&magic, 1, 4, f) == 4 && magic == kCloudMagic &&
            std::fread(&version, 1, 4, f) == 4 && version == kCloudVersion &&
            std::fread(&h->keyframe_id, 1, 8, f) == 8 &&
            std::fread(&h->frame_idx, 1, 8, f) == 8 &&
            std::fread(h->T_wc, 1, 64, f) == 64 &&
            std::fread(&h->n, 1, 4, f) == 4;
  const size_t n = ok ? h->n : 0;
  auto get = [&](void* p, size_t bytes) {
    ok = ok && std::fread(p, 1, bytes, f) == bytes;
  };
  get(uids, n * 8);
  get(points_w, n * 3 * 4);
  get(points_cam, n * 3 * 4);
  get(uv_left, n * 2 * 4);
  get(uv_right, n * 2 * 4);
  get(descriptors, n * 4 * 8);
  std::fclose(f);
  return ok;
}

}  // namespace svi
