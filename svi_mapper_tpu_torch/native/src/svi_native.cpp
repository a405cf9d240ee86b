// C ABI for the svi_mapper_tpu_torch native runtime (loaded via ctypes).
//
// Exposes the host-side C++ components -- descriptor search index
// (hbst.hpp), keyframe-cloud codec (cloud_io.hpp), and the prefetching
// stereo dump loader (dump_io.hpp).  All handles are opaque pointers;
// all buffers are caller-allocated NumPy memory.
//
// Build: g++ -O3 -std=c++17 -shared -fPIC -pthread (see ../build.py).

#include <cstdint>
#include <cstring>

#include "cloud_io.hpp"
#include "dump_io.hpp"
#include "hbst.hpp"

extern "C" {

// ---------------------------------------------------------------------------
// descriptor index
// ---------------------------------------------------------------------------

void* svi_index_create(int max_depth, int max_leaf_size) {
  return new svi::DescriptorIndex(max_depth, max_leaf_size);
}

void svi_index_destroy(void* h) {
  delete static_cast<svi::DescriptorIndex*>(h);
}

void svi_index_add(void* h, const uint64_t* descs, int n, int64_t keyframe_id) {
  static_cast<svi::DescriptorIndex*>(h)->add(descs, n, keyframe_id);
}

int64_t svi_index_size(void* h) {
  return static_cast<svi::DescriptorIndex*>(h)->size();
}

int64_t svi_index_n_keyframes(void* h) {
  return static_cast<svi::DescriptorIndex*>(h)->n_keyframes();
}

void svi_index_query(void* h, const uint64_t* descs, int n, int cutoff,
                     int64_t max_kf, int32_t* votes) {
  auto* idx = static_cast<svi::DescriptorIndex*>(h);
  std::memset(votes, 0, sizeof(int32_t) * idx->n_keyframes());
  idx->query(descs, n, cutoff, max_kf, votes);
}

// ---------------------------------------------------------------------------
// cloud codec
// ---------------------------------------------------------------------------

int svi_cloud_write(const char* path, int64_t keyframe_id, int64_t frame_idx,
                    const float* T_wc, uint32_t n, const int64_t* uids,
                    const float* points_w, const float* points_cam,
                    const float* uv_left, const float* uv_right,
                    const uint64_t* descriptors) {
  svi::CloudHeader h;
  h.keyframe_id = keyframe_id;
  h.frame_idx = frame_idx;
  std::memcpy(h.T_wc, T_wc, sizeof(h.T_wc));
  h.n = n;
  return svi::cloud_write(path, h, uids, points_w, points_cam, uv_left,
                          uv_right, descriptors)
             ? 1
             : 0;
}

// Returns n (landmark count) or -1; fills keyframe_id/frame_idx/T_wc[16].
int64_t svi_cloud_read_header(const char* path, int64_t* keyframe_id,
                              int64_t* frame_idx, float* T_wc) {
  svi::CloudHeader h;
  if (!svi::cloud_read_header(path, &h)) return -1;
  *keyframe_id = h.keyframe_id;
  *frame_idx = h.frame_idx;
  std::memcpy(T_wc, h.T_wc, sizeof(h.T_wc));
  return h.n;
}

int svi_cloud_read(const char* path, int64_t* uids, float* points_w,
                   float* points_cam, float* uv_left, float* uv_right,
                   uint64_t* descriptors) {
  svi::CloudHeader h;
  return svi::cloud_read(path, &h, uids, points_w, points_cam, uv_left,
                         uv_right, descriptors)
             ? 1
             : 0;
}

// ---------------------------------------------------------------------------
// stereo dump loader
// ---------------------------------------------------------------------------

void* svi_dump_writer_open(const char* path, uint32_t height, uint32_t width) {
  auto* w = new svi::DumpWriter();
  if (!w->open(path, height, width)) {
    delete w;
    return nullptr;
  }
  return w;
}

int svi_dump_writer_append(void* h, int64_t frame_id, double timestamp,
                           const uint8_t* left, const uint8_t* right) {
  return static_cast<svi::DumpWriter*>(h)->append(frame_id, timestamp, left,
                                                  right)
             ? 1
             : 0;
}

void svi_dump_writer_close(void* h) {
  auto* w = static_cast<svi::DumpWriter*>(h);
  w->close();
  delete w;
}

// Opens with a `prefetch` deep background reader thread.
void* svi_dump_reader_open(const char* path, int prefetch, uint32_t* n_frames,
                           uint32_t* height, uint32_t* width) {
  auto* r = new svi::DumpReader();
  if (!r->open(path, prefetch)) {
    delete r;
    return nullptr;
  }
  *n_frames = r->n_frames();
  *height = r->height();
  *width = r->width();
  return r;
}

// Pops into caller buffers; returns 1, or 0 at end-of-stream.
int svi_dump_reader_next(void* h, int64_t* frame_id, double* timestamp,
                         uint8_t* left, uint8_t* right) {
  auto* r = static_cast<svi::DumpReader*>(h);
  svi::Frame fr;
  if (!r->next(&fr)) return 0;
  *frame_id = fr.frame_id;
  *timestamp = fr.timestamp;
  std::memcpy(left, fr.left.data(), fr.left.size());
  std::memcpy(right, fr.right.data(), fr.right.size());
  return 1;
}

void svi_dump_reader_close(void* h) {
  auto* r = static_cast<svi::DumpReader*>(h);
  r->close();
  delete r;
}

int svi_dump_validate(const char* path, char* err, int err_len) {
  return svi::dump_validate(path, err, err_len);
}

}  // extern "C"
