// Stereo message-dump format + prefetching reader (native data loader).
//
// Native counterpart of the reference's txt_io message dumps: the trackers
// replay recorded streams (tracker_gt.cpp:182-268), produced from KITTI
// folders by republisher_kitti (republisher_kitti.cpp:28-100) and checked
// by validate_dataset (validate_dataset.cpp:73-111).  Fresh design: one
// binary file of paired stereo records (the reference pairs L/R messages by
// frame id + timestamp at read time; we pair at write time so the reader's
// hot path is a single sequential read), plus a background prefetch thread
// with a bounded ring buffer so image decode/IO overlaps device compute.
//
// Layout (little-endian):
//   magic "SVID" u32, version u32, n_frames u32, height u32, width u32
//   per frame: frame_id i64, timestamp f64,
//              left  h*w u8, right h*w u8
#pragma once

#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace svi {

constexpr uint32_t kDumpMagic = 0x44495653u;  // "SVID"
constexpr uint32_t kDumpVersion = 1;

struct DumpWriter {
  std::FILE* f = nullptr;
  uint32_t n = 0, h = 0, w = 0;

  bool open(const char* path, uint32_t height, uint32_t width) {
    f = std::fopen(path, "wb");
    if (!f) return false;
    h = height;
    w = width;
    uint32_t zero = 0;
    std::fwrite(&kDumpMagic, 1, 4, f);
    std::fwrite(&kDumpVersion, 1, 4, f);
    std::fwrite(&zero, 1, 4, f);  // frame count patched on close
    std::fwrite(&h, 1, 4, f);
    std::fwrite(&w, 1, 4, f);
    return true;
  }

  bool append(int64_t frame_id, double timestamp, const uint8_t* left,
              const uint8_t* right) {
    if (!f) return false;
    const size_t px = (size_t)h * w;
    bool ok = std::fwrite(&frame_id, 1, 8, f) == 8 &&
              std::fwrite(&timestamp, 1, 8, f) == 8 &&
              std::fwrite(left, 1, px, f) == px &&
              std::fwrite(right, 1, px, f) == px;
    if (ok) ++n;
    return ok;
  }

  void close() {
    if (!f) return;
    std::fseek(f, 8, SEEK_SET);
    std::fwrite(&n, 1, 4, f);
    std::fclose(f);
    f = nullptr;
  }
};

struct Frame {
  int64_t frame_id;
  double timestamp;
  std::vector<uint8_t> left, right;
};

// Sequential reader with a background prefetch thread: the thread reads
// ahead up to `depth` frames into a bounded queue; next() pops (blocking
// only if the reader thread is behind).
class DumpReader {
 public:
  bool open(const std::string& path, int depth) {
    f_ = std::fopen(path.c_str(), "rb");
    if (!f_) return false;
    uint32_t magic = 0, version = 0;
    if (std::fread(&magic, 1, 4, f_) != 4 || magic != kDumpMagic ||
        std::fread(&version, 1, 4, f_) != 4 || version != kDumpVersion ||
        std::fread(&n_, 1, 4, f_) != 4 || std::fread(&h_, 1, 4, f_) != 4 ||
        std::fread(&w_, 1, 4, f_) != 4) {
      std::fclose(f_);
      f_ = nullptr;
      return false;
    }
    depth_ = depth > 0 ? depth : 4;
    stop_ = false;
    thread_ = std::thread([this] { this->loop(); });
    return true;
  }

  uint32_t n_frames() const { return n_; }
  uint32_t height() const { return h_; }
  uint32_t width() const { return w_; }

  // Pop the next frame.  Returns false at end-of-stream.
  bool next(Frame* out) {
    std::unique_lock<std::mutex> lk(mu_);
    not_empty_.wait(lk, [this] { return !queue_.empty() || done_; });
    if (queue_.empty()) return false;
    *out = std::move(queue_.front());
    queue_.pop_front();
    not_full_.notify_one();
    return true;
  }

  void close() {
    {
      std::lock_guard<std::mutex> lk(mu_);
      stop_ = true;
      not_full_.notify_all();
    }
    if (thread_.joinable()) thread_.join();
    if (f_) {
      std::fclose(f_);
      f_ = nullptr;
    }
  }

  ~DumpReader() { close(); }

 private:
  void loop() {
    const size_t px = (size_t)h_ * w_;
    for (uint32_t i = 0; i < n_; ++i) {
      Frame fr;
      fr.left.resize(px);
      fr.right.resize(px);
      bool ok = std::fread(&fr.frame_id, 1, 8, f_) == 8 &&
                std::fread(&fr.timestamp, 1, 8, f_) == 8 &&
                std::fread(fr.left.data(), 1, px, f_) == px &&
                std::fread(fr.right.data(), 1, px, f_) == px;
      std::unique_lock<std::mutex> lk(mu_);
      if (!ok || stop_) break;
      not_full_.wait(lk, [this] { return (int)queue_.size() < depth_ || stop_; });
      if (stop_) break;
      queue_.push_back(std::move(fr));
      not_empty_.notify_one();
    }
    std::lock_guard<std::mutex> lk(mu_);
    done_ = true;
    not_empty_.notify_all();
  }

  std::FILE* f_ = nullptr;
  uint32_t n_ = 0, h_ = 0, w_ = 0;
  int depth_ = 4;
  std::thread thread_;
  std::mutex mu_;
  std::condition_variable not_empty_, not_full_;
  std::deque<Frame> queue_;
  bool stop_ = false, done_ = false;
};

// Offline integrity check (validate_dataset parity): frame ids strictly
// increasing, timestamps non-decreasing, file size consistent with header.
inline int dump_validate(const char* path, char* err, int err_len) {
  std::FILE* f = std::fopen(path, "rb");
  auto fail = [&](const char* msg) {
    std::snprintf(err, err_len, "%s", msg);
    if (f) std::fclose(f);
    return 0;
  };
  if (!f) return fail("cannot open file");
  uint32_t magic, version, n, h, w;
  if (std::fread(&magic, 1, 4, f) != 4 || magic != kDumpMagic)
    return fail("bad magic");
  if (std::fread(&version, 1, 4, f) != 4 || version != kDumpVersion)
    return fail("bad version");
  if (std::fread(&n, 1, 4, f) != 4 || std::fread(&h, 1, 4, f) != 4 ||
      std::fread(&w, 1, 4, f) != 4)
    return fail("truncated header");
  const size_t px = (size_t)h * w;
  int64_t prev_id = -1;
  double prev_ts = -1e300;
  std::vector<uint8_t> skip(2 * px);
  for (uint32_t i = 0; i < n; ++i) {
    int64_t id;
    double ts;
    if (std::fread(&id, 1, 8, f) != 8 || std::fread(&ts, 1, 8, f) != 8)
      return fail("truncated record header");
    if (id <= prev_id) return fail("frame ids not strictly increasing");
    if (ts < prev_ts) return fail("timestamps decreasing");
    prev_id = id;
    prev_ts = ts;
    if (std::fread(skip.data(), 1, 2 * px, f) != 2 * px)
      return fail("truncated image data");
  }
  std::fclose(f);
  return (int)n;
}

}  // namespace svi
