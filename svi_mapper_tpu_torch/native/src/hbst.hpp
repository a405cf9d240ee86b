// Incremental binary descriptor search tree (host-side place recognition).
//
// Fills the role of the reference's CBTree/CBNode/CBITree descriptor trees
// (reference CBNode.h:64-201 split-bit construction, CBTree.h:198-236
// bit-guided descent + leaf scan, CBITree.h:15-60 incremental add) and of
// the DBoW2 BriefDatabase keyframe query (CTrackerGT.cpp:411): descriptors
// from every keyframe live in ONE incrementally grown tree; a query pool
// descends bit-by-bit to a leaf, linearly scans it under a Hamming cutoff,
// and votes for the owning keyframe of its best match.  This is a fresh
// implementation (HBST-style), not a translation: nodes split lazily on
// insertion overflow instead of eagerly at build time, and matching returns
// per-keyframe vote counts directly (the only thing the TPU pipeline needs
// from the host index -- candidate shortlisting; exact pool-vs-pool match
// geometry runs on device, svi_mapper_tpu_torch/mapping/closure.py).
//
// Descriptors are 256-bit BRIEF packed as 4 x uint64 words.
#pragma once

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <memory>
#include <unordered_map>
#include <vector>

namespace svi {

constexpr int kWords = 4;  // 256 bits

struct Descriptor {
  uint64_t w[kWords];
  int64_t keyframe_id;
};

inline int hamming(const uint64_t* a, const uint64_t* b) {
  int d = 0;
  for (int i = 0; i < kWords; ++i) d += __builtin_popcountll(a[i] ^ b[i]);
  return d;
}

inline bool test_bit(const uint64_t* w, int bit) {
  return (w[bit >> 6] >> (bit & 63)) & 1u;
}

class DescriptorIndex {
 public:
  DescriptorIndex(int max_depth, int max_leaf_size)
      : max_depth_(max_depth), max_leaf_size_(max_leaf_size) {
    root_ = std::make_unique<Node>();
  }

  // Insert one keyframe's descriptor pool.
  void add(const uint64_t* descs, int n, int64_t keyframe_id) {
    for (int i = 0; i < n; ++i) {
      Descriptor d;
      std::memcpy(d.w, descs + i * kWords, sizeof(d.w));
      d.keyframe_id = keyframe_id;
      insert(root_.get(), d, 0);
      ++size_;
    }
    if (keyframe_id >= n_keyframes_) n_keyframes_ = keyframe_id + 1;
  }

  // For each query descriptor: descend, scan the leaf, and if the best
  // match is within `cutoff`, vote for its keyframe.  Returns the vote
  // count per keyframe id in [0, n_keyframes).  `max_kf >= 0` restricts the
  // scan to keyframes with id < max_kf — the temporal exclusion of closure
  // search, applied at vote time so recent (or self) duplicates cannot
  // shadow older keyframes (the reference queries DBoW2 BEFORE adding the
  // new keyframe, CTrackerGT.cpp:411).
  void query(const uint64_t* descs, int n, int cutoff, int64_t max_kf,
             int32_t* votes /* [n_keyframes] zero-initialised by caller */) const {
    for (int i = 0; i < n; ++i) {
      const uint64_t* q = descs + i * kWords;
      const Node* node = root_.get();
      while (node->split_bit >= 0) {
        node = test_bit(q, node->split_bit) ? node->one.get() : node->zero.get();
      }
      int best = cutoff + 1;
      int64_t best_kf = -1;
      for (const Descriptor& d : node->leaf) {
        if (max_kf >= 0 && d.keyframe_id >= max_kf) continue;
        int dist = hamming(q, d.w);
        if (dist < best) {
          best = dist;
          best_kf = d.keyframe_id;
        }
      }
      if (best_kf >= 0) votes[best_kf] += 1;
    }
  }

  int64_t size() const { return size_; }
  int64_t n_keyframes() const { return n_keyframes_; }

 private:
  struct Node {
    int split_bit = -1;  // -1: leaf
    std::vector<Descriptor> leaf;
    std::unique_ptr<Node> zero, one;
  };

  void insert(Node* node, const Descriptor& d, int depth) {
    while (node->split_bit >= 0) {
      node = test_bit(d.w, node->split_bit) ? node->one.get() : node->zero.get();
      ++depth;
    }
    node->leaf.push_back(d);
    if ((int)node->leaf.size() > max_leaf_size_ && depth < max_depth_) {
      split(node);
    }
  }

  // Choose the bit whose ones-fraction over the leaf is closest to 0.5
  // (the balanced-split criterion of the reference, CBNode.h:64-92) and
  // partition the leaf.  If no bit separates the set (all descriptors
  // identical on every bit), stay a leaf.
  void split(Node* node) {
    const size_t n = node->leaf.size();
    int counts[256] = {0};
    for (const Descriptor& d : node->leaf)
      for (int bit = 0; bit < 256; ++bit)
        if (test_bit(d.w, bit)) ++counts[bit];
    int best_bit = -1;
    double best_score = 1e9;
    for (int bit = 0; bit < 256; ++bit) {
      if (counts[bit] == 0 || counts[bit] == (int)n) continue;  // non-separating
      double score = std::abs((double)counts[bit] / n - 0.5);
      if (score < best_score) {
        best_score = score;
        best_bit = bit;
      }
    }
    if (best_bit < 0) return;  // unsplittable: identical descriptors
    node->split_bit = best_bit;
    node->zero = std::make_unique<Node>();
    node->one = std::make_unique<Node>();
    for (const Descriptor& d : node->leaf)
      (test_bit(d.w, best_bit) ? node->one : node->zero)->leaf.push_back(d);
    node->leaf.clear();
    node->leaf.shrink_to_fit();
  }

  int max_depth_, max_leaf_size_;
  int64_t size_ = 0, n_keyframes_ = 0;
  std::unique_ptr<Node> root_;
};

}  // namespace svi
