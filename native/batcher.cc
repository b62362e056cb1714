// Host-side batch-assembly core for the data pipeline.
//
// The reference assembles every batch with Python loops (one-hot encoding is
// a triple loop, Util/Tool.py:4-28; Siamese duplication a per-sample append
// loop, ShapeNet_DGCNN_trainer.py:264-289). The numpy rewrites in
// utils/tools.py / data/augment.py are already vectorized; this C++ core
// fuses the remaining multi-pass work (one-hot + interleave + mask) into
// single write passes so batch assembly keeps up with the device when the
// prefetch thread is the bottleneck.
//
// Build: scripts/build_native.sh (g++ -O3 -shared -fPIC). Loaded via ctypes
// (weaksuppointcloudseg_tpu/native.py) with a transparent numpy fallback.

#include <cstdint>
#include <cstring>

extern "C" {

// labels [n] int32 -> out [n, k] f32 one-hot (out zero-initialized here).
void onehot_f32(const int32_t* labels, int64_t n, int64_t k, float* out) {
  std::memset(out, 0, sizeof(float) * n * k);
  for (int64_t i = 0; i < n; ++i) {
    int64_t c = labels[i];
    if (c >= 0 && c < k) out[i * k + c] = 1.0f;
  }
}

// src [b, row] f32 -> dst [2b, row] with each row duplicated (interleaved).
void interleave_dup_f32(const float* src, int64_t b, int64_t row, float* dst) {
  for (int64_t i = 0; i < b; ++i) {
    const float* s = src + i * row;
    std::memcpy(dst + (2 * i) * row, s, sizeof(float) * row);
    std::memcpy(dst + (2 * i + 1) * row, s, sizeof(float) * row);
  }
}

// int32 variant of the row duplication.
void interleave_dup_i32(const int32_t* src, int64_t b, int64_t row,
                        int32_t* dst) {
  for (int64_t i = 0; i < b; ++i) {
    const int32_t* s = src + i * row;
    std::memcpy(dst + (2 * i) * row, s, sizeof(int32_t) * row);
    std::memcpy(dst + (2 * i + 1) * row, s, sizeof(int32_t) * row);
  }
}

// Labelled-point mask: for each batch row, set mask[row, idx[j]] = 1 for the
// row's label-budget indices. idx is ragged: offsets [b+1] into flat_idx.
void build_mask_f32(const int64_t* flat_idx, const int64_t* offsets,
                    int64_t b, int64_t n, float* mask) {
  std::memset(mask, 0, sizeof(float) * b * n);
  for (int64_t i = 0; i < b; ++i) {
    for (int64_t j = offsets[i]; j < offsets[i + 1]; ++j) {
      int64_t p = flat_idx[j];
      if (p >= 0 && p < n) mask[i * n + p] = 1.0f;
    }
  }
}

// Fused Siamese seg batch: labels [b, n] int32 -> onehot [2b, n, k] f32 with
// each sample's one-hot row written twice (duplicate pair), single pass.
void siamese_onehot_f32(const int32_t* labels, int64_t b, int64_t n,
                        int64_t k, float* out) {
  std::memset(out, 0, sizeof(float) * 2 * b * n * k);
  for (int64_t i = 0; i < b; ++i) {
    float* r0 = out + (2 * i) * n * k;
    float* r1 = out + (2 * i + 1) * n * k;
    for (int64_t p = 0; p < n; ++p) {
      int64_t c = labels[i * n + p];
      if (c >= 0 && c < k) {
        r0[p * k + c] = 1.0f;
        r1[p * k + c] = 1.0f;
      }
    }
  }
}

}  // extern "C"
