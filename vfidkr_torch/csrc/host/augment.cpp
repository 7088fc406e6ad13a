// The trainer's triplet augment on the host: C++ with OpenMP.
//
// Counterpart of vfidkr_augment_triplet_batch (native/vfidkr_native.cpp),
// with the same semantics: per sample, the temporal swap of the first and
// last frames, the crop at (oy, ox), the left-right and up-down flips, and
// u8 / 255.0f in float.  It writes planar NCHW float32 straight into the
// batch's tensors: x0 the first frame, x1 the last, y the middle one.  The
// random draws stay with the caller (vfidkr_torch.data.vimeo90k.draw_augment,
// the reference's order), so the batches equal the Python path's
// (vimeo90k.augment_triplet) to the last bit.
//
// Built by vfidkr_torch/data/native.py: g++ -O3 -fPIC -fopenmp -shared, no
// -ffast-math (the division rounds as numpy's float32 division does).

#include <cstdint>

namespace {

// The frame of a sample that output f (0: x0, 1: x1, 2: y) reads, as an
// index into the sample's (im1, im2, im3).
inline int32_t source_frame(int32_t f, int32_t swap) {
  if (f == 2) return 1;
  return ((f == 0) != (swap != 0)) ? 0 : 2;
}

}  // namespace

extern "C" {

// frames:  3 n pointers to contiguous h x w x 3 uint8 frames, sample by
//          sample (im1, im2, im3 of sample 0, then of sample 1, ...).
// aug:     n records {swap, oy, ox, fliplr, flipud} (int32 x 5); the caller
//          checks that each crop lies in its frame.
// slot:    n positions of the samples along the batch's first dimension.
// x0, x1, y: the batch's (B, 3, crop_h, crop_w) float32 outputs.
// threads: the OpenMP threads of this call.
void vfidkr_augment_triplets(const uint8_t* const* frames, int32_t n,
                             int32_t h, int32_t w, int32_t crop_h,
                             int32_t crop_w, const int32_t* aug,
                             const int32_t* slot, float* x0, float* x1,
                             float* y, int32_t threads) {
  (void)h;
  const int64_t plane = static_cast<int64_t>(crop_h) * crop_w;
  const int64_t rows = static_cast<int64_t>(n) * 3 * crop_h;
  // one job an output row, so a batch of three samples still spreads over
  // every thread; handed out 8 rows at a time, so a thread the OS preempts
  // (the trainer's decode workers share the cores) holds no share back
#pragma omp parallel for schedule(dynamic, 8) num_threads(threads)
  for (int64_t job = 0; job < rows; ++job) {
    const int32_t i = static_cast<int32_t>(job / (3 * crop_h));
    const int32_t f = static_cast<int32_t>((job / crop_h) % 3);
    const int32_t r = static_cast<int32_t>(job % crop_h);
    const int32_t* a = aug + 5 * static_cast<int64_t>(i);
    const int32_t swap = a[0], oy = a[1], ox = a[2], lr = a[3], ud = a[4];
    const uint8_t* src = frames[3 * static_cast<int64_t>(i) +
                                source_frame(f, swap)];
    const int32_t sy = ud ? oy + crop_h - 1 - r : oy + r;
    const uint8_t* row = src + (static_cast<int64_t>(sy) * w + ox) * 3;
    float* out = (f == 0 ? x0 : f == 1 ? x1 : y) +
                 static_cast<int64_t>(slot[i]) * 3 * plane +
                 static_cast<int64_t>(r) * crop_w;
    for (int32_t c = 0; c < crop_w; ++c) {
      const uint8_t* px = row + 3 * static_cast<int64_t>(lr ? crop_w - 1 - c
                                                             : c);
      out[c] = px[0] / 255.0f;
      out[plane + c] = px[1] / 255.0f;
      out[2 * plane + c] = px[2] / 255.0f;
    }
  }
}

}  // extern "C"
