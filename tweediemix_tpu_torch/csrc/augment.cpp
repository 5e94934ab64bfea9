// Native data-augmentation kernel for the training input pipeline.
//
// Implements the Custom-Diffusion random-scale paste augmentation of the
// reference dataset (concept_training/diffusers_data_pipeline_xl.py:155-176):
// the instance image is resized to a random scale in [size/3, size],
// pasted at a random offset onto a black size x size canvas, and a
// latent-resolution (size/8) validity mask marking the pasted region is
// emitted. The reference does this per-sample in Python/PIL on the host;
// here it is a C++ kernel (bilinear resize + paste + mask fill + [-1,1]
// normalization in one pass) exposed through ctypes so the input pipeline
// keeps the single host core free for the TPU feed.
//
// All buffers are caller-allocated. Layouts: HWC uint8 in, HWC float32 out.

#include <algorithm>
#include <cstdint>
#include <cstring>

extern "C" {

// Bilinear-resize src (ih x iw x 3, uint8) to (th x tw), paste at (oy, ox)
// onto a black (size x size) canvas normalized to [-1, 1] (float32,
// size*size*3), and write a (mask_size x mask_size) float32 mask with 1.0
// over the latent-space footprint of the pasted region.
void paste_augment(const uint8_t* src, int ih, int iw,
                   int th, int tw, int oy, int ox, int size,
                   float* out, float* mask, int mask_size) {
  std::memset(mask, 0, sizeof(float) * mask_size * mask_size);
  const float fill = (0.0f / 127.5f) - 1.0f;  // black canvas, normalized
  const int total = size * size * 3;
  for (int i = 0; i < total; ++i) out[i] = fill;

  const float sy = ih > 1 ? static_cast<float>(ih - 1) / std::max(th - 1, 1) : 0.f;
  const float sx = iw > 1 ? static_cast<float>(iw - 1) / std::max(tw - 1, 1) : 0.f;

  const int y0 = std::max(0, -oy), y1 = std::min(th, size - oy);
  const int x0 = std::max(0, -ox), x1 = std::min(tw, size - ox);
  for (int y = y0; y < y1; ++y) {
    const float fy = y * sy;
    const int iy = static_cast<int>(fy);
    const int iy1 = std::min(iy + 1, ih - 1);
    const float wy = fy - iy;
    float* dst_row = out + ((y + oy) * size + x0 + ox) * 3;
    for (int x = x0; x < x1; ++x) {
      const float fx = x * sx;
      const int ix = static_cast<int>(fx);
      const int ix1 = std::min(ix + 1, iw - 1);
      const float wx = fx - ix;
      const uint8_t* p00 = src + (iy * iw + ix) * 3;
      const uint8_t* p01 = src + (iy * iw + ix1) * 3;
      const uint8_t* p10 = src + (iy1 * iw + ix) * 3;
      const uint8_t* p11 = src + (iy1 * iw + ix1) * 3;
      for (int c = 0; c < 3; ++c) {
        const float v = (1 - wy) * ((1 - wx) * p00[c] + wx * p01[c]) +
                        wy * ((1 - wx) * p10[c] + wx * p11[c]);
        dst_row[(x - x0) * 3 + c] = v / 127.5f - 1.0f;
      }
    }
  }

  // latent-resolution validity mask over the pasted rectangle, shrunk by one
  // latent pixel on each side
  // (diffusers_data_pipeline_xl.py:175-176: mask[oy//8+1 : (oy+th)//8-1, ...])
  const int factor = size / mask_size;
  int my0 = oy / factor + 1, my1 = (oy + th) / factor - 1;
  int mx0 = ox / factor + 1, mx1 = (ox + tw) / factor - 1;
  my0 = std::max(0, my0); my1 = std::min(mask_size, my1);
  mx0 = std::max(0, mx0); mx1 = std::min(mask_size, mx1);
  for (int y = my0; y < my1; ++y)
    for (int x = mx0; x < mx1; ++x) mask[y * mask_size + x] = 1.0f;
}

// Shorter-side resize + crop + normalize for class/prior images
// (reference image_transforms, diffusers_data_pipeline_xl.py:120-128:
// Resize(size) keeps aspect with the shorter side = size, then
// RandomCrop/CenterCrop(size)). (th x tw) are the resized dims; the crop
// window starts at (cy, cx) in resized coordinates. Bilinear samples are
// taken directly from the source so the crop never materializes the full
// resized image.
void resize_crop_normalize(const uint8_t* src, int ih, int iw,
                           int th, int tw, int cy, int cx, int size,
                           float* out) {
  const float sy = ih > 1 ? static_cast<float>(ih - 1) / std::max(th - 1, 1) : 0.f;
  const float sx = iw > 1 ? static_cast<float>(iw - 1) / std::max(tw - 1, 1) : 0.f;
  for (int y = 0; y < size; ++y) {
    const float fy = std::min(y + cy, th - 1) * sy;
    const int iy = static_cast<int>(fy);
    const int iy1 = std::min(iy + 1, ih - 1);
    const float wy = fy - iy;
    for (int x = 0; x < size; ++x) {
      const float fx = std::min(x + cx, tw - 1) * sx;
      const int ix = static_cast<int>(fx);
      const int ix1 = std::min(ix + 1, iw - 1);
      const float wx = fx - ix;
      const uint8_t* p00 = src + (iy * iw + ix) * 3;
      const uint8_t* p01 = src + (iy * iw + ix1) * 3;
      const uint8_t* p10 = src + (iy1 * iw + ix) * 3;
      const uint8_t* p11 = src + (iy1 * iw + ix1) * 3;
      for (int c = 0; c < 3; ++c) {
        const float v = (1 - wy) * ((1 - wx) * p00[c] + wx * p01[c]) +
                        wy * ((1 - wx) * p10[c] + wx * p11[c]);
        out[(y * size + x) * 3 + c] = v / 127.5f - 1.0f;
      }
    }
  }
}

}  // extern "C"
