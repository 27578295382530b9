// Bilateral filter of metric depth, written by hand for Hopper (sm_90a).
//
// Replaces the TPU kernel bilateral_filter_depth_pallas
// (maskfusion_tpu/ops/pallas_kernels.py:121-161); its semantics are those of
// the XLA twin maskfusion_tpu/ops/preprocess.bilateral_filter_depth
// (ref depth_bilateral_metric.frag:31-76):
//   out(p) = sum_q w(p,q) d(q) / sum_q w(p,q)  over the (2R+1)^2 window,
//   w = exp(-(|p-q|^2 * ss + (d(p)-d(q))^2 * sc)),
// taps outside the image are +inf and skipped, zero-depth taps count with
// their range penalty, and out = 0 where d(p) <= min_valid.
//
// Bound on the card: at 640x480 and R=6 the filter evaluates ~52 M taps,
// each an expf and ~9 FP32 operations, against 2.4 MB of traffic (one f32
// read and one f32 write per pixel).  It is bound by arithmetic: ~7 us of
// FP32 issue at 67 TFLOP/s, ~13 us if the expf throughput of the special
// function units is the limit, against ~0.7 us of memory time.
//
// Design: a 32x8 block stages its tile plus an R-pixel halo in shared
// memory once (+inf outside the image), so every tap is a shared-memory
// read and device memory is touched once per pixel; each thread then runs
// the window loop in the twin's tap order (dy-major, then dx) with the
// precise expf, keeping the 1e-5 agreement with the twin.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBX = 32;
constexpr int kBY = 8;

__global__ void bilateral_depth_kernel(const float* __restrict__ depth,
                                       float* __restrict__ out, int H, int W,
                                       int R, float ss, float sc,
                                       float min_valid) {
  extern __shared__ float tile[];
  const int tw = kBX + 2 * R;
  const int th = kBY + 2 * R;
  const int x0 = blockIdx.x * kBX;
  const int y0 = blockIdx.y * kBY;
  for (int i = threadIdx.y * kBX + threadIdx.x; i < tw * th; i += kBX * kBY) {
    const int gy = y0 + i / tw - R;
    const int gx = x0 + i % tw - R;
    tile[i] = (gy >= 0 && gy < H && gx >= 0 && gx < W) ? depth[gy * W + gx]
                                                        : INFINITY;
  }
  __syncthreads();

  const int x = x0 + threadIdx.x;
  const int y = y0 + threadIdx.y;
  if (x >= W || y >= H) return;
  const float* centre = &tile[(threadIdx.y + R) * tw + threadIdx.x + R];
  const float c = centre[0];
  float sum1 = 0.0f;
  float sum2 = 0.0f;
  for (int dy = -R; dy <= R; ++dy) {
    const float* row = centre + dy * tw;
    for (int dx = -R; dx <= R; ++dx) {
      const float nb = row[dx];
      if (!isfinite(nb)) continue;
      const float space2 = (float)(dy * dy + dx * dx);
      const float diff = c - nb;
      const float w = expf(-(space2 * ss + diff * diff * sc));
      sum1 += nb * w;
      sum2 += w;
    }
  }
  const float filtered = sum1 / fmaxf(sum2, 1e-20f);
  out[y * W + x] = (c <= min_valid) ? 0.0f : filtered;
}

}  // namespace

extern "C" int mft_bilateral_depth(const float* depth, float* out, int H,
                                   int W, int R, float ss, float sc,
                                   float min_valid, void* stream) {
  const dim3 block(kBX, kBY);
  const dim3 grid((W + kBX - 1) / kBX, (H + kBY - 1) / kBY);
  const size_t smem = sizeof(float) * (kBX + 2 * R) * (kBY + 2 * R);
  bilateral_depth_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
      depth, out, H, W, R, ss, sc, min_valid);
  return (int)cudaGetLastError();
}
