// Geometric edge map of the segmentation, written by hand for Hopper
// (sm_90a).
//
// Replaces the TPU kernel geometric_edge_map_pallas
// (maskfusion_tpu/ops/pallas_kernels.py:171-223); its semantics are those of
// the XLA twin maskfusion_tpu/ops/seg_ops.geometric_edge_map
// (ref segmentation.cu:98-177).  For each pixel p with vertex v and normal n,
// over the 8 neighbours q in the twin's order:
//   side = (v_q - v) . n
//   conc = 1 - n_q . n, zeroed where side < 0
//   c = max conc, d = max |side|      (a NaN term counts as 0)
//   out = min(1, max(wC * c, wD * d))
// The 1-pixel border and invalid pixels (v.x not finite or v.z <= 0) are 1.
//
// Bound on the card: at 640x480 the kernel reads 24 bytes and writes 4 per
// pixel (8.6 MB, ~2.6 us at 3.35 TB/s) and does ~150 FP32 operations per
// pixel (~0.7 us at 67 TFLOP/s).  It is bound by memory traffic.
//
// Design: one thread per pixel.  A 32x8 block stages both maps' tile plus a
// 1-pixel NaN halo in shared memory with coalesced reads of the interleaved
// (H, W, 3) rows, so each input element is read once from device memory.
// The dot products are rounded as the twin's three-term sums are
// (((a*x + b*y) + c*z), no fused multiply-add), and the NaN -> 0 step is
// explicit: fmaxf drops a NaN operand where the twin's maximum would keep it.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBX = 32;
constexpr int kBY = 8;
constexpr int kTW = kBX + 2;
constexpr int kTH = kBY + 2;

__device__ __forceinline__ float dot3(float ax, float ay, float az, float bx,
                                      float by, float bz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(ax, bx), __fmul_rn(ay, by)),
                   __fmul_rn(az, bz));
}

__device__ __forceinline__ float nan_to_zero(float x) {
  return isnan(x) ? 0.0f : x;
}

__global__ void geometric_edge_map_kernel(const float* __restrict__ vmap,
                                          const float* __restrict__ nmap,
                                          float* __restrict__ out, int H,
                                          int W, float wD, float wC) {
  __shared__ float vt[kTH][kTW * 3];
  __shared__ float nt[kTH][kTW * 3];
  const int x0 = blockIdx.x * kBX;
  const int y0 = blockIdx.y * kBY;
  // one tile row is 3 * kTW consecutive floats of the interleaved maps
  for (int i = threadIdx.y * kBX + threadIdx.x; i < kTH * kTW * 3;
       i += kBX * kBY) {
    const int ty = i / (kTW * 3);
    const int tc = i % (kTW * 3);
    const int gy = y0 + ty - 1;
    const int gx = x0 + tc / 3 - 1;
    const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
    const long g = ((long)gy * W + (x0 - 1)) * 3 + tc;
    vt[ty][tc] = in ? vmap[g] : NAN;
    nt[ty][tc] = in ? nmap[g] : NAN;
  }
  __syncthreads();

  const int x = x0 + threadIdx.x;
  const int y = y0 + threadIdx.y;
  if (x >= W || y >= H) return;
  const int cy = threadIdx.y + 1;
  const int cc = (threadIdx.x + 1) * 3;
  const float vx = vt[cy][cc], vy = vt[cy][cc + 1], vz = vt[cy][cc + 2];
  if (x < 1 || x >= W - 1 || y < 1 || y >= H - 1 || !isfinite(vx) ||
      vz <= 0.0f) {
    out[(long)y * W + x] = 1.0f;
    return;
  }
  const float nx = nt[cy][cc], ny = nt[cy][cc + 1], nz = nt[cy][cc + 2];
  float c = 0.0f;
  float d = 0.0f;
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    if (k == 4) continue;
    const int qy = cy + k / 3 - 1;
    const int qc = cc + (k % 3 - 1) * 3;
    const float side = dot3(__fsub_rn(vt[qy][qc], vx),
                            __fsub_rn(vt[qy][qc + 1], vy),
                            __fsub_rn(vt[qy][qc + 2], vz), nx, ny, nz);
    float conc = __fsub_rn(
        1.0f, dot3(nt[qy][qc], nt[qy][qc + 1], nt[qy][qc + 2], nx, ny, nz));
    if (side < 0.0f) conc = 0.0f;
    c = fmaxf(c, nan_to_zero(conc));
    d = fmaxf(d, nan_to_zero(fabsf(side)));
  }
  out[(long)y * W + x] = fminf(1.0f, fmaxf(c * wC, d * wD));
}

}  // namespace

extern "C" int mft_geometric_edge_map(const float* vmap, const float* nmap,
                                      float* out, int H, int W, float wD,
                                      float wC, void* stream) {
  const dim3 block(kBX, kBY);
  const dim3 grid((W + kBX - 1) / kBX, (H + kBY - 1) / kBY);
  geometric_edge_map_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      vmap, nmap, out, H, W, wD, wC);
  return (int)cudaGetLastError();
}

// Launch shape at (H, W): info = {grid x, grid y, threads a block, dynamic
// shared bytes, resident blocks a SM}.
extern "C" int mft_geometric_edge_map_grid(int H, int W, int unused,
                                           int* info) {
  (void)unused;
  int per_sm = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, geometric_edge_map_kernel, kBX * kBY, 0);
  info[0] = (W + kBX - 1) / kBX;
  info[1] = (H + kBY - 1) / kBY;
  info[2] = kBX * kBY;
  info[3] = 0;
  info[4] = per_sm;
  return (int)err;
}
