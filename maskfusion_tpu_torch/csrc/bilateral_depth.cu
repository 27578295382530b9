// Bilateral filter of metric depth, written by hand for Hopper (sm_90a).
//
// Replaces the TPU kernel bilateral_filter_depth_pallas
// (maskfusion_tpu/ops/pallas_kernels.py:121-161); its semantics are those of
// the XLA twin maskfusion_tpu/ops/preprocess.bilateral_filter_depth
// (ref depth_bilateral_metric.frag:31-76):
//   out(p) = sum_q w(p,q) d(q) / sum_q w(p,q)  over the (2R+1)^2 window,
//   w = exp(-(|p-q|^2 * ss + (d(p)-d(q))^2 * sc)),
// taps outside the image are +inf and skipped, as are non-finite taps,
// zero-depth taps count with their range penalty, and out = 0 where
// d(p) <= min_valid.
//
// Bound on the card: at 640x480 and R=6 the filter evaluates ~51 M taps
// against 2.4 MB of traffic (one f32 read and one f32 write a pixel).  At
// the 9 FP32 operations a tap that the bound counts it is ~6.9 us of FP32
// issue at 67 TFLOP/s; but every tap also needs one exponential, and the
// special-function units run 16 lanes a clock on each SM, so one ex2 a tap
// floors the kernel at ~51 M / (16 x 132 x 1.75-1.98 GHz) = ~12-14 us.
//
// Design, against that floor:
// - The weight is one ex2 and one FMA a tap: w = ex2(S[dy][dx] - diff^2 *
//   sc*log2e), with the spatial term S = -(dy^2+dx^2) * ss*log2e taken from
//   a table built once a block, one row of it held in registers a dy.  No
//   int->float conversion and no precise expf in the loop.
// - No branch a tap: taps outside the image and non-finite taps are staged
//   as FLT_MAX, whose range term (d(p) - FLT_MAX)^2 overflows to +inf, so
//   ex2 gives exactly 0 and FLT_MAX * 0 adds 0 to sum1.  That holds for
//   every finite centre below 1e18 (and sc > 0, ss finite); any other
//   centre (non-finite, huge) takes an exact path chosen once for the
//   pixel, which reads its taps from device memory and skips non-finite
//   ones, as the twin does.
// - Register blocking: each thread filters kK = 2 pixels of one column.
//   Each pixel sums its taps dy-major, then dx, as the twin.
// - R = 1..8 are compiled as template instances (the dx and pixel loops
//   unrolled, the dy loop kept, which keeps the code small); any other
//   radius runs the same kernel with a runtime R.
// - The tile is staged with cp.async, so a thread's loads are all in
//   flight at once.
// - Tiles of 32x16 pixels, 256 threads: 640x480 gives 600 blocks, and with
//   registers held to 5 blocks a SM all 600 are resident in one wave (4.55
//   a SM on 132 SMs).  Other shapes (3 to 16 warps a block, 1 to 5 pixels a
//   thread) were tried on the card at VGA and none was faster.
// ex2.approx.ftz has a 2 ulp error and flushes weights below 2^-126 to 0;
// the centre's own weight is 1, so that changes no output beyond 1e-37.

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>

namespace {

constexpr int kBX = 32;          // tile width: one warp a tile row
constexpr int kTY = 8;           // thread rows of a block
constexpr int kK = 2;            // pixels a thread filters, one column
constexpr int kBY = kTY * kK;    // tile height
constexpr int kThreads = kBX * kTY;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kFastCentre = 1e18f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// 4-byte asynchronous copy to shared memory (zero-filled where !valid):
// a thread issues all its copies before it waits for any.
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ float space_term(int dy, int dx, float ssl) {
  return -((float)(dy * dy + dx * dx) * ssl);
}

// The twin's tap loop for one pixel with centre c: taps read from device
// memory, outside and non-finite taps skipped.
__device__ __noinline__ float2 exact_sums(const float* __restrict__ depth,
                                          int H, int W, int R, int y, int x,
                                          float c, float ssl, float scl) {
  float s1 = 0.0f, s2 = 0.0f;
  for (int dy = -R; dy <= R; ++dy) {
    for (int dx = -R; dx <= R; ++dx) {
      const int gy = y + dy, gx = x + dx;
      if (gy < 0 || gy >= H || gx < 0 || gx >= W) continue;
      const float nb = depth[gy * W + gx];
      if (!isfinite(nb)) continue;
      const float diff = c - nb;
      const float w = ex2(fmaf(diff * diff, -scl, space_term(dy, dx, ssl)));
      s1 = fmaf(nb, w, s1);
      s2 += w;
    }
  }
  return make_float2(s1, s2);
}

// RT > 0: radius RT, unrolled; RT == 0: radius r_arg at run time.
template <int RT>
__global__ void __launch_bounds__(kThreads, 5)
    bilateral_depth_kernel(const float* __restrict__ depth,
                           float* __restrict__ out, int H, int W, int r_arg,
                           float ss, float sc, float min_valid) {
  const int R = RT > 0 ? RT : r_arg;
  const int n = 2 * R + 1;
  const int tw = kBX + 2 * R;
  const int th = kBY + 2 * R;
  extern __shared__ float smem[];
  float* tile = smem;              // th x tw, FLT_MAX outside / non-finite
  float* space = smem + tw * th;   // n x n spatial terms
  const int x0 = blockIdx.x * kBX;
  const int y0 = blockIdx.y * kBY;
  const int tid = threadIdx.y * kBX + threadIdx.x;
  const float ssl = ss * kLog2e;
  const float scl = sc * kLog2e;
  for (int i = tid; i < tw * th; i += kThreads) {
    const int gy = y0 + i / tw - R;
    const int gx = x0 + i % tw - R;
    const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
    cp_async4(&tile[i], in ? depth + gy * W + gx : depth, in);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  // each thread fixes the elements it copied itself
  for (int i = tid; i < tw * th; i += kThreads) {
    const int gy = y0 + i / tw - R;
    const int gx = x0 + i % tw - R;
    const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
    if (!in || !isfinite(tile[i])) tile[i] = FLT_MAX;
  }
  for (int i = tid; i < n * n; i += kThreads)
    space[i] = space_term(i / n - R, i % n - R, ssl);
  __syncthreads();

  const int tx = threadIdx.x;
  const int ty0 = threadIdx.y * kK;
  const float* band = tile + ty0 * tw + tx;   // window rows of this thread
  float c[kK], s1[kK], s2[kK];
#pragma unroll
  for (int k = 0; k < kK; ++k) {
    c[k] = band[(k + R) * tw + R];
    s1[k] = 0.0f;
    s2[k] = 0.0f;
  }
  // each output's taps in the twin's order: dy-major, then dx; a row of the
  // spatial table is read once a dy and kept in registers
#pragma unroll 1
  for (int dy = -R; dy <= R; ++dy) {
    const float* srow = space + (dy + R) * n;
    float sreg[RT > 0 ? 2 * RT + 1 : 1];
    if constexpr (RT > 0) {
#pragma unroll
      for (int dxi = 0; dxi < n; ++dxi) sreg[dxi] = srow[dxi];
    }
#pragma unroll
    for (int k = 0; k < kK; ++k) {
      const float* row = band + (k + dy + R) * tw;
#pragma unroll
      for (int dxi = 0; dxi < n; ++dxi) {
        float S;
        if constexpr (RT > 0) S = sreg[dxi];
        else S = srow[dxi];
        const float nb = row[dxi];
        const float diff = c[k] - nb;
        const float w = ex2(fmaf(diff * diff, -scl, S));
        s1[k] = fmaf(nb, w, s1[k]);
        s2[k] += w;
      }
    }
  }

  const bool fast_params = scl > 0.0f && isfinite(ssl);
  const int x = x0 + tx;
#pragma unroll
  for (int k = 0; k < kK; ++k) {
    const int y = y0 + ty0 + k;
    if (x >= W || y >= H) continue;
    float cv = c[k];
    float2 s = make_float2(s1[k], s2[k]);
    if (!(fast_params && fabsf(cv) < kFastCentre)) {
      cv = depth[y * W + x];
      s = exact_sums(depth, H, W, R, y, x, cv, ssl, scl);
    }
    out[y * W + x] = (cv <= min_valid) ? 0.0f : s.x / fmaxf(s.y, 1e-20f);
  }
}

using Kernel = void (*)(const float*, float*, int, int, int, float, float,
                        float);

Kernel kernel_for(int R) {
  switch (R) {
    case 1: return bilateral_depth_kernel<1>;
    case 2: return bilateral_depth_kernel<2>;
    case 3: return bilateral_depth_kernel<3>;
    case 4: return bilateral_depth_kernel<4>;
    case 5: return bilateral_depth_kernel<5>;
    case 6: return bilateral_depth_kernel<6>;
    case 7: return bilateral_depth_kernel<7>;
    case 8: return bilateral_depth_kernel<8>;
    default: return bilateral_depth_kernel<0>;
  }
}

size_t smem_bytes(int R) {
  const size_t tile = (size_t)(kBX + 2 * R) * (kBY + 2 * R);
  const size_t table = (size_t)(2 * R + 1) * (2 * R + 1);
  return sizeof(float) * (tile + table);
}

// Lets a runtime radius use shared memory beyond the 48 KB default.
cudaError_t prepare(Kernel k, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

}  // namespace

extern "C" int mft_bilateral_depth(const float* depth, float* out, int H,
                                   int W, int R, float ss, float sc,
                                   float min_valid, void* stream) {
  if (R < 0 || H <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  const Kernel k = kernel_for(R);
  const size_t smem = smem_bytes(R);
  const cudaError_t err = prepare(k, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 block(kBX, kTY);
  const dim3 grid((W + kBX - 1) / kBX, (H + kBY - 1) / kBY);
  k<<<grid, block, smem, (cudaStream_t)stream>>>(depth, out, H, W, R, ss, sc,
                                                  min_valid);
  return (int)cudaGetLastError();
}

// Launch shape at (H, W, R): info = {grid x, grid y, threads a block,
// dynamic shared bytes, resident blocks a SM}.
extern "C" int mft_bilateral_depth_grid(int H, int W, int R, int* info) {
  if (R < 0) return (int)cudaErrorInvalidValue;
  const Kernel k = kernel_for(R);
  const size_t smem = smem_bytes(R);
  cudaError_t err = prepare(k, smem);
  int per_sm = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k, kThreads,
                                                        smem);
  info[0] = (W + kBX - 1) / kBX;
  info[1] = (H + kBY - 1) / kBY;
  info[2] = kThreads;
  info[3] = (int)smem;
  info[4] = per_sm;
  return (int)err;
}
