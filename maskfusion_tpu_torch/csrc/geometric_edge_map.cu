// Geometric edge map of the segmentation, written by hand for Hopper
// (sm_90a).
//
// Replaces the TPU kernel geometric_edge_map_pallas
// (maskfusion_tpu/ops/pallas_kernels.py:171-223); its semantics are those of
// the XLA twin maskfusion_tpu/ops/seg_ops.geometric_edge_map
// (ref segmentation.cu:98-177).  For each pixel p with vertex v and normal n,
// over the 8 neighbours q:
//   side = (v_q - v) . n
//   conc = 1 - n_q . n, zeroed where side < 0
//   c = max conc, d = max |side|      (a NaN term counts as 0)
//   out = min(1, max(wC * c, wD * d))
// The 1-pixel border and invalid pixels (v.x not finite or v.z <= 0) are 1.
//
// Bound on the card: at 640x480 the kernel reads 24 bytes and writes 4 per
// pixel (8.6 MB, ~2.6 us at 3.35 TB/s) and does ~150 FP32 operations per
// pixel (~0.7 us at 67 TFLOP/s; as no product may fuse with a sum, that is
// ~1.5 us of issue on 132 SMs).  Each SM has only ~2,300 pixels, so the
// kernel is one short wave whose time is the latency of its first loads and
// of its per-row arithmetic as much as bytes.
//
// Design:
// - Work: a warp owns 30 columns of the image (lanes 1-30; lanes 0 and 31
//   hold the columns on either side) and walks down a band of rows.  The
//   (column group, row) units, group-major, are split evenly over kWarpsSM
//   warps a SM in one wave, so every SM gets the same number of rows within
//   one and nothing waits for a second wave.  A warp whose share crosses
//   the end of a column group walks two pieces.
// - Loads straight into registers: each lane loads its pixel's vertex and
//   normal of the next row (6 floats, through L1) while it computes the
//   current row, so every byte is read once by the warp that owns it and
//   the only re-reads are the halo: two columns of 32 and two rows a band,
//   served from L1 and L2.  No shared memory, no barrier: the x-1 and x+1
//   neighbours come from the lanes beside with __shfl_up_sync /
//   __shfl_down_sync (12 shuffles a row); a lane keeps the 3x3 neighbourhood
//   (54 floats) and shifts it down a row at a time.
// - Nothing staged outside the image: a lane left or right of the image,
//   and the rows above and below it, take zeros (a select after an
//   in-bounds load, not a branch, so the shuffles run converged).  Those
//   values only reach pixels of the 1-pixel border, whose output is forced
//   to 1, so any value would do.
// - Shared concavity: 1 - n_q . n_p rounds exactly as 1 - n_p . n_q (the
//   same three products, summed in the same order), so each pixel computes
//   the concavity of its right, down-left, down and down-right pairs and
//   takes the other four from the lane beside (shuffles) and from its own
//   previous row: 4 three-term dots a pixel in place of 8.
// - Stores: a warp writes 30 consecutive floats of a row.
// The dot products are rounded as the twin's three-term sums are
// (((a*x + b*y) + c*z), no fused multiply-add) and differences with
// __fsub_rn.  The NaN -> 0 step of the twin is taken by fmaxf itself: c and
// d start at +0 and only grow, and fmaxf(c, NaN) = c = fmaxf(c, 0), so
// `c = fmaxf(c, x)` gives what `c = fmaxf(c, isnan(x) ? 0 : x)` gives, bit
// for bit; likewise the concavity zeroed where side < 0 leaves c as it is.
// So the outputs are those of the one-thread-per-pixel kernel this
// replaces, bit for bit.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kG = 30;         // columns a warp owns
constexpr int kBW = 8;         // warps a block
constexpr int kWarpsSM = 16;   // warps a SM in the one wave
constexpr unsigned kAll = 0xffffffffu;

__device__ __forceinline__ float dot3(float ax, float ay, float az, float bx,
                                      float by, float bz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(ax, bx), __fmul_rn(ay, by)),
                   __fmul_rn(az, bz));
}

// One pixel's vertex and normal.
struct Px {
  float v[3];
  float n[3];
};

// One row of a lane's 3x3 neighbourhood: columns x-1, x, x+1.
struct Row {
  float v[3][3];
  float n[3][3];
};

// Pixel (y, x), or zeros outside the image: a select, not a branch.
__device__ __forceinline__ void load_px(Px& p, const float* __restrict__ vmap,
                                        const float* __restrict__ nmap,
                                        int y, int x, int H, int W) {
  const bool in = y >= 0 && y < H && x >= 0 && x < W;
  const long long g = in ? ((long long)y * W + x) * 3 : 0;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float v = __ldg(vmap + g + k);
    const float n = __ldg(nmap + g + k);
    p.v[k] = in ? v : 0.0f;
    p.n[k] = in ? n : 0.0f;
  }
}

// A row of the neighbourhood from the lanes' pixels of that row.
__device__ __forceinline__ void spread(Row& r, const Px& p) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    r.v[1][k] = p.v[k];
    r.n[1][k] = p.n[k];
    r.v[0][k] = __shfl_up_sync(kAll, p.v[k], 1);
    r.n[0][k] = __shfl_up_sync(kAll, p.n[k], 1);
    r.v[2][k] = __shfl_down_sync(kAll, p.v[k], 1);
    r.n[2][k] = __shfl_down_sync(kAll, p.n[k], 1);
  }
}

// 1 - n_q . n_p for the centre p of row m.
__device__ __forceinline__ float conc(const float* qn, const Row& m) {
  return __fsub_rn(1.0f, dot3(qn[0], qn[1], qn[2], m.n[1][0], m.n[1][1],
                              m.n[1][2]));
}

// One neighbour q of the centre of row m, with its concavity cq.
__device__ __forceinline__ void tap(const float* qv, float cq, const Row& m,
                                    float& c, float& d) {
  const float side =
      dot3(__fsub_rn(qv[0], m.v[1][0]), __fsub_rn(qv[1], m.v[1][1]),
           __fsub_rn(qv[2], m.v[1][2]), m.n[1][0], m.n[1][1], m.n[1][2]);
  if (!(side < 0.0f)) c = fmaxf(c, cq);
  d = fmaxf(d, fabsf(side));
}

__global__ void __launch_bounds__(32 * kBW)
    geometric_edge_map_kernel(const float* __restrict__ vmap,
                              const float* __restrict__ nmap,
                              float* __restrict__ out, int H, int W, float wD,
                              float wC, int groups) {
  const int lane = threadIdx.x & 31;
  const long long warps = (long long)gridDim.x * kBW;
  const long long w = (long long)blockIdx.x * kBW + threadIdx.x / 32;
  const long long units = (long long)groups * H;
  const int u0 = (int)(units * w / warps);
  const int u1 = (int)(units * (w + 1) / warps);
  for (int u = u0; u < u1;) {
    const int ya = u % H;
    const int yb = ya + min(H - ya, u1 - u);
    const int x = (u / H) * kG - 1 + lane;
    const bool own = lane >= 1 && lane <= kG && x < W;
    const bool col_interior = x >= 1 && x < W - 1;
    // rows ya-1 .. yb; each is loaded while the row before it computes
    Px p;
    load_px(p, vmap, nmap, ya - 1, x, H, W);
    int next = ya;
    auto fetch = [&](Row& r) {
      const Px a = p;
      load_px(p, vmap, nmap, next <= yb ? next : -1, x, H, W);
      ++next;
      spread(r, a);
    };
    float pDL, pD, pDR;   // the row above's down-left, down, down-right conc
    auto step = [&](const Row& t, const Row& m, Row& b, int y) {
      fetch(b);
      const float cR = conc(m.n[2], m);
      const float cDL = conc(b.n[0], m);
      const float cD = conc(b.n[1], m);
      const float cDR = conc(b.n[2], m);
      const float cL = __shfl_up_sync(kAll, cR, 1);
      const float cUL = __shfl_up_sync(kAll, pDR, 1);
      const float cUR = __shfl_down_sync(kAll, pDL, 1);
      float c = 0.0f;
      float d = 0.0f;
      tap(t.v[0], cUL, m, c, d);
      tap(t.v[1], pD, m, c, d);
      tap(t.v[2], cUR, m, c, d);
      tap(m.v[0], cL, m, c, d);
      tap(m.v[2], cR, m, c, d);
      tap(b.v[0], cDL, m, c, d);
      tap(b.v[1], cD, m, c, d);
      tap(b.v[2], cDR, m, c, d);
      pDL = cDL;
      pD = cD;
      pDR = cDR;
      const bool interior = col_interior && y >= 1 && y < H - 1;
      const float e = (!interior || !isfinite(m.v[1][0]) || m.v[1][2] <= 0.0f)
                          ? 1.0f
                          : fminf(1.0f, fmaxf(c * wC, d * wD));
      if (own) out[(long long)y * W + x] = e;
    };
    Row r0, r1, r2;
    fetch(r0);
    fetch(r1);
    // the down conc of row ya-1, which the band's first row takes as its up
    pDL = conc(r1.n[0], r0);
    pD = conc(r1.n[1], r0);
    pDR = conc(r1.n[2], r0);
    // three rows a turn, so the neighbourhood rotates without moves
    for (int y = ya; y < yb; y += 3) {
      step(r0, r1, r2, y);
      if (y + 1 >= yb) break;
      step(r1, r2, r0, y + 1);
      if (y + 2 >= yb) break;
      step(r2, r0, r1, y + 2);
    }
    u = (u / H) * H + yb;
  }
}

// One wave of kWarpsSM warps a SM over the group-major (column group, row)
// units, at most one warp a unit.
cudaError_t launch_on_device(int H, int W, int* blocks, int* groups) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  *groups = (W + kG - 1) / kG;
  const long long units = (long long)*groups * H;
  long long warps = (long long)sms * kWarpsSM;
  if (warps > units) warps = units;
  *blocks = (int)((warps + kBW - 1) / kBW);
  return err;
}

}  // namespace

extern "C" int mft_geometric_edge_map(const float* vmap, const float* nmap,
                                      float* out, int H, int W, float wD,
                                      float wC, void* stream) {
  if (H <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  int blocks = 0, groups = 0;
  const cudaError_t err = launch_on_device(H, W, &blocks, &groups);
  if (err != cudaSuccess) return (int)err;
  geometric_edge_map_kernel<<<blocks, 32 * kBW, 0, (cudaStream_t)stream>>>(
      vmap, nmap, out, H, W, wD, wC, groups);
  return (int)cudaGetLastError();
}

// Launch shape at (H, W): info = {grid x, grid y, threads a block, dynamic
// shared bytes, resident blocks a SM}.
extern "C" int mft_geometric_edge_map_grid(int H, int W, int unused,
                                           int* info) {
  (void)unused;
  if (H <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  int blocks = 0, groups = 0, per_sm = 0;
  cudaError_t err = launch_on_device(H, W, &blocks, &groups);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, geometric_edge_map_kernel, 32 * kBW, 0);
  info[0] = blocks;
  info[1] = 1;
  info[2] = 32 * kBW;
  info[3] = 0;
  info[4] = per_sm;
  return (int)err;
}
