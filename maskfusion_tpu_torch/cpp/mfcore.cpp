// Native host-side runtime of maskfusion_tpu_torch (a copy of the JAX
// package's maskfusion_tpu/cpp/mfcore.cpp).
//
// The reference keeps its per-frame label logic on the CPU
// (cv::connectedComponentsWithStats + the edge-reassignment loop,
// MfSegmentation.cpp:239-291) and decodes klg logs with zlib/libjpeg
// (KlgLogReader.cpp).  These are the host hot paths of our pipeline too, so
// they are implemented natively and exposed over a plain C ABI for ctypes.
//
// Built at first use by maskfusion_tpu_torch.cpp.build() into build/mfcore/.

#include <cstdint>
#include <cstring>
#include <vector>
#include <zlib.h>

namespace {

struct UnionFind {
  std::vector<int32_t> parent;
  explicit UnionFind(size_t n) : parent(n) {
    for (size_t i = 0; i < n; ++i) parent[i] = static_cast<int32_t>(i);
  }
  int32_t find(int32_t x) {
    int32_t root = x;
    while (parent[root] != root) root = parent[root];
    while (parent[x] != root) {
      int32_t next = parent[x];
      parent[x] = root;
      x = next;
    }
    return root;
  }
  void unite(int32_t a, int32_t b) {
    a = find(a);
    b = find(b);
    if (a == b) return;
    if (a < b) parent[b] = a; else parent[a] = b;
  }
};

}  // namespace

extern "C" {

// 4-connected components over a binary mask.
// labels_out: h*w int32 (0 = background), sizes_out: max_comp int32,
// bboxes_out: max_comp * 4 int32 (top, left, bottom, right; inclusive).
// Returns the number of components + 1 (index 0 = background), or -1 if
// more than max_comp components exist.
//
// Run-based two-pass union-find: rows are scanned into maximal runs of
// foreground pixels; each run unites with the 4-connected overlapping runs
// of the previous row.  Union-find over RUNS (typically ~100s per VGA
// frame) instead of pixels (307200) — the per-pixel formulation was the
// naive version (ConnectedLabels.hpp:23-32 region-grows per pixel; OpenCV
// uses a similar run/block strategy in connectedComponentsWithStats).
int32_t mf_connected_components(const uint8_t* binary, int32_t h, int32_t w,
                                int32_t* labels_out, int32_t* sizes_out,
                                int32_t* bboxes_out, int32_t max_comp) {
  struct Run { int32_t row, start, end, parent; };
  std::vector<Run> runs;
  runs.reserve(1024);
  std::vector<int32_t> prev_first(1, 0);  // index of first run per row
  std::vector<int32_t> row_first(h + 1, 0);

  // pass 1: extract runs + unite with overlapping runs of the row above
  for (int32_t y = 0; y < h; ++y) {
    row_first[y] = static_cast<int32_t>(runs.size());
    const uint8_t* row = binary + static_cast<size_t>(y) * w;
    int32_t x = 0;
    int32_t above = (y > 0) ? row_first[y - 1] : 0;
    const int32_t above_end = (y > 0) ? row_first[y] : 0;
    while (x < w) {
      while (x < w && !row[x]) ++x;
      if (x >= w) break;
      const int32_t start = x;
      while (x < w && row[x]) ++x;
      const int32_t id = static_cast<int32_t>(runs.size());
      runs.push_back({y, start, x, id});
      // unite with all runs in the previous row overlapping [start, x)
      while (above < above_end && runs[above].end <= start) ++above;
      int32_t a = above;
      while (a < above_end && runs[a].start < x) {
        // find roots + union (smaller root wins)
        int32_t r1 = id, r2 = a;
        while (runs[r1].parent != r1) r1 = runs[r1].parent;
        while (runs[r2].parent != r2) r2 = runs[r2].parent;
        if (r1 != r2) {
          if (r1 < r2) runs[r2].parent = r1; else runs[r1].parent = r2;
        }
        ++a;
      }
    }
  }
  row_first[h] = static_cast<int32_t>(runs.size());

  // pass 2: assign dense labels to roots in first-appearance order
  const int32_t n_runs = static_cast<int32_t>(runs.size());
  std::vector<int32_t> run_label(n_runs, 0);
  int32_t next = 1;
  for (int32_t i = 0; i < n_runs; ++i) {
    int32_t r = i;
    while (runs[r].parent != r) r = runs[r].parent;
    // path compress
    int32_t c = i;
    while (runs[c].parent != r) { int32_t nx = runs[c].parent; runs[c].parent = r; c = nx; }
    if (run_label[r] == 0) {
      if (next >= max_comp) return -1;
      run_label[r] = next++;
    }
    run_label[i] = run_label[r];
  }

  std::memset(sizes_out, 0, sizeof(int32_t) * max_comp);
  for (int32_t c = 0; c < max_comp; ++c) {
    bboxes_out[c * 4 + 0] = h; bboxes_out[c * 4 + 1] = w;
    bboxes_out[c * 4 + 2] = -1; bboxes_out[c * 4 + 3] = -1;
  }
  std::memset(labels_out, 0, sizeof(int32_t) * static_cast<size_t>(h) * w);
  for (int32_t i = 0; i < n_runs; ++i) {
    const Run& run = runs[i];
    const int32_t l = run_label[i];
    int32_t* dst = labels_out + static_cast<size_t>(run.row) * w;
    for (int32_t x2 = run.start; x2 < run.end; ++x2) dst[x2] = l;
    sizes_out[l] += run.end - run.start;
    int32_t* bb = bboxes_out + l * 4;
    if (run.row < bb[0]) bb[0] = run.row;
    if (run.start < bb[1]) bb[1] = run.start;
    if (run.row > bb[2]) bb[2] = run.row;
    if (run.end - 1 > bb[3]) bb[3] = run.end - 1;
  }
  // background stats (label 0)
  int64_t fg = 0;
  for (int32_t l = 1; l < next; ++l) fg += sizes_out[l];
  sizes_out[0] = static_cast<int32_t>(static_cast<int64_t>(h) * w - fg);
  bboxes_out[0] = 0; bboxes_out[1] = 0; bboxes_out[2] = h - 1; bboxes_out[3] = w - 1;
  return next;
}

// Edge-pixel reassignment by depth continuity (MfSegmentation.cpp:243-291):
// `iters` synchronous rounds; a pixel labelled 0 or in a tiny component
// adopts the first 8-neighbour (fixed priority order) whose ORIGINAL
// component is big enough and whose depth is within `delta`.
void mf_reassign_edges(int32_t* labels, const float* depth,
                       const int32_t* sizes, int32_t h, int32_t w,
                       int32_t iters, float delta, int32_t small_thresh) {
  // Frontier formulation of the synchronous relaxation.  A needy pixel's
  // outcome can only change between rounds if one of its 8 neighbours
  // became big-labelled in the previous round (existing big neighbours
  // keep the same label and depth, so a failed depth test stays failed;
  // labels never shrink).  So each round only visits (a) last round's
  // untested exposure frontier, instead of every needy pixel in the
  // image (58% of it on heavily textured scenes).  Updates are buffered
  // per round, so every read within a round sees start-of-round labels —
  // identical results to the previous full-image double buffer.
  static const int off[8][2] = {{-1, -1}, {-1, 0}, {-1, 1}, {0, -1},
                                {0, 1},  {1, -1}, {1, 0},  {1, 1}};
  const size_t n = static_cast<size_t>(h) * w;
  std::vector<uint8_t> needs(n, 0);
  std::vector<uint8_t> queued(n, 0);
  std::vector<int32_t> cand, next_cand;
  std::vector<std::pair<int32_t, int32_t>> pending;
  for (int32_t y = 1; y < h - 1; ++y) {
    const size_t row = static_cast<size_t>(y) * w;
    for (int32_t x = 1; x < w - 1; ++x) {
      const int32_t c = labels[row + x];
      if (c == 0 || sizes[c] < small_thresh) needs[row + x] = 1;
    }
  }
  // round-1 candidates: needy pixels with at least one big neighbour
  for (int32_t y = 1; y < h - 1; ++y) {
    const size_t row = static_cast<size_t>(y) * w;
    for (int32_t x = 1; x < w - 1; ++x) {
      const int32_t i = static_cast<int32_t>(row + x);
      if (!needs[i]) continue;
      for (const auto& o : off) {
        const int32_t cn = labels[i + o[0] * w + o[1]];
        if (cn != 0 && sizes[cn] > small_thresh) {
          cand.push_back(i);
          queued[i] = 1;
          break;
        }
      }
    }
  }
  for (int32_t it = 0; it < iters && !cand.empty(); ++it) {
    pending.clear();
    for (const int32_t i : cand) {
      queued[i] = 0;
      const float d = depth[i];
      for (const auto& o : off) {
        const int32_t j = i + o[0] * w + o[1];
        const int32_t cn = labels[j];
        if (cn != 0 && sizes[cn] > small_thresh &&
            __builtin_fabsf(depth[j] - d) < delta) {
          pending.emplace_back(i, cn);
          needs[i] = 0;
          break;
        }
      }
    }
    if (pending.empty()) break;
    next_cand.clear();
    for (const auto& p : pending) labels[p.first] = p.second;
    // expose: needy unqueued neighbours of newly assigned pixels (their
    // outcome may now differ); re-queue failed candidates only if they
    // too are adjacent to a new assignment
    for (const auto& p : pending) {
      const int32_t i = p.first;
      for (const auto& o : off) {
        const int32_t j = i + o[0] * w + o[1];
        if (needs[j] && !queued[j]) {
          queued[j] = 1;
          next_cand.push_back(j);
        }
      }
    }
    cand.swap(next_cand);
  }
}

// One pass over the label image computing every per-component histogram
// MfSegmentation needs (the numpy formulation is one 307200-element
// bincount per table): component x projected-model counts, component x
// mask-index counts.  comp_model is (n_comp, nm) int32, overlap is
// (n_comp, n_masks) int32 (untouched when n_masks < 2); id_to_index maps
// raw projected ids (uint8) to model rows.
void mf_label_stats(const int32_t* labels, const uint8_t* proj_ids,
                    const int32_t* id_to_index, const uint8_t* mask,
                    int64_t n, int32_t nm, int32_t n_masks,
                    int32_t* comp_model, int32_t* overlap) {
  if (n_masks >= 2) {
    const int32_t mmax = n_masks - 1;
    for (int64_t i = 0; i < n; ++i) {
      const int32_t c = labels[i];
      ++comp_model[static_cast<int64_t>(c) * nm + id_to_index[proj_ids[i]]];
      int32_t m = mask[i];
      if (m > mmax) m = mmax;
      ++overlap[static_cast<int64_t>(c) * n_masks + m];
    }
  } else {
    for (int64_t i = 0; i < n; ++i) {
      ++comp_model[static_cast<int64_t>(labels[i]) * nm +
                   id_to_index[proj_ids[i]]];
    }
  }
}

// Model-row x segmentation-label overlap histogram (one combined-key
// bincount in numpy): mmo is (nm, 256) int32.
void mf_model_seg_overlap(const uint8_t* seg, const uint8_t* proj_ids,
                          const int32_t* id_to_index, int64_t n,
                          int32_t* mmo) {
  for (int64_t i = 0; i < n; ++i) {
    ++mmo[static_cast<int64_t>(id_to_index[proj_ids[i]]) * 256 + seg[i]];
  }
}

// Per-label depth moments over valid (depth > 0) pixels (replaces a
// boolean-index copy + three weighted bincounts).  cnt/s1/s2 are 256-wide.
void mf_depth_moments(const uint8_t* seg, const float* depth, int64_t n,
                      int64_t* cnt, double* s1, double* s2) {
  for (int64_t i = 0; i < n; ++i) {
    const float d = depth[i];
    if (d > 0.0f) {
      const uint8_t s = seg[i];
      ++cnt[s];
      s1[s] += d;
      s2[s] += static_cast<double>(d) * d;
    }
  }
}

// Per-label bounding boxes over a uint8 label image in one pass:
// bboxes is (256, 4) int32 (top, left, bottom, right; inclusive), labels
// absent from the image keep (h, w, -1, -1).
void mf_u8_bboxes(const uint8_t* img, int32_t h, int32_t w,
                  int32_t* bboxes) {
  for (int32_t l = 0; l < 256; ++l) {
    bboxes[l * 4 + 0] = h; bboxes[l * 4 + 1] = w;
    bboxes[l * 4 + 2] = -1; bboxes[l * 4 + 3] = -1;
  }
  for (int32_t y = 0; y < h; ++y) {
    const uint8_t* row = img + static_cast<size_t>(y) * w;
    for (int32_t x = 0; x < w; ++x) {
      int32_t* bb = bboxes + row[x] * 4;
      if (y < bb[0]) bb[0] = y;
      if (x < bb[1]) bb[1] = x;
      if (y > bb[2]) bb[2] = y;
      if (x > bb[3]) bb[3] = x;
    }
  }
}

// zlib inflate for klg depth payloads (KlgLogReader.cpp:66-69).
// Returns decompressed byte count or -1.
int64_t mf_inflate(const uint8_t* src, int64_t src_len, uint8_t* dst,
                   int64_t dst_cap) {
  uLongf out_len = static_cast<uLongf>(dst_cap);
  const int rc = uncompress(dst, &out_len, src, static_cast<uLong>(src_len));
  return rc == Z_OK ? static_cast<int64_t>(out_len) : -1;
}

// uint16 mm -> float32 metres conversion fused with the inflate consumer
// (KlgLogReader.cpp:70).
void mf_depth_mm_to_m(const uint16_t* src, float* dst, int64_t n) {
  for (int64_t i = 0; i < n; ++i) dst[i] = src[i] * 0.001f;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Sparse SPD Cholesky for the deformation-graph normal equations.
//
// The reference factorises its embedded-deformation GN system with CHOLMOD
// and re-uses the symbolic analysis across solves (CholeskyDecomp.cpp:31-96);
// this is the same design on Eigen's SimplicialLLT: analyzePattern once per
// graph topology, factorize+solve per GN iteration.  Compiled only when the
// tensorflow-bundled Eigen headers are present (-DMF_HAVE_EIGEN).
// ---------------------------------------------------------------------------
#ifdef MF_HAVE_EIGEN
#include <Eigen/Sparse>

namespace {
using SpMat = Eigen::SparseMatrix<float>;

struct CholHandle {
  Eigen::SimplicialLLT<SpMat, Eigen::Lower> llt;
  int32_t n = 0;
  bool analyzed = false;
};

using SpMapC = Eigen::Map<const Eigen::SparseMatrix<float>>;

// zero-copy view of a scipy CSC matrix (sorted indices, compressed):
// Eigen's compressed column storage matches scipy's exactly.  Single
// precision: the GN step tolerates ~1e-6 relative solves and the f32
// factorisation halves the numeric-factor memory traffic (the per-
// iteration cost).
SpMapC map_csc(int32_t n, const int32_t* indptr, const int32_t* indices,
               const float* data) {
  return SpMapC(n, n, indptr[n], indptr, indices, data);
}
}  // namespace

extern "C" {

// Create a handle and run the symbolic analysis for a CSC pattern.
void* mf_chol_create(int32_t n, const int32_t* indptr,
                     const int32_t* indices, const float* data) {
  auto* h = new CholHandle;
  h->n = n;
  SpMat A = map_csc(n, indptr, indices, data);
  h->llt.analyzePattern(A);
  h->llt.factorize(A);
  if (h->llt.info() != Eigen::Success) {
    delete h;
    return nullptr;
  }
  h->analyzed = true;
  return h;
}

// Refactorise with new values on the SAME pattern. Returns 0 on success.
int32_t mf_chol_refactor(void* vh, int32_t n, const int32_t* indptr,
                         const int32_t* indices, const float* data) {
  auto* h = static_cast<CholHandle*>(vh);
  if (!h || h->n != n) return -1;
  SpMat A = map_csc(n, indptr, indices, data);
  h->llt.factorize(A);
  return h->llt.info() == Eigen::Success ? 0 : -2;
}

// Solve A x = b with the current factorisation. Returns 0 on success.
int32_t mf_chol_solve(void* vh, const float* b, float* x) {
  auto* h = static_cast<CholHandle*>(vh);
  if (!h || !h->analyzed) return -1;
  Eigen::Map<const Eigen::VectorXf> bv(b, h->n);
  Eigen::VectorXf xv = h->llt.solve(bv);
  if (h->llt.info() != Eigen::Success) return -2;
  Eigen::Map<Eigen::VectorXf>(x, h->n) = xv;
  return 0;
}

void mf_chol_destroy(void* vh) { delete static_cast<CholHandle*>(vh); }

}  // extern "C"
#endif  // MF_HAVE_EIGEN
