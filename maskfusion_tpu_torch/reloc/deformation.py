"""Embedded deformation graph (Sumner-style) for map non-rigid correction.

Port of ``maskfusion_tpu/reloc/deformation.py`` (ref
Core/Utils/DeformationGraph.{h,cpp} + Core/Model/Deformation.{h,cpp} +
CholeskyDecomp): graph nodes sampled from the surfel map, Gauss-Newton over
per-node affine transforms with rotation / regularisation / constraint
energies (wRot=1, wReg=10, wCon=100 — DeformationGraph.cpp:25-27), solved
by sparse normal equations.  Application blends the k=4 nearest nodes per
point as copy_unstable.vert:161-341 does in the clean shader.

The graph is small (<= 1024 nodes) and its solve sparse: sampling, the
Gauss-Newton assembly, the solve (mfcore's sparse Cholesky where it was
built with Eigen, else block-Jacobi CG), the host blend and the pose update
are numpy / scipy, copied from the JAX package.  The blend over a whole
map (`apply_to_map_device`) and over large point batches runs as torch ops
on the graph's device, a 65,536-row chunk at a time: the squared distance
in its GEMM form |p|^2 + |g|^2 - 2 p.g^T in f32 (not torch.cdist, which
changes formula with the size), the k nearest nodes lowest index first
among equal distances (jax.lax.top_k's order), one gather from the (G, 24)
node table, and the affine blend, with normals through the inverse
transpose.  No Pallas kernel computes this in the JAX package, so neither
does a hand-written kernel here.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch
from scipy import sparse
from scipy.sparse.linalg import spsolve

from maskfusion_tpu_torch import cpp as native
from maskfusion_tpu_torch import resolve_device

W_ROT = 1.0
W_REG = 10.0
W_CON = 100.0
K_NEIGHBOURS = 4
CHUNK = 65536          # rows of one device blend step: its (CHUNK, G) f32
                       # distance matrix is 256 MB at G = 1024


def _nearest_k(d2: torch.Tensor, k: int):
    """The k smallest entries of each row of `d2` in ascending order, the
    lowest index first among equal values (jax.lax.top_k's order, which
    torch.topk does not promise): k passes of a row minimum, each taking
    the first index of its minimum.  Overwrites `d2`."""
    vals, ids = [], []
    for j in range(k):
        v, i = torch.min(d2, 1)
        vals.append(v)
        ids.append(i)
        if j + 1 < k:
            d2.scatter_(1, i[:, None], float("inf"))
    return torch.stack(vals, 1), torch.stack(ids, 1)


def _blend_chunk(p: torch.Tensor, nr: Optional[torch.Tensor],
                 g: torch.Tensor, g2: torch.Tensor, tab: torch.Tensor,
                 k: int):
    """One chunk of the device blend (the JAX package's jitted
    `_apply_chunks_jit` body): (C, 3) points and normals (or None) ->
    blended points and renormalised normals (None without normals)."""
    d2 = (p * p).sum(1)[:, None] + g2[None] - 2.0 * (p @ g.T)
    v, ids = _nearest_k(d2, k)
    d = torch.sqrt(torch.clamp_min(v, 0.0))
    dmax = d[:, -1:] * 1.0001 + 1e-12
    w = (1.0 - d / dmax) ** 2
    w = w / torch.clamp_min(w.sum(1, keepdim=True), 1e-12)
    rows = tab[ids]                                        # (C, k, 24)
    A = rows[..., 0:9].reshape(rows.shape[0], k, 3, 3)
    t = rows[..., 9:12]
    gk = rows[..., 12:15]
    dv = p[:, None, :] - gk
    o = (w[..., None] * ((A * dv[..., None, :]).sum(-1) + gk + t)).sum(1)
    if nr is None:
        return o, None
    iT = rows[..., 15:24].reshape(rows.shape[0], k, 3, 3)
    no = (w[..., None] * (iT * nr[:, None, None, :]).sum(-1)).sum(1)
    no = no / torch.clamp_min(torch.linalg.vector_norm(
        no, dim=-1, keepdim=True), 1e-12)
    return o, no


@dataclasses.dataclass
class GraphConstraint:
    src: np.ndarray          # (3,) point in map (world) coordinates
    dst: np.ndarray          # (3,) where it should move to
    relative: bool = False
    src_time: int = 0
    dst_time: int = 0


class DeformationGraph:
    def __init__(self, nodes: np.ndarray,
                 node_times: Optional[np.ndarray] = None, device=None):
        """nodes: (G, 3) world positions (sampled from the map); `device`
        is where `apply_to_map_device` and the batched `apply_to_points`
        run (default: the card)."""
        self.device = resolve_device(device, "DeformationGraph")
        self.g = nodes.astype(np.float64)
        self.n = len(nodes)
        self.times = (node_times if node_times is not None
                      else np.arange(self.n)).astype(np.float64)
        self.A = np.tile(np.eye(3), (self.n, 1, 1))    # per-node affine
        self.t = np.zeros((self.n, 3))
        # k-NN connectivity (reference: sequential in time order;
        # we use metric kNN which is strictly better for loop closures)
        d2 = np.sum((self.g[:, None] - self.g[None]) ** 2, -1)
        np.fill_diagonal(d2, np.inf)
        k = min(K_NEIGHBOURS, self.n - 1)
        self.neighbours = np.argsort(d2, axis=1)[:, :k]   # (G, k)
        self.constraints: List[GraphConstraint] = []

    @classmethod
    def sample_from_map(cls, positions: np.ndarray, init_times: np.ndarray,
                        max_nodes: int = 1024,
                        device=None) -> "DeformationGraph":
        """Systematic sampling in map order (Deformation::sampleGraphModel,
        Deformation.cpp:207-276 — bufferSize 1024 nodes)."""
        order = np.argsort(init_times)
        step = max(1, len(positions) // max_nodes)
        idx = order[::step][:max_nodes]
        return cls(positions[idx], init_times[idx], device=device)

    def add_constraint(self, src: np.ndarray, dst: np.ndarray,
                       src_time: int = 0, dst_time: int = 0,
                       relative: bool = False):
        self.constraints.append(GraphConstraint(
            np.asarray(src, np.float64), np.asarray(dst, np.float64),
            relative, src_time, dst_time))

    # ----------------------------------------------------------- weights
    def _knn_weights(self, pts: np.ndarray,
                     chunk: int = 1 << 16) -> Tuple[np.ndarray, np.ndarray]:
        """(P, k) node ids + normalised blend weights per point
        (copy_unstable.vert's k=4 (1 - d/dmax)^2 scheme).  Chunked so the
        (P, G) distance matrix never exceeds ~chunk*G floats — at 1024
        nodes a full-map application would otherwise need GBs."""
        k = min(K_NEIGHBOURS, self.n)
        ids_out = np.empty((len(pts), k), np.int64)
        w_out = np.empty((len(pts), k), np.float64)
        g32 = self.g.astype(np.float32)
        g2 = (g32 * g32).sum(1)
        for s in range(0, len(pts), chunk):
            p = pts[s:s + chunk].astype(np.float32)
            # |p-g|^2 via one GEMM — the (chunk, G, 3) broadcast form
            # materialised gigabytes at 1024 nodes (70 s per 100k points)
            d2 = np.maximum(
                (p * p).sum(1)[:, None] + g2[None] - 2.0 * (p @ g32.T), 0.0)
            if k < self.n:
                ids = np.argpartition(d2, k - 1, axis=1)[:, :k]
                # order the k selected by distance (dmax needs the farthest)
                sub = np.take_along_axis(d2, ids, 1)
                o = np.argsort(sub, axis=1)
                ids = np.take_along_axis(ids, o, 1)
            else:
                ids = np.argsort(d2, axis=1)[:, :k]
            d = np.sqrt(np.take_along_axis(d2, ids, 1))
            dmax = d[:, -1:] * 1.0001 + 1e-12
            w = (1.0 - d / dmax) ** 2
            w = w / np.maximum(w.sum(1, keepdims=True), 1e-12)
            ids_out[s:s + chunk] = ids
            w_out[s:s + chunk] = w
        return ids_out, w_out

    # ---------------------------------------------------------- optimise
    def optimise(self, iterations: int = 3) -> Tuple[float, float]:
        """Gauss-Newton over (A, t).  Returns (total_error, mean_cons_error)
        — the acceptance pair used by Deformation::constrain
        (Deformation.cpp:75-180: accept if meanConsError < 0.0003 and
        error < 0.12)."""
        if not self.constraints:
            return 0.0, 0.0
        cons_src = np.stack([c.src for c in self.constraints])
        cons_dst = np.stack([c.dst for c in self.constraints])
        cids, cw = self._knn_weights(cons_src)

        nvar = self.n * 12

        def pack_index(node, comp):
            return node * 12 + comp

        n = self.n
        k = self.neighbours.shape[1]
        kc = cids.shape[1]
        C = len(self.constraints)
        i_idx = np.arange(n)
        c3 = np.arange(3)

        # fully vectorised COO assembly (the reference builds the same
        # Jacobian with CHOLMOD triplets, CholeskyDecomp.cpp; python loops
        # were quadratic pain at the reference's 1024-node graph size)
        for it in range(iterations):
            # convergence precheck BEFORE the (dominant) assembly+solve:
            # the acceptance gate is meanConsError < 3e-4 (Deformation.cpp:
            # 75-180); once the constraint error sits an order below that,
            # further GN iterations cannot change the accept decision.
            # C is tiny (tens), so this costs microseconds.
            gk0 = self.g[cids]
            pred0 = np.einsum(
                "ck,ckd->cd", cw,
                np.einsum("ckab,ckb->cka", self.A[cids],
                          cons_src[:, None] - gk0) + gk0 + self.t[cids])
            if (it > 0 and float(np.linalg.norm(pred0 - cons_dst, axis=1)
                                 .mean()) < 3e-5):
                break
            blocks = []  # (rows, cols, vals) per energy term
            resids = []
            r0 = 0

            sq_rot = np.sqrt(W_ROT)
            # column-orthogonality: 3 pair residuals per node
            pa = np.array([0, 0, 1])
            pb = np.array([1, 2, 2])
            rows_p = (r0 + (i_idx[:, None] * 3 + np.arange(3)[None])  # (n,p)
                      )[:, :, None, None]
            rows_p = np.broadcast_to(rows_p, (n, 3, 3, 2))
            # entry 0: col (c*3+pa), val A[i,c,pb]; entry 1: col (c*3+pb),
            # val A[i,c,pa]
            cols_pair = np.stack([
                i_idx[:, None, None] * 12 + c3[None, None] * 3 + pa[None, :, None],
                i_idx[:, None, None] * 12 + c3[None, None] * 3 + pb[None, :, None],
            ], axis=-1)                                               # (n,3,3,2)
            vals_pair = np.stack([
                sq_rot * self.A[:, :, pb].transpose(0, 2, 1),         # (n,3,3) [i,p,c]
                sq_rot * self.A[:, :, pa].transpose(0, 2, 1),
            ], axis=-1)
            resid_pair = sq_rot * np.einsum(
                "ncp,ncp->np", self.A[:, :, pa], self.A[:, :, pb])    # (n,3)
            blocks.append((rows_p.ravel(), cols_pair.ravel(),
                           vals_pair.ravel()))
            resids.append(resid_pair.ravel())
            r0 += 3 * n

            # unit-column residuals
            rows_u = (r0 + i_idx[:, None] * 3 + np.arange(3)[None])   # (n,a)
            rows_u = np.broadcast_to(rows_u[:, :, None], (n, 3, 3))
            cols_u = (i_idx[:, None, None] * 12 + c3[None, None] * 3
                      + np.arange(3)[None, :, None])                  # (n,a,c)
            vals_u = 2 * sq_rot * self.A.transpose(0, 2, 1)           # (n,a,c)
            resid_u = sq_rot * (np.einsum("nca,nca->na", self.A, self.A) - 1.0)
            blocks.append((rows_u.ravel(), cols_u.ravel(), vals_u.ravel()))
            resids.append(resid_u.ravel())
            r0 += 3 * n

            # regularisation: (n, k, 3) residuals
            sq_reg = np.sqrt(W_REG)
            jn = self.neighbours                                       # (n,k)
            e = self.g[jn] - self.g[:, None]                           # (n,k,3)
            pred = (np.einsum("ncd,nkd->nkc", self.A, e)
                    + (self.g + self.t)[:, None] - (self.g + self.t)[jn])
            rows_r = (r0 + (i_idx[:, None, None] * (3 * k)
                            + np.arange(k)[None, :, None] * 3
                            + c3[None, None]))                         # (n,k,c)
            # 3 A-entries + own t + neighbour t = 5 entries per residual
            cols_rA = np.broadcast_to(
                i_idx[:, None, None, None] * 12
                + c3[None, None, :, None] * 3
                + np.arange(3)[None, None, None], (n, k, 3, 3))        # (n,k,c,d)
            vals_rA = np.broadcast_to(
                sq_reg * e[:, :, None, :], (n, k, 3, 3))
            cols_rt = np.broadcast_to(
                i_idx[:, None, None] * 12 + 9 + c3[None, None],
                (n, k, 3))                                             # (n,k,c)
            cols_rtj = jn[:, :, None] * 12 + 9 + c3[None, None]
            blocks.append((np.broadcast_to(rows_r[..., None],
                                           (n, k, 3, 3)).ravel(),
                           cols_rA.ravel(), vals_rA.ravel()))
            blocks.append((rows_r.ravel(), cols_rt.ravel(),
                           np.full(n * k * 3, sq_reg)))
            blocks.append((rows_r.ravel(), cols_rtj.ravel(),
                           np.full(n * k * 3, -sq_reg)))
            resids.append((sq_reg * pred).ravel())
            r0 += n * k * 3

            # constraints: (C, 3) residuals, kc nodes each
            sq_con = np.sqrt(W_CON)
            gk = self.g[cids]                                          # (C,kc,3)
            ec = cons_src[:, None] - gk                                # (C,kc,3)
            pred_c = np.einsum(
                "ck,ckd->cd", cw,
                np.einsum("ckab,ckb->cka", self.A[cids], ec)
                + gk + self.t[cids])
            err_c = pred_c - cons_dst                                  # (C,3)
            rows_c = (r0 + np.arange(C)[:, None] * 3 + c3[None])       # (C,c)
            cols_cA = (cids[:, :, None, None] * 12
                       + c3[None, None, :, None] * 3
                       + np.arange(3)[None, None, None])               # (C,kc,c,d)
            vals_cA = (sq_con * cw[:, :, None, None]
                       * np.broadcast_to(ec[:, :, None, :], (C, kc, 3, 3)))
            cols_ct = cids[:, :, None] * 12 + 9 + c3[None, None]       # (C,kc,c)
            vals_ct = sq_con * np.broadcast_to(
                cw[:, :, None], (C, kc, 3))
            rows_cA = np.broadcast_to(
                rows_c[:, None, :, None], (C, kc, 3, 3))
            rows_ct = np.broadcast_to(rows_c[:, None, :], (C, kc, 3))
            blocks.append((rows_cA.ravel(), cols_cA.ravel(),
                           vals_cA.ravel()))
            blocks.append((rows_ct.ravel(), cols_ct.ravel(),
                           vals_ct.ravel()))
            resids.append((sq_con * err_c).ravel())
            r0 += C * 3

            rows = np.concatenate([b[0] for b in blocks])
            cols = np.concatenate([b[1] for b in blocks])
            vals = np.concatenate([b[2] for b in blocks])
            J = sparse.csr_matrix((vals, (rows, cols)), shape=(r0, nvar))
            b = -np.concatenate(resids)
            dx = self._solve_normal_equations(J, J.T @ b)
            dx = dx.reshape(self.n, 12)
            self.A += dx[:, :9].reshape(self.n, 3, 3)
            self.t += dx[:, 9:]
            # converged GN steps stop early — small closures settle in 1-2
            # iterations, halving the dominant factorise+solve cost
            if float(np.abs(dx).max()) < 1e-6:
                break

        # final errors
        phi = self.apply_to_points(cons_src)
        return self._final_errors(phi, cons_dst)

    def _solve_normal_equations(self, J: sparse.csr_matrix,
                                rhs: np.ndarray) -> np.ndarray:
        """Direct sparse Cholesky (mfcore's Eigen SimplicialLLT with the
        symbolic analysis cached across GN iterations — the reference's
        CholeskyDecomp.cpp:31-96 design on CHOLMOD) where mfcore was built
        with Eigen (``has_chol``); block-Jacobi-preconditioned CG otherwise,
        or inside ``cpp.disabled()``.  `last_solver` names the one that ran.

        scipy's SuperLU-backed spsolve is ~100x slower on this 12G x 12G
        system (measured 8.7 s at 1024 nodes); CG converges in ~100
        iterations (~160 ms) and remains the pure-python fallback."""
        JtJn = (J.T @ J).tocsc()
        # 1e-5 (diag is O(1..200)): a 1e-8 shift is BELOW f32 epsilon at
        # this scale, and the f32 LLT factorisation hits a non-positive
        # pivot on the near-semidefinite system and bails — which silently
        # dropped every solve onto the ~60x slower CG fallback.  1e-5 is
        # still ~1e-6 relative to the diagonal, far below GN step noise.
        JtJn = JtJn + 1e-5 * sparse.eye(JtJn.shape[0], format="csc")
        JtJn.sort_indices()
        x = self._native_chol_solve(JtJn, rhs)
        if x is not None:
            self.last_solver = "cholesky"
            return x
        self.last_solver = "cg"
        from scipy.sparse.linalg import LinearOperator, cg

        nvar = J.shape[1]
        n = nvar // 12
        JtJ = (J.T @ J).tocsr()
        JtJ = JtJ + 1e-5 * sparse.eye(nvar, format="csr")

        # vectorised 12x12 diagonal-block extraction + inversion
        coo = JtJ.tocoo()
        on_block = (coo.row // 12) == (coo.col // 12)
        diag_blocks = np.zeros((n, 12, 12))
        np.add.at(diag_blocks,
                  (coo.row[on_block] // 12, coo.row[on_block] % 12,
                   coo.col[on_block] % 12), coo.data[on_block])
        binv = np.linalg.inv(diag_blocks + 1e-10 * np.eye(12))

        def precond(v):
            return np.einsum("nij,nj->ni", binv,
                             v.reshape(n, 12)).ravel()

        M = LinearOperator((nvar, nvar), matvec=precond)
        # GN inner solves tolerate loose tolerances; 1e-4 converges in
        # ~100 iterations (measured ~160 ms at 1024 nodes vs 3.7 s for
        # SuperLU spsolve — and 198 s (!) for splu on this system)
        x, info = cg(JtJ, rhs, M=M, maxiter=400, rtol=1e-4, atol=0.0)
        if info != 0:  # fall back to the direct solve on non-convergence
            x = spsolve(JtJ.tocsc(), rhs)
        return x

    def _native_chol_solve(self, A_csc: sparse.csc_matrix,
                           rhs: np.ndarray) -> Optional[np.ndarray]:
        """Factorise+solve through libmfcore's Eigen SimplicialLLT.  The
        handle (symbolic analysis) is cached on the graph and reused while
        the sparsity pattern is unchanged — across the GN iterations of one
        optimise() the pattern is constant, so iterations 2+ only pay the
        numeric refactorisation (the CHOLMOD-cached-symbolic behaviour of
        CholeskyDecomp.cpp:48-63)."""
        lib = native.active()
        if lib is None or not getattr(lib, "has_chol", False):
            return None
        n = A_csc.shape[0]
        indptr = np.ascontiguousarray(A_csc.indptr, np.int32)
        indices = np.ascontiguousarray(A_csc.indices, np.int32)
        data = np.ascontiguousarray(A_csc.data, np.float32)
        h = getattr(self, "_chol_handle", None)
        pat = getattr(self, "_chol_pattern", None)
        same = (h is not None and pat is not None
                and pat[0] == n and pat[1].shape == indices.shape
                and np.array_equal(pat[1], indices))
        if same:
            if lib.mf_chol_refactor(h, n, indptr, indices, data) != 0:
                return None
        else:
            if h is not None:
                lib.mf_chol_destroy(h)
                self._chol_handle = None
            h = lib.mf_chol_create(n, indptr, indices, data)
            if not h:
                return None
            self._chol_handle = h
            self._chol_pattern = (n, indices.copy())
        x = np.empty(n, np.float32)
        if lib.mf_chol_solve(h, np.ascontiguousarray(rhs, np.float32),
                             x) != 0:
            return None
        return x.astype(np.float64)

    def __del__(self):
        h = getattr(self, "_chol_handle", None)
        if h:
            lib = native.load()
            if getattr(lib, "has_chol", False):
                lib.mf_chol_destroy(h)

    @staticmethod
    def _final_errors(phi, cons_dst):
        cons_err = np.linalg.norm(phi - cons_dst, axis=1)
        mean_cons = float(cons_err.mean())
        total = float(np.sqrt(np.mean(cons_err ** 2)))
        return total, mean_cons

    # ------------------------------------------------------------- apply
    def apply_to_points(self, pts: np.ndarray,
                        normals: Optional[np.ndarray] = None,
                        device: Optional[bool] = None):
        """Blend-deform points (and optionally normals) by their k nearest
        graph nodes (copy_unstable.vert:161-341 semantics).

        Batches of 4096 points or more run on the graph's device
        (`_apply_points_device`: the kNN from one (P, G) product and the
        blend from one (G, 24)-row gather); smaller ones on the host.  A
        failure on the device raises: there is no fallback to the host (the
        JAX package swallows it, deformation.py:430-434)."""
        if device is None:
            device = len(pts) >= 4096
        if device:
            return self._apply_points_device(pts, normals)
        return self._apply_points_host(pts, normals)

    def _node_table(self):
        """(G, 24) f32 per-node blend table [A(9), t(3), g(3), invT(9)] —
        the only state the device apply needs (copy_unstable.vert:161-341
        serialises the same 16-float/node texture, Deformation.cpp:154-162)."""
        A = self.A.astype(np.float64)
        invT = np.linalg.inv(A).transpose(0, 2, 1)
        return np.concatenate([
            A.reshape(self.n, 9), self.t, self.g,
            invT.reshape(self.n, 9),
        ], axis=1).astype(np.float32)

    def _device_tables(self):
        """The node positions (G, 3), their squared norms and the (G, 24)
        node table on the graph's device: the only state the device blend
        needs, and all that crosses to the device."""
        g = torch.from_numpy(self.g.astype(np.float32)).to(self.device)
        tab = torch.from_numpy(self._node_table()).to(self.device)
        return g, (g * g).sum(1), tab

    def _apply_points_device(self, pts, normals=None, chunk: int = CHUNK):
        """apply_to_points on the graph's device: one upload of the points
        (and normals), the blend a chunk at a time, one fetch back."""
        k = min(K_NEIGHBOURS, self.n)
        g, g2, tab = self._device_tables()
        p_all = torch.from_numpy(np.ascontiguousarray(pts, np.float32)).to(
            self.device)
        n_all = (None if normals is None else torch.from_numpy(
            np.ascontiguousarray(normals, np.float32)).to(self.device))
        out_p = torch.empty_like(p_all)
        out_n = None if n_all is None else torch.empty_like(n_all)
        for s in range(0, len(p_all), chunk):
            o, no = _blend_chunk(p_all[s:s + chunk],
                                 None if n_all is None
                                 else n_all[s:s + chunk], g, g2, tab, k)
            out_p[s:s + chunk] = o
            if out_n is not None:
                out_n[s:s + chunk] = no
        if out_n is None:
            return out_p.cpu().numpy().astype(np.float64)
        both = torch.cat([out_p, out_n], 1).cpu().numpy().astype(np.float64)
        return both[:, :3], both[:, 3:]

    def apply_to_map_device(self, pos: torch.Tensor, normal: torch.Tensor,
                            count):
        """Deform a surfel map's device-resident (cap, 3) `pos` / `normal`
        IN PLACE, without any download or upload of the map: only the
        (G, 24) node table crosses to the device.  Rows [0, count) are
        blended a chunk at a time; rows at or beyond `count` (dead slots)
        are never written, so they keep their values bit for bit.  Returns
        (pos, normal) — the engine's loop-closure path
        (copy_unstable.vert:161-341 applies the same blend in-shader)."""
        n = int(count)
        k = min(K_NEIGHBOURS, self.n)
        g, g2, tab = self._device_tables()
        for s in range(0, n, CHUNK):
            e = min(n, s + CHUNK)
            o, no = _blend_chunk(pos[s:e], normal[s:e], g, g2, tab, k)
            pos[s:e] = o
            normal[s:e] = no
        return pos, normal

    def _apply_points_host(self, pts: np.ndarray,
                           normals: Optional[np.ndarray] = None):
        ids, w = self._knn_weights(pts)
        out = np.zeros_like(pts, dtype=np.float64)
        nout = np.zeros_like(pts, dtype=np.float64) if normals is not None else None
        for kk in range(ids.shape[1]):
            ni = ids[:, kk]
            wgt = w[:, kk:kk + 1]
            d = pts - self.g[ni]
            out += wgt * (np.einsum("nij,nj->ni", self.A[ni], d)
                          + self.g[ni] + self.t[ni])
            if normals is not None:
                inv_t = np.linalg.inv(np.transpose(self.A[ni], (0, 2, 1)))
                nout += wgt * np.einsum("nij,nj->ni", inv_t, normals)
        if normals is not None:
            nout /= np.maximum(np.linalg.norm(nout, axis=1, keepdims=True),
                               1e-12)
            return out, nout
        return out

    def apply_to_pose(self, pose: np.ndarray) -> np.ndarray:
        """Deform a camera pose by moving its position and re-orthonormalised
        rotation (the reference applies the graph to fern poses,
        DeformationGraph.cpp applyGraphToPoses)."""
        p = pose[:3, 3][None]
        ids, w = self._knn_weights(p)
        blended_A = np.einsum("k,kij->ij",
                              w[0], self.A[ids[0]])
        new_t = self.apply_to_points(p)[0]
        R = blended_A @ pose[:3, :3]
        u, _, vt = np.linalg.svd(R)
        out = pose.copy()
        out[:3, :3] = u @ vt
        out[:3, 3] = new_t
        return out
