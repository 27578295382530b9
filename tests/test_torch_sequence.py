"""The port's sequence-level check and its evaluation tools.

The evaluation tools (maskfusion_tpu_torch.tools.evaluate) are held to
tests/test_tools.py's cases and to the JAX package's numbers on the same
files.  The sequence check is tests/test_parity_sequence.py on the port: a
generated TUM-layout sequence (the port's tools.make_sequence, byte for
byte the JAX package's) with an aggressive camera loop and an
independently moving object, through the port's CLI (reader -> engine ->
exporters) with ``-method precomputed`` in the CLI's default (prefused)
schedule, scored at that test's own bounds: camera ATE-RMSE under 3 cm
over at least 70 pairs, instance IoU over 0.65 over at least 70 frames,
the longest object log's displacement within 8 cm of the ground truth's
over at least 20 pairs."""

import os

import numpy as np

from maskfusion_tpu.tools import evaluate as jeval
from maskfusion_tpu.tools import make_sequence as jseq
from maskfusion_tpu_torch.main import main as tmain
from maskfusion_tpu_torch.tools import make_sequence
from maskfusion_tpu_torch.tools.evaluate import ate_rmse, segmentation_iou
from tests.torch_helpers import CPU


def test_ate_rmse_identity_and_offset(tmp_path):
    rng = np.random.default_rng(0)
    gt_lines, est_lines, est_off = [], [], []
    for i in range(20):
        t = np.array([0.1 * i, 0.02 * i, 0.0])
        gt_lines.append(f"{i * 0.1} {t[0]} {t[1]} {t[2]} 0 0 0 1")
        n = rng.normal(0, 0.005, 3)
        est_lines.append(
            f"{i * 0.1} {t[0]+n[0]} {t[1]+n[1]} {t[2]+n[2]} 0 0 0 1")
        # rigidly offset trajectory: ATE after alignment should be ~noise-free
        est_off.append(
            f"{i * 0.1} {t[0]+1.0} {t[2]+2.0} {-t[1]+0.5} 0 0 0 1")
    gt = tmp_path / "gt.txt"
    gt.write_text("\n".join(gt_lines))
    est = tmp_path / "est.txt"
    est.write_text("\n".join(est_lines))
    off = tmp_path / "off.txt"
    off.write_text("\n".join(est_off))

    r = ate_rmse(str(est), str(gt))
    assert r["pairs"] == 20
    assert r["rmse"] < 0.01
    r2 = ate_rmse(str(off), str(gt))   # pure rigid transform -> ~0 after align
    assert r2["rmse"] < 1e-6
    assert r == jeval.ate_rmse(str(est), str(gt))
    assert r2 == jeval.ate_rmse(str(off), str(gt))


def test_segmentation_iou(tmp_path):
    import cv2

    est_d = tmp_path / "est"
    gt_d = tmp_path / "gt"
    est_d.mkdir()
    gt_d.mkdir()
    gt = np.zeros((60, 80), np.uint8)
    gt[10:30, 10:30] = 1
    est = np.zeros((60, 80), np.uint8)
    est[12:30, 10:32] = 5  # different instance numbering, overlapping
    cv2.imwrite(str(gt_d / "Segmentation1.png"), gt)
    cv2.imwrite(str(est_d / "Segmentation1.png"), est)
    r = segmentation_iou(str(est_d), str(gt_d))
    assert r["frames"] == 1 and r["instances"] == 1
    assert 0.6 < r["mean_iou"] < 1.0
    assert r == jeval.segmentation_iou(str(est_d), str(gt_d))


def test_make_sequence_matches_jax(tmp_path):
    """The port's generator writes the JAX package's sequence, file for
    file and byte for byte."""
    jseq.generate(str(tmp_path / "jax"), frames=3, width=64, height=48,
                  seed=3)
    make_sequence.generate(str(tmp_path / "port"), frames=3, width=64,
                           height=48, seed=3)
    files = sorted(p.relative_to(tmp_path / "port")
                   for p in (tmp_path / "port").rglob("*") if p.is_file())
    assert files == sorted(p.relative_to(tmp_path / "jax")
                           for p in (tmp_path / "jax").rglob("*")
                           if p.is_file())
    assert len(files) > 10
    for f in files:
        assert (tmp_path / "port" / f).read_bytes() == \
            (tmp_path / "jax" / f).read_bytes(), f


def test_sequence_ate_and_iou(tmp_path):
    seq = str(tmp_path / "seq")
    make_sequence.generate(seq, frames=72, width=160, height=120, seed=3)
    out = str(tmp_path / "out")
    rc = tmain([
        "-dir", seq, "-method", "precomputed",
        "-cal", os.path.join(seq, "calibration.txt"),
        "-exportdir", out, "-ep", "-es", "-q", "-nso",
        "--global-capacity", str(1 << 17),
        "--object-capacity", str(1 << 13),
    ], device=CPU)
    assert rc == 0

    ate = ate_rmse(os.path.join(out, "poses-0.txt"),
                   os.path.join(seq, "groundtruth.txt"))
    assert ate["pairs"] >= 70
    assert ate["rmse"] < 0.030, f"camera ATE-RMSE {ate['rmse']*100:.2f} cm"

    iou = segmentation_iou(out, os.path.join(seq, "gt_masks"),
                           est_offset=-1)
    assert iou["frames"] >= 70
    assert iou["mean_iou"] > 0.65, f"instance IoU {iou['mean_iou']:.3f}"

    obj_paths = [p for p in os.listdir(out)
                 if p.startswith("poses-") and not p.endswith("-0.txt")]
    assert obj_paths, "no object pose log exported"
    # a jump-deactivation and respawn can split the object's log: score
    # the longest surviving one's span
    est = max((np.loadtxt(os.path.join(out, p)).reshape(-1, 8)
               for p in obj_paths), key=len)
    gt = np.loadtxt(os.path.join(seq, "object_groundtruth.txt"))
    gt_by_ts = {round(r[0], 3): r[1:4] for r in gt}
    pairs = [(r[1:4], gt_by_ts[round(r[0], 3)]) for r in est
             if round(r[0], 3) in gt_by_ts]
    assert len(pairs) >= 20
    est_d = pairs[-1][0] - pairs[0][0]
    gt_d = pairs[-1][1] - pairs[0][1]
    err = np.linalg.norm(est_d - gt_d)
    print(f"camera ATE-RMSE {ate['rmse']} m over {ate['pairs']} pairs, "
          f"instance IoU {iou['mean_iou']} over {iou['frames']} frames, "
          f"object displacement error {err} m over {len(pairs)} pairs")
    assert err < 0.08, f"object displacement error {err*100:.2f} cm"
