"""Instance segmentation subsystem (ref: Core/Segmentation).

Port of ``maskfusion_tpu/segmentation/__init__.py``.  `create_segmenter` is
the strategy dispatcher (Segmentation::init, Segmentation.cpp:47-66):
'maskfusion' fuses instance masks with geometric edges, 'precomputed' maps
mask labels directly to models.  The CRF-based 'cofusion' method is not
ported yet."""

from maskfusion_tpu_torch.segmentation.result import (ModelData,
                                                      SegmentationResult)


def create_segmenter(method: str, config, resolution, intrinsics):
    if method in ("maskfusion", "mask_fusion"):
        from maskfusion_tpu_torch.segmentation.mf_segmentation import (
            MfSegmentation)
        return MfSegmentation(config, resolution, intrinsics)
    if method == "precomputed":
        from maskfusion_tpu_torch.segmentation.pre_segmentation import (
            PreSegmentation)
        return PreSegmentation(config)
    if method in ("cofusion", "co_fusion"):
        raise NotImplementedError(
            "seg_method='cofusion' is not ported yet: it comes with the "
            "Co-Fusion slice (ROADMAP queue 1 item 11)")
    raise ValueError(f"unknown segmentation method: {method}")


__all__ = ["SegmentationResult", "ModelData", "create_segmenter"]
