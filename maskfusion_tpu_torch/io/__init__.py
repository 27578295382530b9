"""Frame sources and result exporters (host-only numpy code).

Copies of ``maskfusion_tpu/io`` for the PyTorch port: the KLG and image
directory readers, the live-capture readers (video and RGB-D SDKs), the
EXR codec, ground-truth trajectories and the TUM / PLY / PNG exporters.
OpenCV is imported only inside the functions that decode or encode PNG and
JPEG or read video, so a raw KLG log runs without it."""
