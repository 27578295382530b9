"""Training on the card (port of ``maskfusion_tpu/parallel``).

``train`` is the one-card Mask R-CNN train step.  The mesh, the sharded
step and the object models split over cards come with multi-device
support (ROADMAP queue 1 item 14)."""
