"""Dense device ops of the port: preprocessing, GN reductions, splat,
fusion, clean, fill-in, and the hand-written CUDA kernels (ops/kernels)."""
