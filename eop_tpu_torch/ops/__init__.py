"""Network blocks, geometry, NMS and the hand-written kernels."""
