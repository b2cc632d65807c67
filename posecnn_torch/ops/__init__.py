"""Ops of the port: Hough voting (CUDA vote kernels), RoI pooling, NMS."""
