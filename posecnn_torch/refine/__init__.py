"""Pose refinement of the port: ICP against depth, RANSAC centres and poses."""
