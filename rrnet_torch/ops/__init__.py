"""Device ops: boxes, heatmap decode, NMS, soft-NMS (CUDA kernel),
ROI-align."""
