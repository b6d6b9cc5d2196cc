"""Device ops: boxes, heatmap decode, NMS, soft-NMS (CUDA kernel),
ROI-align, DCNv2 (plain version and CUDA kernels)."""
