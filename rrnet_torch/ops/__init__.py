"""Device ops: boxes, heatmap decode, NMS (hard NMS and soft-NMS CUDA
kernels), ROI-align, DCNv2 (plain version and CUDA kernels), deformable
PSROI pooling, the int8 convolution, targets and anchor k-means."""
