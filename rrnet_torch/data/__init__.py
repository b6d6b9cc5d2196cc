"""Data: the VisDrone reader, JPEG I/O, the training transforms, the
synthetic set, the loaders, and the host image transport."""
