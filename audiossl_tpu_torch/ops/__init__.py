"""Array ops of the port: windowing, normalization, crop-resize, fused block 1."""
