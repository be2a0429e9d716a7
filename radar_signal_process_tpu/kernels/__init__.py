"""Hand-written kernels outside XLA: the CPU-only native C++ CFAR cascade
(``native_cfar``), loaded on demand by ``models.detect``."""
