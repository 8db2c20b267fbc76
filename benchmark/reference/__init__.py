"""The plain reference that decides ``correct``: numpy and plain PyTorch on
the CPU, importing nothing of ``h264tpu_torch``, ``h264tpu`` or JAX."""
