"""Device operations of the port (``rdst_tpu/ops/``): the kernel wrappers
and their plain PyTorch versions."""
