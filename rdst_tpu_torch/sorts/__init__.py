"""Sort execution plans of the port (``rdst_tpu/sorts/``); the registry
mapping Algorithm names onto them is in ``rdst_tpu_torch/sorter.py``."""
