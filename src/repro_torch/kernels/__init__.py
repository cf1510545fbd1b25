"""Hand-written CUDA kernels of the port (``csrc/``), their bindings, and
their plain PyTorch versions (``ref``); ``ops`` dispatches by device."""
