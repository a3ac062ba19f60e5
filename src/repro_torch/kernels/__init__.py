"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
twin (``ref.py``) and its dispatching wrapper (``ops.py``)."""
