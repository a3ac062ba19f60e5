"""PyTorch + CUDA port of the ``repro`` serving stack (NVIDIA Hopper).

``repro_torch`` mirrors ``repro`` module for module: each module here has one
twin there (``repro_torch/kernels/interp/kernel.py`` ports
``repro/kernels/interp/kernel.py``, and so on) and is held against it by the
``tests/test_torch_*.py`` parity suite. The package imports ``torch`` and
numpy only; it never imports ``jax`` or ``repro``.

Every entry point takes an explicit ``device`` and defaults to ``"cuda"``;
asked for CUDA without a card it raises (:mod:`repro_torch.device`). The
Pallas kernels of the reference become hand-written CUDA C++ kernels for
``sm_90a`` (``csrc/``), built with ``nvcc`` at first use
(:mod:`repro_torch.kernels.build`). Each has a plain PyTorch twin in its
``ref.py``; a wrapper takes the twin only for tensors that lie on the CPU.
"""
