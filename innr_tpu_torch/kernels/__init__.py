"""Hand-written CUDA kernels for Hopper (``sm_90a``) — the native layer.

The counterpart of :mod:`innr_tpu.kernels`, whose Pallas kernels target a
TPU. Each kernel here has a plain PyTorch version in the same module; a
wrapper runs the plain version only for tensors on the CPU (or when
:func:`innr_tpu_torch.config.force_reference` is set), and for CUDA tensors
launches the kernel or raises — never a silent fallback.

- :mod:`innr_tpu_torch.kernels.knn` — fused score + streaming top-k
  (``csrc/knn.cu``).

Sources are compiled at first use by :mod:`innr_tpu_torch.kernels._build`;
importing this package needs neither a GPU nor nvcc.
"""
