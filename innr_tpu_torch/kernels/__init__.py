"""Hand-written CUDA kernels for Hopper (``sm_90a``) — the native layer.

The counterpart of :mod:`innr_tpu.kernels`, whose Pallas kernels target a
TPU. Each kernel here has a plain PyTorch version in the same module; a
wrapper runs the plain version only for tensors on the CPU (or when
:func:`innr_tpu_torch.config.force_reference` is set), and for CUDA tensors
launches the kernel or raises — never a silent fallback.

- :mod:`innr_tpu_torch.kernels.knn` — fused score + streaming top-k
  (``csrc/knn.cu``);
- :mod:`~innr_tpu_torch.kernels.packed_knn`, :mod:`~innr_tpu_torch.kernels.hamming`
  — packed binary / ternary scans (``csrc/packed_knn.cu``, ``csrc/packed.cu``);
- :mod:`~innr_tpu_torch.kernels.pruned_knn`, :mod:`~innr_tpu_torch.kernels.assign`
  — the tile and threshold scans, the nearest-centroid pass
  (``csrc/knn.cu``, ``csrc/pruned.cu``, ``csrc/assign.cu``);
- :mod:`~innr_tpu_torch.kernels.slot_knn`, :mod:`~innr_tpu_torch.kernels.sparse_knn`
  — the slot-sketch and sparse scans (``csrc/slot_knn.cu``,
  ``csrc/sparse_knn.cu``);
- :mod:`~innr_tpu_torch.kernels.maxsim_kernel` — MaxSim scores of a query
  batch over multi-vector documents (``csrc/maxsim.cu``);
- :mod:`~innr_tpu_torch.kernels.row_scan` — the query tile of the two
  one-row-per-thread scans (``slot_scan``, ``sparse_scan``), which share
  ``csrc/row_scan.cuh``.

Sources are compiled at first use by :mod:`innr_tpu_torch.kernels._build`;
importing this package needs neither a GPU nor nvcc.
"""
