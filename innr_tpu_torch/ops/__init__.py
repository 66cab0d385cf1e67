"""Similarity ops by family: dense pairs (``dense``, ``dense_f64``,
``fast_math``), quantized (``scalar``, ``quant``, ``binary``, ``ternary``),
slot sketches (``slot``), sparse vectors (``sparse``, ``sparse_ext``), late
interaction (``maxsim``) and the host top-K tracker (``topk``)."""
