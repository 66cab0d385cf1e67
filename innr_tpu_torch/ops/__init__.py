"""Similarity ops by family: quantized (``scalar``, ``quant``, ``binary``,
``ternary``), slot sketches (``slot``) and sparse vectors (``sparse``,
``sparse_ext``)."""
