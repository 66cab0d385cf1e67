"""dispatch.k1_launches.serve: K1 passes launched a backend call (the change
in ``innr_tpu_torch.kernels.knn.LAUNCHES`` over the window's calls)."""


def read(rec):
    return rec.window.counters["k1_launches"] / len(rec.calls) if rec.calls else None
