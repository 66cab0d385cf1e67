"""The harness end to end on the card, at a small size (marked ``cuda``:
skips without a card)."""

import pytest
import torch
from conftest import tiny

from gpubench import bench
from gpubench.run import run


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["deep100m.serve", "msturing30m.seg.serve", "deep100m.batch"])
def test_a_small_cell_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell = tiny(bench.load_cell(name), rows=2_000_000)
    out = run(cell, 31, 1.0, True, [torch.device("cuda", 0)])
    res = out["result"]
    assert res["correct"], out["checks"]
    assert res["device"]["platform"] == "gpu" and res["device"]["busy_s"] > 0
    assert set(res["metrics"]) == {m["name"] for m in cell.per_layer}
