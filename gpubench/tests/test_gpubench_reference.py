"""The plain reference against a brute-force numpy top-k (lowest-index ties
included), and its control failing the comparison."""

import numpy as np
import pytest
import torch
from conftest import tiny

from gpubench import bench, reference
from gpubench.compare import compare, verdict
from gpubench.control import control
from gpubench.reference import Block, exact_topk, round_tf32
from gpubench.system import corpus_blocks, deleted_ids


def _numpy_topk(x, q, k, metric, alive):
    x, q = x.astype(np.float64), q.astype(np.float64)
    if metric == "l2":
        score = ((q[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    else:
        score = -(q @ x.T)
    score[:, ~alive] = np.inf
    ids = np.stack([np.lexsort((np.arange(len(x)), s))[:k] for s in score])
    vals = np.take_along_axis(score, ids, 1)
    return ids, vals if metric == "l2" else -vals


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("chunk", [1 << 29, 64 * 37])
def test_exact_topk_matches_numpy_ties_to_the_lowest_id(monkeypatch, metric, chunk):
    monkeypatch.setattr(reference, "CHUNK_ELEMS", chunk)
    monkeypatch.setattr(reference, "GROUP", 4)
    rng = np.random.default_rng(3)
    # Small integers: exact ties, every score exact in float32. The
    # reference keeps k + MARGIN candidates, so ties to the lowest id hold
    # for up to MARGIN rows tied at the k-th score.
    x = rng.integers(-12, 13, size=(1500, 6)).astype(np.float32)
    x[700:720] = x[5]  # a run of equal rows
    q = rng.integers(-12, 13, size=(37, 6)).astype(np.float32)
    q[0] = x[5]
    alive = rng.random(1500) > 0.1
    alive[5] = False
    k = 10
    blocks = [Block(torch.from_numpy(x[:900]), 0, torch.from_numpy(alive[:900])),
              Block(torch.from_numpy(x[900:]), 900, torch.from_numpy(alive[900:]))]
    ids, vals, scale = exact_topk(blocks, torch.from_numpy(q), k, metric)
    want_ids, want_vals = _numpy_topk(x, q, k, metric, alive)
    np.testing.assert_array_equal(ids.numpy(), want_ids)
    np.testing.assert_array_equal(vals.numpy(), want_vals)
    assert (scale.numpy() > 0).all()


def test_round_tf32_rounds_to_ten_mantissa_bits_ties_away():
    one = 1.0
    x = torch.tensor([one + 2**-12, one + 2**-11, one + 3 * 2**-12, -(one + 2**-11), 3.0])
    want = torch.tensor([one, one + 2**-10, one + 2**-10, -(one + 2**-10), 3.0])
    assert torch.equal(round_tf32(x), want)


@pytest.mark.parametrize("name", ["deep100m.serve", "msturing30m.seg.serve"])
def test_the_control_fails_and_the_reference_passes(name):
    """The control: the reference in TF32 in the program's place, at a
    size a test run holds. It has to fail one of the cell's numbers; the
    float32 reference's own answers have to pass."""
    cell = tiny(bench.load_cell(name), rows=40_000)
    cell.config.update(queries=256, check_queries=256)
    cpu = [torch.device("cpu")] * cell.chips
    out = control(cell, 5, 1.0, cpu)
    assert out["fails"], out
    cfg = cell.config
    gen = bench.generator(cfg["generator"])
    blocks = corpus_blocks(cfg, 5, cpu)
    q = gen.queries(cfg, 5, cpu[0])
    truth = exact_topk(blocks, q, cfg["k"], cfg["metric"])
    numbers = compare(np.arange(len(q)), truth[1].float().numpy(), truth[0].numpy(), truth,
                      blocks, q, cfg, deleted_ids(blocks))
    assert verdict(numbers, cfg["limits"]), numbers
