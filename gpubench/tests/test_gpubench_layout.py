"""Every cell, configuration, traffic mix, metric, index kind and loop is found
by name from its files, BENCHMARK.json keeps the benchmark's contract, a new
cell made from data files alone runs, and so does one that brings a new
index kind, reference and loop as new files, editing none that is there."""

import hashlib
import json
import re
import shutil

import numpy as np
import pytest
import torch
from conftest import ROOT, tiny

from gpubench import bench
from gpubench.run import run

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]
METRICS = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("name", CELLS)
def test_cell_found_by_name(name):
    cell = bench.load_cell(name)
    cfg = cell.config
    for key in ("source", "rows", "dim", "dtype", "metric", "k", "queries", "check_queries",
                "assumed", "reduced", "chips", "generator", "limits", "index"):
        assert key in cfg, key
    assert cfg["chips"] == cell.chips
    assert len(cfg["source"]) <= 200
    assert callable(bench.loop(cell.traffic["loop"]))
    kind = bench.system(cfg["index"])
    assert callable(kind.build) and callable(kind.blocks)
    ref = bench.reference(cfg["index"])
    assert callable(ref.exact_topk) and callable(ref.control_topk)
    gen = bench.generator(cfg["generator"])
    assert callable(gen.rows) and callable(gen.queries)
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
    assert len(cell.end_to_end) >= 2 and cell.per_layer


@pytest.mark.parametrize("name", METRICS)
def test_metric_reader_found_by_name(name):
    assert callable(bench.reader(name))


def test_benchmark_json_keeps_the_contract():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["gpubench"] and 1 <= SPEC["run_seconds"] <= 51
    names = [c["name"] for c in SPEC["configs"]] + CELLS + METRICS
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("gpubench/") and (ROOT / c["file"]).is_file()
        assert c["reduced"] == json.loads((ROOT / c["file"]).read_text())["reduced"]
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == {c["name"] for c in SPEC["configs"]}
    pairs = {(w["config"], w["traffic"]) for w in SPEC["workloads"]}
    assert len(pairs) == len(CELLS)
    four = [w for w in SPEC["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(CELLS) // 4)
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and len(w["why"]) <= 200
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e
    for m in SPEC["end_to_end"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert UNIT.match(m["unit"]) and m["moves"] in e2e
        for cell in m["workloads"]:
            moved = next(x for x in SPEC["end_to_end"] if x["name"] == m["moves"])
            assert cell in moved.get("workloads", CELLS)
        if "roofline" in m["name"]:
            assert m["unit"] == "%"


_HALVES = '''"""index: halves, a kind for the test: the corpus in two VerticalBatches,
each searched by batch_knn, merged on the host, ties to the lower id."""

import numpy as np

import innr_tpu_torch as itt
from gpubench.reference import Block


def _halves(cfg, seed, devices, gen):
    n = cfg["rows"]
    return [(s, gen.rows(cfg, seed, s, e, devices[0])) for s, e in ((0, n // 2), (n // 2, n))]


def build(cfg, seed, devices, gen):
    parts = [(s, itt.VerticalBatch(rows)) for s, rows in _halves(cfg, seed, devices, gen)]
    k = cfg["k"]

    def search(qs):
        rs = [(s, itt.batch_knn(qs, vb, k)) for s, vb in parts]
        vals = np.concatenate([np.asarray(r.scores) for _, r in rs], 1)
        ids = np.concatenate([np.asarray(r.indices) + s for s, r in rs], 1)
        best = np.argsort(vals, axis=1, kind="stable")[:, :k]
        return np.take_along_axis(vals, best, 1), np.take_along_axis(ids, best, 1)
    return search


def blocks(cfg, seed, devices, gen):
    return [Block(rows, s) for s, rows in _halves(cfg, seed, devices, gen)]
'''

_HALVES_REFERENCE = '''"""The plain reference of index: halves, the dense one."""

from gpubench.reference import control_topk, exact_topk, true_values  # noqa: F401
'''

_CALLS_LOOP = '''"""loop: calls, a loop for the test: the mix's ``calls`` calls of ``batch``
queries, back to back, whatever the window's length."""

import time
from contextlib import nullcontext

import numpy as np

from gpubench.loops import Window, k1_launches


class Loop:
    def __init__(self, system, traffic, pool, seed, seconds):
        self.system, self.pool = system, pool
        self.calls, self.batch = traffic["calls"], traffic["batch"]

    def warm(self):
        self.system.call(self.pool[:self.batch])

    def run(self, span=nullcontext):
        w = Window()
        self.system.calls.clear()
        before = k1_launches()
        with span():
            w.t0 = time.perf_counter()
            for j in range(self.calls):
                q = (j * self.batch + np.arange(self.batch)) % len(self.pool)
                vals, ids = self.system.call(self.pool[q])
                w.attempted += len(q)
                w.qidx.extend(q)
                w.vals.extend(vals)
                w.ids.extend(ids)
            w.t_end = time.perf_counter()
        w.counters = {"k1_launches": k1_launches() - before}
        return w

    def close(self):
        pass
'''


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "gpubench").rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def _new_root(tmp_path):
    """A checkout with BENCHMARK.json and the harness's files, plus new files
    alone: a configuration and a traffic mix (a plain rate) with a new
    per-layer metric; and a configuration of a new index kind, with its
    container, its reference and a new loop."""
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "gpubench", root / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digests(root)
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((ROOT / "gpubench/configs/deep-100M.json").read_text())
    cfg.update(name="tiny-ip", rows=9_000, dim=48, metric="ip", queries=64, check_queries=64,
               source="https://example.org/tiny")
    (root / "gpubench/configs/tiny-ip.json").write_text(json.dumps(cfg))
    cfg.update(name="tiny-halves", index="halves", metric="l2")
    (root / "gpubench/configs/tiny-halves.json").write_text(json.dumps(cfg))
    traffic = json.loads((ROOT / "gpubench/traffic/deep100m.serve.json").read_text())
    traffic.update(name="tiny.serve", config="tiny-ip", rate_per_s=400.0)
    (root / "gpubench/traffic/tiny.serve.json").write_text(json.dumps(traffic))
    (root / "gpubench/traffic/tiny.halves.json").write_text(json.dumps(
        {"name": "tiny.halves", "config": "tiny-halves", "loop": "calls", "calls": 5,
         "batch": 16, "why": "a test"}))
    (root / "gpubench/metrics/generator.late_p95_ms.py").write_text(
        "import numpy as np\n\n\ndef read(rec):\n"
        "    late = rec.window.lateness_ms\n"
        "    return None if late is None else float(np.percentile(late, 95))\n")
    for folder in ("systems", "references"):
        (root / "gpubench" / folder).mkdir(exist_ok=True)
    (root / "gpubench/systems/halves.py").write_text(_HALVES)
    (root / "gpubench/references/halves.py").write_text(_HALVES_REFERENCE)
    (root / "gpubench/loops/calls.py").write_text(_CALLS_LOOP)
    assert {p: d for p, d in _digests(root).items() if p in before} == before
    for name in ("tiny-ip", "tiny-halves"):
        spec["configs"].append({"name": name, "source": cfg["source"],
                                "file": f"gpubench/configs/{name}.json", "reduced": [],
                                "why": "a test"})
    spec["workloads"] += [{"name": "tiny.serve", "config": "tiny-ip", "traffic": "tiny.serve",
                           "chips": 1, "why": "a test"},
                          {"name": "tiny.halves", "config": "tiny-halves",
                           "traffic": "tiny.halves", "chips": 1, "why": "a test"}]
    for m in spec["end_to_end"]:
        if m["name"].startswith("latency"):
            m["workloads"].append("tiny.serve")
        if m["name"] == "queries_per_s":
            m["workloads"].append("tiny.halves")
    for m in spec["per_layer"]:
        if m["name"] == "serving.latency_p95_ms":
            m["workloads"].append("tiny.serve")
    spec["per_layer"].append({"name": "generator.late_p95_ms", "unit": "ms", "better": "lower",
                              "source": "host_clock", "layer": "benchmark",
                              "moves": "latency_p50_ms", "workloads": ["tiny.serve"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root


def test_new_cell_from_data_files_alone_runs(tmp_path):
    root = _new_root(tmp_path)
    cell = bench.load_cell("tiny.serve", root)
    assert cell.config["metric"] == "ip" and cell.traffic["rate_per_s"] == 400.0
    cpu = [torch.device("cpu")]
    out = run(cell, 7, 0.6, False, cpu)
    assert out["result"]["correct"], out
    assert set(out["result"]["metrics"]) == {"latency_p50_ms", "setup_s"}
    out = run(cell, 8, 0.6, True, cpu)
    assert out["result"]["correct"], out
    late = out["result"]["metrics"]["generator.late_p95_ms"]
    assert late["unit"] == "ms" and np.isfinite(late["value"])
    tail = out["result"]["metrics"]["serving.latency_p95_ms"]
    assert tail["unit"] == "ms" and tail["value"] > 0


def test_new_index_kind_reference_and_loop_from_new_files_run(tmp_path, monkeypatch):
    root = _new_root(tmp_path)
    cell = bench.load_cell("tiny.halves", root)
    assert bench.system("halves", root).__file__ == str(root / "gpubench/systems/halves.py")
    ref = bench.reference("halves", root)
    assert ref.__file__ == str(root / "gpubench/references/halves.py")
    cpu = [torch.device("cpu")]
    out = run(cell, 9, 0.1, False, cpu)
    res = out["result"]
    assert res["correct"] and res["attempted"] == 80 and res["failed"] == 0, out
    assert set(res["metrics"]) == {"queries_per_s", "setup_s"}
    # the new kind's reference is the one that judges: broken, it fails the run
    monkeypatch.setattr(ref, "true_values", lambda blocks, q, ids, metric:
                        torch.zeros(ids.shape, dtype=torch.float64))
    assert not run(cell, 9, 0.1, False, cpu)["result"]["correct"]


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_runs_at_a_tiny_size(name):
    cell = tiny(bench.load_cell(name))
    out = run(cell, 2**31 + 11, 0.5, False, [torch.device("cpu")] * cell.chips)
    res = out["result"]
    assert res["correct"] and res["failed"] == 0 and res["attempted"] > 0, out
    assert set(res["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert list(out["checks"]) == list(cell.config["limits"])
