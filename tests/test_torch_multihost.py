"""innr_tpu_torch.parallel.multihost against innr_tpu.parallel.multihost.

Two processes on gloo (a ``file://`` rendezvous in the test's temporary
directory: no TCP port, safe under xdist), each holding its own block of
the corpus sharded over four CPU entries, must return the one-process
scan's answer on every rank: indices equal, scores bit for bit on
integer-valued rows, where ties across the processes go to the lowest
global index. The workers talk over loopback (``GLOO_SOCKET_IFNAME=lo``:
gloo otherwise picks its interface from the host name, which need not be
reachable where the tests run) and use one intra-op thread each (the test
runs beside other pytest workers). Each prints the step it starts; a worker
that hangs dumps its stack and exits at its own limit, below the test's,
and a failure shows both workers' output, so it names the step (the
rendezvous, a search, the save) or the result key that differed. The
in-process arms (argument and environment parsing, the no-op cases, the
contracts) run without a group.
"""

import os
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import innr_tpu.parallel as jp  # noqa: E402
import innr_tpu_torch as tt  # noqa: E402
import innr_tpu_torch.parallel as tp  # noqa: E402
from innr_tpu_torch import config  # noqa: E402
from innr_tpu_torch.parallel import multihost  # noqa: E402

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _cpu_default_device():
    """Host data goes to the card by default; these tests ask for the CPU."""
    previous = config.set_default_device("cpu")
    yield
    config.set_default_device(previous)


def corpus(seed=0):
    rng = np.random.default_rng(seed)
    rows = rng.integers(-3, 4, (130, 16)).astype(np.float32)
    rows[[7, 70, 129]] = 5.0  # ties across both processes' blocks
    return rows, rng.integers(-3, 4, (4, 16)).astype(np.float32)


# A worker dumps its stack and exits after this many seconds; the test
# waits a little longer for both.
WORKER_LIMIT_S = 240
TEST_LIMIT_S = WORKER_LIMIT_S + 60

WORKER = textwrap.dedent(
    """
    import faulthandler
    import sys
    faulthandler.dump_traceback_later(int(sys.argv[4]), exit=True)

    def step(name):
        print("step", name, flush=True)

    step("import")
    import numpy as np
    import torch
    torch.set_num_threads(1)
    from innr_tpu_torch import config
    config.set_default_device("cpu")
    from innr_tpu_torch.parallel import default_mesh, multihost

    pid, rdv = int(sys.argv[1]), sys.argv[2]
    data = np.load(sys.argv[3])
    rows, qs = data["rows"], data["qs"]
    step("rendezvous")
    multihost.initialize(f"file://{rdv}", 2, pid)
    assert multihost.is_multiprocess()
    step("corpus")
    local = rows[:70] if pid == 0 else rows[70:]  # unequal blocks
    c = multihost.corpus_from_process_local_rows(local, n_total=130,
                                                 mesh=default_mesh(["cpu"] * 4))
    assert c.num_vectors == 130 and c.memory_bytes() == local.nbytes
    out = {}
    for name in ("knn_dot", "knn_l2", "knn_cosine"):
        for k in (1, 9, 130):
            step(f"search {name}{k}")
            v, i = getattr(c, name)(qs, k)
            out[f"{name}{k}"] = (v.numpy(), i.numpy())
    step("search filtered")
    mask = np.arange(130) % 3 == 0
    v, i = c.knn_filtered(qs, 12, mask)
    out["filtered"] = (v.numpy(), i.numpy())
    step("search prune")
    v, i = c.knn_dot(qs[0], 5, prune=True)
    out["prune"] = (v.numpy(), i.numpy())
    step("save")
    np.save(f"{rdv}.{pid}.npy", np.array(out, dtype=object), allow_pickle=True)
    print("WORKER OK", pid, flush=True)
    """
)


def _run_workers(rdv, data):
    """Both workers' (return code, output); a worker still running at the
    test's limit is killed and reported with its output so far."""
    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo", OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(pid), str(rdv), str(data), str(WORKER_LIMIT_S)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for pid in (0, 1)]
    deadline = time.monotonic() + TEST_LIMIT_S
    results = []
    for p in procs:
        try:
            out = p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0]
        except subprocess.TimeoutExpired:
            p.kill()
            out = p.communicate()[0] + f"\n[killed after {TEST_LIMIT_S} s]"
        results.append((p.returncode, out))
    return results


def test_two_gloo_processes_equal_one_process(tmp_path):
    rdv = tmp_path / "rdv"
    rows, qs = corpus()
    np.savez(tmp_path / "data.npz", rows=rows, qs=qs)
    results = _run_workers(rdv, tmp_path / "data.npz")
    if any(rc != 0 for rc, _ in results):
        pytest.fail("a gloo worker failed; the last step it printed is where:\n" + "\n".join(
            f"--- rank {pid}, return code {rc}:\n{out[-3000:]}"
            for pid, (rc, out) in enumerate(results)))
    one = tp.ShardedCorpus(rows, tp.default_mesh(["cpu"] * 8))
    want = {f"{n}{k}": getattr(one, n)(qs, k) for n in ("knn_dot", "knn_l2", "knn_cosine")
            for k in (1, 9, 130)}
    want["filtered"] = one.knn_filtered(qs, 12, np.arange(130) % 3 == 0)
    want["prune"] = one.knn_dot(qs[0], 5, prune=True)
    for pid in (0, 1):
        got = np.load(f"{rdv}.{pid}.npy", allow_pickle=True).item()
        for key, (v, i) in want.items():
            np.testing.assert_array_equal(got[key][1], i.numpy(), err_msg=f"{key} rank {pid}")
            np.testing.assert_array_equal(got[key][0].view(np.int32),
                                          v.numpy().view(np.int32), err_msg=f"{key} rank {pid}")
    jv, ji = jp.ShardedCorpus(rows).knn_l2(qs, 9)
    np.testing.assert_array_equal(got["knn_l29"][1], np.asarray(ji))


class TestSingleProcessArms:
    def test_initialize_is_a_noop_without_configuration(self, monkeypatch):
        for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
            monkeypatch.delenv(var, raising=False)
        monkeypatch.setattr(multihost.dist, "init_process_group",
                            lambda *a, **kw: pytest.fail("must not start a group"))
        multihost.initialize()
        assert not multihost.is_multiprocess()

    def test_initialize_is_a_noop_when_a_group_is_up(self, monkeypatch):
        monkeypatch.setattr(multihost.dist, "is_initialized", lambda: True)
        monkeypatch.setattr(multihost.dist, "init_process_group",
                            lambda *a, **kw: pytest.fail("must not start a second group"))
        multihost.initialize("localhost:1234", 2, 0)

    def test_arguments_and_environment(self, monkeypatch):
        calls = []
        monkeypatch.setattr(multihost.dist, "init_process_group",
                            lambda *a, **kw: calls.append((a, kw)))
        for var in ("MASTER_ADDR", "WORLD_SIZE", "RANK"):
            monkeypatch.delenv(var, raising=False)
        multihost.initialize("localhost:2345", 4, 3)
        assert calls[-1] == (("gloo",), {"init_method": "tcp://localhost:2345",
                                         "world_size": 4, "rank": 3})
        monkeypatch.setenv("MASTER_ADDR", "localhost")
        monkeypatch.setenv("MASTER_PORT", "29500")
        monkeypatch.setenv("WORLD_SIZE", "2")
        monkeypatch.setenv("RANK", "1")
        multihost.initialize()
        assert calls[-1] == (("gloo",), {"init_method": "env://", "world_size": 2,
                                         "rank": 1})
        monkeypatch.delenv("RANK")
        with pytest.raises(tt.ContractError):
            multihost.initialize()

    def test_the_card_takes_nccl_and_never_gloo(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        monkeypatch.setattr(multihost.dist, "init_process_group",
                            lambda *a, **kw: pytest.fail("no group without a card"))
        config.set_default_device("cuda")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            multihost.initialize("localhost:1234", 2, 0)

    def test_one_process_defaults_and_contracts(self):
        rows, qs = corpus(1)
        c = multihost.corpus_from_process_local_rows(rows, mesh=tp.default_mesh(["cpu"] * 8))
        assert c.num_vectors == 130
        v, i = c.knn_dot(qs, 6)
        want = tt.batch_knn_dot(qs, tt.VerticalBatch(rows), 6)
        np.testing.assert_array_equal(i.numpy(), want.indices)
        np.testing.assert_array_equal(v.numpy().view(np.int32), want.scores.view(np.int32))
        with pytest.raises(tt.ContractError):
            multihost.corpus_from_process_local_rows(np.zeros(8, np.float32))
        with pytest.raises(tt.ContractError):
            multihost.corpus_from_process_local_rows(rows, n_total=131)
