"""A mesh across processes: 2 processes x 4 CPU positions over gloo.

The port's counterpart of tests/test_multiproc.py. Two fresh processes run
`python -m cl_ops_tpu_torch.bench.mp_worker` (its list is
tests/mp_worker.py's), each holding four positions of one eight-position
`multiproc.global_mesh(devices=["cpu"] * 4)`. Every collective between
the two halves crosses the process boundary through torch.distributed;
each worker checks its own rows against numpy and prints one JSON line.
Each of its checks is one case here. chip_smoke.py runs the same worker
on the card at 2^24 rows.
"""

import json
import os
import socket
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 8 * 512
WAIT_S = 120
CHECKS = ("all_to_all uneven buckets", "all_gather uint32",
          "ppermute across processes", "dist_scan", "dist_sort",
          "dist_group_aggregate", "dist_hash_join zipf",
          "dist_hash_join_expand", "dist_window_cols", "dist_top_k",
          "dist_distinct")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread per test process (and OMP_NUM_THREADS=1 for the
    workers): the suite runs several processes side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def reports():
    """Both workers' reports; each wait is capped, and a worker still
    running at the cap is killed."""
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "cl_ops_tpu_torch.bench.mp_worker",
         str(rank), "2", str(port), "--devices", "cpu,cpu,cpu,cpu",
         "--rows", str(N)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=REPO) for rank in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=WAIT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    got = []
    for rank, (p, out) in enumerate(zip(procs, outs)):
        lines = [ln for ln in out.splitlines() if ln.startswith("{")]
        assert lines, f"worker {rank} printed no report:\n{out[-4000:]}"
        got.append((p.returncode, json.loads(lines[-1]), out))
    return got


def test_both_workers_exit_zero_on_their_positions(reports):
    for rank, (rc, rep, out) in enumerate(reports):
        assert rc == 0, f"worker {rank}:\n{out[-4000:]}"
        assert rep["positions"] == list(range(4 * rank, 4 * rank + 4))
        assert rep["rows"] == N and set(rep["checks"]) == set(CHECKS)
        # on the CPU every kernel runs its plain version
        assert not any(rep["launches"].values())


@pytest.mark.parametrize("check", CHECKS)
def test_worker_check(reports, check):
    for rank, (_, rep, _) in enumerate(reports):
        assert rep["checks"][check] == "ok", (rank, rep["checks"][check])
