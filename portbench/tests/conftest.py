"""Shared fixtures of the benchmark's CPU tests: small scales of each
configuration, and one torch thread (several test workers share the
cores)."""

import pytest
import torch

# Scales at which every query keeps rows on the CPU: SSB at 1/1000 holds
# 40 suppliers, 1,000 parts and 120,000 lineorders; TPC-H at 1/1000 holds
# 15,000 orders and 60,000 lines.
SCALE = {"tpch_sf10": 1e-3, "ssb_sf20": 1e-3}
# Q18's validation QUANTITY (300) qualifies no order at 15,000 orders;
# 200 qualifies a few hundred.
SMALL_PARAMS = {"tpch_q18": {"quantity": 200}}
SEEDS = (1, 2, 2 ** 31 + 5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture
def small_mix(monkeypatch):
    """The harness's mixes with SMALL_PARAMS in place of the parameters."""
    from portbench import run
    orig = run.mix

    def mix(config_name, traffic):
        m = orig(config_name, traffic)
        for q in m["queries"]:
            q["params"] = SMALL_PARAMS.get(q["query"], q.get("params", {}))
        return m
    monkeypatch.setattr(run, "mix", mix)
