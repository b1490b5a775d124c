"""The four ``examples/torch_*.py`` (the JAX package's ``examples/*.py``
driving ``repro_torch``) with ``--quick`` on the CPU: each runs its own
asserts (fake-vs-int parity, artifact streams byte-identical, tp=2 and
replica streams equal to one engine's, finite losses) and returns what it
printed. On the card, ``chip_smoke.py`` phase 26 runs them at their
default device.
"""
import importlib
from pathlib import Path

import numpy as np
import pytest
import torch

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _example(name, monkeypatch):
    # on sys.path, so that the ranks an example spawns import it by name
    monkeypatch.syspath_prepend(str(EXAMPLES))
    return importlib.import_module(name)


def test_quickstart(monkeypatch):
    out = _example("torch_quickstart", monkeypatch).main(["--quick", "--device", "cpu"])
    assert len(out["losses"]) == 6 and np.all(np.isfinite(out["losses"]))
    assert out["parity_rel"] < 1e-4 and len(out["greedy"]) == 12


def test_serve_int4(monkeypatch):
    out = _example("torch_serve_int4", monkeypatch).main(["--quick", "--device", "cpu"])
    assert len(out["streams"]) == 4 and all(len(s) == 8 for s in out["streams"].values())
    assert len(out["sampled"]) == 8


def test_serve_sharded(monkeypatch):
    out = _example("torch_serve_sharded", monkeypatch).main(["--quick", "--device", "cpu"])
    assert out["tp"][2] == out["tp"]["1_reloaded"] == out["replicas"] == out["ref"]


def test_train_qat_distill(monkeypatch):
    out = _example("torch_train_qat_distill", monkeypatch).main(["--quick", "--device", "cpu"])
    assert set(out["student"]) == {"loss/train", "loss/output", "loss/attention",
                                   "loss/value", "loss/total"}
    assert out["student"]["loss/attention"] > 0
