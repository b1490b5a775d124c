"""The port's serve CLI (``repro_torch.launch.serve``) on the CPU.

``main(argv)`` with ``--device cpu`` at the reduced sizes:

* decode: the in-process run that exports an artifact and the run that
  serves that artifact give byte-identical streams, dense and paged (and
  paged == dense); the sampling flags, ``--n``, ``--stop``, ``--stream``,
  ``--shared-prefix`` with ``--prefix-cache-mb``, ``--prefill-batch``,
  ``--policy-from`` and ``--act-bits`` (retargeting a loaded artifact) run
  through;
* ``--mode encoder`` with each ``--task``, export -> artifact equal;
* every flag of a later slice is refused with an error naming it, and so
  are the flag combinations JAX's CLI refuses;
* ``--device`` defaults to the card and raises on a host without CUDA
  (never a silent CPU fallback).
"""
import json

import numpy as np
import pytest
import torch

from repro_torch.launch import serve

BASE = ["--reduced", "--device", "cpu", "--requests", "5", "--slots", "2"]


def _run(*argv):
    return serve.main([*BASE, *argv])


@pytest.mark.parametrize("paging", ["dense", "paged"])
def test_export_then_artifact_streams_are_byte_identical(tmp_path, paging, capsys):
    art = str(tmp_path / "art")
    built = _run("--kv-bits", "8", "--kv-paging", paging, "--export", art)
    loaded = _run("--artifact", art)
    assert "exported artifact" in capsys.readouterr().out
    assert built["plan"] == loaded["plan"] and "kv_bits=8" in loaded["plan"]
    assert (paging == "paged") == ("kv_paging=paged" in loaded["plan"])
    assert loaded["streams"] == built["streams"]
    assert len(built["streams"]) == 5 and all(len(s) == 8 for s in built["streams"])
    assert set(built["finish_reasons"]) == {"length"}
    if paging == "paged":
        assert built["streams"] == _run("--kv-bits", "8")["streams"]
        assert "kv" in built["metrics"]


def test_generation_flags(capsys):
    res = _run("--kv-bits", "4", "--temperature", "0.8", "--top-k", "20",
               "--top-p", "0.9", "--seed", "3", "--n", "2", "--stream",
               "--shared-prefix", "16", "--prefix-cache-mb", "1",
               "--prefill-batch", "2", "--max-len", "64")
    out = capsys.readouterr().out
    assert len(res["streams"]) == 10 and out.count("[stream] rid=") == 80
    assert res["metrics"]["prefix_lookups"] == 10
    stop = res["streams"][0][2]
    stopped = _run("--kv-bits", "4", "--temperature", "0.8", "--top-k", "20",
                   "--top-p", "0.9", "--seed", "3", "--n", "2",
                   "--shared-prefix", "16", "--prefix-cache-mb", "1",
                   "--prefill-batch", "2", "--max-len", "64", "--stop", str(stop))
    assert stopped["streams"][0] == res["streams"][0][:3]
    assert "stop" in stopped["finish_reasons"]


def test_policy_from_and_act_bits(tmp_path, capsys):
    pol = tmp_path / "search.json"
    pol.write_text(json.dumps({"search": {"chosen_int4_layers": [3]}}))
    art = str(tmp_path / "art")
    res = _run("--policy-from", str(pol), "--export", art, "--requests", "2")
    assert "[0:3) w8/a8, [3:4) w4/a4" in res["plan"]
    assert "policy from" in capsys.readouterr().out
    res8 = _run("--artifact", art, "--act-bits", "8", "--requests", "2")
    assert "[3:4) w4/a8" in res8["plan"]
    assert "retargeted activations to 8-bit" in capsys.readouterr().out
    pol.write_text(json.dumps({"search": {"chosen_int4_layers": [9]}}))
    with pytest.raises(ValueError, match="outside the served"):
        _run("--policy-from", str(pol))


@pytest.mark.parametrize("task", ["classify", "embed", "score"])
def test_encoder_mode(tmp_path, task):
    art = str(tmp_path / "enc")
    built = _run("--mode", "encoder", "--task", task, "--export", art)
    loaded = _run("--mode", "encoder", "--task", task, "--artifact", art)
    assert "mode=encoder" in built["plan"] and loaded["plan"] == built["plan"]
    assert set(built["finish_reasons"]) == {"done"} and len(built["results"]) == 5
    np.testing.assert_array_equal(np.array(loaded["results"]),
                                  np.array(built["results"]))
    width = {"classify": 2, "embed": 96, "score": None}[task]
    assert np.array(built["results"]).shape == ((5,) if width is None else (5, width))


REFUSED = {"tenant": (["--tenant", "a=art_dir"], "item 6"),
           "tp": (["--tp", "2"], "item 6"),
           "replicas": (["--replicas", "2"], "item 6"),
           "warmup": (["--warmup"], "Queue 4 item 1")}


@pytest.mark.parametrize("name", list(REFUSED))
def test_later_slice_flags_are_refused(name, capsys):
    argv, item = REFUSED[name]
    with pytest.raises(SystemExit) as exc:
        _run(*argv)
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert f"--{name} is a later slice of the port" in err and item in err


@pytest.mark.parametrize("argv,match", [
    (["--artifact", "a", "--export", "b"], "cannot be combined"),
    (["--artifact", "a", "--kv-paging", "paged"], "own plan"),
    (["--kv-budget-mb", "1"], "needs --kv-paging paged"),
    (["--n", "0"], "--n must be >= 1"),
    (["--tp", "0"], "--tp must be >= 1"),
], ids=["artifact_export", "artifact_paged", "budget_dense", "n0", "tp0"])
def test_refused_combinations(argv, match, capsys):
    with pytest.raises(SystemExit):
        _run(*argv)
    assert match in capsys.readouterr().err


def test_encoder_mode_needs_an_encoder_artifact(tmp_path, capsys):
    art = str(tmp_path / "dec")
    _run("--export", art, "--requests", "1")
    with pytest.raises(SystemExit):
        _run("--mode", "encoder", "--artifact", art)
    assert "needs a mode='encoder' artifact" in capsys.readouterr().err


def test_device_defaults_to_the_card():
    args = serve.parser().parse_args([])
    assert (args.device, args.backend, args.arch) == ("cuda", "cuda", "stablelm-3b")
    if torch.cuda.is_available():
        return          # the card is there: nothing to refuse
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--reduced", "--requests", "1"])
