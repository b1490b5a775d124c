"""The port's serve CLI (``repro_torch.launch.serve``) on the CPU.

``main(argv)`` with ``--device cpu`` at the reduced sizes:

* decode: the in-process run that exports an artifact and the run that
  serves that artifact give byte-identical streams, dense and paged (and
  paged == dense); the sampling flags, ``--n``, ``--stop``, ``--stream``,
  ``--shared-prefix`` with ``--prefix-cache-mb``, ``--prefill-batch``,
  ``--policy-from`` and ``--act-bits`` (retargeting a loaded artifact) run
  through;
* ``--mode encoder`` with each ``--task``, export -> artifact equal;
* the fleet flags run: ``--replicas 2`` (streams byte-identical to one
  engine), two ``--tenant``s (an encoder and a decoder artifact in one
  multi-tenant engine) and ``--tp 2`` on two gloo ranks (streams
  byte-identical to tp=1); ``--warmup`` is still refused with an error
  naming what it waits for, and so are the flag combinations JAX's CLI
  refuses;
* ``--device`` defaults to the card and raises on a host without CUDA
  (never a silent CPU fallback).
"""
import json

import numpy as np
import pytest
import torch

from repro_torch.launch import serve


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """One intra-op thread while this module runs: its ops are small, and
    at one thread a test worker does not contend with the suite's others
    for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

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


@pytest.mark.parametrize("paging", ["dense", "paged"])
def test_moe_arch_serves(tmp_path, paging):
    """``--arch granite-moe-3b-a800m --reduced``: built in process, exported
    and served from the artifact with byte-identical streams."""
    art = str(tmp_path / "art")
    built = _run("--arch", "granite-moe-3b-a800m", "--kv-bits", "8",
                 "--kv-paging", paging, "--export", art)
    assert "granite-moe-3b-a800m" in built["plan"] and "[2:4) w4/a4" in built["plan"]
    assert len(built["streams"]) == 5 and all(len(s) == 8 for s in built["streams"])
    assert _run("--artifact", art)["streams"] == built["streams"]


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


@pytest.mark.parametrize("name", ["tenant", "tp", "replicas", "warmup"])
def test_later_slice_flags_are_refused(name, tmp_path, capsys):
    """The flags that waited for a later slice: ``--tenant``, ``--tp`` and
    ``--replicas`` arrived with the device-layout-and-fleet slice and now
    run (each against what it must equal); ``--warmup`` still waits, and
    its refusal names what for."""
    if name == "warmup":
        with pytest.raises(SystemExit) as exc:
            _run("--warmup")
        assert exc.value.code == 2
        err = capsys.readouterr().err
        assert "--warmup is a later slice of the port" in err and "Queue 4 item 1" in err
        return
    if name == "replicas":
        one = _run("--kv-bits", "8", "--requests", "3")
        two = _run("--kv-bits", "8", "--requests", "3", "--replicas", "2")
        assert "replica set: 2 engines" in capsys.readouterr().out
        assert two["streams"] == one["streams"] and len(two["streams"]) == 3
        return
    if name == "tp":
        base = ["--backend", "reference", "--kv-bits", "8", "--kv-paging", "paged",
                "--requests", "3"]
        one = _run(*base)
        two = _run(*base, "--tp", "2")
        assert "tp=2, " in two["plan"] and "tp=" not in one["plan"]
        assert two["streams"] == one["streams"] and len(two["streams"]) == 3
        return
    enc, dec = str(tmp_path / "enc"), str(tmp_path / "dec")
    _run("--mode", "encoder", "--export", enc, "--requests", "1")
    _run("--kv-bits", "8", "--export", dec, "--requests", "1")
    res = _run("--tenant", f"cls={enc}", "--tenant", f"gen={dec}")
    out = capsys.readouterr().out
    assert "tenant 'cls'" in out and "tenant 'gen'" in out and "multi-tenant burst" in out
    assert res["tenants"] == ["cls", "gen", "cls", "gen", "cls"]
    assert res["finish_reasons"] == ["done", "length", "done", "length", "done"]
    assert [len(o) for o in res["outputs"]] == [2, 8, 2, 8, 2]
    by = res["metrics"]["by_label"]
    assert by["cls/encode"]["tokens"] > 0 and by["gen/decode"]["tokens"] > 0


@pytest.mark.parametrize("argv,match", [
    (["--artifact", "a", "--export", "b"], "cannot be combined"),
    (["--artifact", "a", "--kv-paging", "paged"], "own plan"),
    (["--kv-budget-mb", "1"], "needs --kv-paging paged"),
    (["--n", "0"], "--n must be >= 1"),
    (["--tp", "0"], "--tp must be >= 1"),
    (["--replicas", "0"], "--replicas must be >= 1"),
    (["--tenant", "a=x", "--tp", "2"], "--tp/--replicas apply to single-model"),
    (["--tenant", "a=x", "--replicas", "2"], "--tp/--replicas apply to single-model"),
    (["--tenant", "a=x", "--export", "y"], "cannot be combined with --artifact/--export"),
    (["--tp", "2"], "pass --backend reference"),
], ids=["artifact_export", "artifact_paged", "budget_dense", "n0", "tp0", "replicas0",
        "tenant_tp", "tenant_replicas", "tenant_export", "tp_kernels"])
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
