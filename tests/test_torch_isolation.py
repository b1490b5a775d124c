"""The port stands alone: no JAX, no ``repro``, and no silent CPU fallback.

Every Python file under ``src/repro_torch``, ``chip_smoke.py`` and the
port's examples (``examples/torch_*.py``) is parsed and its imports checked
(``repro_torch`` itself is allowed). Entry points default to the card and
raise on a host without CUDA unless the caller passes ``device="cpu"``.
"""
import ast
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = (sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
              + sorted((ROOT / "examples").glob("torch_*.py")))


def _imported_modules(path: Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    return names


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_imports_neither_jax_nor_repro(path):
    for name in _imported_modules(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), f"{path}: imports {name}"


def test_the_scan_sees_the_whole_port_and_catches_imports(tmp_path):
    rel = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for must in ("chip_smoke.py", "src/repro_torch/kernels/ops.py",
                 "src/repro_torch/kernels/decode_attention.py",
                 "src/repro_torch/kernels/flash_attention.py",
                 "src/repro_torch/models/attention.py",
                 "src/repro_torch/models/api.py",
                 "src/repro_torch/serving/engine.py",
                 "src/repro_torch/serving/kv_cache.py",
                 "src/repro_torch/serving/block_pool.py",
                 "src/repro_torch/serving/prefix_cache.py",
                 "src/repro_torch/deploy/artifact.py",
                 "src/repro_torch/serving/loadgen.py",
                 "src/repro_torch/launch/serve.py",
                 "src/repro_torch/benchmarks/table2_speedup.py",
                 "src/repro_torch/benchmarks/serve_latency.py",
                 "src/repro_torch/benchmarks/serve_load.py",
                 "src/repro_torch/core/quantizer.py",
                 "src/repro_torch/core/distill.py",
                 "src/repro_torch/core/autosearch.py",
                 "src/repro_torch/optim/adam.py",
                 "src/repro_torch/optim/schedule.py",
                 "src/repro_torch/data/synthetic.py",
                 "src/repro_torch/checkpoint/manager.py",
                 "src/repro_torch/launch/train.py",
                 "src/repro_torch/benchmarks/common.py",
                 "src/repro_torch/benchmarks/table1_glue.py",
                 "src/repro_torch/benchmarks/table3_ablation.py",
                 "src/repro_torch/serving/replicas.py",
                 "src/repro_torch/serving/tenants.py",
                 "src/repro_torch/distributed/__init__.py",
                 "src/repro_torch/distributed/sharding.py",
                 "src/repro_torch/launch/mesh.py",
                 "src/repro_torch/models/encdec.py",
                 "src/repro_torch/models/mamba2.py",
                 "src/repro_torch/models/hybrid.py",
                 "src/repro_torch/models/xlstm.py",
                 "src/repro_torch/distributed/compression.py",
                 "src/repro_torch/launch/elastic.py",
                 "src/repro_torch/launch/op_analysis.py",
                 "src/repro_torch/launch/dryrun.py",
                 "src/repro_torch/benchmarks/roofline.py",
                 "src/repro_torch/benchmarks/run.py",
                 "src/repro_torch/distributed/collectives.py",
                 "examples/torch_quickstart.py", "examples/torch_serve_int4.py",
                 "examples/torch_serve_sharded.py",
                 "examples/torch_train_qat_distill.py"):
        assert must in rel
    probe = tmp_path / "probe.py"
    probe.write_text("import jax.numpy as jnp\nfrom repro.core import qat\n"
                     "from . import sibling\nimport repro_torch.kernels\n")
    assert _imported_modules(probe) == ["jax.numpy", "repro.core",
                                        "repro_torch.kernels"]


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a host without CUDA")


def _tiny_artifact(tmp_path):
    from repro_torch.core.policy import QuantPolicy
    from repro_torch.deploy import ExecutionPlan, deploy
    from repro_torch.models.bert import init_bert_classifier, tinybert_config
    cfg = tinybert_config(layers=1, d=16, heads=2, d_ff=32, vocab=64)
    plan = ExecutionPlan.build(cfg, QuantPolicy(num_layers=1, mode="int"),
                               backend="cuda", mode="encoder")
    fp = init_bert_classifier(cfg, 2, torch.Generator().manual_seed(0), "cpu")
    model = deploy(fp, plan, device="cpu")
    model.save(str(tmp_path / "art"))
    return fp, plan, str(tmp_path / "art")


def test_load_without_device_raises_without_cuda(no_cuda, tmp_path):
    from repro_torch.deploy import DeployedModel
    _, _, path = _tiny_artifact(tmp_path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DeployedModel.load(path)
    model = DeployedModel.load(path, device="cpu")
    assert model.device.type == "cpu"


def test_deploy_and_params_default_to_the_card(no_cuda, tmp_path):
    from repro_torch.deploy import deploy, params_from_numpy
    fp, plan, _ = _tiny_artifact(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        deploy(fp, plan)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_numpy({"a": np.zeros(2, np.float32)})


def test_decode_entry_points_default_to_the_card(no_cuda):
    from repro_torch.configs import get_config, reduced
    from repro_torch.serving import SlotKVCache
    cfg = reduced(get_config("stablelm-3b"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SlotKVCache(cfg, slots=2, max_len=8, kv_bits=8)
    assert SlotKVCache(cfg, slots=2, max_len=8, kv_bits=8,
                       device="cpu").state["k_q"].device.type == "cpu"


def test_block_pool_defaults_to_the_card(no_cuda):
    from repro_torch.configs import get_config, reduced
    from repro_torch.serving import BlockPool
    cfg = reduced(get_config("stablelm-3b"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BlockPool(cfg, 1 << 20, kv_bits=4)
    pool = BlockPool(cfg, 1 << 20, kv_bits=4, device="cpu")
    assert pool.bufs["k_q"].device.type == "cpu"


def test_tf32_is_off_for_the_fp32_model():
    import repro_torch  # noqa: F401
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_training_entry_points_default_to_the_card(no_cuda, tmp_path):
    from repro_torch.benchmarks import table1_glue, table3_ablation
    from repro_torch.launch import train
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--reduced", "--steps", "1", "--ckpt-dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        table1_glue.run(steps=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        table1_glue.run_artifact(quick=True, artifact_dir=str(tmp_path / "a"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        table1_glue.cli(["--quick"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        table3_ablation.run(steps=1)
    assert not any(tmp_path.iterdir())      # nothing ran before the refusal


def test_token_mode_entry_points_default_to_the_card(no_cuda, tmp_path):
    """The encoder-decoder's extra decode inputs, a hybrid artifact's load
    and the serve CLI on zamba2-2.7b default to the card and raise without
    one; each runs with ``device="cpu"``."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.core.policy import QuantPolicy
    from repro_torch.deploy import DeployedModel, ExecutionPlan, deploy
    from repro_torch.launch import serve
    from repro_torch.models import api
    cfg = reduced(get_config("seamless-m4t-medium"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.decode_extra_inputs(cfg, 2, 8)
    assert api.decode_extra_inputs(cfg, 2, 8, device="cpu")["enc_out"].device.type == "cpu"
    hcfg = reduced(get_config("zamba2-2.7b"))
    plan = ExecutionPlan.build(hcfg, QuantPolicy(num_layers=4, mode="int"), backend="cuda")
    fp = api.init_model(hcfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        deploy(fp, plan)
    deploy(fp, plan, device="cpu").save(str(tmp_path / "h"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeployedModel.load(str(tmp_path / "h"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "zamba2-2.7b", "--reduced"])


def test_xlstm_and_elastic_entry_points_default_to_the_card(no_cuda, tmp_path):
    """The serve and train CLIs on xlstm-1.3b and ``elastic_resume``
    default to the card and raise without one, before anything is written;
    each runs with the CPU asked for."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.launch import elastic, serve, train
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "xlstm-1.3b", "--reduced"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--arch", "xlstm-1.3b", "--reduced", "--steps", "1",
                    "--ckpt-dir", str(tmp_path / "ckpt")])
    assert not any(tmp_path.iterdir())
    mgr = CheckpointManager(str(tmp_path / "mgr"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        elastic.elastic_resume({"w": torch.zeros(2)}, mgr)
    out = serve.main(["--arch", "xlstm-1.3b", "--reduced", "--device", "cpu",
                      "--requests", "2", "--max-len", "16"])
    assert out is not None
    mgr.save(1, {"w": torch.ones(2)})
    state, step, _ = elastic.elastic_resume({"w": torch.zeros(2)}, mgr, device="cpu")
    assert step == 1 and torch.equal(state["w"], torch.ones(2))


def test_dryrun_and_op_analysis_take_meta_explicitly(no_cuda, capsys):
    """The analysis runs on the meta device and says so: ``analyze``
    refuses a step on CPU tensors (it would compute), a dry-run cell's
    arguments are all meta tensors, and the section runner's device
    sections default to the card (they fail without one) while the
    roofline section needs none."""
    from repro_torch.configs import ShapeSpec, get_config, reduced
    from repro_torch.core.policy import QuantPolicy
    from repro_torch.core.tree import tree_leaves_with_path
    from repro_torch.benchmarks import run
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.op_analysis import analyze
    with pytest.raises(ValueError, match="meta device"):
        analyze(lambda x: x + 1, torch.zeros(2))
    cfg = reduced(get_config("stablelm-3b"))
    step, args, nbytes = dryrun._serve_cell(
        cfg, ShapeSpec("d", 16, 2, "decode"), make_production_mesh(serving=True),
        policy=QuantPolicy(num_layers=4, mode="int", last_k_int4=2), extra={})
    leaves = [v for _, v in tree_leaves_with_path(list(args)) if isinstance(v, torch.Tensor)]
    assert leaves and all(t.is_meta for t in leaves) and nbytes > 0
    assert analyze(step, *args)["launches"]["int8_matmul"] == 14
    assert run.main(["--quick", "--only", "table2"]) == 1
    assert "no CUDA device" in capsys.readouterr().err


def _tp_noop():
    return None


def test_rank_spawners_default_to_the_card(no_cuda):
    """``spawn_tp`` and ``spawn_ranks`` run NCCL ranks on the cards unless
    the caller asks for the CPU: without a device they raise on a host
    with no CUDA, before any process starts."""
    from repro_torch.launch.mesh import spawn_ranks, spawn_tp
    with pytest.raises(RuntimeError, match="needs 2 devices, host has 0"):
        spawn_tp(_tp_noop, 2)
    with pytest.raises(RuntimeError, match="needs 4 devices, host has 0"):
        spawn_ranks(_tp_noop, 2, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        spawn_ranks(_tp_noop, 1, 2, backend="gloo")


@pytest.mark.parametrize("name", ["torch_quickstart", "torch_serve_int4",
                                  "torch_serve_sharded", "torch_train_qat_distill"])
def test_examples_default_to_the_card(no_cuda, name, monkeypatch):
    import importlib
    monkeypatch.syspath_prepend(str(ROOT / "examples"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        importlib.import_module(name).main(["--quick"])
