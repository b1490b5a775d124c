"""The port stands alone: no JAX, no ``repro``, and no silent CPU fallback.

Every Python file under ``src/repro_torch`` and ``chip_smoke.py`` is parsed
and its imports checked (``repro_torch`` itself is allowed). Entry points
default to the card and raise on a host without CUDA unless the caller
passes ``device="cpu"``.
"""
import ast
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


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
                 "src/repro_torch/benchmarks/table3_ablation.py"):
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
