"""QAT-train an LM with the full MKQ recipe (MSE-based LSQ + MINI
distillation from a deeper fp teacher) on the PyTorch / CUDA port, with
fault-tolerant checkpointing, as ``examples/train_qat_distill.py`` does on
the JAX package. ``--scale small`` (the default) is CPU-sized; ``--scale
100m`` is a ~100M-parameter student for the card; the code path is the
same.

Run:  PYTHONPATH=src python examples/torch_train_qat_distill.py --steps 200
      [--quick] [--device cpu]
"""
import argparse
import itertools
import math
import os
import tempfile

from repro_torch.configs import TrainHParams, get_config, reduced
from repro_torch.core.policy import QuantPolicy
from repro_torch.data import SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.launch.train import run_training


def configs(scale: str):
    base = get_config("stablelm-3b")
    if scale == "100m":
        student = base.replace(num_layers=12, d_model=768, num_heads=12,
                               num_kv_heads=12, d_ff=2048, vocab_size=32000,
                               dtype="float32", remat=False)
        teacher = student.replace(num_layers=16, d_model=1024, num_heads=16,
                                  num_kv_heads=16, d_ff=2816)
    else:
        student = reduced(base)
        teacher = student.replace(num_layers=6, d_model=96, num_heads=6,
                                  num_kv_heads=6, d_ff=192, head_dim=16)
    return student, teacher


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--scale", default="small", choices=["small", "100m"])
    p.add_argument("--grad-mode", default="mse", choices=["mse", "ste"])
    p.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                      "repro_torch_qat_distill"))
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=64)
    p.add_argument("--quick", action="store_true",
                   help="smoke mode: 4 steps each, a fresh checkpoint directory")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    if args.quick:      # 4 steps each, checkpoints in a directory of its own
        with tempfile.TemporaryDirectory(prefix="repro_torch_qat_distill_") as d:
            return _train(args, dev, 4, 4, os.path.join(d, "ckpt"))
    return _train(args, dev, args.steps, max(50, args.steps // 4), args.ckpt_dir)


def _train(args, dev, steps: int, teacher_steps: int, ckpt_dir: str) -> dict:
    cfg, tcfg = configs(args.scale)
    n = cfg.num_layers
    policy = QuantPolicy(num_layers=n, mode="fake", last_k_int4=n // 2,
                         grad_mode=args.grad_mode)
    hp = TrainHParams(total_steps=steps, lr_weights=5e-4, alpha=10.0, beta=1.0)
    stream = SyntheticLM(cfg.vocab_size, args.seq, args.batch)
    data = lambda step0: map(stream.batch, itertools.count(step0))   # resumable

    # fp teacher: a few warm-up steps on the same stream (it stands in for a
    # pretrained checkpoint: nothing is downloaded)
    print(f"[example] training the fp teacher briefly on {dev}...")
    tstate, tmetrics = run_training(
        tcfg, QuantPolicy(num_layers=tcfg.num_layers, mode="none"),
        TrainHParams(total_steps=teacher_steps, lr_weights=1e-3), data,
        ckpt_dir=ckpt_dir + "_teacher", ckpt_every=0, log_every=25, device=dev)

    print(f"[example] QAT ({args.grad_mode}) + MINI distillation...")
    state, metrics = run_training(
        cfg, policy, hp, data, ckpt_dir=ckpt_dir, ckpt_every=50,
        distill_teacher=tstate["params"], teacher_cfg=tcfg, log_every=20, device=dev)
    print("[example] final metrics:", metrics)
    assert all(math.isfinite(v) for v in (*metrics.values(), *tmetrics.values())), metrics
    assert int(state["opt"].step) == steps
    return {"teacher": tmetrics, "student": metrics}


if __name__ == "__main__":
    main()
