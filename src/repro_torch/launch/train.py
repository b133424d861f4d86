"""LM training driver, the port's counterpart of ``repro.launch.train``.

    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch qwen1.5-0.5b --preset 10m --steps 200 --batch 8 --seq 128 \
        --ckpt-dir ckpt/run1 [--compress-grads] [--fail-at 60] \
        [--device cpu]

Composes the runtime: the deterministic synthetic data pipeline
(``repro_torch.data``), Adam, checkpoint/restart supervision
(``TrainSupervisor``), straggler monitoring and optional int8
error-feedback gradient compression.  ``--fail-at`` injects a
``WorkerFailure`` to show recovery end to end.  It runs on CUDA unless
``--device cpu`` (and raises without a card).  ``PRESETS`` are the
host-runnable scales on top of ``reduced_config``, which the serve CLI's
``--preset`` names too.
"""
from __future__ import annotations

import argparse
import logging
import os
import tempfile
import time

import torch

from repro_torch.configs import get_config, list_archs
from repro_torch.core.shufflesoftsort import resolve_device
from repro_torch.data.synthetic import synthetic_batch
from repro_torch.launch.steps import model_params, value_and_grad
from repro_torch.models import init_model, param_count, reduced_config
from repro_torch.optim.adam import adam_init, adam_update, clip_by_global_norm
from repro_torch.runtime.checkpoint import CheckpointManager
from repro_torch.runtime.compression import (compress_gradients,
                                             init_compression)
from repro_torch.runtime.fault_tolerance import TrainSupervisor, WorkerFailure
from repro_torch.runtime.straggler import StragglerMonitor

PRESETS = {
    # name: overrides on top of reduced_config for host-runnable scales
    "tiny": dict(d_model=64, num_layers=2, d_ff=128, vocab_size=512),
    "10m": dict(d_model=256, num_layers=6, d_ff=1024, vocab_size=8192,
                num_heads=8, num_kv_heads=8, head_dim=32),
    "100m": dict(d_model=768, num_layers=12, d_ff=3072, vocab_size=32768,
                 num_heads=12, num_kv_heads=12, head_dim=64),
}


def build(arch: str, preset: str, lr: float, compress: bool, device=None):
    """(cfg, state, step) at ``preset``: random weights from seed 0 on
    ``device`` (CUDA unless told otherwise), Adam, and, with
    ``compress``, the compression residuals under ``state["comp"]``."""
    device = resolve_device(device)
    cfg = reduced_config(get_config(arch), **PRESETS[preset])
    params = model_params(init_model(cfg, device, seed=0))
    state = {"params": params, "opt": adam_init(params)}
    if compress:
        state["comp"] = init_compression(params)
    vg = value_and_grad(cfg)

    def step(state, batch):
        (loss, metrics), grads = vg(state["params"], batch)
        grads, gnorm = clip_by_global_norm(grads, 1.0)
        new_state = dict(state)
        if "comp" in state:
            grads, new_state["comp"], _ = compress_gradients(
                grads, state["comp"])
        new_state["params"], new_state["opt"] = adam_update(
            grads, state["opt"], state["params"], lr=lr, b1=0.9, b2=0.95)
        return new_state, dict(metrics, loss=loss, grad_norm=gnorm)

    return cfg, state, step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list_archs(), default="qwen1.5-0.5b")
    ap.add_argument("--preset", choices=PRESETS, default="10m")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "repro_train"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--fail-at", type=int, default=0,
                    help="inject a worker failure at this step (demo)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA; 'cpu' on a host "
                         "without a card)")
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    device = resolve_device(args.device)
    cfg, state, base_step = build(args.arch, args.preset, args.lr,
                                  args.compress_grads, device)
    print(f"arch={args.arch} preset={args.preset} "
          f"params={param_count(state['params']):,}")

    fail = {"armed": args.fail_at > 0}

    def step_fn(state, batch):
        if fail["armed"] and int(batch["step"]) == args.fail_at:
            fail["armed"] = False
            raise WorkerFailure(f"injected failure at step {args.fail_at}")
        return base_step(state, {k: v for k, v in batch.items()
                                 if k != "step"})

    def data_fn(step):
        b = synthetic_batch(cfg, args.batch, args.seq, step, device=device)
        b["step"] = step
        return b

    mgr = CheckpointManager(args.ckpt_dir, keep=3)
    mon = StragglerMonitor()
    sup = TrainSupervisor(step_fn, data_fn, mgr,
                          checkpoint_every=args.ckpt_every, straggler=mon)

    t0 = time.time()
    state, step = sup.run(state, 0, args.steps)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.time() - t0

    losses = [h["metrics"]["loss"] for h in sup.history if "metrics" in h]
    print(f"done: {step} steps in {dt:.1f}s "
          f"({dt / max(len(losses), 1):.2f}s/step), "
          f"loss {losses[0]:.3f} -> {losses[-1]:.3f}, "
          f"restarts={sup.restarts}, stragglers={len(mon.flagged)}")
    return {"first_loss": losses[0], "last_loss": losses[-1],
            "restarts": sup.restarts, "steps": step}


if __name__ == "__main__":
    main()
