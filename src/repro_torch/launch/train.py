"""Training launcher with checkpoints and resume (the port of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b --steps 40 \\
        --smoke --fail-at 20 --device cpu   # a crash at step 20; rerun without --fail-at

Runs real steps of the port's train step (on the card by default: its
attention's and SSD scan's forwards and backwards are the hand-written
kernels, whose launches it prints at its end, or before a simulated crash;
``--arch mamba2-370m`` or ``zamba2-1.2b`` trains the ssm and hybrid
families) and shows
the fault-tolerance loop: an asynchronous checkpoint every ``--ckpt-every``
steps, a simulated crash at ``--fail-at`` (exit status 1), and a rerun
without ``--fail-at`` that resumes from the latest checkpoint and follows
the uninterrupted run bit for bit (the data is a pure function of the
step). The int8 compression's error feedback is not checkpointed, as in
JAX, so a resumed ``--compress-grads`` run restarts it from zero.

A checkpoint's label is the number of steps it holds (the optimizer's
``step``), and a resume starts at that step: the checkpoint written after
step s is labelled s + 1, and the final one ``--steps``, so a rerun with a
larger ``--steps`` goes on where the last run ended (under the schedule
of the new ``--steps``, whose cosine decay after the warmup depends on
it, as in JAX). Two departures from
the JAX launcher: it labels its periodic checkpoints s (the state after
step s) and so applies step s twice on a resume, where its final save is
labelled as here; and a simulated crash here first waits for the
checkpoint being written, so that the rerun finds it. ``--smoke``
is the reduced config with vocab 512; a model without RoPE gets a position
table of ``seq + 8`` rows.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from typing import Optional, Sequence

import torch

from repro_torch import bridge
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs import get_config
from repro_torch.kernels import attn_bwd, ssd_scan, verify_attn
from repro_torch.models.model_zoo import build_model
from repro_torch.runtime import resolve_device
from repro_torch.training.data import DataConfig, batch_at
from repro_torch.training.optimizer import AdamWConfig, adamw_init
from repro_torch.training.train_step import TrainConfig, make_train_step


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", type=str, default="qwen2-1.5b")
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--ckpt-dir", type=str, default=None)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--fail-at", type=int, default=None,
                    help="inject a crash at this step (fault-tolerance demo)")
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    return ap.parse_args(argv)


def _on(batch: dict, device: torch.device) -> dict:
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def _launches() -> dict:
    """This process's launches of the attention and SSD kernels, by kernel
    (those launched at least once)."""
    launches = {**verify_attn.LAUNCHES, **attn_bwd.LAUNCHES, **ssd_scan.LAUNCHES}
    return {k: n for k, n in launches.items() if n}


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = dataclasses.replace(cfg.reduced(), vocab_size=512)
    model = build_model(cfg)
    ckpt_dir = args.ckpt_dir or f"experiments/train_torch_{cfg.name}"

    tcfg = TrainConfig(
        optimizer=AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=args.steps),
        remat=True, loss_chunk=64, attn_chunk=64,
        grad_accum=args.grad_accum, compress_grads=args.compress_grads,
    )
    step_fn = make_train_step(model, tcfg)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq + 1, global_batch=args.batch)

    kw = {"max_pos": args.seq + 8} if not cfg.use_rope else {}
    params = model.init_params(torch.Generator(device=device).manual_seed(0), **kw)
    opt = adamw_init(bridge.params_tree(params))
    start = ckpt.latest_step(ckpt_dir)
    if start is not None:
        state, _ = ckpt.restore(ckpt_dir, {"params": bridge.params_tree(params), "opt": opt},
                                device=device)
        bridge.load_params_(params, state["params"])
        opt = state["opt"]
        print(f"[resume] restored step {start} from {ckpt_dir}", flush=True)
    else:
        start = 0

    err, pending, metrics = None, None, None
    for s in range(start, args.steps):
        if args.fail_at is not None and s == args.fail_at:
            if pending is not None:
                pending.join()
            print(f"crashed. launches {json.dumps(_launches())}", flush=True)
            raise SystemExit(f"[fault-injection] simulated node failure at step {s} "
                             f"— rerun the command without --fail-at to resume")
        batch = _on(batch_at(dcfg, s, cfg), device)
        params, opt, err, metrics = step_fn(params, opt, err, batch)
        if s % 5 == 0 or s == args.steps - 1:
            print(f"step {s:4d} loss {float(metrics['loss']):.4f} "
                  f"gnorm {float(metrics['grad_norm']):.2f}", flush=True)
        if s and s % args.ckpt_every == 0:
            if pending is not None:
                pending.join()
            pending = ckpt.save(ckpt_dir, s + 1,
                                {"params": bridge.params_tree(params), "opt": opt},
                                async_save=True)
    if pending is not None:
        pending.join()
    if metrics is not None:  # a rerun past --steps trains nothing and relabels nothing
        ckpt.save(ckpt_dir, args.steps, {"params": bridge.params_tree(params), "opt": opt})
    last = f" last loss {float(metrics['loss'])!r}" if metrics is not None else ""
    print(f"done.{last} launches {json.dumps(_launches())}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
