"""Training launcher with ABA data batching + fault tolerance.

Counterpart of ``repro/launch/train.py``, with its flags and one more,
``--device`` (default ``cuda``; ``cpu`` runs the plain path):

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
        --reduced --steps 200 --batch 8 --seq 128 --aba-batching \\
        --ckpt-dir /tmp/ckpt --device cpu

Fault tolerance model:
  * checkpoint every --ckpt-every steps, atomic rename, retention=3
    (``train.checkpoint``, the reference's on-disk format);
  * SIGTERM/SIGINT (preemption) -> synchronous checkpoint, clean exit;
  * on start, auto-restore the newest checkpoint (params + opt + step);
  * the ABA batch schedule is DETERMINISTIC given (dataset, batch size,
    seed): after restore, the step counter alone reproduces the exact
    mini-batch sequence -- no data-loader state to persist.  Batches come
    from ``repro_torch.train.pipeline.ABAPipeline``'s epoch iterator; with
    ``--refresh-features`` each next epoch's warm re-partition is
    dispatched asynchronously and drains under the current epoch's train
    steps (membership then rides the carried engine state);
  * straggler mitigation: steps slower than --straggler-factor x the
    running median are logged with the step id.

``--dp`` / ``--tp`` build ``make_host_mesh`` on ``--device``, repeated at
every position: ``--grad-compression --dp 2`` runs both data shards on the
one device, one after another.
"""

from __future__ import annotations

import argparse
import signal
import time

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.data.minibatch import epoch_order, random_sequencer_batches
from repro_torch.data.synthetic import lm_token_stream
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import transformer as T
from repro_torch.models.registry import get_config
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.compression import (init_error_state,
                                           make_compressed_dp_train_step)
from repro_torch.train.optimizer import OptConfig, adamw_init
from repro_torch.train.pipeline import ABAPipeline
from repro_torch.train.train_step import make_train_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--n-docs", type=int, default=2048)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--aba-batching", action="store_true",
                    help="diverse mini-batches via ABA (the paper's use)")
    ap.add_argument("--refresh-features", action="store_true",
                    help="with --aba-batching: warm re-partition every "
                    "epoch, dispatched asynchronously so the solve overlaps "
                    "the previous epoch's train steps (repro_torch.train."
                    "pipeline).  Batch membership then depends on the "
                    "carried engine state, so restore-replay reproduces the "
                    "schedule only from the same start epoch (default: "
                    "static membership, pure step-counter replay)")
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--dp", type=int, default=1)
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--straggler-factor", type=float, default=3.0)
    ap.add_argument("--stop-after", type=int, default=0,
                    help="simulate preemption: checkpoint + exit after N steps")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="where the model trains: cuda (default; raises "
                    "without a card) or cpu (the kernels' plain versions)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch, reduced=args.reduced)
    mesh = make_host_mesh(args.dp, args.tp, device=dev)
    opt_cfg = OptConfig(lr=args.lr, warmup_steps=min(20, args.steps // 5 + 1),
                        decay_steps=args.steps)

    # ---- data: synthetic LM corpus + ABA diverse batching ------------------
    tokens, feats = lm_token_stream(args.n_docs, args.seq, cfg.vocab_size,
                                    seed=args.seed)
    pipe = None
    if args.aba_batching:
        pipe = ABAPipeline(feats, args.batch, seed=args.seed, device=dev)
        sd, rg = pipe.diversity_stats(feats)
        print(f"[data] ABA batches: K={len(pipe)} diversity sd={sd:.4f} "
              f"range={rg:.4f}"
              + (" (refresh: overlapped)" if args.refresh_features else ""))
        steps_per_epoch = len(pipe)
    else:
        batches = random_sequencer_batches(args.n_docs, args.batch,
                                           seed=args.seed)
        steps_per_epoch = len(batches)

    # ---- model/optimizer ----------------------------------------------------
    model = T.init_params(cfg, generator=torch.Generator(
        device=dev).manual_seed(args.seed), device=dev)
    opt_state = adamw_init(model)
    if args.grad_compression:
        err = init_error_state(model)
        step_fn = make_compressed_dp_train_step(cfg, mesh, opt_cfg)
    else:
        err = None
        step_fn = make_train_step(cfg, mesh, opt_cfg,
                                  loss_chunk=min(128, args.seq))

    start_step = 0
    if args.ckpt_dir:
        state = {"params": model, "opt": opt_state}
        restored, rstep = ckpt.restore(args.ckpt_dir, state)
        if restored is not None:
            model, opt_state = restored["params"], restored["opt"]
            start_step = rstep
            print(f"[restore] resumed from step {rstep}")

    stop = {"flag": False}

    def _preempt(signum, frame):
        print(f"[signal] {signum}: checkpoint + exit")
        stop["flag"] = True

    def save(step):
        if args.ckpt_dir:
            path = ckpt.save(args.ckpt_dir, step,
                             {"params": model, "opt": opt_state})
            print(f"[ckpt] step {step} -> {path}")

    def epoch_batches():
        """(step, idx) pairs from ``start_step`` on, epoch-major (the
        reference's schedule: see the module's doc)."""
        start_epoch = start_step // steps_per_epoch
        n_epochs = -(-args.steps // steps_per_epoch) - start_epoch
        if pipe is not None:
            refresh = (lambda e: feats) if args.refresh_features else None
            epochs_it = pipe.epochs(n_epochs, features=refresh,
                                    start_epoch=start_epoch)
        else:
            epochs_it = ((batches[b] for b in
                          epoch_order(args.seed, e, steps_per_epoch))
                         for e in range(start_epoch,
                                        start_epoch + n_epochs))
        step = start_epoch * steps_per_epoch
        for ep in epochs_it:
            for idx in ep:
                if step >= args.steps:
                    return
                if step >= start_step:
                    yield step, idx
                step += 1

    handlers = {s: signal.signal(s, _preempt)
                for s in (signal.SIGTERM, signal.SIGINT)}
    try:
        times = []
        losses = []
        for step, idx in epoch_batches():
            batch = {"tokens": torch.from_numpy(tokens[idx]).long().to(dev)}
            t0 = time.time()
            if err is not None:
                model, opt_state, err, metrics = step_fn(model, opt_state,
                                                         err, batch)
            else:
                model, opt_state, metrics = step_fn(model, opt_state, batch)
            loss = float(metrics["loss"])
            dt = time.time() - t0
            times.append(dt)
            losses.append(loss)
            med = float(np.median(times[-50:]))
            if dt > args.straggler_factor * med and len(times) > 10:
                print(f"[straggler] step {step} took {dt:.2f}s "
                      f"(median {med:.2f}s)")
            if step % args.log_every == 0 or step == args.steps - 1:
                print(f"[step {step}] loss={loss:.4f} "
                      f"lr={float(metrics['lr']):.2e}"
                      f" gnorm={float(metrics['grad_norm']):.2f} {dt:.2f}s")
            if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
                save(step + 1)
            if stop["flag"] or (args.stop_after
                                and step + 1 >= args.stop_after):
                save(step + 1)
                print(f"[preempt] stopped after step {step}")
                return losses[-1]
    finally:
        for s, h in handlers.items():
            signal.signal(s, h)
    save(args.steps)
    print(f"[done] last-step loss {losses[-1]:.4f} "
          f"(mean last-10 {np.mean(losses[-10:]):.4f})")
    return losses[-1]  # last-step loss: bit-identical under restore-replay


if __name__ == "__main__":
    main()
