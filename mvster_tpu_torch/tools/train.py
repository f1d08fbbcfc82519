"""Training tool: MVS4Net on DTU, one process on one device (counterpart of mvster_tpu.tools.train).

  python -m mvster_tpu_torch.tools.train --trainpath $DTU \\
      --trainlist lists/dtu/train.txt --testlist lists/dtu/val.txt \\
      --logdir checkpoints/exp --batch_size 2 --group_cor --inverse_depth \\
      --rt --mono --attn_temp 2

It runs on the card (`--device cuda`, the default) and raises where there
is none, unless given `--device cpu`, which runs the kernels' plain
versions; TF32 is off for matmuls and cuDNN.  Adam (0.9, 0.999) with
`--wd` as coupled L2 (optax's add_decayed_weights before adam), the
learning-rate schedule as a LambdaLR; initial weights drawn as the JAX
package's flax modules draw theirs (tools/weights.init_state_dict), or
`--loadckpt`.  Each epoch: the train steps (scalars to
<logdir>/metrics.jsonl every --summary_freq steps), a checkpoint every
--save_freq epochs ({"epoch", "model", "optimizer"}), an eval pass over the
val list.  `--mode profile` writes a torch.profiler trace of 3 train steps
after one warm-up step to <logdir>/profile/.  Data parallelism is not
ported yet.
"""

from __future__ import annotations

import itertools
import os
import time

import torch

from mvster_tpu_torch.data import MVSLoader, find_dataset_def
from mvster_tpu_torch.dist.train_step import make_eval_step, make_train_step
from mvster_tpu_torch.models.losses import mvs4net_loss
from mvster_tpu_torch.models.mvs4net import MVS4Net
from mvster_tpu_torch.tools.cli import (
    build_train_parser,
    loss_kwargs_from_args,
    model_config_from_args,
    resolve_device,
)
from mvster_tpu_torch.tools.weights import init_state_dict, load_reference_ckpt
from mvster_tpu_torch.train.checkpoint import CheckpointManager
from mvster_tpu_torch.train.logging import MetricLogger
from mvster_tpu_torch.train.loop import device_batch, evaluate, train_epoch
from mvster_tpu_torch.train.schedules import make_lr_factor
from mvster_tpu_torch.utils.seeding import set_random_seed


def build_datasets(args):
    dataset_cls = find_dataset_def(args.dataset)
    train_ds = dataset_cls(
        args.trainpath, args.trainlist, "train", args.nviews,
        args.interval_scale, rt=args.rt, use_raw_train=args.use_raw_train,
        seed=args.seed,
    )
    val_ds = dataset_cls(
        args.testpath or args.trainpath, args.testlist, "val", args.nviews,
        args.interval_scale,
    )
    return train_ds, val_ds


def _profile(train_step, loader, device, logdir):
    """One warm-up step, then a torch.profiler trace of three."""
    from torch.profiler import ProfilerActivity, profile

    batches = itertools.islice(itertools.cycle(loader), 4)
    train_step(device_batch(next(batches), device))
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        for batch in batches:
            train_step(device_batch(batch, device))
        if device.type == "cuda":
            torch.cuda.synchronize()
    os.makedirs(os.path.join(logdir, "profile"), exist_ok=True)
    path = os.path.join(logdir, "profile", "train_steps.json")
    prof.export_chrome_trace(path)
    sort = "self_cuda_time_total" if device.type == "cuda" else "self_cpu_time_total"
    print(prof.key_averages().table(sort_by=sort, row_limit=25))
    print(f"profile trace of 3 train steps written to {path}")
    return path


def main(argv=None):
    """Returns {"steps", "val", "checkpoint"[, "profile"]}: the train steps
    taken, the last eval means and the last checkpoint's path."""
    args = build_train_parser().parse_args(argv)
    device = resolve_device(args.device)
    # full float32 matmuls and convolutions, as the reference computes them
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    set_random_seed(args.seed)

    config = model_config_from_args(args)
    model = MVS4Net(config)
    model.load_state_dict(init_state_dict(model, args.seed), strict=True)
    if args.loadckpt:
        model.load_state_dict(load_reference_ckpt(args.loadckpt, config), strict=True)
        print(f"loaded weights from {args.loadckpt}")
    model.to(device)
    loss_kwargs = loss_kwargs_from_args(args, mono=args.mono)

    train_ds, val_ds = build_datasets(args)
    train_loader = MVSLoader(train_ds, args.batch_size, shuffle=True,
                             drop_last=True, seed=args.seed,
                             num_workers=args.num_workers)
    # drop_last=False like the reference's val loader; evaluate() pads the
    # trailing partial batch with zero-mask duplicates
    val_loader = MVSLoader(val_ds, args.batch_size, shuffle=False, drop_last=False)
    steps_per_epoch = len(train_loader)

    optimizer = torch.optim.Adam(model.parameters(), lr=args.lr,
                                 betas=(0.9, 0.999), eps=1e-8,
                                 weight_decay=args.wd)
    ckpt_mgr = CheckpointManager(args.logdir)
    start_epoch = 0
    if args.resume:
        epoch = ckpt_mgr.restore(model, optimizer)
        if epoch is not None:
            start_epoch = epoch + 1
            print(f"resumed from epoch {epoch}")
    for group in optimizer.param_groups:
        group["initial_lr"] = args.lr
    scheduler = torch.optim.lr_scheduler.LambdaLR(
        optimizer,
        make_lr_factor(args.lr_scheduler, steps_per_epoch, args.epochs, args.lrepochs),
        last_epoch=steps_per_epoch * start_epoch - 1,
    )

    train_step = make_train_step(model, optimizer, mvs4net_loss, loss_kwargs,
                                 grad_accum=args.grad_accum, scheduler=scheduler)
    eval_step = make_eval_step(model, mvs4net_loss, loss_kwargs)
    result = {"steps": 0, "val": {}, "checkpoint": None}
    print(f"training: {len(train_ds)} samples, {steps_per_epoch} steps/epoch on {device}")

    if args.mode == "profile":
        result["profile"] = _profile(train_step, train_loader, device, args.logdir)
        return result

    logger = MetricLogger(args.logdir)
    for epoch in range(start_epoch, args.epochs):
        t0 = time.perf_counter()
        result["steps"] += train_epoch(train_step, train_loader, epoch, device,
                                       logger, summary_freq=args.summary_freq)
        print(f"epoch {epoch}: {time.perf_counter() - t0:.2f} s")
        if (epoch + 1) % args.save_freq == 0:
            result["checkpoint"] = ckpt_mgr.save(epoch, model, optimizer)
        if epoch % args.eval_freq == 0 or epoch == args.epochs - 1:
            result["val"] = evaluate(eval_step, val_loader, device, logger,
                                     global_step=steps_per_epoch * (epoch + 1))
    logger.close()
    return result


if __name__ == "__main__":
    main()
