"""Training tool: MVS4Net on DTU or BlendedMVS, on one device or data parallel (counterpart of mvster_tpu.tools.train).

  python -m mvster_tpu_torch.tools.train --trainpath $DTU \\
      --trainlist lists/dtu/train.txt --testlist lists/dtu/val.txt \\
      --logdir checkpoints/exp --batch_size 2 --group_cor --inverse_depth \\
      --rt --mono --attn_temp 2

The BlendedMVS fine-tune (768x576, blend_loss) starts from a DTU checkpoint:

  python -m mvster_tpu_torch.tools.train --dataset blendedmvs \\
      --trainpath $BLENDEDMVS --trainlist lists/blendedmvs/train.txt \\
      --testlist lists/blendedmvs/val.txt --loadckpt $CKPT \\
      --nviews 7 --batch_size 2 --group_cor --inverse_depth --mono \\
      --attn_temp 2 --ot_backend pallas

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
after one warm-up step to <logdir>/profile/.

Data parallel, one process a card, launched by torchrun:

  python -m torch.distributed.run --nproc_per_node 4 \\
      -m mvster_tpu_torch.tools.train --batch_size 8 ...

`--batch_size` is the global batch and must divide by the number of
processes.  Rank r runs on cuda:LOCAL_RANK (gloo on `--device cpu`, NCCL on
the card), reads its shard of the data (the same seed on every rank), and
trains the model wrapped in DistributedDataParallel; BatchNorm moments,
the losses and the metrics are the global batch's, as in the JAX
package's data-parallel step (dist/reduce.py).  Rank 0 prints, logs,
writes the checkpoints (keys without DDP's `module.` prefix) and the
profile trace; every rank takes the same steps.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import time

import torch
import torch.distributed as dist
from torch.nn.parallel import DistributedDataParallel

from mvster_tpu_torch.data import MVSLoader, find_dataset_def
from mvster_tpu_torch.dist.mesh import is_main, maybe_initialize_distributed, rank_device
from mvster_tpu_torch.dist.train_step import make_eval_step, make_train_step
from mvster_tpu_torch.models.losses import blend_loss, mvs4net_loss
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
    """(train, val) datasets: DTU, or BlendedMVS for the fine-tune (robust
    training, `--rt`, for the train split only)."""
    dataset_cls = find_dataset_def(args.dataset)
    if args.dataset.startswith("dtu"):
        train_ds = dataset_cls(
            args.trainpath, args.trainlist, "train", args.nviews,
            args.interval_scale, rt=args.rt, use_raw_train=args.use_raw_train,
            seed=args.seed,
        )
        val_ds = dataset_cls(
            args.testpath or args.trainpath, args.testlist, "val", args.nviews,
            args.interval_scale,
        )
    elif args.dataset.startswith("blendedmvs"):
        train_ds = dataset_cls(
            args.trainpath, args.trainlist, "train", args.nviews,
            robust_train=args.rt, seed=args.seed,
        )
        val_ds = dataset_cls(
            args.testpath or args.trainpath, args.testlist, "val", args.nviews,
            robust_train=False,
        )
    else:
        raise ValueError(f"unsupported training dataset {args.dataset}")
    return train_ds, val_ds


def select_loss(dataset: str):
    """blend_loss (adds the final stage's EPE, err1, err3) for BlendedMVS,
    mvs4net_loss otherwise, for the train and the eval step alike."""
    return blend_loss if dataset.startswith("blendedmvs") else mvs4net_loss


def _profile(train_step, loader, device, logdir):
    """One warm-up step, then a torch.profiler trace of three; every rank
    takes the steps, rank 0 traces them."""
    from torch.profiler import ProfilerActivity, profile

    batches = itertools.islice(itertools.cycle(loader), 4)
    train_step(device_batch(next(batches), device))
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    with profile(activities=activities) if is_main() else contextlib.nullcontext() as prof:
        for batch in batches:
            train_step(device_batch(batch, device))
        if device.type == "cuda":
            torch.cuda.synchronize()
    if prof is None:
        return None
    os.makedirs(os.path.join(logdir, "profile"), exist_ok=True)
    path = os.path.join(logdir, "profile", "train_steps.json")
    prof.export_chrome_trace(path)
    sort = "self_cuda_time_total" if device.type == "cuda" else "self_cpu_time_total"
    print(prof.key_averages().table(sort_by=sort, row_limit=25))
    print(f"profile trace of 3 train steps written to {path}")
    return path


def main(argv=None):
    """Returns {"steps", "val", "checkpoint", "rank", "world_size",
    "backend"[, "profile"]}: the train steps taken, the last eval means
    (global), the last checkpoint's path, and the process group (backend
    None without one).  Under torchrun it joins the group that the
    environment describes and leaves it on return."""
    args = build_train_parser().parse_args(argv)
    device = resolve_device(args.device)
    owns_group = not dist.is_initialized()
    rank, world = maybe_initialize_distributed(device)
    try:
        return _train(args, rank_device(device), rank, world)
    finally:
        if owns_group and dist.is_initialized():
            dist.destroy_process_group()


def _train(args, device, rank, world):
    if args.batch_size % world:
        raise ValueError(f"--batch_size {args.batch_size} is the global batch and must "
                         f"divide by the {world} processes")
    say = print if is_main() else (lambda *a, **k: None)
    # full float32 matmuls and convolutions, as the reference computes them
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    set_random_seed(args.seed)

    config = model_config_from_args(args)
    model = MVS4Net(config)
    model.load_state_dict(init_state_dict(model, args.seed), strict=True)
    if args.loadckpt:
        model.load_state_dict(load_reference_ckpt(args.loadckpt, config), strict=True)
        say(f"loaded weights from {args.loadckpt}")
    model.to(device)
    loss_kwargs = loss_kwargs_from_args(args, mono=args.mono)

    train_ds, val_ds = build_datasets(args)
    batch = args.batch_size // world
    train_loader = MVSLoader(train_ds, batch, shuffle=True, drop_last=True,
                             num_shards=world, shard_index=rank, seed=args.seed,
                             num_workers=args.num_workers)
    # drop_last=False like the reference's val loader; evaluate() pads the
    # trailing partial batch with zero-mask duplicates
    val_loader = MVSLoader(val_ds, batch, shuffle=False, drop_last=False,
                           num_shards=world, shard_index=rank)
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
            say(f"resumed from epoch {epoch}")
    for group in optimizer.param_groups:
        group["initial_lr"] = args.lr
    scheduler = torch.optim.lr_scheduler.LambdaLR(
        optimizer,
        make_lr_factor(args.lr_scheduler, steps_per_epoch, args.epochs, args.lrepochs),
        last_epoch=steps_per_epoch * start_epoch - 1,
    )
    backend = dist.get_backend() if dist.is_initialized() else None
    if backend is not None:
        # every rank starts from the same seed, so DDP's broadcast of rank
        # 0's state changes nothing; BatchNorm's running statistics stay
        # each rank's own (equal, as their moments are global)
        model = DistributedDataParallel(
            model, device_ids=[device.index] if device.type == "cuda" else None,
            broadcast_buffers=False)

    loss_fn = select_loss(args.dataset)
    train_step = make_train_step(model, optimizer, loss_fn, loss_kwargs,
                                 grad_accum=args.grad_accum, scheduler=scheduler)
    eval_step = make_eval_step(model, loss_fn, loss_kwargs)
    result = {"steps": 0, "val": {}, "checkpoint": None, "rank": rank,
              "world_size": world, "backend": backend}
    say(f"training: {len(train_ds)} samples, {steps_per_epoch} steps/epoch on {device}"
        + (f", {world} processes ({backend}), global batch {args.batch_size}"
           if backend else ""))

    if args.mode == "profile":
        result["profile"] = _profile(train_step, train_loader, device, args.logdir)
        return result

    logger = MetricLogger(args.logdir, is_main=is_main())
    for epoch in range(start_epoch, args.epochs):
        t0 = time.perf_counter()
        result["steps"] += train_epoch(train_step, train_loader, epoch, device,
                                       logger, summary_freq=args.summary_freq,
                                       print_fn=say)
        say(f"epoch {epoch}: {time.perf_counter() - t0:.2f} s")
        if (epoch + 1) % args.save_freq == 0:
            result["checkpoint"] = ckpt_mgr.save(epoch, model, optimizer)
        if epoch % args.eval_freq == 0 or epoch == args.epochs - 1:
            result["val"] = evaluate(eval_step, val_loader, device, logger,
                                     global_step=steps_per_epoch * (epoch + 1),
                                     print_fn=say)
    logger.close()
    return result


if __name__ == "__main__":
    main()
