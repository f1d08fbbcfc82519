"""Training: train.loop.train_epoch over data.loader.MVSLoader, the step
from dist.train_step.make_train_step, wired as tools/train._train wires
them.

Set-up parses the configuration's flags with the port's train parser,
loads the seeded weights strictly, builds the in-memory dataset of the
traffic's pool, MVSLoader (shuffled, drop_last, prefetching), Adam (0.9,
0.999, 1e-8, `--wd`), the LambdaLR schedule of `--lr_scheduler` (its
warm-up), and the step with the loss that `--dataset` selects.  It runs `warmup` steps of epoch 0 through
train_epoch, which build and warm every kernel, and then puts the same
objects back where the seed put them: the weights and buffers loaded
again in place from the seeded state dict, Adam's state cleared and the
schedule at its step 0.  The window then runs epochs from 1 on until
`seconds` have passed and at least three steps are done: the loader
handed to train_epoch stops at the first batch it is asked for after that.
The window's first three steps are the ones the check follows: their
batches, their losses, their stage depths (kept on the card, so nothing
in the window waits on them), the first gradient as Adam holds it after
step one and the parameters' change after step three.

With a trace, the profiler covers `trace_count` steps from step
`trace_after` of the window, each step a unit range; the harness times
each step's wait in the loader and its host time in the step.
"""

from __future__ import annotations

import contextlib
import copy
import time

import torch

from mvsbench import check, traffic, work
from mvsbench.cells import flags
from mvsbench.common import Readings, cpu_seconds, free_cuda, quartiles, say
from mvsbench.trace import Profiler, unit_range, warm

CHECKED_STEPS = 3
ADAM_BETA1 = 0.9


class Pool:
    """The traffic's samples as a dataset."""

    def __init__(self, samples):
        self.samples = samples

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        return self.samples[i]


class Feed:
    """The loader handed to train_epoch: MVSLoader's batches, timed, until
    `limit` batches or, once `floor` batches are taken, the deadline.  It
    keeps the first `keep` batches it hands out after `keep` is set."""

    def __init__(self, loader):
        self.loader = loader
        self.waits = []
        self.batches = []
        self.keep = 0
        self.limit = None
        self.floor = 0
        self.deadline = None
        self.stopped = False

    def __len__(self):
        return len(self.loader)

    @property
    def batch_size(self):
        return self.loader.batch_size

    def set_epoch(self, epoch):
        self.loader.set_epoch(epoch)

    def _stop(self):
        return (self.limit is not None and len(self.waits) >= self.limit) or (
            self.deadline is not None and len(self.waits) >= self.floor
            and time.perf_counter() >= self.deadline)

    def __iter__(self):
        it = iter(self.loader)
        try:
            while not self._stop():
                t = time.perf_counter()
                try:
                    batch = next(it)
                except StopIteration:
                    return
                self.waits.append(time.perf_counter() - t)
                if len(self.batches) < self.keep:
                    self.batches.append(batch)
                yield batch
            self.stopped = True
        finally:
            it.close()


class Step:
    """The train step, timed on the host; from step `check_at` on, reads
    what the check needs from `CHECKED_STEPS` steps (their stage depths,
    which the reference replays and judges) without waiting on the card,
    and starts and stops the profiler."""

    def __init__(self, step, model, optimizer, sd, sync):
        self.step = step
        self.model = model
        self.optimizer = optimizer
        self.sd = sd
        self.sync = sync
        self.host = []
        self.losses = []
        self.depths = []
        self.grad_norms = self.change_norms = None
        self.check_at = None
        self.prof = None
        self.trace_first = self.trace_count = None
        self.warm_at = None

    def __call__(self, batch):
        i = len(self.host)
        k = i - self.check_at if self.check_at is not None else -1
        tracing = self.prof is not None and self.trace_first <= i < self.trace_first + self.trace_count
        if tracing and i == self.trace_first:
            self.sync()
            self.prof.start()
        t = time.perf_counter()
        if i == self.warm_at:
            warm(lambda: (self.step(batch), self.sync()))
        hook = (self.model.register_forward_hook(self._keep_depths)
                if 0 <= k < CHECKED_STEPS else None)
        with unit_range() if tracing else contextlib.nullcontext():
            scalars, images = self.step(batch)
        self.host.append(time.perf_counter() - t)
        if hook is not None:
            hook.remove()
            self.losses.append([scalars["loss"]] + [scalars[f"s{j}_c_loss"] for j in range(4)])
        if k == 0:  # a leaf the optimizer holds no state for has moved nothing
            self.grad_norms = {
                name: torch.linalg.vector_norm(self.optimizer.state[p].get(
                    "exp_avg", torch.zeros((), device=p.device)).double()) / (1 - ADAM_BETA1)
                for name, p in self.model.named_parameters()}
        if k == CHECKED_STEPS - 1:
            self.change_norms = {
                name: torch.linalg.vector_norm((p.detach() - self.sd[name]).double())
                for name, p in self.model.named_parameters()}
        if tracing and i == self.trace_first + self.trace_count - 1:
            self.sync()
            self.prof.stop()
        return scalars, images

    def _keep_depths(self, _module, _args, out):
        """Each checked step's stage depths: those of stages 1-3 are the
        windows of stages 2-4."""
        self.depths.append({k: out[k]["depth"].detach().clone()
                            for k in ("stage1", "stage2", "stage3", "stage4")})

    def readings(self):
        as_float = lambda d: {k: float(v) for k, v in d.items()}  # noqa: E731
        return {"losses": [[float(x) for x in s] for s in self.losses],
                "grad_norms": as_float(self.grad_norms),
                "change_norms": as_float(self.change_norms),
                "stage_depths": [{k: v.cpu() for k, v in d.items()} for d in self.depths]}


def restart(model, optimizer, scheduler, sd, optimizer_state, scheduler_state):
    """The model, Adam and the schedule back where the seed put them, in
    place: the same objects, which the step holds."""
    with torch.no_grad():
        model.load_state_dict(sd, strict=True)
    optimizer.load_state_dict(copy.deepcopy(optimizer_state))
    scheduler.load_state_dict(copy.deepcopy(scheduler_state))


def parse(cell):
    from mvster_tpu_torch.tools.cli import build_train_parser

    t = cell.traffic
    return build_train_parser().parse_args(
        ["--trainpath", ".", "--trainlist", "-", "--testlist", "-",
         "--batch_size", str(t["batch"]), "--nviews", str(t["views"]),
         *flags(cell.config["train"]), *flags(cell.config["model"])])


def loader_of(cell, seed):
    """MVSLoader over the traffic's pool, as _train builds it."""
    from mvster_tpu_torch.data.loader import MVSLoader

    dataset = Pool(traffic.pool(cell.traffic, seed))
    return MVSLoader(dataset, cell.traffic["batch"], shuffle=True, drop_last=True, seed=seed)


def train_window(cell, seed, seconds, trace, device, t_start):
    """Set-up, warm-up and the window: {e2e, first (the check's readings of
    the window's first steps), step, feed, sd, steps, args,
    memory_peak_bytes}."""
    from mvster_tpu_torch.models.mvs4net import MVS4Net
    from mvster_tpu_torch.tools.cli import loss_kwargs_from_args, model_config_from_args
    from mvster_tpu_torch.tools.train import select_loss
    from mvster_tpu_torch.train.loop import train_epoch
    from mvster_tpu_torch.train.schedules import make_lr_factor
    from mvster_tpu_torch.dist.train_step import make_train_step

    t = cell.traffic
    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    args = parse(cell)
    sd = cell.weights(seed, device)
    model = MVS4Net(model_config_from_args(args))
    model.load_state_dict(sd, strict=True)
    model.to(device)
    say(f"set-up: model at {time.perf_counter() - t_start:.2f} s")
    loss_kwargs = loss_kwargs_from_args(args, mono=args.mono)
    loader = loader_of(cell, seed)
    say(f"set-up: pool at {time.perf_counter() - t_start:.2f} s")
    steps_per_epoch = len(loader)
    optimizer = torch.optim.Adam(model.parameters(), lr=args.lr, betas=(0.9, 0.999),
                                 eps=1e-8, weight_decay=args.wd)
    for group in optimizer.param_groups:
        group["initial_lr"] = args.lr
    scheduler = torch.optim.lr_scheduler.LambdaLR(
        optimizer, make_lr_factor(args.lr_scheduler, steps_per_epoch, args.epochs,
                                  args.lrepochs), last_epoch=-1)
    seeded = copy.deepcopy(optimizer.state_dict()), copy.deepcopy(scheduler.state_dict())
    step = Step(make_train_step(model, optimizer, select_loss(args.dataset), loss_kwargs,
                                grad_accum=args.grad_accum, scheduler=scheduler),
                model, optimizer, sd, sync)
    feed = Feed(loader)
    quiet = lambda *a, **k: None  # noqa: E731
    if steps_per_epoch < CHECKED_STEPS:
        raise ValueError(f"{steps_per_epoch} steps an epoch: the check follows the first "
                         f"{CHECKED_STEPS} of an epoch")
    feed.limit = t["warmup"]
    if trace:  # one more step, profiled and thrown away
        step.warm_at = t["warmup"] - 1
    say(f"set-up: optimizer and step at {time.perf_counter() - t_start:.2f} s")
    epoch = 0
    while not feed.stopped:
        train_epoch(step, feed, epoch, device, None, summary_freq=args.summary_freq,
                    print_fn=quiet)
        epoch += 1
    sync()
    say(f"set-up: {t['warmup']} steps at {time.perf_counter() - t_start:.2f} s")
    restart(model, optimizer, scheduler, sd, *seeded)
    step.check_at = len(step.host)
    feed.keep, feed.batches = CHECKED_STEPS, []
    setup_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    if trace:
        step.prof = Profiler()
        step.trace_first, step.trace_count = t["warmup"] + t["trace_after"], t["trace_count"]
    feed.limit, feed.stopped = None, False
    n0 = len(step.host)
    feed.floor = len(feed.waits) + CHECKED_STEPS
    cpu0 = cpu_seconds()
    t0 = time.perf_counter()
    feed.deadline = t0 + seconds
    while not feed.stopped:
        train_epoch(step, feed, epoch, device, None, summary_freq=args.summary_freq,
                    print_fn=quiet)
        epoch += 1
    sync()
    t1 = time.perf_counter()
    cpu1 = cpu_seconds()
    steps = len(step.host) - n0
    window_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    e2e = {"train_step_ms": (t1 - t0) / steps * 1e3,
           "peak_mem_gib": window_peak / 2**30,
           "setup_s": t0 - t_start}
    say(f"window: {steps} steps in {t1 - t0:.3f} s; host ms a step in the step "
        f"callable, quartiles {quartiles(step.host[n0:])}; this process's CPU cores "
        f"{(cpu1 - cpu0) / (t1 - t0):.2f}")
    if step.prof is not None and step.prof.running:
        step.prof.stop()
    first = step.readings()
    return {"e2e": e2e, "first": first, "step": step, "feed": feed, "sd": sd,
            "steps": steps, "args": args, "memory_peak_bytes": max(setup_peak, window_peak)}


def readings(cell, out):
    """The traced sub-window's Readings."""
    t = cell.traffic
    step, feed = out["step"], out["feed"]
    if step.prof is None:
        return None
    tr = step.prof.trace()
    a = step.trace_first
    flops = work.reference_flops(cell.reference, cell.ref_config, t["height"], t["width"],
                                 t["views"], t["batch"], train=True)
    host = {"input_wait": feed.waits[a:a + step.trace_count],
            "step": step.host[a:a + step.trace_count]}
    return Readings(cell, tr, flops=flops, host=host)


def run(cell, seed, seconds, trace, device, t_start):
    out = train_window(cell, seed, seconds, trace, device, t_start)
    result = {"attempted": out["steps"], "failed": 0, "e2e": out["e2e"],
              "memory_peak_bytes": out["memory_peak_bytes"],
              "readings": readings(cell, out)}
    first, batches, sd, args = out["first"], out["feed"].batches, out["sd"], out["args"]
    del out
    free_cuda()
    t2 = time.perf_counter()
    ref = check.reference_steps(cell.reference, sd, cell.ref_config, batches, args.lr,
                                args.ot_iter, device, first["stage_depths"])
    result["values"] = check.judge_steps(first, ref)
    say(f"check: {len(batches)} reference steps in {time.perf_counter() - t2:.2f} s")
    return result
