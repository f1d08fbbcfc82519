"""Train and eval steps, on one device or data parallel (counterpart of mvster_tpu.dist.train_step).

`make_train_step` returns step(batch) -> (scalars, images): one forward in
train mode, the loss, one backward, one optimizer update (and one
scheduler step).  With grad_accum = a > 1 the batch is split into a
microbatches whose gradients are summed at the initial parameters (the
parameters do not change until the update), divided by a, and applied in
one update; BatchNorm's running statistics move once per microbatch, in
order; scalars are means over the microbatches and images the whole batch,
as the JAX package's scanned step gives them.

Data parallel: the model may be wrapped in DistributedDataParallel, one
process a device, each rank holding its shard of the global batch.  DDP
all-reduces the gradients; BatchNorm moments, every masked-mean loss term
and the depth metrics are those of the global batch (dist/reduce), so a
step equals the JAX package's sharded step on the whole batch, and every
rank returns the same global scalars.  Under grad_accum each rank splits
its own shard: global microbatch i is the i-th slice of every rank's
shard (the JAX step splits the global batch into contiguous slices, so the
two agree on the global batch arranged microbatch-major); every
microbatch but the last runs under no_sync, so the gradients are
all-reduced once a step.

The batch is a dict of tensors on the model's device: imgs (B, V, H, W, 3),
proj_matrices {stage: (B, V, 2, 4, 4)}, depth_values (B, K), depth and
mask {stage: (B, Hs, Ws)} (train/loop.device_batch makes it from the
loader's numpy batch).
"""

from __future__ import annotations

import contextlib
from typing import Callable

import torch

from mvster_tpu_torch.models.losses import mvs4net_loss
from mvster_tpu_torch.train.metrics import depth_metrics


def _forward_loss(model, batch, loss_fn, loss_kwargs, **model_kwargs):
    """The forward of `model` on `batch` and the loss: (loss, aux, outputs)."""
    outputs = model(batch["imgs"], batch["proj_matrices"], batch["depth_values"],
                    **model_kwargs)
    loss, aux = loss_fn(outputs, batch["depth"], batch["mask"],
                        depth_values=batch["depth_values"], **loss_kwargs)
    return loss, aux, outputs


def _collect_scalars_images(loss, aux, outputs, imgs, depth_gt_ms, mask_ms, group=None):
    """The reference train_sample's scalar and image dicts, detached; the
    depth metrics over whole images whose bands the ranks of `group` hold."""
    final_stage = f"stage{len(aux['stage_ot_loss'])}"
    scalars = {"loss": loss}
    for i in range(len(aux["stage_ot_loss"])):
        scalars[f"s{i}_d_loss"] = aux["stage_l1_loss"][i]
        scalars[f"s{i}_c_loss"] = aux["stage_ot_loss"][i]
        scalars[f"s{i}_range_err_ratio"] = aux["range_err_ratio"][i]
    for k, v in aux.items():  # blend_loss extras: epe / err1 / err3
        if not isinstance(v, list):
            scalars[k] = v
    depth = outputs["depth"]
    scalars.update(depth_metrics(depth, depth_gt_ms[final_stage],
                                 mask_ms[final_stage] > 0.5, group))
    images = {
        "depth_est": depth * mask_ms[final_stage],
        "depth_est_nomask": depth,
        "depth_gt": depth_gt_ms["stage1"],
        "ref_img": imgs[:, 0],
        "mask": mask_ms["stage1"],
        "errormap": (depth - depth_gt_ms[final_stage]).abs() * mask_ms[final_stage],
    }
    detach = lambda x: x.detach()  # noqa: E731
    return ({k: detach(v) for k, v in scalars.items()},
            {k: detach(v) for k, v in images.items()})


def _split(batch, a: int):
    """The batch as `a` microbatches along dim 0."""
    def chunks(x):
        if isinstance(x, dict):
            parts = {k: chunks(v) for k, v in x.items()}
            return [{k: parts[k][i] for k in parts} for i in range(a)]
        if x.shape[0] % a:
            raise ValueError(f"batch of {x.shape[0]} does not split into {a} microbatches")
        return list(torch.chunk(x, a, dim=0))

    parts = {k: chunks(v) for k, v in batch.items()}
    return [{k: parts[k][i] for k in parts} for i in range(a)]


def make_train_step(
    model: torch.nn.Module,
    optimizer: torch.optim.Optimizer,
    loss_fn: Callable = mvs4net_loss,
    loss_kwargs: dict | None = None,
    grad_accum: int = 1,
    scheduler=None,
):
    """The train step of `model` (a module, or one wrapped in DDP);
    `scheduler` (a LambdaLR, say) is stepped after each update."""
    loss_kwargs = dict(loss_kwargs or {})
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")

    def forward_backward(mb, scale):
        loss, aux, outputs = _forward_loss(model, mb, loss_fn, loss_kwargs)
        (loss * scale).backward()
        return _collect_scalars_images(loss, aux, outputs, mb["imgs"],
                                       mb["depth"], mb["mask"])

    def step(batch):
        model.train()
        optimizer.zero_grad(set_to_none=True)
        if grad_accum == 1:
            scalars, images = forward_backward(batch, 1.0)
        else:
            micro = _split(batch, grad_accum)
            no_sync = getattr(model, "no_sync", contextlib.nullcontext)
            results = []
            for i, mb in enumerate(micro):
                with no_sync() if i < grad_accum - 1 else contextlib.nullcontext():
                    results.append(forward_backward(mb, 1.0 / grad_accum))
            scalars = {k: torch.stack([r[0][k] for r in results]).mean()
                       for k in results[0][0]}
            images = {k: torch.cat([r[1][k] for r in results])
                      for k in results[0][1]}
        optimizer.step()
        if scheduler is not None:
            scheduler.step()
        return scalars, images

    return step


def make_eval_step(model: torch.nn.Module, loss_fn: Callable = mvs4net_loss,
                   loss_kwargs: dict | None = None):
    """No-grad eval step returning the train step's scalar dict (the
    reference test_sample_depth; the mono branch is off in eval).  A DDP
    model runs unwrapped, its scalars the global batch's."""
    model = getattr(model, "module", model)
    loss_kwargs = dict(loss_kwargs or {})
    loss_kwargs["mono"] = False

    @torch.no_grad()
    def step(batch):
        model.eval()
        loss, aux, outputs = _forward_loss(model, batch, loss_fn, loss_kwargs)
        scalars, _ = _collect_scalars_images(loss, aux, outputs, batch["imgs"],
                                             batch["depth"], batch["mask"])
        return scalars

    return step
