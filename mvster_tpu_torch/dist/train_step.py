"""Train and eval steps on one device (counterpart of mvster_tpu.dist.train_step).

`make_train_step` returns step(batch) -> (scalars, images): one forward in
train mode, the loss, one backward, one optimizer update (and one
scheduler step).  With grad_accum = a > 1 the batch is split into a
microbatches whose gradients are summed at the initial parameters (the
parameters do not change until the update), divided by a, and applied in
one update; BatchNorm's running statistics move once per microbatch, in
order; scalars are means over the microbatches and images the whole batch,
as the JAX package's scanned step gives them.  Data parallelism (DDP) is not
ported yet.

The batch is a dict of tensors on the model's device: imgs (B, V, H, W, 3),
proj_matrices {stage: (B, V, 2, 4, 4)}, depth_values (B, K), depth and
mask {stage: (B, Hs, Ws)} (train/loop.device_batch makes it from the
loader's numpy batch).
"""

from __future__ import annotations

from typing import Callable

import torch

from mvster_tpu_torch.models.losses import mvs4net_loss
from mvster_tpu_torch.train.metrics import depth_metrics


def _collect_scalars_images(loss, aux, outputs, imgs, depth_gt_ms, mask_ms):
    """The reference train_sample's scalar and image dicts, detached."""
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
                                 mask_ms[final_stage] > 0.5))
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
    """The train step; `scheduler` (a LambdaLR, say) is stepped after each update."""
    loss_kwargs = dict(loss_kwargs or {})
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")

    def forward_backward(mb, scale):
        outputs = model(mb["imgs"], mb["proj_matrices"], mb["depth_values"])
        loss, aux = loss_fn(outputs, mb["depth"], mb["mask"],
                            depth_values=mb["depth_values"], **loss_kwargs)
        (loss * scale).backward()
        return _collect_scalars_images(loss, aux, outputs, mb["imgs"],
                                       mb["depth"], mb["mask"])

    def step(batch):
        model.train()
        optimizer.zero_grad(set_to_none=True)
        if grad_accum == 1:
            scalars, images = forward_backward(batch, 1.0)
        else:
            results = [forward_backward(mb, 1.0 / grad_accum)
                       for mb in _split(batch, grad_accum)]
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
    reference test_sample_depth; the mono branch is off in eval)."""
    loss_kwargs = dict(loss_kwargs or {})
    loss_kwargs["mono"] = False

    @torch.no_grad()
    def step(batch):
        model.eval()
        outputs = model(batch["imgs"], batch["proj_matrices"], batch["depth_values"])
        loss, aux = loss_fn(outputs, batch["depth"], batch["mask"],
                            depth_values=batch["depth_values"], **loss_kwargs)
        scalars, _ = _collect_scalars_images(loss, aux, outputs, batch["imgs"],
                                             batch["depth"], batch["mask"])
        return scalars

    return step
