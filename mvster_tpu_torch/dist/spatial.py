"""Image-row (H) sharded inference and training (counterpart of mvster_tpu.dist.spatial).

Plane-sweep inference and training at resolutions whose activations
outgrow one device: the ranks of a data row share its images by bands of
rows, and each rank runs the cascade on its band alone.  The JAX package
lets GSPMD partition H over a second mesh axis, whatever the model
computes; here the exchanges are written out, and every configuration of
the model runs:

  - every convolution taller than one row takes halo rows from the other
    bands before it runs (the count follows from its kernel, stride and
    padding; the image's first and last bands keep zero padding), through
    hooks on the conv modules while the step runs, so the model's layers
    run unchanged.  A halo taller than the band (PAM's 7x7 and PDAM's
    7x7x7 gates at Reg2d's deepest level) reads every band it reaches.
    This covers FPN4 and the ConvNeXt pyramids (their 7x7 depthwise and
    2x2 patchify convs; LayerNorm is per pixel), Reg2d and Reg3d (its
    stride-2 3x3x3 convs, transposed convs and 3x3x3 head), ASFF's conv
    blocks (its max pools, window equal to stride, and nearest upsampling
    are row-local on aligned bands), the mono decoder, and PAM and PDAM,
    whose statistics are per pixel;
  - the align-corners resizes (the FPN's top-down 2x, the hypotheses'
    2x, the confidence's upsampling) take one halo row on each side and
    map the band's rows to their global coordinates: the model takes
    this resize as its `resize` callable (RowBand.resize);
  - the plane sweep reads any source row, so each stage gathers the whole
    source feature maps from the bands (the model's `gather_sources`
    callable, RowBand.gather_sources); the reference stays a band, and
    the cost-volume kernel K1 takes the band's first row (`row0`) and the
    sources' own size;
  - the layers with a `row_band` attribute get the band while the step
    runs: CAM's and DCAM's pools over H are the whole image's (the mean a
    sum over the spatial group over the image's count, the max each
    band's max in its slot, the slots' max), and DCN computes its offsets
    on the band and samples the whole map gathered from the bands, at
    global rows, clamped to the whole image.

Strided convolutions sample rows at the global parity, so a band starts at
a multiple of the cascade's total stride: the FPN's 8 times the
regulariser's 8 (Reg2d's three stride-2 levels, or Reg3d's down_size <= 3)
at stage 1 is 64 rows, and H must be a multiple of 64 * spatial.

Collectives are all_reduce only (sums into zeroed slots, exact since
x + 0 = x), since gloo takes nothing else on CUDA tensors; the ranks of
one card therefore run over gloo.  Each exchange is a sum over the
spatial group (dist/reduce.AllSum), so its backward is one too: the
gradient of the halo rows a rank read goes back into the rows of the
band they came from, each rank keeps its own band's rows of a gathered
map's gradient, summed over the group, and a pooled value's gradient
reaches every band that it pooled.  In training the loss, BatchNorm's
moments (sums over every rank) and the depth metrics (each image's sums
over its bands) are the global batch's, and the parameters' gradients are
averaged over every rank once the backward is done.  The entry points are
the functions, under torchrun's environment:

  rank, world = dist.mesh.maybe_initialize_distributed(device, backend)
  groups = make_2d_groups(data, spatial)
  step = make_spatial_infer_step(model, groups)
  depth, conf = step(imgs, proj_matrices, depth_values)  # this data row's
  train = make_spatial_train_step(model, optimizer, groups, loss_kwargs=...)
  scalars, images = train(batch)  # this data row's batch; images its band
"""

from __future__ import annotations

import contextlib
from typing import Any, NamedTuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from mvster_tpu_torch.dist.mesh import rank, world_size
from mvster_tpu_torch.dist.reduce import AllSum
from mvster_tpu_torch.dist.train_step import _collect_scalars_images, _forward_loss
from mvster_tpu_torch.models.losses import mvs4net_loss

# rows a band must hold a multiple of: the pyramid's stride 8 times the
# regulariser's 8 (three stride-2 levels of Reg2d, or of Reg3d at most)
BAND_ALIGN = 64


class SpatialGroups(NamedTuple):
    """This rank's place in a (data x spatial) split of the world."""

    data: int
    spatial: int
    data_row: int  # rank // spatial: the batch shard it serves
    band: int      # rank % spatial: its band of image rows
    spatial_group: Any  # the ranks of its data row (None with spatial 1)
    data_group: Any     # the ranks of its band index (None with data 1)


def make_2d_groups(data: int, spatial: int) -> SpatialGroups:
    """Split the world into data x spatial ranks, rank r at data row
    r // spatial and band r % spatial (the counterpart of make_2d_mesh).
    Every rank creates every group, in one order, as torch.distributed
    requires."""
    world = world_size()
    if data < 1 or spatial < 1 or data * spatial != world:
        raise ValueError(f"data {data} x spatial {spatial} != world size {world}")
    r = rank()
    spatial_group = data_group = None
    if world > 1:
        for d in range(data):
            g = dist.new_group([d * spatial + k for k in range(spatial)])
            if d == r // spatial:
                spatial_group = g
        for k in range(spatial):
            g = dist.new_group([d * spatial + k for d in range(data)])
            if k == r % spatial:
                data_group = g
    return SpatialGroups(data, spatial, r // spatial, r % spatial,
                         spatial_group if spatial > 1 else None,
                         data_group if data > 1 else None)


class RowBand:
    """This rank's band of image rows and the exchanges with the others of
    its spatial group.  Maps are (..., rows, W): the row axis second to
    last, unless a `dim` says otherwise."""

    def __init__(self, groups: SpatialGroups):
        self.n = groups.spatial
        self.index = groups.band
        self.group = groups.spatial_group

    def row0(self, rows: int) -> int:
        """The band's first row in the image, for a band of `rows` rows."""
        return self.index * rows

    def cut(self, x: torch.Tensor, dim: int = -2) -> torch.Tensor:
        """The band's rows of a whole map x (rows along `dim`)."""
        rows = x.shape[dim] // self.n
        return x.narrow(dim, self.row0(rows), rows)

    def check_height(self, h: int) -> None:
        """Raise ValueError unless an image of h rows splits into bands that
        each start at a multiple of the cascade's total stride."""
        if h % (BAND_ALIGN * self.n):
            raise ValueError(f"H = {h} must be a multiple of {BAND_ALIGN} x spatial "
                             f"{self.n}: a band starts at a multiple of the cascade's "
                             f"total stride ({BAND_ALIGN} rows)")

    def _sum(self, x: torch.Tensor) -> torch.Tensor:
        """x summed over the spatial group; its gradient likewise summed."""
        return AllSum.apply(x, self.group) if self.n > 1 else x

    def gather(self, x: torch.Tensor, dim: int = -2) -> torch.Tensor:
        """The whole map from every band's x, rows along `dim`.  Each rank's
        gradient of the whole map is summed over the group and each band
        keeps its own rows."""
        d = dim % x.dim()
        rows = x.shape[d]

        def zeros(bands):
            return x.new_zeros((*x.shape[:d], bands * rows, *x.shape[d + 1:]))

        full = torch.cat([zeros(self.index), x, zeros(self.n - 1 - self.index)], dim=d)
        return self._sum(full)

    def gather_sources(self, src: torch.Tensor) -> tuple[torch.Tensor, int]:
        """The whole source feature maps (V-1, B, H, W, C) from every band's
        (V-1, B, rows, W, C), and the band's first image row."""
        return self.gather(src, dim=2), self.row0(src.shape[2])

    def halo(self, x: torch.Tensor, top: int, bottom: int) -> torch.Tensor:
        """x with the `top` rows above the band and the `bottom` rows below
        it (zeros past the image's edges) -> (..., top + rows + bottom, W).
        The halos and their gradients travel in x's precision, or float32
        for lower ones; the gradient of the rows a rank read from another
        band is summed back into that band's rows.  A halo taller than the
        band reads the whole map (`gather`), so it takes rows from every
        band it reaches."""
        if top == bottom == 0:
            return x
        rows = x.shape[-2]
        dt = x.dtype if x.dtype in (torch.float32, torch.float64) else torch.float32
        if max(top, bottom) > rows:
            whole = self.gather(x.to(dt))
            edge = lambda n: whole.new_zeros((*x.shape[:-2], n, x.shape[-1]))  # noqa: E731
            whole = torch.cat([edge(top), whole, edge(bottom)], dim=-2)
            return whole.narrow(-2, self.row0(rows), top + rows + bottom).to(x.dtype)
        # slot r holds band r's last `top` rows (the next band's halo above)
        # and its first `bottom` rows (the previous band's halo below)
        own = torch.cat([x[..., rows - top:, :], x[..., :bottom, :]], dim=-2).to(dt)
        slots = self._slots(own)
        above = (slots[self.index - 1, ..., :top, :].to(x.dtype) if self.index > 0
                 else x.new_zeros((*x.shape[:-2], top, x.shape[-1])))
        below = (slots[self.index + 1, ..., top:, :].to(x.dtype) if self.index < self.n - 1
                 else x.new_zeros((*x.shape[:-2], bottom, x.shape[-1])))
        return torch.cat([above, x, below], dim=-2)

    def _slots(self, own: torch.Tensor) -> torch.Tensor:
        """(n, *own.shape): slot r holds band r's `own`, summed over the group
        into zeroed slots."""
        return self._sum(torch.stack([own if r == self.index else torch.zeros_like(own)
                                      for r in range(self.n)]))

    def mean(self, x: torch.Tensor, dims: tuple[int, ...]) -> torch.Tensor:
        """The whole image's mean of x over `dims`, the row axis (-2) among
        them: the bands' sums summed over the group, over the image's count.
        Under data x spatial ranks each data row pools its own images."""
        count = self.n * int(np.prod([x.shape[d] for d in dims]))
        return self._sum(x.sum(dims)) / count

    def amax(self, x: torch.Tensor, dims: tuple[int, ...]) -> torch.Tensor:
        """The whole image's max of x over `dims`, the row axis among them:
        each band's max in its slot, the slots' max.  The gradient goes back
        to the band that held the maximum."""
        return self._slots(x.amax(dims)).amax(0)

    def resize(self, x: torch.Tensor, out_rows: int, out_w: int) -> torch.Tensor:
        """Align-corners bilinear resize of the band's (..., rows, W) to
        (..., out_rows, out_w), the image's H growing by out_rows / rows:
        output row i of the image reads input row i * (Hin - 1) / (Hout - 1),
        computed, as F.interpolate computes it, in float32, or in float64
        for float64 maps (and the blend in float32 at least)."""
        rows, w = x.shape[-2:]
        h_in, h_out = rows * self.n, out_rows * self.n
        ct = torch.promote_types(x.dtype, torch.float32)
        xh = self.halo(x, 1, 1).to(ct)  # image rows row0 - 1 .. row0 + rows
        base = self.row0(rows) - 1
        real = np.float64 if ct == torch.float64 else np.float32
        scale = real(h_in - 1) / real(h_out - 1)
        start = self.row0(out_rows)
        src = torch.arange(start, start + out_rows, dtype=ct, device=x.device) * float(scale)
        i0 = torch.floor(src)
        lam = src - i0
        i0 = i0.long()
        i1 = torch.clamp(i0 + 1, max=h_in - 1)
        a = xh.index_select(-2, i0 - base)
        b = xh.index_select(-2, i1 - base)
        y = a * (1 - lam)[:, None] + b * lam[:, None]
        if out_w != w:  # the rows are done: F.interpolate's row weights are (1, 0)
            lead = y.shape[:-2]
            y = F.interpolate(y.reshape(-1, 1, out_rows, w), size=(out_rows, out_w),
                              mode="bilinear", align_corners=True)
            y = y.reshape(*lead, out_rows, out_w)
        return y.to(x.dtype)

    @contextlib.contextmanager
    def halo_convs(self, module: nn.Module):
        """Within: every conv of `module` taller than one row (its rows the
        second-to-last axis) takes its halo rows from the other bands and
        pads no rows itself; a transposed conv's output is cropped to the
        band's rows; and every layer with a `row_band` attribute (the
        channel-attention blocks' pools over H, DCN's sampling) gets this
        band as it.  The modules are restored on exit."""
        handles, saved, layers = [], [], []
        try:
            for m in module.modules():
                if hasattr(m, "row_band"):
                    layers.append(m)
                    m.row_band = self
                if not isinstance(m, (nn.Conv2d, nn.Conv3d, nn.ConvTranspose3d)):
                    continue
                k, s, p = m.kernel_size[-2], m.stride[-2], m.padding[-2]
                if k == 1 and p == 0:
                    continue
                if m.dilation[-2] != 1 or m.padding_mode != "zeros":
                    raise NotImplementedError(f"no halo rule for {m}")
                saved.append((m, m.padding, getattr(m, "output_padding", None)))
                if isinstance(m, nn.ConvTranspose3d):
                    handles += self._transposed_hooks(m, k, s, p)
                else:  # output row i reads input rows s*i - p .. s*i - p + k - 1
                    m.padding = (*m.padding[:-2], 0, m.padding[-1])
                    top, bottom = p, k - s - p
                    handles.append(m.register_forward_pre_hook(
                        lambda mod, args, t=top, b=bottom: (self.halo(args[0], t, b),)))
            yield
        finally:
            for m in layers:
                del m.row_band  # back to the class's None
            for h in handles:
                h.remove()
            for m, padding, output_padding in saved:
                m.padding = padding
                if output_padding is not None:
                    m.output_padding = output_padding

    def _transposed_hooks(self, m, k, s, p):
        """Output row o gathers the input rows i with s*i - p + k' = o,
        k' < k: a band's output rows need (k - 1 - p) // s rows above and
        (p + s - 1) // s below.  The conv then runs on the padded band with
        the original padding and no output padding, and its output is cut
        to the band's s * rows rows."""
        top, bottom = (k - 1 - p) // s, (p + s - 1) // s
        if (bottom - 1) * s + k - 2 * p < 0:  # the output would not reach the band's end
            raise NotImplementedError(f"no halo rule for {m}")
        m.output_padding = (*m.output_padding[:-2], 0, m.output_padding[-1])
        rows = {}

        def pre(mod, args):
            rows["n"] = args[0].shape[-2]
            return (self.halo(args[0], top, bottom),)

        def post(mod, args, out):
            return out[..., s * top:s * (top + rows["n"]), :]

        return [m.register_forward_pre_hook(pre), m.register_forward_hook(post)]


def make_spatial_infer_step(model, groups: SpatialGroups):
    """The eval forward with each rank of a data row holding one band of
    image rows.  Returns step(imgs, proj_matrices, depth_values) ->
    (depth, photometric_confidence), this rank's band, each
    (B, H / spatial, W); the inputs are its data row's, whole, and only
    the band's image rows go to the device."""
    band = RowBand(groups)

    def step(imgs, proj_matrices, depth_values):
        band.check_height(imgs.shape[2])
        dev = next(model.parameters()).device
        imgs = band.cut(imgs, 2).to(dev)
        proj_matrices = {k: v.to(dev) for k, v in proj_matrices.items()}
        was_training = model.training
        model.eval()
        try:
            with torch.inference_mode(), band.halo_convs(model):
                out = model(imgs, proj_matrices, depth_values.to(dev),
                            resize=band.resize, gather_sources=band.gather_sources)
        finally:
            model.train(was_training)
        return out["depth"], out["photometric_confidence"]

    return step


def _average_gradients(module: nn.Module) -> None:
    """Each parameter's gradient summed over every rank and divided by the
    world size, in one all_reduce: the global batch's gradient, since each
    rank holds the world size times its share (dist/reduce.py).  Written
    out rather than through DDP, whose bucket reductions would interleave
    with the backward's own all_reduces on the default group."""
    world = world_size()
    grads = [p.grad for p in module.parameters() if p.grad is not None]
    if world == 1 or not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat)
    flat /= world
    for g, part in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(part.view_as(g))


def make_spatial_train_step(model, optimizer, groups: SpatialGroups,
                            loss_kwargs: dict | None = None):
    """One train step over a (data x spatial) split of the ranks (the
    counterpart of the JAX make_spatial_train_step): the batch split over
    the data rows, each image's rows over the ranks of its data row.  The
    parameters and optimizer state are the same on every rank; the loss,
    BatchNorm's moments and the depth metrics are the global batch's (its
    whole images'), and the gradients are summed over both axes.

    Returns step(batch) -> (scalars, images): `batch` is this data row's,
    whole (imgs (B, V, H, W, 3), proj_matrices, depth_values, and each
    stage's depth and mask (B, Hs, Ws), as train/loop.device_batch makes
    it), of which only the band's rows go to the device; the scalars are
    the global batch's, the same on every rank, and the images this rank's
    band (gather_rows assembles them)."""
    band = RowBand(groups)
    loss_kwargs = dict(loss_kwargs or {})

    def step(batch):
        band.check_height(batch["imgs"].shape[2])
        dev = next(model.parameters()).device
        local = {"imgs": band.cut(batch["imgs"], 2).to(dev),
                 "proj_matrices": {k: v.to(dev) for k, v in batch["proj_matrices"].items()},
                 "depth_values": batch["depth_values"].to(dev),
                 "depth": {k: band.cut(v).to(dev) for k, v in batch["depth"].items()},
                 "mask": {k: band.cut(v).to(dev) for k, v in batch["mask"].items()}}
        model.train()
        optimizer.zero_grad(set_to_none=True)
        with band.halo_convs(model):
            loss, aux, outputs = _forward_loss(model, local, mvs4net_loss, loss_kwargs,
                                               resize=band.resize,
                                               gather_sources=band.gather_sources)
            loss.backward()
        result = _collect_scalars_images(loss, aux, outputs, local["imgs"], local["depth"],
                                         local["mask"], band.group)
        _average_gradients(model)
        optimizer.step()
        return result

    return step


def gather_rows(band_map: torch.Tensor, groups: SpatialGroups, dim: int = -2) -> torch.Tensor:
    """The whole map of a data row from each rank's band (rows along `dim`)."""
    return RowBand(groups).gather(band_map, dim)
