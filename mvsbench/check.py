"""The comparisons that decide `correct`, against the plain reference.

Serving (`judge_views`): each answer is replayed stage by stage through
the reference, whose stage s > 1 takes its hypotheses from the answer's
own stage s - 1 depth (as a served token is fed back to a language
model's reference).  At each stage and pixel: the gap by which the
reference's probability of the hypothesis that the answer picked (the one
nearest its depth) lies below the reference's best; |the answer's
confidence - the reference's|, each at full resolution as served; and how
far the answer's depth lies from the hypothesis it picked, relative to it.
Over the judged views, stages 1-4 (stage 4 is the served depth and
confidence) and their pixels:
  depth_gap_p9999  the worst view's 99.99th percentile of the depth gap;
  conf_gap_p999    the worst view's 99.9th percentile of the confidence gap;
  depth_off        the largest relative distance from a hypothesis;
  depth_gap, conf_gap  the widest gaps (read, not compared: they sit at
                   the one worst-conditioned pixel of ~8 million; PERF.md).

Training (`judge_steps`): the window's first three steps, which start
from the seeded state, against the reference's Adam steps on the same
batches from the same weights, each reference step on the program's own
stage 1-3 depths (its windows, as in serving), and those depths judged
as serving judges a view's:
  loss1_gap   the widest relative gap of the first step's loss and its
              per-stage OT terms;
  grad_gap    the first gradient (as Adam holds it after one step), by the
              worst leaf: the gap between the two norms of a leaf over the
              larger of the reference's norm of that leaf and of the median
              leaf;
  change_gap  the parameters' change after the three steps, by the worst
              leaf, so measured; leaves whose reference gradient is under a
              thousandth of the median leaf's are left out (they move under
              Adam by round-off alone);
  depth1_gap_p9999  as serving's depth_gap_p9999, of every stage's depth
              of the first step against the reference's probabilities on
              the same windows (depth1_gap, the widest, is read; after a
              step the parameters differ as loss_gap's note says);
  depth_off   as in serving, over every stage of the three steps;
  loss_gap    every step's loss and terms (read, not compared: after a
              step Adam's sign-like update of gradients within float32 noise
              of zero moves steps 2-3 as far as the control does; PERF.md).
A cell compares the numbers its workload file gives a limit.

"""

from __future__ import annotations

import math

import numpy as np
import torch

from mvsbench.reference import losses as ref_losses


def _tensor(x, device):
    return torch.as_tensor(np.ascontiguousarray(x), dtype=torch.float32, device=device)


def serve_inputs(sample, device):
    imgs = _tensor(sample["imgs"], device)[None]
    projs = {k: _tensor(v, device)[None] for k, v in sample["proj_matrices"].items()}
    return imgs, projs, _tensor(sample["depth_values"], device)[None]


@torch.no_grad()
def judge_view(ref, sd, cfg, sample, answer, device) -> dict:
    """answer: stage{s}_depth (1, h_s, w_s), stage{s}_conf (1, H, W) for
    s = 1..3, and depth, confidence (1, H, W) for stage 4 (numpy); judged
    by the reference module `ref` at its cfg."""
    imgs, projs, dv = serve_inputs(sample, device)
    depths = {f"stage{s}": _tensor(answer[f"stage{s}_depth"], device) for s in (1, 2, 3)}
    depths["stage4"] = _tensor(answer["depth"], device)
    confs = {f"stage{s}": _tensor(answer[f"stage{s}_conf"], device) for s in (1, 2, 3)}
    confs["stage4"] = _tensor(answer["confidence"], device)
    outs, _ = ref.forward(sd, cfg, imgs, projs, dv, stage_depths=depths)
    gaps, offs, confd = [], [], []
    for key, out in outs.items():
        gap, off = pick_gaps(out["hypo"], out["attn"], depths[key])
        gaps.append(gap)
        offs.append(off)
        confd.append((confs[key] - out["confidence"]).abs().flatten())
    gaps, offs, confd = torch.cat(gaps), torch.cat(offs), torch.cat(confd)
    return {"depth_gap": float(gaps.max()), "conf_gap": float(confd.max()),
            "depth_gap_p9999": _quantile(gaps, 0.9999), "conf_gap_p999": _quantile(confd, 0.999),
            "depth_off": float(offs.max())}


def pick_gaps(hypo, attn, depth):
    """At each pixel of depth (B, h, w): the gap by which the reference's
    probability (attn, B x D x h x w) of the hypothesis nearest the depth
    lies below its best, and the depth's distance from that hypothesis
    relative to it (flat)."""
    d = depth[:, None]
    pick = (hypo - d).abs().argmin(1, keepdim=True)
    picked = hypo.gather(1, pick)
    gap = attn.max(1, keepdim=True).values - attn.gather(1, pick)
    return gap.flatten(), ((d - picked).abs() / picked).flatten()


def _quantile(x, q):
    """The q-quantile of a flat tensor (the k-th smallest, k = ceil(q n))."""
    k = max(1, math.ceil(q * x.numel()))
    return float(torch.kthvalue(x.float().cpu(), k).values)


def judge_views(ref, sd, cfg, judged, device) -> dict:
    """The widest of each number over [(sample, answer)]; NaN where an
    answer holds a NaN."""
    views = [judge_view(ref, sd, cfg, sample, answer, device) for sample, answer in judged]
    return {k: math.nan if any(math.isnan(v[k]) for v in views) else max(v[k] for v in views)
            for k in views[0]}


@torch.no_grad()
def reference_answer(ref, sd, cfg, sample, device) -> dict:
    """The reference's own answer, as infer_views gives one (for the control)."""
    outs, _ = ref.forward(sd, cfg, *serve_inputs(sample, device))
    ans = {}
    for s in (1, 2, 3, 4):
        o = outs[f"stage{s}"]
        ans[f"stage{s}_depth"] = o["depth"].cpu().numpy()
        ans[f"stage{s}_conf"] = o["confidence"].cpu().numpy()
    ans["depth"], ans["confidence"] = ans["stage4_depth"], ans["stage4_conf"]
    return ans


def train_batch(batch, device):
    """A loader batch (numpy, nested) -> float32 tensors on the device."""
    if isinstance(batch, dict):
        return {k: train_batch(v, device) for k, v in batch.items()
                if not isinstance(v, (list, str))}
    return _tensor(batch, device)


def norms(tensors: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in tensors.items()}


def _leaf_gaps(got: dict, want: dict, keep=None) -> list[float]:
    keys = [k for k in want if keep is None or k in keep]
    median = float(np.median([want[k] for k in want]))
    return [abs(got[k] - want[k]) / max(want[k], median) for k in keys]


def judge_depths(depths: list, volumes: list) -> dict:
    """Each step's stage depths ({stage: (B, h, w)}) against the reference's
    {stage: (hypo, attn)} on the same windows; NaN where the depths are
    missing or of another shape (answers that never came)."""
    if not depths or len(depths) != len(volumes) or any(
            d[k].shape != v[k][1][:, 0].shape for d, v in zip(depths, volumes) for k in v):
        return {"depth1_gap_p9999": math.nan, "depth1_gap": math.nan, "depth_off": math.nan}
    steps = []
    for d, vol in zip(depths, volumes):
        gaps, offs = zip(*(pick_gaps(h, a, d[k].to(a.device)) for k, (h, a) in vol.items()))
        steps.append((torch.cat(gaps), torch.cat(offs)))
    gaps1 = steps[0][0]
    return {"depth1_gap_p9999": _quantile(gaps1, 0.9999), "depth1_gap": float(gaps1.max()),
            "depth_off": max(float(offs.max()) for _, offs in steps)}


def judge_steps(program: dict, reference: dict) -> dict:
    """program / reference: {"losses": [[total, ot1..ot4] a step],
    "grad_norms": {leaf: |g1|}, "change_norms": {leaf: |p_n - p_0|},
    "stage_depths": [{stage: depth} a step]}; the reference's also
    "volumes": [{stage: (hypo, attn)} a step]."""
    gaps = [[abs(p - r) / max(abs(r), 1e-12) for p, r in zip(ps, rs)]
            for ps, rs in zip(program["losses"], reference["losses"])]
    ref_g = reference["grad_norms"]
    median_g = float(np.median(list(ref_g.values())))
    moved = {k for k, v in ref_g.items() if v >= 1e-3 * median_g}
    out = {"loss_gap": max(max(g) for g in gaps), "loss1_gap": max(gaps[0]),
           "grad_gap": max(_leaf_gaps(program["grad_norms"], ref_g)),
           "change_gap": max(_leaf_gaps(program["change_norms"], reference["change_norms"],
                                        moved))}
    bad = ([v for s in program["losses"] for v in s] + list(program["grad_norms"].values())
           + list(program["change_norms"].values()))
    if not all(math.isfinite(v) for v in bad):
        out = {k: math.nan for k in out}
    out.update(judge_depths(program["stage_depths"], reference["volumes"]))
    return out


def reference_steps(ref, sd, cfg, batches, lr, iters, device, stage_depths=None) -> dict:
    """The reference module's Adam steps on `batches` (loader batches) from sd;
    each step on the windows of the given stage depths where they cover
    its batch (a program's, so that a near-tied argmax that float32 may
    flip either way moves neither side's windows), else on its own."""
    dev_batches = [train_batch(b, device) for b in batches]
    sd = {k: v.to(device) for k, v in sd.items()}
    forced = None
    if stage_depths is not None:
        forced = [{k: v.to(device) for k, v in d.items()}
                  if d["stage1"].shape[0] == b["imgs"].shape[0] else None
                  for d, b in zip(stage_depths, dev_batches)]
    losses, grads, params, depths, volumes = ref_losses.train_steps(
        ref.forward, sd, cfg, dev_batches, lr=lr, iters=iters, stage_depths=forced)
    change = {k: params[k] - sd[k] for k in params}
    return {"losses": losses, "grad_norms": norms(grads), "change_norms": norms(change),
            "stage_depths": [{k: v.cpu() for k, v in d.items()} for d in depths],
            "volumes": volumes}


def verdict(values: dict, limits: dict) -> tuple[bool, dict]:
    """(every number finite and within its limit, {name: {value, limit}})."""
    table = {k: {"value": values.get(k, math.nan), "limit": limits[k]} for k in limits}
    ok = all(math.isfinite(v["value"]) and v["value"] <= v["limit"] for v in table.values())
    return ok, table
