"""Inference and fusion tool: depth maps -> filtered point clouds -> metric (counterpart of mvster_tpu.tools.test).

Per scan, as the JAX inference tool does it:
  1. the eval forward over every reference view (`infer_views`), writing
     depth_est/*.pfm, confidence/*.pfm, cams/*_cam.txt and images/*.jpg, a
     camera-frame ply_local/*.ply every --save_freq views, with
     --save_jpg each stage's depth as a colour-mapped jpg, with --vis_mono
     the last view's stage-4 features (vis_mono/*_feat_stage4.npy) and
     with --vis_ETA each stage's per-source-view attention volumes
     (vis_ETA/*_stage{s}_attn.npy, utils/debug.attention_maps: K2 on the
     card);
  2. the cross-view geometric filter and fusion on the device
     (infer/fusion.py), writing mask/*_{photo,geo,final}.png and the fused
     mvsnet{scan:03d}_l3.ply (DTU) or <scan>.ply (Tanks, ETH3D);
  3. with --dtu_gt_dir, the DTU metric (eval/dtu_metric.py) over the fused
     DTU scans, printed and written to dtu_metrics.json.
Datasets: general_eval (DTU and custom scans), tanks (--split) and eth3d.
Everything runs on the card unless --device cpu is given; without a card
it raises.

`infer_views` is the dispatch/drain loop of the JAX inference tool's
save_depth: reference views in chunks of eval_batch (the trailing chunk
padded with its last view, so every forward has one shape), one eval
forward per chunk.  It launches chunk i+1's forward before it yields chunk
i's views, so the card runs the next forward while the caller writes the
current views; on the CPU the outputs are the same and the overlap is gone.

  python -m mvster_tpu_torch.tools.test --testpath $DTU_TEST \\
      --testlist lists/dtu/test.txt --loadckpt model.ckpt \\
      --interval_scale 1.06 --thres_view 4 --conf 0.5 \\
      --group_cor --attn_temp 2 --inverse_depth [--dtu_gt_dir "$MVS_DATA"]
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Iterable, Iterator, NamedTuple

import numpy as np
import torch

from mvster_tpu_torch.data import find_dataset_def
from mvster_tpu_torch.models.mvs4net import MVS4Net
from mvster_tpu_torch.tools.cli import (
    build_test_parser,
    model_config_from_args,
    resolve_device,
)
from mvster_tpu_torch.tools.weights import load_reference_ckpt


class _Pending(NamedTuple):
    """A chunk whose forward was launched: its samples, its outputs on
    their way to the host, the event after their copy, and the clock at
    its launch."""

    chunk: list[dict]
    host: dict[str, torch.Tensor]
    copied: torch.cuda.Event | None
    t0: float


def _dispatch(model, chunk, eval_batch, device, return_debug) -> _Pending:
    """Launch one chunk's forward and the copy of its outputs into pinned
    host memory behind it, without waiting for either (on a card)."""
    padded = chunk + [chunk[-1]] * (eval_batch - len(chunk))
    cuda = device.type == "cuda"

    def put(arrays):
        x = torch.from_numpy(np.stack(arrays))
        return (x.pin_memory() if cuda else x).to(device, non_blocking=cuda)

    imgs = put([s["imgs"] for s in padded])
    projs = {k: put([s["proj_matrices"][k] for s in padded])
             for k in padded[0]["proj_matrices"]}
    dv = put([s["depth_values"] for s in padded])
    t0 = time.perf_counter()
    with torch.inference_mode():
        out = model(imgs, projs, dv, return_debug=return_debug)
        result = {"depth": out["depth"], "confidence": out["photometric_confidence"]}
        for s in range(1, 5):
            stage = out[f"stage{s}"]
            result[f"stage{s}_depth"] = stage["depth"]
            result[f"stage{s}_conf"] = stage["photometric_confidence"]
            if return_debug:  # numpy has no bfloat16: the features go as float32
                result[f"stage{s}_feat"] = stage["debug_features"].float()
                result[f"stage{s}_proj"] = stage["debug_proj"]
                result[f"stage{s}_hypo"] = stage["hypo_depth"]
    if not cuda:
        return _Pending(chunk, result, None, t0)
    host = {}
    for k, v in result.items():
        host[k] = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
        host[k].copy_(v, non_blocking=True)
    copied = torch.cuda.Event()
    copied.record()
    return _Pending(chunk, host, copied, t0)


def _drain(pending: _Pending) -> Iterator[tuple[dict, dict[str, Any]]]:
    """Wait for one chunk's outputs on the host; yield its real views."""
    if pending.copied is not None:
        pending.copied.synchronize()
    seconds = time.perf_counter() - pending.t0
    result = {k: v.numpy() for k, v in pending.host.items()}
    for i, sample in enumerate(pending.chunk):
        view = {k: v[i:i + 1] for k, v in result.items()}
        view["seconds"] = seconds
        view["chunk_views"] = len(pending.chunk)
        yield sample, view


def infer_views(model: MVS4Net, samples: Iterable[dict], eval_batch: int = 1,
                return_debug: bool = False) -> Iterator[tuple[dict, dict[str, Any]]]:
    """Run the eval forward over reference views; yield (sample, result).

    samples: dicts with imgs (V, H, W, 3), proj_matrices {stage: (V, 2, 4, 4)}
    and depth_values (K,), all of one shape.  result: numpy depth and
    confidence (1, H, W), stage{s}_depth / stage{s}_conf (with
    return_debug also stage{s}_feat (1, V, h, w, C), stage{s}_proj
    (1, V, 4, 4) and stage{s}_hypo (1, D, h, w)), and `seconds`, shared by
    the `chunk_views` views of its chunk: as in the JAX inference tool, the
    wall time from the launch of the chunk's forward until its results are
    on the host, which, with the next chunk launched first, is measured
    when the chunk is drained.

    Before it yields chunk i's views it reads chunk i+1's samples and
    launches chunk i+1's forward; chunk i's outputs were copied behind its
    forward into pinned host memory, and only the event after that copy is
    waited on, when chunk i drains.
    """
    eval_batch = max(1, eval_batch)
    device = next(model.parameters()).device
    pending = None
    for chunk in _chunks(samples, eval_batch):
        current = _dispatch(model, chunk, eval_batch, device, return_debug)
        if pending is not None:
            yield from _drain(pending)
        pending = current
    if pending is not None:
        yield from _drain(pending)


def _chunks(samples: Iterable[dict], n: int) -> Iterator[list[dict]]:
    chunk: list[dict] = []
    for sample in samples:
        chunk.append(sample)
        if len(chunk) == n:
            yield chunk
            chunk = []
    if chunk:
        yield chunk


def colormap_jet(depth: np.ndarray) -> np.ndarray:
    import cv2

    valid = depth > 0
    mi = depth[valid].min() if valid.any() else 0.0
    ma = depth.max()
    norm = (depth - mi) / (ma - mi + 1e-8)
    return cv2.applyColorMap((255 * norm).astype(np.uint8), cv2.COLORMAP_JET)


def save_depth(args, model: MVS4Net, testlist) -> tuple[float, int]:
    """The forward over every scan's reference views, writing each view's
    outputs; returns (forward seconds, views)."""
    dataset_cls = find_dataset_def(args.dataset)
    total_time, total_views = 0.0, 0
    # fix_res pins the whole multi-scan run to the first scan's resolution
    # (the reference's module-global s_h/s_w, general_eval4.py:7,135-153);
    # per-scan datasets thread the pinned size through this variable
    carried_fixed_wh = None
    for scan in testlist:
        if args.dataset.startswith("general"):
            dataset = dataset_cls(
                args.testpath, [scan], "test", args.num_view, args.interval_scale,
                max_h=args.max_h, max_w=args.max_w, fix_res=args.fix_res,
            )
            if args.fix_res and carried_fixed_wh is not None:
                dataset.fixed_wh = carried_fixed_wh
        elif args.dataset == "tanks":
            dataset = dataset_cls(args.testpath, n_views=args.num_view, split=args.split)
        elif args.dataset == "eth3d":
            dataset = dataset_cls(args.testpath, n_views=args.num_view)
        else:
            raise ValueError(f"unsupported test dataset {args.dataset}")

        samples = (dataset[i] for i in range(len(dataset)))
        views = infer_views(model, samples, args.eval_batch,
                            return_debug=args.vis_ETA or args.vis_mono)
        for idx, (sample, out) in enumerate(views):
            total_time += out["seconds"] / out["chunk_views"]
            total_views += 1
            _write_view_outputs(args, sample, out, idx, len(dataset))
        if args.dataset.startswith("general") and args.fix_res:
            carried_fixed_wh = dataset.fixed_wh
    return total_time, total_views


def _write_view_outputs(args, sample, out, idx, total):
    """One reference view's PFMs, cam file, image, ply_local cloud, stage
    jpgs and vis dumps, in the JAX inference tool's layout."""
    import cv2

    from mvster_tpu_torch.data.common import write_cam_file
    from mvster_tpu_torch.data.pfm import write_pfm
    from mvster_tpu_torch.infer.ply import camera_pointcloud, write_ply

    filename = sample["filename"]
    cam = sample["proj_matrices"]["stage4"][0]  # reference view, full-res K

    def path_for(kind, suffix):
        p = os.path.join(args.outdir, filename.format(kind, suffix))
        os.makedirs(os.path.dirname(p), exist_ok=True)
        return p

    write_pfm(path_for("depth_est", ".pfm"), out["depth"][0])
    write_pfm(path_for("confidence", ".pfm"), out["confidence"][0])
    dv = sample["depth_values"]
    intr4 = np.zeros((4, 4), np.float32)
    intr4[:3, :3] = cam[1, :3, :3]
    intr4[3, :4] = [float(dv[0]), float(dv[1] - dv[0] if len(dv) > 2 else 0.0),
                    0.0, float(dv[-1])]
    write_cam_file(path_for("cams", "_cam.txt"), cam[0], intr4)
    img = (np.clip(sample["imgs"][0], 0, 1) * 255).astype(np.uint8)
    cv2.imwrite(path_for("images", ".jpg"), cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
    if idx % args.save_freq == 0:
        # camera-frame coloured cloud every save_freq views, as the
        # reference's ply_local dumps (test_mvs4.py:263-264)
        xyz, rgb = camera_pointcloud(out["depth"][0], cam[1, :3, :3], img)
        write_ply(path_for("ply_local", ".ply"), xyz, rgb)
    if args.save_jpg:
        for s in range(1, 5):
            cv2.imwrite(path_for("depth_est", f"stage_{s}.jpg"),
                        colormap_jet(out[f"stage{s}_depth"][0]))
    if args.vis_mono:  # the last view's stage-4 features (MVS4Net.py:70-75)
        np.save(path_for("vis_mono", "_feat_stage4.npy"), out["stage4_feat"][:, -1])
    if args.vis_ETA:  # per-view epipolar attention (mvs4net_utils.py:1044-1046)
        from mvster_tpu_torch.utils.debug import attention_maps

        device = torch.device(args.device)
        group_dims = model_config_from_args(args).group_cor_dim
        for s in range(1, 5):
            feats = torch.from_numpy(out[f"stage{s}_feat"]).to(device)  # (1, V, h, w, C)
            projs = torch.from_numpy(out[f"stage{s}_proj"]).to(device)  # (1, V, 4, 4)
            maps = attention_maps(
                feats[:, 0], list(feats[:, 1:].unbind(1)), projs[:, 0],
                list(projs[:, 1:].unbind(1)),
                torch.from_numpy(out[f"stage{s}_hypo"]).to(device),
                group_dim=group_dims[s - 1],
            )
            np.save(path_for("vis_ETA", f"_stage{s}_attn.npy"), maps.cpu().numpy())
    if idx % 10 == 0:
        print(f"view {idx}/{total} written")


def fuse_scan(args, scan: str, device: torch.device | str) -> str:
    """Filter and fuse one scan's saved depth maps into a point cloud on
    `device`; writes the mask PNGs and the PLY, returns the PLY's path."""
    import cv2

    from mvster_tpu_torch.data.common import read_cam_file, read_image, read_pair_file
    from mvster_tpu_torch.data.pfm import read_pfm
    from mvster_tpu_torch.infer.fusion import fuse_scene
    from mvster_tpu_torch.infer.ply import write_ply

    scan_dir = os.path.join(args.outdir, scan)
    if args.dataset == "tanks":  # tanks scans live under the split's directory
        pair_path = os.path.join(args.testpath, args.split, scan, "pair.txt")
    else:  # general_eval, eth3d: testpath/<scan>/pair.txt
        pair_path = os.path.join(args.testpath, scan, "pair.txt")
    pair_data = read_pair_file(pair_path)

    depths, confs, intrinsics, extrinsics, images = {}, {}, {}, {}, {}
    for vid in sorted({v for ref, srcs in pair_data for v in [ref, *srcs]}):
        cam = read_cam_file(os.path.join(scan_dir, f"cams/{vid:08d}_cam.txt"))
        intrinsics[vid] = cam.intrinsics
        extrinsics[vid] = cam.extrinsics
        depths[vid] = read_pfm(os.path.join(scan_dir, f"depth_est/{vid:08d}.pfm"))[0]
        confs[vid] = read_pfm(os.path.join(scan_dir, f"confidence/{vid:08d}.pfm"))[0]
        images[vid] = read_image(os.path.join(scan_dir, f"images/{vid:08d}.jpg"))

    xyz, rgb, masks = fuse_scene(
        pair_data, depths, confs, intrinsics, extrinsics, images,
        conf_thresh=args.conf, thres_view=args.thres_view, device=device,
    )
    # per-view mask dumps, as the reference's mask/*_photo|geo|final.png
    mask_dir = os.path.join(scan_dir, "mask")
    os.makedirs(mask_dir, exist_ok=True)
    for vid, m in masks.items():
        for kind in ("photo", "geo", "final"):
            cv2.imwrite(os.path.join(mask_dir, f"{vid:08d}_{kind}.png"),
                        (m[kind] * 255).astype(np.uint8))
        print(f"{scan} view {vid:02d} photo/geo/final: "
              f"{m['photo'].mean():.3f}/{m['geo'].mean():.3f}/{m['final'].mean():.3f}")

    ply_name = f"mvsnet{int(scan[4:]):03d}_l3.ply" if scan.startswith("scan") else f"{scan}.ply"
    out_path = os.path.join(args.outdir, ply_name)
    write_ply(out_path, xyz, rgb)
    print(f"saved {len(xyz)} points to {out_path}")
    return out_path


def fusion_scan_list(args, testlist):
    """The scans to filter and fuse: the testlist, or for tanks and eth3d
    (whose inference runs the whole split) the split's scans."""
    if args.dataset == "tanks":
        from mvster_tpu_torch.data.tanks import ADVANCED, INTERMEDIATE

        return INTERMEDIATE if args.split == "intermediate" else ADVANCED
    if args.dataset == "eth3d":
        from mvster_tpu_torch.data.eth3d import TEST_SCANS

        return TEST_SCANS
    return testlist


def main(argv=None) -> dict[str, Any]:
    """Run the tool; returns its wall times in seconds: forward (the
    forwards alone), depth (forwards and writing the views), fusion per
    scan, metric (or None) and the number of views."""
    args = build_test_parser().parse_args(argv)
    if args.filter_method != "normal":
        # the reference declares --filter_method gipuma but ships no
        # implementation (test_mvs4.py:60)
        raise NotImplementedError(
            f"--filter_method {args.filter_method!r}: only 'normal' is "
            "implemented (the reference's gipuma path is unimplemented too)"
        )
    if args.use_raw_train:
        args.max_h, args.max_w = 1200, 1600
    if args.testlist != "all" and os.path.isfile(args.testlist):
        with open(args.testlist) as f:
            testlist = [ln.rstrip() for ln in f if ln.strip()]
    else:
        testlist = [args.testlist]

    device = resolve_device(args.device)
    # full float32 convolutions and matmuls, as the reference computes them
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    config = model_config_from_args(args)
    model = MVS4Net(config)
    model.load_state_dict(load_reference_ckpt(args.loadckpt, config), strict=True)
    model = model.to(device).eval()

    t0 = time.perf_counter()
    forward_s, views = save_depth(args, model, testlist)
    times: dict[str, Any] = {"forward": forward_s, "depth": time.perf_counter() - t0,
                             "views": views, "fusion": {}, "metric": None}
    print(f"avg time: {forward_s / max(views, 1):.4f} s/view on {device}")

    for scan in fusion_scan_list(args, testlist):
        t0 = time.perf_counter()
        fuse_scan(args, scan, device)
        times["fusion"][scan] = time.perf_counter() - t0

    if args.dataset.startswith("general") and args.dtu_gt_dir:
        from mvster_tpu_torch.eval.dtu_metric import evaluate_dtu

        t0 = time.perf_counter()
        scan_ids = [int(s[4:]) for s in testlist if s.startswith("scan")]
        summary = evaluate_dtu(args.outdir, args.dtu_gt_dir, scan_ids)
        times["metric"] = time.perf_counter() - t0
        print(json.dumps(summary, indent=2))
        with open(os.path.join(args.outdir, "dtu_metrics.json"), "w") as f:
            json.dump(summary, f, indent=2)
    return times


if __name__ == "__main__":
    main()
