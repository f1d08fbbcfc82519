"""Inference tool: depth and confidence maps per reference view (counterpart of mvster_tpu.tools.test).

`infer_views` is the forward/drain loop of the JAX inference tool's save_depth:
reference views in chunks of eval_batch (the trailing chunk padded with
its last view, so every forward has one shape), one eval forward per
chunk, results copied to the host.  It imports nothing beyond torch and
numpy.  Unlike the JAX inference tool it does not dispatch the next chunk before
draining the current one.

`main` is the `--dataset general_eval` command line: it writes
depth_est/*.pfm, confidence/*.pfm, cams/*_cam.txt and images/*.jpg per scan
in the JAX inference tool's layout (without its ply_local dumps).  Point-cloud
fusion and the DTU metric are not ported yet, so it writes depth maps only.

  python -m mvster_tpu_torch.tools.test --testpath $DTU_TEST \\
      --testlist lists/dtu/test.txt --loadckpt model.ckpt \\
      --interval_scale 1.06 --group_cor --attn_temp 2 --inverse_depth
"""

from __future__ import annotations

import os
import time
from typing import Any, Iterable, Iterator

import numpy as np
import torch

from mvster_tpu_torch.models.mvs4net import MVS4Net
from mvster_tpu_torch.tools.cli import build_test_parser, model_config_from_args
from mvster_tpu_torch.tools.weights import load_reference_ckpt


def _forward_chunk(model, chunk, eval_batch, device):
    real = len(chunk)
    padded = chunk + [chunk[-1]] * (eval_batch - real)
    imgs = torch.from_numpy(np.stack([s["imgs"] for s in padded])).to(device)
    projs = {
        k: torch.from_numpy(np.stack([s["proj_matrices"][k] for s in padded])).to(device)
        for k in padded[0]["proj_matrices"]
    }
    dv = torch.from_numpy(np.stack([s["depth_values"] for s in padded])).to(device)
    t0 = time.perf_counter()
    with torch.inference_mode():
        out = model(imgs, projs, dv)
        result = {"depth": out["depth"], "confidence": out["photometric_confidence"]}
        for s in range(1, 5):
            result[f"stage{s}_depth"] = out[f"stage{s}"]["depth"]
            result[f"stage{s}_conf"] = out[f"stage{s}"]["photometric_confidence"]
        result = {k: v.cpu().numpy() for k, v in result.items()}  # waits
    seconds = time.perf_counter() - t0
    for i in range(real):
        view = {k: v[i:i + 1] for k, v in result.items()}
        view["seconds"] = seconds
        view["chunk_views"] = real
        yield chunk[i], view


def infer_views(model: MVS4Net, samples: Iterable[dict], eval_batch: int = 1
                ) -> Iterator[tuple[dict, dict[str, Any]]]:
    """Run the eval forward over reference views; yield (sample, result).

    samples: dicts with imgs (V, H, W, 3), proj_matrices {stage: (V, 2, 4, 4)}
    and depth_values (K,), all of one shape.  result: numpy depth and
    confidence (1, H, W), stage{s}_depth / stage{s}_conf, and `seconds`,
    the wall time of the forward that produced the view (with the copy
    back to the host), shared by the `chunk_views` views of its chunk.
    """
    eval_batch = max(1, eval_batch)
    device = next(model.parameters()).device
    chunk: list[dict] = []
    for sample in samples:
        chunk.append(sample)
        if len(chunk) == eval_batch:
            yield from _forward_chunk(model, chunk, eval_batch, device)
            chunk = []
    if chunk:
        yield from _forward_chunk(model, chunk, eval_batch, device)


def _write_view_outputs(args, sample, out):
    """One reference view's PFMs, cam file and image, in the JAX inference tool's layout."""
    import cv2

    from mvster_tpu.data.common import write_cam_file
    from mvster_tpu.data.pfm import write_pfm

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


def main(argv=None):
    args = build_test_parser().parse_args(argv)
    # the data loaders need PIL (and cv2 for resizes); imported here so the
    # rest of the port runs without them
    from mvster_tpu.data import find_dataset_def

    if args.use_raw_train:
        args.max_h, args.max_w = 1200, 1600
    if args.testlist != "all" and os.path.isfile(args.testlist):
        with open(args.testlist) as f:
            testlist = [ln.rstrip() for ln in f if ln.strip()]
    else:
        testlist = [args.testlist]

    device = torch.device(args.device or ("cuda" if torch.cuda.is_available() else "cpu"))
    # full float32 convolutions, as the reference computes them
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    config = model_config_from_args(args)
    model = MVS4Net(config)
    model.load_state_dict(load_reference_ckpt(args.loadckpt, config), strict=True)
    model = model.to(device).eval()

    dataset_cls = find_dataset_def(args.dataset)
    total_time, total_views = 0.0, 0
    for scan in testlist:
        dataset = dataset_cls(
            args.testpath, [scan], "test", args.num_view, args.interval_scale,
            max_h=args.max_h, max_w=args.max_w,
        )
        samples = (dataset[i] for i in range(len(dataset)))
        for idx, (sample, out) in enumerate(infer_views(model, samples, args.eval_batch)):
            total_time += out["seconds"] / out["chunk_views"]
            total_views += 1
            _write_view_outputs(args, sample, out)
            if idx % 10 == 0:
                print(f"view {idx}/{len(dataset)} written")
    print(f"avg time: {total_time / max(total_views, 1):.4f} s/view on {device}")


if __name__ == "__main__":
    main()
