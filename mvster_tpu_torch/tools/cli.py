"""Flags of the port's inference and training tools (counterpart of mvster_tpu.tools.cli).

The model flags are the JAX package's (add_model_args), mapped onto the
port's MVS4NetConfig; the test flags are the subset that the port's
inference tool runs (general_eval, depth maps only); the train flags are
the JAX training tool's for one process on one device.  Both tools take
--device, default cuda, and raise without a card unless given --device cpu.
"""

from __future__ import annotations

import argparse

import torch

from mvster_tpu_torch.config import MVS4NetConfig


def _csv_ints(text: str):
    return tuple(int(x) for x in text.split(",") if x)


def _csv_floats(text: str):
    return tuple(float(x) for x in text.split(",") if x)


def add_device_arg(p: argparse.ArgumentParser):
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the kernels' "
                        "plain versions)")


def resolve_device(name: str) -> torch.device:
    """The device to run on; raises for a CUDA device when there is no card,
    so an entry point never falls back to the CPU unasked."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"--device {name}: no CUDA device is available; the port runs on "
            "an NVIDIA GPU (pass --device cpu to run on the CPU)"
        )
    return device


def add_model_args(p: argparse.ArgumentParser):
    p.add_argument("--arch_mode", default="fpn", choices=["fpn", "convnext", "convnext4"])
    p.add_argument("--reg_mode", default="reg2d", choices=["reg2d", "reg3d"])
    p.add_argument("--fpn_base_channel", type=int, default=8)
    p.add_argument("--reg_channel", type=int, default=8)
    p.add_argument("--ndepths", type=str, default="8,8,4,4")
    p.add_argument("--depth_inter_r", type=str, default="0.5,0.5,0.5,1")
    p.add_argument("--group_cor", action="store_true")
    p.add_argument("--group_cor_dim", type=str, default="8,8,4,4")
    p.add_argument("--inverse_depth", action="store_true")
    p.add_argument("--agg_type", default="ConvBnReLU3D")
    p.add_argument("--dcn", action="store_true")
    p.add_argument("--pos_enc", type=int, default=0)
    p.add_argument("--mono", action="store_true")
    p.add_argument("--ASFF", action="store_true")
    p.add_argument("--attn_temp", type=float, default=2.0)
    p.add_argument("--compute_dtype", default="float32", choices=["float32", "bfloat16"])


def model_config_from_args(args) -> MVS4NetConfig:
    return MVS4NetConfig(
        arch_mode=args.arch_mode,
        reg_net=args.reg_mode,
        fpn_base_channel=args.fpn_base_channel,
        reg_channel=args.reg_channel,
        stage_splits=_csv_ints(args.ndepths),
        depth_interals_ratio=_csv_floats(args.depth_inter_r),
        group_cor=args.group_cor,
        group_cor_dim=_csv_ints(args.group_cor_dim),
        inverse_depth=args.inverse_depth,
        agg_type=args.agg_type,
        dcn=args.dcn,
        pos_enc=args.pos_enc,
        mono=args.mono,
        asff=args.ASFF,
        attn_temp=args.attn_temp,
        compute_dtype=args.compute_dtype,
    )


def build_test_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="mvster_tpu_torch inference tool: writes depth and "
                    "confidence maps (PFM), cams and images per reference "
                    "view.  It writes depth maps only: point-cloud fusion "
                    "and the DTU metric are not ported yet.",
    )
    p.add_argument("--dataset", default="general_eval", choices=["general_eval"])
    p.add_argument("--testpath", required=True)
    p.add_argument("--testlist", required=True,
                   help="a scan name, or a file listing one scan per line")
    p.add_argument("--loadckpt", required=True,
                   help="reference MVSTER .ckpt or a saved state dict")
    p.add_argument("--outdir", default="./outputs")
    p.add_argument("--interval_scale", type=float, default=1.06)
    p.add_argument("--num_view", type=int, default=5)
    p.add_argument("--eval_batch", type=int, default=1,
                   help="reference views per forward")
    p.add_argument("--max_h", type=int, default=864)
    p.add_argument("--max_w", type=int, default=1152)
    p.add_argument("--use_raw_train", action="store_true")
    add_device_arg(p)
    add_model_args(p)
    return p


def loss_kwargs_from_args(args, mono: bool) -> dict:
    return dict(
        stage_lw=_csv_floats(args.dlossw),
        l1ot_lw=_csv_floats(args.l1ce_lw),
        inverse_depth=args.inverse_depth,
        ot_iter=args.ot_iter,
        ot_eps=args.ot_eps,
        ot_continous=args.ot_continous,
        ot_backend=args.ot_backend,
        mono=mono,
    )


def build_train_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="mvster_tpu_torch training tool: one process on one "
                    "device (DTU; data parallelism is not ported yet)",
    )
    p.add_argument("--mode", default="train", choices=["train", "profile"],
                   help="profile: a torch.profiler trace of 3 train steps")
    p.add_argument("--dataset", default="dtu", choices=["dtu", "dtu_yao4"])
    p.add_argument("--trainpath", required=True)
    p.add_argument("--testpath", default=None)
    p.add_argument("--trainlist", required=True)
    p.add_argument("--testlist", required=True)
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--lr", type=float, default=0.001)
    p.add_argument("--lrepochs", type=str, default="6,8,9:2")
    p.add_argument("--lr_scheduler", default="MS", choices=["MS", "cos", "onecycle"])
    p.add_argument("--wd", type=float, default=0.0)
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--interval_scale", type=float, default=1.06)
    p.add_argument("--loadckpt", default=None,
                   help="initial weights: a reference MVSTER .ckpt or a saved state dict")
    p.add_argument("--logdir", default="./checkpoints/debug")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--summary_freq", type=int, default=100)
    p.add_argument("--save_freq", type=int, default=1)
    p.add_argument("--eval_freq", type=int, default=1)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--nviews", type=int, default=5)
    p.add_argument("--dlossw", type=str, default="1,1,1,1")
    p.add_argument("--l1ce_lw", type=str, default="0,1")
    p.add_argument("--ot_continous", action="store_true")
    p.add_argument("--ot_iter", type=int, default=10)
    p.add_argument("--ot_eps", type=float, default=1)
    p.add_argument("--ot_backend", default="xla", choices=["xla", "pallas"],
                   help="pallas needs the fused Sinkhorn kernels, not ported "
                        "yet: it raises")
    p.add_argument("--rt", action="store_true")
    p.add_argument("--grad_accum", type=int, default=1,
                   help="split each batch into N microbatches, accumulate "
                        "gradients, apply one optimizer update")
    p.add_argument("--use_raw_train", action="store_true")
    p.add_argument("--num_workers", type=int, default=0,
                   help="decode samples in N worker processes (0 = in-process)")
    add_device_arg(p)
    add_model_args(p)
    return p
