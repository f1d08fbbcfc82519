"""Flags of the port's inference tool (counterpart of mvster_tpu.tools.cli).

The model flags are the JAX inference tool's (tools/cli.py add_model_args), mapped
onto the port's MVS4NetConfig; the test flags are the subset that the
port's inference tool runs (general_eval, depth maps only).
"""

from __future__ import annotations

import argparse

from mvster_tpu_torch.config import MVS4NetConfig


def _csv_ints(text: str):
    return tuple(int(x) for x in text.split(",") if x)


def _csv_floats(text: str):
    return tuple(float(x) for x in text.split(",") if x)


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
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda when available, else cpu)")
    add_model_args(p)
    return p
