"""The DTU point-cloud benchmark (counterpart of mvster_tpu.eval)."""

from mvster_tpu_torch.eval.dtu_metric import (
    aggregate_stats,
    evaluate_scan,
    nn_distances,
    reduce_points,
)

__all__ = ["aggregate_stats", "evaluate_scan", "nn_distances", "reduce_points"]
