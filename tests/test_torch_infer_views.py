"""tools/test.infer_views' dispatch-ahead, on the CPU.

A wrapper of the model records the order of its forwards and of the views
that the consumer takes: with eval_batch 1 and 2 over 3 samples, chunk
i+1's forward runs before chunk i's first view is yielded.  The views,
their order and the padded trailing chunk are bitwise those of one
model(...) call per chunk in sequence, with return_debug too.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from torch import nn

CFG = dict(group_cor=True, group_cor_dim=(4, 4, 4, 4), inverse_depth=True,
           fpn_base_channel=4, reg_channel=4, attn_temp=2.0)
N_SAMPLES = 3


class _Recording(nn.Module):
    """The model, with each forward's number appended to `log`."""

    def __init__(self, model, log):
        super().__init__()
        self.model = model
        self.log = log

    def forward(self, *args, **kwargs):
        self.log.append(("forward", sum(kind == "forward" for kind, _ in self.log)))
        return self.model(*args, **kwargs)


def _model():
    from mvster_tpu_torch.models.mvs4net import MVS4Net, MVS4NetConfig
    from mvster_tpu_torch.tools.weights import random_state_dict

    model = MVS4Net(MVS4NetConfig(**CFG)).eval()
    model.load_state_dict(random_state_dict(model, seed=0), strict=True)
    return model


def _samples():
    from helpers import plane_scene_sample

    out = []
    for seed in range(N_SAMPLES):
        s = plane_scene_sample(seed)
        out.append({"imgs": s["imgs"][0], "depth_values": s["depth_values"][0],
                    "proj_matrices": {k: v[0] for k, v in s["proj_matrices"].items()}})
    return out


def _sequential(model, samples, eval_batch, return_debug):
    """One model(...) call per chunk, in order: each real view's outputs."""
    views = []
    for start in range(0, len(samples), eval_batch):
        chunk = samples[start:start + eval_batch]
        padded = chunk + [chunk[-1]] * (eval_batch - len(chunk))
        stack = lambda xs: torch.from_numpy(np.stack(xs))  # noqa: E731
        with torch.inference_mode():
            out = model(stack([s["imgs"] for s in padded]),
                        {k: stack([s["proj_matrices"][k] for s in padded])
                         for k in padded[0]["proj_matrices"]},
                        stack([s["depth_values"] for s in padded]), return_debug=return_debug)
        want = {"depth": out["depth"], "confidence": out["photometric_confidence"]}
        for s in range(1, 5):
            st = out[f"stage{s}"]
            want[f"stage{s}_depth"] = st["depth"]
            want[f"stage{s}_conf"] = st["photometric_confidence"]
            if return_debug:
                want[f"stage{s}_feat"] = st["debug_features"]
                want[f"stage{s}_proj"] = st["debug_proj"]
                want[f"stage{s}_hypo"] = st["hypo_depth"]
        for i in range(len(chunk)):
            views.append({k: v[i:i + 1].numpy() for k, v in want.items()})
    return views


@pytest.mark.parametrize("eval_batch", [1, 2])
def test_next_chunk_is_launched_before_the_current_chunk_is_yielded(eval_batch):
    from mvster_tpu_torch.tools.test import infer_views

    log = []
    samples = _samples()
    for sample, _ in infer_views(_Recording(_model(), log), samples, eval_batch):
        log.append(("yield", next(i for i, s in enumerate(samples) if s is sample)))
    chunks = -(-N_SAMPLES // eval_batch)
    assert [i for kind, i in log if kind == "forward"] == list(range(chunks))
    assert [i for kind, i in log if kind == "yield"] == list(range(N_SAMPLES))
    for c in range(chunks - 1):
        assert log.index(("forward", c + 1)) < log.index(("yield", c * eval_batch)), log
    if eval_batch == 1:
        assert log == [("forward", 0), ("forward", 1), ("yield", 0), ("forward", 2),
                       ("yield", 1), ("yield", 2)]


@pytest.mark.parametrize("return_debug", [False, True])
@pytest.mark.parametrize("eval_batch", [1, 2])
def test_views_are_bitwise_those_of_sequential_calls(eval_batch, return_debug):
    from mvster_tpu_torch.tools.test import infer_views

    model, samples = _model(), _samples()
    want = _sequential(model, samples, eval_batch, return_debug)
    got = list(infer_views(model, samples, eval_batch, return_debug=return_debug))
    assert [s for s, _ in got] == samples and all(a is b for (a, _), b in zip(got, samples))
    assert len(got) == len(want) == N_SAMPLES
    for i, ((_, res), ref) in enumerate(zip(got, want)):
        assert res["chunk_views"] == min(eval_batch, N_SAMPLES - i // eval_batch * eval_batch)
        assert res["seconds"] > 0
        assert set(res) == set(ref) | {"seconds", "chunk_views"}
        for key, v in ref.items():
            np.testing.assert_array_equal(res[key], v, err_msg=f"view {i} {key}")
