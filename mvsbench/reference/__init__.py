"""The plain PyTorch references that decide `correct`; each imports torch alone.

A configuration names its reference by a top-level `"reference": "<name>"`,
the module `mvsbench/reference/<name>.py`; without the key it is `model`.
A reference module provides:

  MODEL_KEYS  {key: None or value}: every key of the configuration's
              `model` that it reads (None: any value), and those it pins
              to the one value it computes (the key has to be there, at
              that value).  A configuration with another key, or a pinned
              key at another value, is refused by cells.Cell.
  config(model)  the settings it computes from the configuration's
              `model`: an object with `fpn_base`, `ndepths` and
              `group_cor_dim` (read by work.stage_shapes) and `lower`
              (None, or "tf32" for the control: every convolution from
              TF32 operands).
  state_shapes(cfg)  {key: shape} of every weight and buffer, in the port's
              state-dict grammar; weights.seeded_state_dict fills them.
  forward(sd, cfg, imgs, projs, depth_values, train=False, stage_depths=None)
              -> ({stage: {depth, confidence, hypo, attn}}, {stage: mono
              depth}), as `model.forward` documents them.

The losses and the Adam steps (`losses.py`) are shared: they take a
reference's `forward`.  A new reference may import and extend `model`.
"""
