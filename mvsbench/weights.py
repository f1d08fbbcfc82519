"""Seeded weights, made on the device in two draws.

Every weight and buffer that the cell's reference lists (its
`state_shapes`), from one normal and one uniform draw of a torch.Generator on the device, cut into
leaves: convolution kernels He-normal over their fan-in (a transposed
kernel's fan-in over (in, *k)), the logit heads `reg.*.prob` ten times
that, so the softmax over depth is decisive; BatchNorm scales and running
variances uniform in [0.5, 1.5]; biases, shifts and running means 0.1
times a normal; the BatchNorm step counters 0.  The same dict goes to the
system under test (which loads it strictly) and to the reference.
"""

from __future__ import annotations

import math

import torch

PROB_GAIN = 10.0


def seeded_state_dict(shapes: dict, seed: int, device) -> dict[str, torch.Tensor]:
    gen = torch.Generator(device=device).manual_seed(seed)
    sizes = {k: math.prod(s) for k, s in shapes.items()}
    total = sum(sizes.values())
    normal = torch.randn(total, generator=gen, device=device)
    uniform = torch.rand(total, generator=gen, device=device)
    out, at = {}, 0
    for key, shape in shapes.items():
        n, leaf = sizes[key], key.rsplit(".", 1)[-1]
        z, u = normal[at:at + n].reshape(shape), uniform[at:at + n].reshape(shape)
        at += n
        if leaf == "num_batches_tracked":
            out[key] = torch.zeros((), dtype=torch.long, device=device)
        elif leaf == "weight" and len(shape) > 1:
            transposed = key.startswith("reg.") and key.endswith((
                ".conv7.0.weight", ".conv9.0.weight", ".conv11.0.weight"))
            fan_in = math.prod(shape) // (shape[1] if transposed else shape[0])
            gain = PROB_GAIN if ".prob." in key else 1.0
            out[key] = z * (gain * math.sqrt(2.0 / fan_in))
        elif leaf in ("weight", "running_var"):
            out[key] = 0.5 + u
        else:
            out[key] = 0.1 * z
    return out
