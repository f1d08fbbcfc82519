"""String-keyed dataset registry (the port's copy of mvster_tpu.data.registry).

Datasets register under their own names and the reference's aliases
(import side effects are in mvster_tpu_torch.data.__init__).
"""

from __future__ import annotations

_REGISTRY: dict[str, type] = {}


def register_dataset(*names):
    def deco(cls):
        for name in names:
            _REGISTRY[name] = cls
        return cls
    return deco


def find_dataset_def(name: str):
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown dataset {name!r}; registered: {sorted(_REGISTRY)}"
        ) from None
