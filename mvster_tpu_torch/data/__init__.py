"""The port's data layer: numpy datasets and the batch loader (copies of mvster_tpu.data's)."""

from mvster_tpu_torch.data.loader import MVSLoader
from mvster_tpu_torch.data.pfm import read_pfm, write_pfm
from mvster_tpu_torch.data.registry import find_dataset_def, register_dataset

# register the datasets the port carries
from mvster_tpu_torch.data import blendedmvs, dtu, eth3d, general_eval, tanks  # noqa: F401,E402
