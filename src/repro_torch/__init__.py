"""PyTorch/CUDA port of the serverless analytics system (``repro``).

The control plane (decision workflows, controllers), the serverless
function runtime with its shuffle store, and the columnar analytics data
plane, with the partition kernels written by hand in CUDA for Hopper
(``repro_torch.kernels``). It imports ``torch``, numpy and the standard
library only.
"""

from repro_torch.device import NoDeviceError, resolve_device  # noqa: F401
