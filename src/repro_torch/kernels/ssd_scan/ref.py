"""The plain PyTorch version of the Mamba-2 SSD chunked scan.

Re-exports the model's implementation, as the reference's ``ref.py`` does,
so that the kernel's oracle and the model's plain path have one source.
"""
from repro_torch.models.ssm import ssd_reference  # noqa: F401
