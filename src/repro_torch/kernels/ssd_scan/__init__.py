from repro_torch.kernels.ssd_scan.ops import ssd_scan, ssd_scan_ref  # noqa: F401
from repro_torch.kernels.ssd_scan.ssd_scan import (  # noqa: F401
    check_args, ensure_built, launch_count, reset_launches, smem_bytes,
    ssd_scan_kernel, sub_chunk)
