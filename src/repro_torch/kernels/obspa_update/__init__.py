from repro_torch.kernels.obspa_update.obspa_update import (  # noqa: F401
    BLOCK, check_args, ensure_built, inblock_sweep_kernel, launch_count, plan,
    reset_launches)
from repro_torch.kernels.obspa_update.ops import (  # noqa: F401
    inblock_sweep, obspa_sweep, obspa_sweep_batched, sweep_oracle)
from repro_torch.kernels.obspa_update.ref import (  # noqa: F401
    inblock_sweep_plain, sweep_numpy, sweep_plain)
