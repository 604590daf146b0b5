from repro_torch.kernels.flash_attention.ops import (  # noqa: F401
    flash_attention, flash_attention_ref)
from repro_torch.kernels.flash_attention.flash_attention import (  # noqa: F401
    check_args, ensure_built, flash_attention_kernel, launch_count, plan,
    reset_launches)
