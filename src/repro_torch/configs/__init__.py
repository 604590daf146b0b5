"""Config registry: importing this package registers every architecture."""
from repro_torch.configs.base import (  # noqa: F401
    ArchConfig, ShapeConfig, SHAPES, SPEC_VERIFY_CHUNK, ASSIGNED_ARCHS,
    cell_supported, get_config, list_archs, reduced, register,
)

# Self-registering architecture modules.
from repro_torch.configs import qwen3_1_7b      # noqa: F401
from repro_torch.configs import tinyllama_1_1b  # noqa: F401
from repro_torch.configs import phi3_medium_14b  # noqa: F401
from repro_torch.configs import granite_20b     # noqa: F401
from repro_torch.configs import qwen3_moe_30b_a3b  # noqa: F401
from repro_torch.configs import qwen2_moe_a2_7b    # noqa: F401
from repro_torch.configs import paligemma_3b    # noqa: F401
from repro_torch.configs import hymba_1_5b      # noqa: F401
from repro_torch.configs import mamba2_1_3b     # noqa: F401
from repro_torch.configs import hubert_xlarge   # noqa: F401
from repro_torch.configs import paper_models    # noqa: F401
