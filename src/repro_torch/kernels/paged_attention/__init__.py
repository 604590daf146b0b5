from repro_torch.kernels.paged_attention.ops import (  # noqa: F401
    paged_attention, paged_prefill_attention)
from repro_torch.kernels.paged_attention.paged_attention import (  # noqa: F401
    decode_splits, ensure_built, expected_visits, launch_counts,
    paged_attention_kernel, paged_prefill_attention_kernel, plan,
    reset_launches)
from repro_torch.kernels.paged_attention.quant import (  # noqa: F401
    CACHE_DTYPES, QUANT_SPECS, dequantize, is_quantized, pool_dtype,
    quantize)
from repro_torch.kernels.paged_attention.ref import (  # noqa: F401
    paged_attention_reference, paged_prefill_attention_reference)
