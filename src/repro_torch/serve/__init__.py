from repro_torch.serve.engine import (  # noqa: F401
    Engine, FinishedRequest, ServeConfig)
from repro_torch.serve.kv_cache import (  # noqa: F401
    BlockAllocator, OutOfBlocks, PagedCache)
from repro_torch.serve.scheduler import (  # noqa: F401
    FCFSScheduler, Request, RequestState, StepPlan)
