from repro_torch.serve.cluster import (  # noqa: F401
    Cluster, ClusterConfig, Replica)
from repro_torch.serve.engine import (  # noqa: F401
    AuditViolation, Engine, EngineOverloaded, FinishedRequest,
    SequenceHandoff, ServeConfig)
from repro_torch.serve.faults import (  # noqa: F401
    CrashError, Fault, FaultError, FaultInjector)
from repro_torch.serve.kv_cache import (  # noqa: F401
    BlockAllocator, OutOfBlocks, PagedCache)
from repro_torch.serve.scheduler import (  # noqa: F401
    FCFSScheduler, Request, RequestState, StepPlan)
from repro_torch.serve.snapshot import (  # noqa: F401
    adopt_requests, capture_requests, load as load_snapshot, restore_engine,
    restore_into, save_snapshot)
