from repro_torch.flow.daemon import (DaemonConfig, DaemonStats,
                                     LoadShedError, PlannerHTTPServer,
                                     PlannerService, PoolSpec)
from repro_torch.flow.executor import (FlowConfig, FlowResult, FlowRunner,
                                       MultiTenantRunner, TenantRecord)
from repro_torch.flow.streaming import (SLA_BEST_EFFORT, SLA_CLASSES,
                                        SLA_GUARANTEED, SLA_STANDARD,
                                        StreamConfig, StreamingRunner,
                                        StreamRecord, TenantRequest,
                                        deadline_hit_rate)

__all__ = [
    "DaemonConfig", "DaemonStats", "LoadShedError", "PlannerHTTPServer",
    "PlannerService", "PoolSpec",
    "FlowConfig", "FlowResult", "FlowRunner", "MultiTenantRunner",
    "TenantRecord", "SLA_BEST_EFFORT", "SLA_CLASSES", "SLA_GUARANTEED",
    "SLA_STANDARD", "StreamConfig", "StreamingRunner", "StreamRecord",
    "TenantRequest", "deadline_hit_rate",
]
