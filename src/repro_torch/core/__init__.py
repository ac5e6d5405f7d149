"""Data diffusion core: the paper's contribution as composable components.

Public API:
  Cache / eviction policies ............. core.cache
  Stores + bandwidth model .............. core.store
  Centralized & local indices ........... core.index
  Tasks / executor states ............... core.task
  Generic dispatch engine (5 policies) .. core.dispatch
  Data-aware scheduler (Task adapter) ... core.scheduler
  Dynamic resource provisioner .......... core.provisioner
  Abstract model (Section 4) ............ core.model
  Workload generators ................... core.workload
  Discrete-event simulator .............. core.simulator
"""

from .cache import Cache, CacheStats, EVICTION_POLICIES
from .dispatch import DataAwareDispatcher
from .index import (
    CacheLocationIndex,
    CentralizedIndex,
    CoherenceBus,
    HashRing,
    IndexShard,
    LocalIndex,
    ShardedIndex,
)
from .model import (
    ModelInputs,
    average_overhead_time,
    computational_intensity,
    efficiency,
    efficiency_bound_holds,
    optimize_resources,
    predict_wet_ramp,
    speedup,
    workload_execution_time,
    workload_execution_time_with_overheads,
    working_set_fits,
    zeta,
)
from .provisioner import ALLOCATION_POLICIES, DynamicResourceProvisioner, ProvisionRequest
from .scheduler import POLICIES, DataAwareScheduler, SchedulerStats
from .simulator import (
    HardwareProfile,
    SimConfig,
    SimResult,
    Simulator,
    run_experiment,
    teragrid_profile,
    tpu_pod_profile,
)
from .store import (
    BandwidthResource,
    DataObject,
    PersistentStore,
    TransientStore,
    copy_time,
    eta,
)
from .task import ExecutorState, Task, TaskState
from .workload import (
    Workload,
    locality_workload,
    paper_ramp_rates,
    provisioning_workload,
    scheduler_microbench_workload,
)

__all__ = [
    "Cache", "CacheStats", "EVICTION_POLICIES",
    "CacheLocationIndex", "CentralizedIndex", "CoherenceBus", "HashRing",
    "IndexShard", "LocalIndex", "ShardedIndex",
    "ModelInputs", "average_overhead_time", "computational_intensity",
    "efficiency", "efficiency_bound_holds", "optimize_resources",
    "predict_wet_ramp", "speedup", "workload_execution_time",
    "workload_execution_time_with_overheads", "working_set_fits", "zeta",
    "ALLOCATION_POLICIES", "DynamicResourceProvisioner", "ProvisionRequest",
    "POLICIES", "DataAwareDispatcher", "DataAwareScheduler", "SchedulerStats",
    "HardwareProfile", "SimConfig", "SimResult", "Simulator",
    "run_experiment", "teragrid_profile", "tpu_pod_profile",
    "BandwidthResource", "DataObject", "PersistentStore", "TransientStore",
    "copy_time", "eta",
    "ExecutorState", "Task", "TaskState",
    "Workload", "locality_workload", "paper_ramp_rates",
    "provisioning_workload", "scheduler_microbench_workload",
]
