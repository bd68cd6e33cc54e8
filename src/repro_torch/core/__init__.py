"""repro_torch.core -- the Wilkins in situ workflow system (the paper's contribution).

Layers (paper Fig. 1):
  workflow driver   -> driver.Wilkins            (Wilkins-master)
  workflow graph    -> graph.WorkflowGraph       (data-centric YAML matching)
  execution         -> comm.TaskComm             (restricted worlds)
  data transport    -> channel.Channel           (flow control all/some/latest)
                       redistribute              (M->N planning + executors)
  data model / VOL  -> datamodel, vol, h5        (HDF5 data model + interception)
  fault tolerance   -> recovery.RunSupervisor    (policies, epochs, fault plan)
"""

from . import datamodel, h5, redistribute, scheduler
from .channel import (Channel, ChannelError, ChannelMux, ChannelStats,
                      ChannelTimeout, FlowControl, NO_DATA, PrefetchPool)
from .recovery import (FailurePolicy, FaultPlan, FaultSpec, InjectedFault,
                       RecoveryContext, RescaleError, RescaleEvent,
                       RescaleInterrupt, RescaleOp, RunSupervisor, StallEvent,
                       SupersededError, TaskState, edge_key, reshard_blocks)
from .scheduler import (DepthAutotuner, FairPolicy, FifoPolicy,
                        ResizableSemaphore, SchedulerConfig, SchedulerRuntime,
                        TelemetryTimeline)
from .comm import TaskComm, world
from .datamodel import BlockOwnership, Dataset, File, Group
from .driver import TaskFailure, Wilkins, WorkflowReport
from .graph import DsetSpec, Edge, Port, TaskSpec, WorkflowGraph
from .redistribute import (CompiledPlan, PlanCache, RedistSpec, plan_cache,
                           reset_plan_cache)
from .vol import VOL, current_vol

__all__ = [
    "datamodel",
    "h5",
    "redistribute",
    "scheduler",
    "PrefetchPool",
    "DepthAutotuner",
    "FairPolicy",
    "FifoPolicy",
    "ResizableSemaphore",
    "SchedulerConfig",
    "SchedulerRuntime",
    "TelemetryTimeline",
    "Channel",
    "ChannelError",
    "ChannelMux",
    "ChannelStats",
    "ChannelTimeout",
    "FlowControl",
    "NO_DATA",
    "FailurePolicy",
    "FaultPlan",
    "FaultSpec",
    "InjectedFault",
    "RecoveryContext",
    "RescaleError",
    "RescaleEvent",
    "RescaleInterrupt",
    "RescaleOp",
    "RunSupervisor",
    "StallEvent",
    "SupersededError",
    "TaskState",
    "edge_key",
    "reshard_blocks",
    "TaskComm",
    "world",
    "BlockOwnership",
    "Dataset",
    "File",
    "Group",
    "TaskFailure",
    "Wilkins",
    "WorkflowReport",
    "DsetSpec",
    "Edge",
    "Port",
    "TaskSpec",
    "WorkflowGraph",
    "CompiledPlan",
    "PlanCache",
    "RedistSpec",
    "plan_cache",
    "reset_plan_cache",
    "VOL",
    "current_vol",
]
