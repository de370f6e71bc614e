"""RMS: Slurm-analogue resource manager (cluster, policy, scheduler, sim),
the port's copy of ``repro.rms``: host code, whose one device input is the
reconfiguration cost model that :mod:`repro_torch.calib` fits on the card."""
from repro_torch.rms.capacity import (CHURN_SCENARIOS, CapacityConfig,
                                      CapacityManager, churn_schedule,
                                      plan_drain)
from repro_torch.rms.cluster import Cluster
from repro_torch.rms.costmodel import (PAPER_APPS, AppModel,
                                       ReconfigCostModel, lm_app_model)
from repro_torch.rms.engine import (CheckpointTick, Event, ExpandTimeout,
                                    JobFinish, JobSubmit, NodeDrain,
                                    NodeFail, NodeJoin, NodePowerOff,
                                    NodePowerOn, PhaseChange, ReconfigPoint,
                                    SimulationEngine, StragglerOnset,
                                    StragglerScan, TrafficTick)
from repro_torch.rms.job import Job, JobPhase, JobState
from repro_torch.rms.policy import PolicyConfig, ReconfigPolicy, factor_sizes
from repro_torch.rms.scheduler import (MAX_PRIORITY, POLICY_REGISTRY,
                                       FairSharePolicy, MoldableStartPolicy,
                                       PreemptiveBackfillPolicy, Scheduler,
                                       SchedulerConfig, SchedulingPolicy,
                                       SJFPolicy, make_policy,
                                       register_policy)
from repro_torch.rms.simulator import (ActionRecord, ClusterSimulator,
                                       SimConfig, SimReport)

__all__ = ["Cluster", "PAPER_APPS", "AppModel", "ReconfigCostModel",
           "lm_app_model", "Job", "JobPhase", "JobState", "PolicyConfig",
           "ReconfigPolicy", "factor_sizes", "MAX_PRIORITY", "Scheduler",
           "SchedulerConfig", "SchedulingPolicy", "POLICY_REGISTRY",
           "SJFPolicy", "FairSharePolicy", "PreemptiveBackfillPolicy",
           "MoldableStartPolicy",
           "make_policy", "register_policy", "ActionRecord",
           "ClusterSimulator", "SimConfig", "SimReport",
           "SimulationEngine", "Event", "JobSubmit", "JobFinish",
           "ReconfigPoint", "ExpandTimeout", "NodeFail", "PhaseChange",
           "StragglerOnset", "StragglerScan", "CheckpointTick",
           "TrafficTick",
           "NodeJoin", "NodeDrain", "NodePowerOff", "NodePowerOn",
           "CapacityConfig", "CapacityManager", "CHURN_SCENARIOS",
           "churn_schedule", "plan_drain"]
