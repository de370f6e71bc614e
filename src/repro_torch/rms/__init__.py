"""What ``LocalRMS`` and ``ReconfigPolicy.decide`` need of the reference's
resource manager (``repro.rms``), copied: the job and cluster models, the
policy, its reason codes and ``MAX_PRIORITY``. The reference's simulator,
scheduler and workloads are not part of the port."""
from repro_torch.rms.cluster import Cluster
from repro_torch.rms.job import Job, JobState
from repro_torch.rms.policy import PolicyConfig, ReconfigPolicy, factor_sizes
from repro_torch.rms.scheduler import MAX_PRIORITY

__all__ = ["Cluster", "Job", "JobState", "MAX_PRIORITY", "PolicyConfig",
           "ReconfigPolicy", "factor_sizes"]
