"""repro_torch.ps — the multi-tenant parameter-server subsystem.

One shared cluster, J concurrent training jobs, ONE device-resident
decision path: per-job lag windows live stacked in a (J, lag+1, n_pad)
ring (mixed worker widths ride the same stack through per-job width
masks), and every tick replays a single captured observe+decide graph a
bucket instead of J controllers' launches.
"""
from repro_torch.ps.scheduler import (JobView, PriorityScheduler,
                                      RoundRobinScheduler,
                                      ShortestStepScheduler, job_views,
                                      make_scheduler)
from repro_torch.ps.server import JobHandle, JobRegistry, PSJob, PSServer

__all__ = [
    "JobHandle", "JobRegistry", "PSJob", "PSServer",
    "JobView", "RoundRobinScheduler", "PriorityScheduler",
    "ShortestStepScheduler", "job_views", "make_scheduler",
]
