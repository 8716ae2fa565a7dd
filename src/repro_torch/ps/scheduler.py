"""Admission/ordering policies for the multi-tenant parameter server.

A copy of ``repro.ps.scheduler`` (numpy only), kept in the port so that it
never imports the JAX package; the same views give the same orders.

Which jobs' gradients does the shared cluster service this tick?  A
policy sees lightweight job views and returns an ordered service list of
at most ``capacity`` job ids.  Chen et al. and Dutta et al. frame
straggler mitigation as a per-job error–runtime trade-off; on a shared
cluster the scheduler is where those trade-offs meet.

Contracts the reference's property tests pin down
(tests/test_ps_scheduler.py; tests/test_torch_ps.py holds the copy's
orders against the reference's):

  * ``RoundRobinScheduler`` — starvation-free: with J jobs at equal
    priority and capacity c, per-job service counts over ANY window of
    J*k ticks differ by at most 1.
  * ``PriorityScheduler`` — deterministic in (priority, job_id) only:
    the service order is invariant under permutation of job insertion
    order (ties break on job_id, never on admission order).
  * ``ShortestStepScheduler`` — shortest-predicted-step-first, ranked by
    the DMM's posterior-predictive E[x_(c)] step time fetched lazily from
    the server (jobs without a prediction yet sort first — they need
    service to warm up).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence


@dataclass(frozen=True)
class JobView:
    """What a policy is allowed to see about a job."""
    job_id: str
    priority: float
    admit_order: int
    predicted_iter: Optional[Callable[[], Optional[float]]] = None


def _capacity(views: Sequence[JobView], capacity: Optional[int]) -> int:
    if capacity is None:
        return len(views)
    return max(0, min(int(capacity), len(views)))


class RoundRobinScheduler:
    """Cyclic, starvation-free service order at equal priorities.

    The ring is the admission order; each tick serves the next
    ``capacity`` jobs, so the service sequence is one consecutive run of
    the cyclic job sequence — which is what makes the fairness bound
    exact.

    The resume point is tracked as the ADMIT ORDER of the last job
    served, never as an index into the ring: admits and evicts change the
    ring's length, and an index cursor would silently land on a
    different job after any membership change (serving someone twice and
    skipping someone else, which breaks the fairness bound the property
    tests pin).  Admit orders are unique and monotone, so "the first
    ring entry admitted after the last one served (wrapping)" is
    well-defined no matter who joined or left in between — an evicted
    resume point degrades to its cyclic successor.
    """

    def __init__(self):
        self._last: Optional[int] = None    # admit_order of last served

    def order(self, views: Sequence[JobView],
              capacity: Optional[int] = None) -> List[str]:
        ring = sorted(views, key=lambda v: v.admit_order)
        cap = _capacity(ring, capacity)
        if cap == 0:
            return []
        m = len(ring)
        start = 0
        if self._last is not None:
            start = next((i for i, v in enumerate(ring)
                          if v.admit_order > self._last), 0)
        picks = [ring[(start + i) % m] for i in range(cap)]
        self._last = picks[-1].admit_order
        return [v.job_id for v in picks]


class PriorityScheduler:
    """Strict priority: highest first, ties broken by job_id (stable
    under any permutation of admission order — deliberately NOT
    admit_order, which would make the policy depend on arrival history).
    Low-priority jobs CAN starve under capacity pressure; that is the
    policy, not a bug."""

    def order(self, views: Sequence[JobView],
              capacity: Optional[int] = None) -> List[str]:
        ranked = sorted(views, key=lambda v: (-v.priority, v.job_id))
        return [v.job_id for v in ranked[:_capacity(views, capacity)]]


class ShortestStepScheduler:
    """Shortest-predicted-step-first (SPSF) with bounded starvation.

    Ranks by the DMM's posterior-predictive E[x_(c)] for each job's next
    step — the same quantity the fused decision already computed, fetched
    lazily (one scalar per job).  Serving predicted-fast jobs first packs
    more completed steps into a tick budget when the cluster cannot
    service everyone.

    Two classes of job jump the queue: jobs without a prediction (cold,
    or in the Elfving fallback — they need service to warm up), and jobs
    unserviced for ``max_starve`` consecutive ticks.  The latter matters
    because an unserviced job's prediction can NEVER refresh (predictions
    are made at service time): without aging, the job whose last decision
    predicted the slowest step would be excluded forever even after the
    cluster regime that made it slow has passed.
    """

    def __init__(self, max_starve: int = 16):
        self.max_starve = max_starve
        self._age: dict = {}

    def order(self, views: Sequence[JobView],
              capacity: Optional[int] = None) -> List[str]:
        age = self._age

        def key(v: JobView):
            t = v.predicted_iter() if v.predicted_iter is not None else None
            a = age.get(v.job_id, 0)
            if t is None or a >= self.max_starve:
                # urgent tier, most-starved first: ordering urgents by t
                # would let fast jobs re-age into the tier and leapfrog
                # the slowest forever
                return (0, -a, v.job_id)
            return (1, t, v.job_id)

        ranked = sorted(views, key=key)
        picks = [v.job_id for v in ranked[:_capacity(views, capacity)]]
        chosen = set(picks)
        self._age = {v.job_id: (0 if v.job_id in chosen
                                else age.get(v.job_id, 0) + 1)
                     for v in views}
        return picks


_POLICIES = {
    "rr": RoundRobinScheduler,
    "round_robin": RoundRobinScheduler,
    "priority": PriorityScheduler,
    "spsf": ShortestStepScheduler,
    "shortest": ShortestStepScheduler,
}


def make_scheduler(policy: str):
    if policy not in _POLICIES:
        raise ValueError(f"unknown scheduler policy {policy!r} "
                         f"(want one of {sorted(_POLICIES)})")
    return _POLICIES[policy]()


def job_views(server) -> List[JobView]:
    """Build policy views over a :class:`~repro_torch.ps.server.PSServer`'s
    admitted jobs (predicted step times close over the server, fetched
    only if a policy asks)."""
    views = []
    for job in server.registry.jobs():
        views.append(JobView(
            job_id=job.job_id, priority=job.priority,
            admit_order=job.admit_order,
            predicted_iter=(lambda jid=job.job_id:
                            server.predicted_iter_time(jid))))
    return views
