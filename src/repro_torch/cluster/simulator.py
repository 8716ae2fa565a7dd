"""Cluster run-time simulator (a copy of ``repro.cluster.simulator``).

The port keeps its own copy of the numpy-only ``ClusterSim``, the
``microbatch_progress`` query, the fault overlay (``OverlaySim``), the
churn layer (``ChurnEvent``, ``ChurnSim``, ``resize_schedule``), the
multi-tenant partitioning (``partition_ids``, ``PartitionView``,
``PartitionedSim``) and the presets, so that it never imports the JAX
package; the same seed gives the same runtimes and the same membership
schedule.

Generates joint worker runtimes with the phenomenology the paper observes on
its real clusters (Fig. 2): machine-correlated slowdowns (workers share
nodes), time-correlated regimes (a slow node persisting for ~60 iterations,
then equilibrating), contention periods, and heavy-tailed per-worker
straggler spikes.  On real hardware the same interface is backed by
``time.monotonic()`` measurements per host; the simulator is the stand-in
the CPU-only container uses for end-to-end runs and benchmarks.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np


@dataclass
class Regime:
    name: str
    node_mult: np.ndarray      # (n_nodes,) multiplicative slowdown
    extra_noise: float = 0.0   # additional lognormal sigma


@dataclass
class ClusterSim:
    """Regime-switching, node-correlated runtime generator."""
    n_workers: int
    n_nodes: int = 4
    base_mean: float = 1.0
    worker_hetero: float = 0.15   # fixed per-worker speed spread
    noise_sigma: float = 0.07     # iid lognormal noise
    ar_rho: float = 0.9           # AR(1) node-load persistence
    ar_sigma: float = 0.05
    spike_prob: float = 0.015     # heavy-tail straggler probability
    spike_scale: float = 0.8
    regime_stay: float = 0.985    # Markov chain self-transition
    seed: int = 0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        self._rng = rng
        # node assignment: contiguous groups (like cores on a machine)
        sizes = np.full(self.n_nodes, self.n_workers // self.n_nodes)
        sizes[: self.n_workers % self.n_nodes] += 1
        self.node_of = np.repeat(np.arange(self.n_nodes), sizes)
        self.mu = self.base_mean * (
            1.0 + self.worker_hetero * (rng.uniform(size=self.n_workers)
                                        - 0.3))
        self.regimes = self._make_regimes()
        self._state = rng.integers(len(self.regimes))
        self._load = np.zeros(self.n_nodes)
        self.t = 0

    def _make_regimes(self) -> List[Regime]:
        ones = np.ones(self.n_nodes)
        regs = [Regime("uniform", ones.copy())]
        for k in range(self.n_nodes):
            m = ones.copy()
            m[k] = 1.9
            regs.append(Regime(f"slow_node_{k}", m))
        regs.append(Regime("contended", ones * 1.35, extra_noise=0.12))
        return regs

    # ------------------------------------------------------------------
    def step(self) -> np.ndarray:
        """One SGD iteration's joint runtimes (n_workers,)."""
        rng = self._rng
        if rng.uniform() > self.regime_stay:
            self._state = rng.integers(len(self.regimes))
        reg = self.regimes[self._state]
        self._load = (self.ar_rho * self._load
                      + self.ar_sigma * rng.standard_normal(self.n_nodes))
        node_factor = reg.node_mult * np.exp(self._load)
        sigma = self.noise_sigma + reg.extra_noise
        noise = np.exp(sigma * rng.standard_normal(self.n_workers)
                       - 0.5 * sigma ** 2)
        spikes = np.where(rng.uniform(size=self.n_workers) < self.spike_prob,
                          1.0 + rng.exponential(self.spike_scale,
                                                self.n_workers), 1.0)
        t = self.mu * node_factor[self.node_of] * noise * spikes
        self.t += 1
        return t

    def run(self, n_steps: int) -> np.ndarray:
        return np.stack([self.step() for _ in range(n_steps)])

    @property
    def regime_name(self) -> str:
        return self.regimes[self._state].name


# ---------------------------------------------------------------------------
# Progress query: partial work completed by a wall-clock deadline.
# ---------------------------------------------------------------------------


def microbatch_progress(times, t: float, n_micro: int) -> np.ndarray:
    """Fraction of ``n_micro`` microbatches each worker finishes by time ``t``.

    ``times`` are full-step runtimes (any width — a ClusterSim row, a
    ChurnSim active-set row, or a measured vector); a worker's microbatches
    are assumed uniform across its step, so worker w completes
    ``floor(n_micro * t / times[w])`` of them by the deadline, capped at
    ``n_micro``.  The returned fractions are exact multiples of
    ``1 / n_micro`` — the granularity anytime-SGD partial gradient sums
    actually come in (a worker cannot ship half a microbatch) — and a
    worker with ``times[w] <= t`` returns exactly 1.0.

    This is the query the JAX package's ``AnytimeController``
    turns a cutoff time into a per-worker f32 contribution vector with.
    """
    if n_micro < 1:
        raise ValueError(f"n_micro must be >= 1, got {n_micro}")
    times = np.asarray(times, np.float64)
    frac = np.clip(t / np.maximum(times, 1e-300), 0.0, 1.0)
    # the 1e-9 guard keeps an exact k/n_micro ratio from flooring to k-1
    return np.floor(frac * n_micro + 1e-9) / float(n_micro)


# ---------------------------------------------------------------------------
# Fault overlay: mutable per-worker stalls/slowdowns on any runtime source.
# ---------------------------------------------------------------------------


class OverlaySim:
    """Mutable fault overlay on a full-width runtime source.

    The control plane's live twin of the scripted :class:`ChurnSim`: a
    supervisor (or a drill script) toggles per-worker ``stall`` flags
    (crashed/hung workers never finish — their runtime becomes
    :data:`STALL` seconds) and ``slow`` multipliers mid-run, while the
    base simulator keeps generating the full-width joint phenomenology.
    Untouched columns are bit-identical to the base run, so a detected
    fault schedule can be replayed as a scripted one column-exactly.
    """

    STALL = 1e9

    def __init__(self, base):
        self.base = base
        n = base.n_workers
        self.mult = np.ones(n)
        self.stalled = np.zeros(n, bool)

    @property
    def n_workers(self) -> int:
        return self.base.n_workers

    @property
    def t(self) -> int:
        return self.base.t

    def stall(self, wid: int, on: bool = True):
        self.stalled[int(wid)] = bool(on)

    def slow(self, wid: int, factor: float = 1.0):
        if factor <= 0:
            raise ValueError(f"slowdown factor must be > 0, got {factor}")
        self.mult[int(wid)] = float(factor)

    def step(self) -> np.ndarray:
        row = np.asarray(self.base.step(), np.float64) * self.mult
        return np.where(self.stalled, self.STALL, row)

    def run(self, n_steps: int) -> np.ndarray:
        return np.stack([self.step() for _ in range(n_steps)])


# ---------------------------------------------------------------------------
# Churn layer: elastic worker membership on top of any runtime source.
# ---------------------------------------------------------------------------


@dataclass
class ChurnEvent:
    """One membership change, keyed on the base simulator's step count.

    ``kill`` / ``restore`` name GLOBAL worker ids (columns of the base
    sim); ``resize`` is a convenience target width — extra kills come off
    the highest active ids, restores come back lowest-id first.  The event
    fires BEFORE the runtimes of iteration ``step`` are drawn, so the
    step at which it fires already runs at the new width.
    """
    step: int
    kill: Tuple[int, ...] = ()
    restore: Tuple[int, ...] = ()
    resize: Optional[int] = None


class ChurnSim:
    """Membership schedule wrapped around a ClusterSim (or TraceReplay).

    The base simulator keeps generating FULL-width joint runtimes — the
    cluster's phenomenology (node regimes, AR load) is independent of which
    workers currently hold a lease — and ``step()`` returns only the active
    columns.  ``n_workers`` / ``active_ids`` reflect the membership of the
    NEXT ``step()`` (pending events are applied eagerly), so a caller can
    resize its plumbing before drawing the runtimes of the resized step.

    Survivor columns are therefore column-exact across a resize: worker j's
    runtime series is the same whether or not its neighbours were killed.
    """

    def __init__(self, base, events: List[ChurnEvent]):
        self.base = base
        self.events = sorted(events, key=lambda e: e.step)
        self._active = np.ones(base.n_workers, bool)
        self._ei = 0
        self._apply_pending()

    def _apply_pending(self):
        while (self._ei < len(self.events)
               and self.events[self._ei].step <= self.base.t):
            ev = self.events[self._ei]
            self._ei += 1
            if ev.kill:
                self._active[list(ev.kill)] = False
            if ev.restore:
                self._active[list(ev.restore)] = True
            if ev.resize is not None:
                n = int(ev.resize)
                if not 1 <= n <= self.base.n_workers:
                    raise ValueError(f"resize target {n} outside "
                                     f"[1, {self.base.n_workers}]")
                ids = np.flatnonzero(self._active)
                if n < ids.size:                  # kill highest active ids
                    self._active[ids[n:]] = False
                elif n > ids.size:                # restore lowest dead ids
                    dead = np.flatnonzero(~self._active)
                    self._active[dead[: n - ids.size]] = True

    @property
    def n_workers(self) -> int:
        self._apply_pending()
        return int(self._active.sum())

    @property
    def active_ids(self) -> np.ndarray:
        """Global worker ids of the active set, ascending."""
        self._apply_pending()
        return np.flatnonzero(self._active)

    @property
    def t(self) -> int:
        return self.base.t

    def step(self) -> np.ndarray:
        """Joint runtimes of the CURRENT active set ((n_active,))."""
        self._apply_pending()
        active = self._active.copy()
        return self.base.step()[active]

    def run(self, n_steps: int) -> List[np.ndarray]:
        """Rows may change width across events, so this returns a list."""
        return [self.step() for _ in range(n_steps)]


def resize_schedule(base, plan: List[Tuple[int, int]]) -> ChurnSim:
    """ChurnSim from a [(step, n_workers), ...] width plan."""
    return ChurnSim(base, [ChurnEvent(step=s, resize=n) for s, n in plan])


# ---------------------------------------------------------------------------
# Multi-tenant partitioning: J jobs share one cluster's workers.
# ---------------------------------------------------------------------------


def partition_ids(n_workers: int, n_jobs: int) -> List[np.ndarray]:
    """Contiguous near-equal partition of global worker ids over jobs
    (first ``n_workers % n_jobs`` partitions get the extra worker) —
    the same convention the node assignment uses."""
    if not 1 <= n_jobs <= n_workers:
        raise ValueError(f"cannot split {n_workers} workers into "
                         f"{n_jobs} jobs")
    sizes = np.full(n_jobs, n_workers // n_jobs)
    sizes[: n_workers % n_jobs] += 1
    bounds = np.concatenate([[0], np.cumsum(sizes)])
    return [np.arange(bounds[j], bounds[j + 1]) for j in range(n_jobs)]


class PartitionView:
    """One job's timer view of a :class:`PartitionedSim` partition.

    Implements the Trainer timer protocol (``n_workers`` /
    ``active_ids`` / ``step``) over the job's slice of the shared
    cluster.  Views advance independent cursors, so the multi-job
    scheduler can service jobs at different rates and each job's runtime
    series stays internally consistent; churn events apply at the VIEW's
    own step index (ChurnEvent semantics: the event fires before the
    runtimes of iteration ``step`` are drawn).
    """

    def __init__(self, parent: "PartitionedSim", ids: np.ndarray):
        self.parent = parent
        self.ids = np.asarray(ids, int)
        self.t = 0

    def _active_mask(self) -> np.ndarray:
        member = self.parent.membership_at(self.t)
        return member[self.ids]

    @property
    def n_workers(self) -> int:
        return int(self._active_mask().sum())

    @property
    def active_ids(self) -> np.ndarray:
        """Global worker ids of this partition's active set, ascending."""
        return self.ids[self._active_mask()]

    def step(self) -> np.ndarray:
        """Joint runtimes of the partition's CURRENT active set."""
        row = self.parent.row(self.t)
        out = row[self.active_ids]
        self.t += 1
        return out

    def run(self, n_steps: int) -> List[np.ndarray]:
        return [self.step() for _ in range(n_steps)]


class PartitionedSim:
    """Split one base cluster's workers among J concurrent jobs.

    The base simulator keeps generating FULL-width joint runtimes — node
    regimes and AR load are properties of the shared hardware, not of
    which job leases which worker — and each :class:`PartitionView`
    serves its partition's columns.  Rows are generated once and cached
    by step index, so every view of step ``i`` sees the SAME draw:
    worker j's runtime series is identical whether it is read by a
    multi-job loop or a single-tenant run (column-exactness, the
    ChurnSim invariant, extended across tenants).  Rows every registered
    view has moved past are pruned, so memory is bounded by the cursor
    SPREAD between jobs, not run length — and the spread itself is
    bounded by ``max_cache`` rows, so a pinned cursor (a starved or
    evicted job whose view stopped advancing) cannot grow the cache
    without bound; it gets a loud ``IndexError`` on its next read
    instead.  Create all views before stepping (a view opened after
    pruning raises the same way).

    ``events`` is a :class:`ChurnEvent` schedule over GLOBAL worker ids;
    a kill inside partition p shrinks job p's view (its Trainer resizes
    through the elastic protocol) and leaves every other job untouched.
    """

    def __init__(self, base, partitions: List[np.ndarray],
                 events: List[ChurnEvent] = (), max_cache: int = 4096):
        self.base = base
        self.max_cache = max_cache
        self.partitions = [np.asarray(p, int) for p in partitions]
        flat = np.concatenate(self.partitions) if self.partitions else \
            np.array([], int)
        if flat.size != np.unique(flat).size:
            raise ValueError("partitions overlap")
        if flat.size and (flat.min() < 0 or flat.max() >= base.n_workers):
            raise ValueError("partition ids outside the base cluster")
        for ev in events:
            if ev.resize is not None:
                raise ValueError(
                    "ChurnEvent.resize targets a global width; partitioned "
                    "schedules must kill/restore explicit worker ids")
        self.events = sorted(events, key=lambda e: e.step)
        self._rows: List[np.ndarray] = []
        self._row0 = 0                       # step index of _rows[0]
        self._members: dict = {}
        self._views: List[PartitionView] = []

    def _prune(self):
        """Drop cached rows/masks no registered view can read again —
        or, past ``max_cache``, rows only a pinned (stalled) view could."""
        if not self._views:
            return
        low = min(v.t for v in self._views)
        low = max(low, self._row0 + len(self._rows) - self.max_cache)
        while self._row0 < low:
            self._rows.pop(0)
            self._row0 += 1
        if len(self._members) > len(self.events) + 2:
            self._members = {i: m for i, m in self._members.items()
                             if i >= low}

    def row(self, i: int) -> np.ndarray:
        """The full-width joint runtimes of step ``i`` (cached)."""
        if i < self._row0:
            raise IndexError(
                f"row {i} was pruned (oldest cached: {self._row0}); "
                f"create every PartitionView before stepping")
        while len(self._rows) <= i - self._row0:
            self._rows.append(self.base.step())
            self._prune()
        return self._rows[i - self._row0]

    def membership_at(self, i: int) -> np.ndarray:
        """Global active mask after every event with ``step <= i``."""
        if i not in self._members:
            active = np.ones(self.base.n_workers, bool)
            for ev in self.events:
                if ev.step > i:
                    break
                if ev.kill:
                    active[list(ev.kill)] = False
                if ev.restore:
                    active[list(ev.restore)] = True
            self._members[i] = active
        return self._members[i]

    def view(self, job: int) -> PartitionView:
        v = PartitionView(self, self.partitions[job])
        self._views.append(v)
        return v

    def views(self) -> List[PartitionView]:
        return [self.view(j) for j in range(len(self.partitions))]


# ---------------------------------------------------------------------------
# Presets matching the paper's two clusters.
# ---------------------------------------------------------------------------


def paper_cluster_158(seed: int = 0, n_workers: int = 158) -> ClusterSim:
    """4 nodes x 40 Xeon cores, 1 PS + 1 spare => 158 workers (paper §4.1).

    Calibrated near the paper's measured moments (mean 1.057 s, std 0.393 s).
    ``n_workers`` scales the same phenomenology down for CPU-budget
    end-to-end tests (node count and per-worker moments unchanged).
    """
    return ClusterSim(n_workers=n_workers, n_nodes=4, base_mean=1.0,
                      worker_hetero=0.15, noise_sigma=0.07,
                      spike_prob=0.02, spike_scale=0.9, seed=seed)


def cray_xc40_2175(seed: int = 0) -> ClusterSim:
    """32 KNL nodes x 68 logical cores, minus the PS => 2175 workers."""
    return ClusterSim(n_workers=2175, n_nodes=32, base_mean=1.0,
                      worker_hetero=0.1, noise_sigma=0.05,
                      spike_prob=0.01, spike_scale=0.7,
                      regime_stay=0.99, seed=seed)


def tpu_pod_hosts(n_hosts: int = 64, seed: int = 0) -> ClusterSim:
    """Per-host step-time jitter for a TPU pod (input pipeline + DCN):
    weaker heterogeneity, rarer spikes — the regime the controller sees when
    driving the masked-psum cutoff on the production mesh."""
    return ClusterSim(n_workers=n_hosts, n_nodes=max(2, n_hosts // 16),
                      base_mean=1.0, worker_hetero=0.04, noise_sigma=0.03,
                      spike_prob=0.01, spike_scale=1.5, regime_stay=0.995,
                      seed=seed)
