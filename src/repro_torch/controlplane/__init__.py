"""Control plane: supervision that turns simulated elasticity into
detected, recovered reality (the port of ``repro.controlplane``).

A chief detects worker failure from missed heartbeats and recovers from
checkpoints, instead of being told by a scripted ``ChurnSim``:

  * :mod:`~repro_torch.controlplane.events`    — structured JSONL event
    stream, byte-compatible with the reference's, with a tailing reader;
  * :mod:`~repro_torch.controlplane.heartbeat` — deadline-driven
    per-worker ``alive -> suspect -> dead`` state machine (with rejoin);
  * :mod:`~repro_torch.controlplane.faults`    — seeded, composable fault
    plans (crash / hang / slowdown / checkpoint corruption / flaky
    restart);
  * :mod:`~repro_torch.controlplane.supervisor` — the chief: worker pools
    (logical-clock workers, or subprocesses), kills, restarts with capped
    exponential backoff, evictions, and the detected membership fed into
    the unchanged elastic ``Trainer`` path;
  * :mod:`~repro_torch.controlplane.worker`    — the subprocess worker
    payload (``python -m repro_torch.controlplane.worker``).

The reference's ``src/repro/controlplane/README.md`` holds the contract
(state-machine table, restart policy, event schema); the port keeps it.
"""
from repro_torch.controlplane.events import (Event, EventLog, read_events,
                                             tail_events)
from repro_torch.controlplane.faults import Fault, FaultInjector, FaultPlan
from repro_torch.controlplane.heartbeat import (ALIVE, DEAD, SUSPECT,
                                                HeartbeatMonitor)
from repro_torch.controlplane.supervisor import (ProcWorkerPool,
                                                 SimWorkerPool,
                                                 SupervisedTimer, Supervisor,
                                                 drill_report)

__all__ = [
    "Event", "EventLog", "read_events", "tail_events",
    "Fault", "FaultPlan", "FaultInjector",
    "ALIVE", "SUSPECT", "DEAD", "HeartbeatMonitor",
    "Supervisor", "SimWorkerPool", "ProcWorkerPool", "SupervisedTimer",
    "drill_report",
]
