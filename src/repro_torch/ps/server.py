"""Multi-tenant parameter server: batched device decisions for J jobs.

The port of ``repro.ps.server``.  A production cluster runs many training
jobs at once, and each one needs the paper's cutoff decision every step.
Launching J controllers' decisions per tick pays the launch overhead J
times for tiny per-job compute; this module decides every job of a bucket
in ONE launch:

  * :class:`JobRegistry` — admit/evict/resize bookkeeping.  Each job owns
    its :class:`~repro_torch.core.runtime_model.api.RuntimeModel`, its
    worker membership, a priority, and a checkpoint-group name.
  * :class:`PSServer` — the decision plane.  Jobs of the same DMM
    architecture (lag, k_samples, z_dim, hidden) share a *bucket* even at
    MIXED worker widths: their lag windows live stacked in one
    ``(J_b, lag+1, n_pad)`` device ring, their params are zero-padded to
    the bucket width (``stack_models_padded``), and per-job width masks
    (``controller._batched_observe_decide_ragged``) keep each job's
    decision exactly its own.  ``flush()`` therefore issues ONE launch per
    bucket a tick whatever the job mix: on the card, one replay of a
    CUDA graph captured for the bucket, on the bucket's own stream.
    Observation rows, masks, predictive moments, keys and censor flags
    travel in one packed upload; cutoffs, moments and iteration times
    come back in one copy to pinned host memory, read once a launch
    (:meth:`PSServer._out_host`); the (K, n) sample clouds stay on the
    device.
  * :class:`JobHandle` — a controller-protocol facade (`predict_cutoff` /
    `observe` / `resize` / `seed_window` / `window_array`), so one
    ``launch.train.Trainer`` per job drives the shared server unchanged,
    checkpointing included (the ``"ctl"`` group works verbatim).

A bucket captures at most two graphs, observe+decide and decide-only, for
its current stack.  A tick that services only some of the bucket's jobs
(the scheduler's ``capacity`` below J) replays the same full-bucket graph
with a per-row *serviced* flag: unserviced rows keep their ring, head and
last outputs (the decision is a pure function of ring and key, so the
serviced rows get the reference's cutoffs).  So a capacity change never
captures, and a capture happens only when the stack changes (admit,
evict, resize, a refit's install, a repack).  Before a stack changes the
bucket waits for its last replay: nothing is freed under a replay in
flight.

Per-job elasticity follows the ``ElasticController`` protocol: ``resize``
without a refit model remaps the job's window (survivors column-exact),
detaches it from the batched path onto a warm-seeded Elfving fallback,
and refits the DMM from the surviving trace once ``refit_fresh`` fresh
observations arrive — then the job rejoins its (new) bucket.  With
``refit_async=True`` the ELBO refit runs on a worker thread
(``controller._spawn_refit``), on the card on a stream of its own, so a
tick served during an active refit never waits for ``model.fit``;
results stale by resize generation are discarded, never installed.

Semantics contract: J jobs, mixed widths included, get the cutoffs of J
looped single-job controllers: batching amortizes launches, it never
changes the decision (tests/test_torch_ps.py holds it against the JAX
package's server and the port's own controller).
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import controller as C
from repro_torch.core.cutoff import order_stats
from repro_torch.core.runtime_model.api import (RuntimeModel, batched_layout,
                                                stack_models_padded)


# ---------------------------------------------------------------------------
# The batched entries.  The flush path uploads ONE packed f64 block (32-bit
# key words and f32 values are exact in f64): [times, mask, mu, std] as
# (4, J, n_pad), the (J, 4) key words [decide key | impute base key], the
# (J,) impute steps, censor flags and serviced flags.  Key folding, mask
# decode and the serviced merge happen on the device.
# ---------------------------------------------------------------------------


def _unpack_obs(pack, keys, steps, cen):
    """The packed observation block as the obs dict
    ``controller._ragged_append_core`` consumes.  The impute keys are
    folded on the device, row j equal to ``controller._impute_key(seed_j,
    step_j)``."""
    return {"times": pack[0], "mask": pack[1] > 0.5,
            "mu": pack[2], "std": pack[3],
            "key": C._batched_impute_keys(keys[:, 2:], steps),
            "cen": cen}


def _split_inp(inp, J: int, n: int):
    """(pack (4, J, n), keys (J, 4), steps, cen, serviced) views of the
    packed upload (a tensor, or its host numpy view)."""
    o = 4 * J * n
    return (inp[:o].reshape(4, J, n), inp[o:o + 4 * J].reshape(J, 4),
            inp[o + 4 * J:o + 5 * J], inp[o + 5 * J:o + 6 * J],
            inp[o + 6 * J:o + 7 * J])


def _full_observe_decide(params, st, scales, widths, los, *, k_samples: int):
    """Every serviced row of the bucket: append its observation, decide
    its next step.  Rows whose serviced flag is 0 keep their ring, head
    and outputs."""
    rings, heads = st["rings"], st["heads"]
    J, _, n = rings.shape
    pack, keys, steps, cen, serv = _split_inp(st["inp"], J, n)
    keys = keys.to(torch.int64)
    serv = serv > 0.5
    obs = _unpack_obs(pack.to(torch.float32), keys, steps.to(torch.int64),
                      cen > 0.5)
    r, h, *out = C._batched_observe_decide_ragged(
        params, rings, heads, obs, keys[:, :2], scales, widths, los,
        k_samples=k_samples)
    rings.copy_(torch.where(serv[:, None, None], r, rings))
    heads.copy_(torch.where(serv, h, heads))
    _write_out(st, serv, *out)


def _full_decide(params, st, scales, widths, los, *, k_samples: int):
    """Decide-only twin: the serviced rows' decisions, rings untouched."""
    rings = st["rings"]
    J, _, n = rings.shape
    _, keys, _, _, serv = _split_inp(st["inp"], J, n)
    out = C._batched_decide_ragged(
        params, rings, st["heads"], keys[:, :2].to(torch.int64), scales,
        widths, los, k_samples=k_samples)
    _write_out(st, serv > 0.5, *out)


def _write_out(st, serv, cut, samples, mu, std, it):
    """The serviced rows' outputs into the fetch block ``out`` —
    [cutoff, E[x_(c)], mu (n_pad), std (n_pad)] a row — and the sample
    clouds; other rows keep what they held."""
    new = torch.cat([cut.to(torch.float32)[:, None], it[:, None], mu, std],
                    dim=1)
    st["out"].copy_(torch.where(serv[:, None], new, st["out"]))
    st["samples"].copy_(torch.where(serv[:, None, None], samples,
                                    st["samples"]))


_BODIES = {"observe": _full_observe_decide, "decide": _full_decide}


def _seed_ring(rows: np.ndarray, cap: int, n: int, n_pad: int):
    """Build the (cap, n_pad) f32 ring + head a fresh controller would
    reach by appending width-n ``rows`` with full masks — without cap
    launches.  Plain appends write the f32 times verbatim, so the real
    columns are bit-exact; pad columns stay zero (the decision masks them
    out, it never reads them)."""
    rows = np.asarray(rows, np.float32)[-cap:]
    ring = np.zeros((cap, n_pad), np.float32)
    m = rows.shape[0]
    ring[:m, :n] = rows
    return ring, m % cap, min(m, cap)


# ---------------------------------------------------------------------------
# Job records + registry.
# ---------------------------------------------------------------------------


@dataclass
class PSJob:
    """One tenant of the shared parameter server (registry record)."""
    job_id: str
    model: Optional[RuntimeModel]
    members: np.ndarray                 # global worker ids
    priority: float
    admit_order: int
    k_samples: int
    min_frac: float
    seed: int
    ckpt_group: str

    width: int = 0                      # current worker count
    step: int = 0                       # controller step counter
    count: int = 0                      # rows in the lag window
    mode: str = "dmm"                   # "dmm" | "fallback"
    slot: int = -1                      # row in the bucket stack
    bucket_sig: Optional[tuple] = None
    fallback: Optional[C.ElfvingController] = None
    fresh: int = 0                      # observations since last (re)fit
    resize_count: int = 0
    refit_failures: int = 0             # consecutive failed async fits
    fallback_steps: int = 0
    trace: list = field(default_factory=list, repr=False)  # refit data
    # decision plumbing (device refs, fetched lazily)
    pending: Optional[tuple] = None     # (dstep, row, outputs dict)
    pending_pred: Optional[tuple] = None  # (mu row, std row, samples, row)
    last_iter: Optional[float] = None   # E[x_(c)] of the last decision
    queued: bool = False
    # async refit in flight: controller._spawn_refit triple
    refit_task: Optional[tuple] = None
    # architecture template for refits (widths change, shapes don't)
    lag: int = 20
    z_dim: int = 32
    hidden: int = 64
    device: Optional[torch.device] = None

    @property
    def cap(self) -> int:
        return self.lag + 1

    @property
    def warmed_up(self) -> bool:
        return self.mode == "dmm" and self.count >= self.cap


class JobRegistry:
    """Admission bookkeeping for the multi-tenant server.

    Owns the job records: who is admitted, their RuntimeModel, worker
    membership, scheduling priority, and per-job checkpoint-group name
    (``ps/<job_id>``).  The decision-plane state (stacked rings, pending
    batched outputs) belongs to :class:`PSServer`.
    """

    def __init__(self):
        self._jobs: Dict[str, PSJob] = {}
        self._admitted = 0

    def admit(self, job_id: str, model: RuntimeModel, *,
              members=None, priority: float = 0.0, k_samples: int = 64,
              min_frac: float = 0.5, seed: int = 0) -> PSJob:
        if job_id in self._jobs:
            raise ValueError(f"job {job_id!r} already admitted")
        if model.params is None:
            raise ValueError(f"job {job_id!r}: admit a fitted RuntimeModel")
        members = (np.asarray(members, int) if members is not None
                   else np.arange(model.n_workers))
        if members.shape != (model.n_workers,):
            raise ValueError(
                f"job {job_id!r}: {members.shape[0]} members for a "
                f"width-{model.n_workers} model")
        job = PSJob(job_id=job_id, model=model, members=members,
                    priority=float(priority), admit_order=self._admitted,
                    k_samples=int(k_samples), min_frac=float(min_frac),
                    seed=int(seed), ckpt_group=f"ps/{job_id}",
                    width=model.n_workers, lag=model.lag,
                    z_dim=model.z_dim, hidden=model.hidden,
                    device=model.device)
        self._jobs[job_id] = job
        self._admitted += 1
        return job

    def evict(self, job_id: str) -> PSJob:
        return self._jobs.pop(job_id)

    def __getitem__(self, job_id: str) -> PSJob:
        return self._jobs[job_id]

    def __contains__(self, job_id: str) -> bool:
        return job_id in self._jobs

    def __len__(self) -> int:
        return len(self._jobs)

    def ids(self) -> List[str]:
        """Admitted job ids in admission order."""
        return [j.job_id for j in
                sorted(self._jobs.values(), key=lambda j: j.admit_order)]

    def jobs(self) -> List[PSJob]:
        return [self._jobs[i] for i in self.ids()]

    def set_priority(self, job_id: str, priority: float):
        self._jobs[job_id].priority = float(priority)


# ---------------------------------------------------------------------------
# The decision plane.
# ---------------------------------------------------------------------------


class _Bucket:
    """Jobs of one DMM architecture, windows stacked in ONE device ring.

    ``n_pad`` is the bucket's pad width — the max worker width of its
    jobs.  It grows when a wider job joins and shrinks when the widest
    leaves, so a same-width bucket carries no padding.

    ``st`` holds the tensors a launch reads and writes in place: the
    (J, lag+1, n_pad) f32 ``rings`` and (J,) int64 ``heads``, the packed
    upload ``inp`` (f64), the fetch block ``out`` ((J, 2 + 2 n_pad) f32)
    and the (J, K, n_pad) ``samples``.  On the card a launch is: upload
    ``inp`` from pinned memory, replay the graph of its kind, copy
    ``out`` to pinned memory — all on the bucket's stream, its end marked
    by the bucket's event.  A stack change makes a new ``st`` (waiting for
    the last replay first) and drops the graphs; outputs still pending
    keep the old block alive.
    """

    def __init__(self, cap: int, k_samples: int, device):
        self.cap = cap
        self.k_samples = k_samples
        self.device = torch.device(device)
        self.n_pad = 0
        self.jobs: List[PSJob] = []
        self._stacked = None    # (params, scales, widths, los) cache
        self.graphs: dict = {}  # kind -> CUDAGraph of the current stack
        self.captures = 0       # graphs captured over the bucket's life
        self.replays = 0        # graph replays on the card
        if self.device.type == "cuda":
            self.stream = torch.cuda.Stream(self.device)
            self.event = torch.cuda.Event()
        else:
            self.stream = self.event = None
        self.st = self._new_state(torch.zeros((0, cap, 0)),
                                  torch.zeros((0,), dtype=torch.int64))

    # -- streams --------------------------------------------------------
    @contextlib.contextmanager
    def on_stream(self):
        """Device work on the bucket's stream, its end marked by the
        bucket's event (on the CPU: nothing to order)."""
        if self.stream is None:
            yield
            return
        with torch.cuda.stream(self.stream):
            yield
            self.event.record(self.stream)

    def wait(self):
        """Block until the bucket's device work is done (its pinned
        buffers may then be read and rewritten, its tensors freed)."""
        if self.event is not None:
            self.event.synchronize()

    # -- the stack ------------------------------------------------------
    def _new_state(self, rings, heads) -> dict:
        """A state block around ``rings`` / ``heads``, with fresh upload
        and output buffers (and their pinned mirrors on the card)."""
        J, n, dev = rings.shape[0], rings.shape[2], self.device
        f32 = dict(dtype=torch.float32, device=dev)
        st = {"rings": rings.to(dev), "heads": heads.to(dev),
              "inp": torch.zeros((4 * J * n + 7 * J,), dtype=torch.float64,
                                 device=dev),
              "out": torch.zeros((J, 2 + 2 * n), **f32),
              "samples": torch.zeros((J, self.k_samples, n), **f32)}
        if self.stream is not None:
            st["inp_host"] = torch.zeros(st["inp"].shape,
                                         dtype=torch.float64, pin_memory=True)
            st["out_host"] = torch.zeros(st["out"].shape,
                                         dtype=torch.float32, pin_memory=True)
        else:
            st["inp_host"], st["out_host"] = st["inp"], st["out"]
        return st

    def restack(self, rings, heads):
        """Swap in a new stack (a job joined or left, or the pad width
        changed): wait for the last replay, then drop the graphs and the
        stacked params built for the old one."""
        self.wait()
        self.graphs = {}
        self._stacked = None
        self.st = self._new_state(rings, heads)

    def stacked(self):
        if self._stacked is None:
            with self.on_stream():
                params, scales = stack_models_padded(
                    [j.model for j in self.jobs], self.n_pad)
                widths = torch.tensor([j.width for j in self.jobs],
                                      device=self.device)
                los = torch.tensor(
                    [order_stats.min_frac_floor(j.width, j.min_frac)
                     for j in self.jobs], device=self.device)
            self._stacked = (batched_layout(params), scales, widths, los)
        return self._stacked

    def repack(self, n_pad_new: int):
        """Re-home every ring at a new pad width (on the device).  Caller
        guarantees every job width fits ``n_pad_new``, so truncation only
        ever drops zero pad columns."""
        with self.on_stream():
            rings = self.st["rings"]
            w = min(rings.shape[2], n_pad_new)
            new = torch.zeros(rings.shape[:2] + (n_pad_new,),
                              dtype=torch.float32, device=self.device)
            new[:, :, :w] = rings[:, :, :w]
            heads = self.st["heads"].clone()
        self.n_pad = n_pad_new
        self.restack(new, heads)

    # -- launches -------------------------------------------------------
    def launch(self, kind: str):
        """One launch of ``kind`` ("observe" or "decide") over the whole
        bucket, the upload already written to ``st["inp_host"]``: eagerly
        on the CPU; on the card upload, replay the graph of this kind
        (captured at its first use for this stack) and fetch ``out``."""
        params, scales, widths, los = self.stacked()
        body = _BODIES[kind]

        def run(st):
            body(params, st, scales, widths, los, k_samples=self.k_samples)

        st = self.st
        if self.stream is None:
            run(st)
            return
        with self.on_stream():
            st["inp"].copy_(st["inp_host"], non_blocking=True)
        if kind not in self.graphs:
            self.graphs[kind] = self._capture(run)
        with self.on_stream():
            self.graphs[kind].replay()
            self.replays += 1
            st["out_host"].copy_(st["out"], non_blocking=True)

    def _capture(self, run):
        """Capture ``run(st)`` as a CUDA graph on the bucket's stream, after
        one eager run on a copy of the state (lazy library set-up must not
        happen inside the capture, and the warm-up must not step the real
        rings).  Thread-local, as ``CutoffController._capture``: an async
        refit may be fitting on a worker thread meanwhile.  A capture that
        fails raises."""
        with self.on_stream():
            run({k: v.clone() for k, v in self.st.items()
                 if not k.endswith("_host")})
        self.wait()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=self.stream,
                              capture_error_mode="thread_local"):
            run(self.st)
        self.captures += 1
        return graph

    def host_inp(self, rows: List[int]):
        """The host upload, cleared for a launch serving bucket ``rows``:
        pad columns read mask True, only ``rows`` are serviced.  Waits for
        the last launch first (it may still be reading the block)."""
        self.wait()
        inp = self.st["inp_host"].numpy()
        inp[:] = 0.0
        pack, keys, steps, cen, serv = _split_inp(inp, len(self.jobs),
                                                  self.n_pad)
        pack[1] = 1.0
        serv[rows] = 1.0
        return pack, keys, steps, cen


class PSServer:
    """The multi-tenant decision plane (see module docstring).

    Tick protocol (what ``launch.multi_job.run_ticks`` runs)::

        server.prefetch(serviced)        # cold decisions, one launch
        for job_id in serviced:          # scheduler's order
            c = server.predict_cutoff(job_id)   # lazy host fetch
            ... run the job's train step with the bit array ...
            server.observe(job_id, times, mask)  # enqueues
        server.flush()                   # ONE launch per architecture
                                         # bucket: widths and impute
                                         # modes all ride it

    ``flush`` is also called implicitly whenever a job with a queued
    observation is asked to predict, so a ``JobHandle`` behaves like a
    plain controller even without a tick loop calling ``flush``.

    ``obs`` (a :class:`repro_torch.obs.ObsRun`): a ``ps.flush`` span
    around each flush, a ``ps.dispatch`` span around each bucket's launch
    inside it, a ``ps.refit`` span around a synchronous refit, and host
    counters of refits started, failed and installed.  Spans and counters
    are host bookkeeping only; the decisions are the bare server's.
    """

    def __init__(self, registry: Optional[JobRegistry] = None, *,
                 history: int = 512, refit_steps: int = 150,
                 refit_batch: int = 8, refit_fresh: int = 4,
                 refit_async: bool = False, fallback_warmup: int = 3,
                 refit_retries: int = 1, obs=None):
        self.obs = obs
        self.registry = registry if registry is not None else JobRegistry()
        self.history = history
        self.refit_steps = refit_steps
        self.refit_batch = refit_batch
        self.refit_fresh = refit_fresh
        self.refit_async = refit_async
        self.fallback_warmup = fallback_warmup
        self.refit_retries = refit_retries
        self._buckets: Dict[tuple, _Bucket] = {}
        self._queue: List[dict] = []
        self.dispatches = 0             # fused decision launches issued
        self.ticks = 0                  # flush() calls that launched

    # -- admission ------------------------------------------------------
    def admit(self, job_id: str, model: RuntimeModel, *, window=None,
              members=None, priority: float = 0.0, k_samples: int = 64,
              min_frac: float = 0.5, seed: int = 0) -> "JobHandle":
        """Admit a job; ``window`` warm-starts its lag window (rows of
        raw runtimes, as ``CutoffController.seed_window``)."""
        self.flush()
        job = self.registry.admit(job_id, model, members=members,
                                  priority=priority, k_samples=k_samples,
                                  min_frac=min_frac, seed=seed)
        self._place(job, window)
        if window is not None:
            job.trace = [np.asarray(r, np.float64)
                         for r in np.asarray(window)][-self.history:]
        return JobHandle(self, job_id)

    def evict(self, job_id: str) -> dict:
        """Remove a job; returns its final window (or None) and trace."""
        self.flush()
        job = self.registry[job_id]
        window = None
        if job.mode == "dmm" and job.count > 0:
            window = self.window_array(job_id)
        if job.bucket_sig is not None:
            self._remove(job)
        job.refit_task = None
        self.registry.evict(job_id)
        return {"window": window, "trace": np.array(job.trace)}

    def handle(self, job_id: str) -> "JobHandle":
        if job_id not in self.registry:
            raise KeyError(job_id)
        return JobHandle(self, job_id)

    # -- bucket plumbing ------------------------------------------------
    def _sig(self, job: PSJob) -> tuple:
        """The decision ARCHITECTURE: window length, sampling count, DMM
        shape and device.  Deliberately width-free — mixed worker widths
        share one bucket via pad-to-bucket ragged launches (the per-job
        width and argmax floor are tensors of the launch).  Two jobs with
        different (z_dim, hidden) still cannot share a param stack."""
        return (job.cap, job.k_samples, job.z_dim, job.hidden,
                str(job.device))

    def _place(self, job: PSJob, window=None):
        """Insert a dmm-mode job into its architecture bucket, growing
        the bucket pad width if this job is the widest, and seeding its
        ring slot."""
        sig = self._sig(job)
        b = self._buckets.get(sig)
        if b is None:
            b = self._buckets[sig] = _Bucket(job.cap, job.k_samples,
                                             job.device)
        if job.width > b.n_pad:
            b.repack(job.width)
        rows = np.asarray(window, np.float64) if window is not None else None
        if rows is not None and rows.ndim != 2:
            raise ValueError(f"seed window must be (T, n), got {rows.shape}")
        if rows is not None and rows.shape[1] != job.width:
            raise ValueError(f"seed window width {rows.shape[1]} != "
                             f"job width {job.width}")
        ring, head, count = _seed_ring(
            rows if rows is not None else np.zeros((0, job.width)),
            job.cap, job.width, b.n_pad)
        with b.on_stream():
            rings = torch.cat([b.st["rings"],
                               torch.from_numpy(ring).to(b.device)[None]])
            heads = torch.cat([b.st["heads"],
                               torch.tensor([head], device=b.device)])
        job.slot = len(b.jobs)
        b.jobs.append(job)
        b.restack(rings, heads)
        job.bucket_sig = sig
        job.count = count
        job.mode = "dmm"

    def _remove(self, job: PSJob):
        b = self._buckets[job.bucket_sig]
        i = job.slot
        keep = [k for k in range(len(b.jobs)) if k != i]
        with b.on_stream():
            idx = torch.tensor(keep, dtype=torch.int64, device=b.device)
            rings, heads = b.st["rings"][idx], b.st["heads"][idx]
        b.jobs.pop(i)
        for k, other in enumerate(b.jobs):
            other.slot = k
        b.restack(rings, heads)
        sig, job.bucket_sig = job.bucket_sig, None
        job.slot = -1
        if not b.jobs:
            del self._buckets[sig]
            return
        widest = max(j.width for j in b.jobs)
        if widest < b.n_pad:
            b.repack(widest)

    # -- window diagnostics / checkpointing -----------------------------
    def window_array(self, job_id: str) -> np.ndarray:
        """The job's lag window, oldest row first (host copy, pad
        columns stripped).

        Raises ValueError while empty — the Trainer's checkpoint path
        relies on this to skip cold controllers."""
        self.flush()
        job = self.registry[job_id]
        if job.mode != "dmm":
            if not job.trace:
                raise ValueError("window is empty")
            return np.stack(job.trace[-job.cap:])
        if job.count == 0:
            raise ValueError("window is empty")
        b = self._buckets[job.bucket_sig]
        b.wait()
        ring = b.st["rings"][job.slot].cpu().numpy()
        head = int(b.st["heads"][job.slot].cpu())
        w = np.roll(ring, -head, axis=0)[:, :job.width]
        return w[-job.count:] if job.count < job.cap else w

    def seed_window(self, job_id: str, rows: np.ndarray):
        """Warm-start the job's window from recorded traces (checkpoint
        restore path)."""
        self.flush()
        job = self.registry[job_id]
        rows = np.asarray(rows, np.float64)
        if rows.shape[1] != job.width:
            raise ValueError(f"seed rows have width {rows.shape[1]}, "
                             f"job width is {job.width}")
        job.trace = (job.trace + [r for r in rows])[-self.history:]
        if job.mode != "dmm":
            for r in rows[-50:]:
                job.fallback.buf.append(np.asarray(r, np.float64))
            return
        b = self._buckets[job.bucket_sig]
        old = (np.asarray(self.window_array(job_id), np.float32)
               if job.count else np.zeros((0, job.width), np.float32))
        merged = np.concatenate([old, np.asarray(rows, np.float32)])
        ring, head, count = _seed_ring(merged, job.cap, job.width, b.n_pad)
        # in place: the bucket's graphs stay valid
        with b.on_stream():
            b.st["rings"][job.slot].copy_(torch.from_numpy(ring))
            b.st["heads"][job.slot].fill_(head)
        job.count = min(job.count + rows.shape[0], job.cap)
        job.pending = None
        job.pending_pred = None

    def checkpoint_group(self, job_id: str) -> Dict[str, np.ndarray]:
        """The job's persistable controller state (``"ctl"``-group shape:
        width, members, step, window), under its registry group name."""
        job = self.registry[job_id]
        grp = {"n": np.int64(job.width),
               "members": np.asarray(job.members, np.int64),
               "step": np.int64(job.step)}
        try:
            grp["window"] = np.asarray(self.window_array(job_id), np.float64)
        except ValueError:
            pass
        return grp

    def checkpoint_groups(self) -> Dict[str, Dict[str, np.ndarray]]:
        return {self.registry[i].ckpt_group: self.checkpoint_group(i)
                for i in self.registry.ids()}

    # -- the decision path ----------------------------------------------
    # reprolint: hot-path
    def predict_cutoff(self, job_id: str) -> int:
        job = self.registry[job_id]
        if job.queued:
            self.flush()
        self._poll_refit(job)
        job.step += 1
        if job.mode == "fallback":
            job.fallback_steps += 1
            return min(job.fallback.predict_cutoff(), job.width)
        if not job.warmed_up:
            job.pending_pred = None
            return job.width
        if job.pending is None or job.pending[0] != job.step:
            # first decision after seeding/rejoin, or out-of-cadence
            # call: launch one now (prefetch() batches this for a whole
            # service set)
            self._decide_jobs([job], [job.step])
        _, row, out = job.pending
        job.pending = None
        host = self._out_host(out)
        # predictive moments come back as HOST rows (one shared fetch per
        # batched output, amortized over its jobs) so the next flush can
        # splice them straight into the packed upload
        job.pending_pred = (host["mu"][row], host["std"][row],
                            out["samples"], row)
        job.last_iter = float(host["iter"][row])
        return int(host["cutoff"][row])

    @staticmethod
    def _out_host(out: dict) -> dict:
        """Host view of one batched decision output, read ONCE per launch
        (cutoffs, moments and iter times of every job row in one pinned
        block, copied by the launch itself) and cached on the output dict;
        the (K, n) sample clouds stay on the device.  The bucket's event
        marks its latest launch, which covers this one; rows a later
        launch did not service still hold this launch's values, and a row
        is serviced again only after its decision was read."""
        h = out.get("host")
        if h is None:
            # THE designated wait: the launch's copy into pinned memory
            if out["event"] is not None:
                # reprolint: disable=host-sync-in-hot-path -- THE designated wait: the launch's copy into pinned memory
                out["event"].synchronize()
            # reprolint: disable=host-sync-in-hot-path -- a view of the pinned output buffer on the host, read after the wait above
            block = out["st"]["out_host"].numpy().copy()
            n = (block.shape[1] - 2) // 2
            h = out["host"] = {"cutoff": block[:, 0].astype(np.int64),
                               "iter": block[:, 1],
                               "mu": block[:, 2:2 + n],
                               "std": block[:, 2 + n:]}
        return h

    def prefetch(self, job_ids=None):
        """Batch the decide-only launch for every warmed job in
        ``job_ids`` (default: all) that has no decision in flight for its
        next step — one launch per bucket instead of one per job."""
        ids = job_ids if job_ids is not None else self.registry.ids()
        jobs = [self.registry[i] for i in ids]
        need = [j for j in jobs
                if j.mode == "dmm" and j.warmed_up and not j.queued
                and (j.pending is None or j.pending[0] != j.step + 1)]
        by_bucket: Dict[tuple, list] = {}
        for j in need:
            by_bucket.setdefault(j.bucket_sig, []).append(j)
        for group in by_bucket.values():
            self._decide_jobs(group, [j.step + 1 for j in group])

    def _decide_jobs(self, jobs: List[PSJob], dsteps: List[int]):
        """Decide-only batched launch for same-bucket jobs.  ``dsteps``
        are the decision steps: the caller's current step when invoked
        from ``predict_cutoff`` (which already incremented), step+1 when
        prefetching."""
        b = self._buckets[jobs[0].bucket_sig]
        slots = [j.slot for j in jobs]
        _, keys, _, _ = b.host_inp(slots)
        keys[slots, :2] = C._prng_key_rows(
            [j.seed + d for j, d in zip(jobs, dsteps)])
        b.launch("decide")
        self.dispatches += 1
        out = {"event": b.event, "st": b.st, "samples": b.st["samples"]}
        for j, d in zip(jobs, dsteps):
            j.pending = (d, j.slot, out)

    def observe(self, job_id: str, times, finished_mask=None):
        job = self.registry[job_id]
        t = np.asarray(times, np.float64)
        if t.shape != (job.width,):
            raise ValueError(
                f"job {job_id!r}: observe got {t.shape[0]} runtimes at "
                f"width {job.width}; resize() before the resized step")
        mask = (np.ones(job.width, bool) if finished_mask is None
                else np.asarray(finished_mask, bool))
        if not mask.any():
            # no coherent cutoff time exists to impute anything at: reject
            # loudly (the CutoffController/ElasticController convention)
            raise ValueError(
                f"job {job_id!r}: observe got an all-False finished_mask: "
                "a step with zero finished workers has no observed cutoff "
                "time to impute the censored entries at")
        # rolling imputed trace: refit training data (plain imputation at
        # the observed cutoff time, as ElasticController keeps it)
        row = np.where(mask, t, t[mask].max()) if not mask.all() else t
        job.trace = (job.trace + [row])[-self.history:]
        job.fresh += 1
        if job.mode == "fallback":
            job.fallback.observe(times, finished_mask)
            self._poll_refit(job)
            # a refit this poll installed put the job back on the DMM: no
            # second fit (the reference spawns one here and discards its
            # result when it lands)
            if job.mode == "fallback" and job.refit_task is None:
                self._maybe_refit(job)
            return
        if job.queued:
            self.flush()        # one observation in flight per job, max
        t32 = t.astype(np.float32)
        # mirror CutoffController.observe's mode selection exactly: a
        # full-sync observation takes the plain append even when moments
        # are pending
        cen = job.pending_pred is not None and not bool(mask.all())
        pred = (job.pending_pred[0], job.pending_pred[1]) if cen else None
        if job.pending_pred is not None:
            # moments stay valid for the queued imputation; the sample
            # cache does not survive the window change
            job.pending_pred = job.pending_pred[:2] + (None,
                                                       job.pending_pred[3])
        job.count = min(job.count + 1, job.cap)
        if job.warmed_up:
            self._queue.append({
                "job": job, "times": t32, "mask": mask, "cen": cen,
                "pred": pred, "dstep": job.step + 1, "istep": job.step})
            job.queued = True
        else:
            # warmup: plain append straight into the job's ring slot, in
            # place on the device (pad columns stay 0.0, which the
            # decision never reads)
            b = self._buckets[job.bucket_sig]
            rowp = np.zeros(b.n_pad, np.float32)
            rowp[:job.width] = np.where(mask, t32, t32[mask].max())
            with b.on_stream():
                ring = b.st["rings"][job.slot]
                head = b.st["heads"][job.slot]
                at = torch.arange(job.cap, device=b.device) == head
                ring.copy_(torch.where(
                    at[:, None], torch.from_numpy(rowp).to(b.device)[None],
                    ring))
                head.copy_((head + 1) % job.cap)

    def flush(self) -> int:
        """Launch every queued observation+decision: ONE launch per
        architecture bucket — mixed widths AND mixed plain/censored modes
        all ride it (width masks and censor flags are per-row data).
        Returns the launches issued."""
        if not self._queue:
            return 0
        # spans stamp host perf_counter edges around the launches; their
        # attributes are host ints already on the queue entries
        tracer = self.obs.trace if self.obs is not None else None
        fspan = (tracer.span("ps.flush", track="ps", tick=self.ticks,
                             queued=len(self._queue))
                 if tracer is not None else contextlib.nullcontext())
        with fspan:
            issued = self._launch_queue(tracer)
        self.dispatches += issued
        self.ticks += 1
        return issued

    def _launch_queue(self, tracer) -> int:
        """:meth:`flush`'s body: the queue grouped by bucket, one packed
        upload and one launch a bucket, each in a ``ps.dispatch`` span."""
        queue, self._queue = self._queue, []
        groups: Dict[tuple, list] = {}
        for e in queue:
            groups.setdefault(e["job"].bucket_sig, []).append(e)
        issued = 0
        for sig, entries in groups.items():
            b = self._buckets[sig]
            slots = [e["job"].slot for e in entries]
            gather = slots != list(range(len(b.jobs)))
            dspan = (tracer.span("ps.dispatch", track="ps",
                                 jobs=len(entries), n_pad=b.n_pad,
                                 gather=gather)
                     if tracer is not None else contextlib.nullcontext())
            with dspan:
                # one packed upload: [times, mask, mu, std] + keys/steps/cen
                pack, keys, steps, cen = b.host_inp(slots)
                for e, r in zip(entries, slots):
                    w = e["job"].width
                    pack[0, r, :w] = e["times"]
                    pack[1, r, :w] = e["mask"]
                    if e["cen"]:
                        pack[2, r, :w] = e["pred"][0][:w]
                        pack[3, r, :w] = e["pred"][1][:w]
                    steps[r] = e["istep"]
                    cen[r] = e["cen"]
                keys[slots, :2] = C._prng_key_rows(
                    [e["job"].seed + e["dstep"] for e in entries])
                keys[slots, 2:] = C._prng_key_rows(
                    [e["job"].seed + 1_000_003 for e in entries])
                b.launch("observe")
            issued += 1
            out = {"event": b.event, "st": b.st, "samples": b.st["samples"]}
            for e, r in zip(entries, slots):
                e["job"].pending = (e["dstep"], r, out)
                e["job"].queued = False
        return issued

    # -- diagnostics -----------------------------------------------------
    def predicted_iter_time(self, job_id: str) -> Optional[float]:
        """Posterior-predictive E[x_(c)] of the job's latest decision (raw
        seconds) — the shortest-predicted-step-first scheduler's key.
        None before the first warmed-up decision (and in fallback mode,
        where the analytic controller has no sample cloud)."""
        return self.registry[job_id].last_iter

    def predicted_order_stats(self, job_id: str):
        job = self.registry[job_id]
        samples = self.predicted_samples(job_id)
        if samples is None:
            return None
        self._buckets[job.bucket_sig].wait()
        return order_stats.mc_order_stats(samples.cpu().numpy())

    def predicted_samples(self, job_id: str):
        """DEVICE view of the job's latest predictive sample cloud,
        ``(K, n)`` with the bucket's pad columns sliced off — a view, never
        a host fetch.  None when no sampled decision is pending (cold,
        fallback mode, or already consumed by a censored observe)."""
        job = self.registry[job_id]
        if job.pending_pred is None or job.pending_pred[2] is None:
            return None
        return job.pending_pred[2][job.pending_pred[3], :, :job.width]

    def snapshot_samples(self, job_id: str):
        """:meth:`predicted_samples` copied into storage the caller owns
        (``core.controller.snapshot``), on the card on the bucket's
        stream, where the next launch rewrites the bucket's samples; the
        bucket's event covers the copy, so a restack waits for it before
        it drops the old block."""
        samples = self.predicted_samples(job_id)
        if samples is None:
            return None
        b = self._buckets[self.registry[job_id].bucket_sig]
        with b.on_stream():
            return C.snapshot(samples, b.stream)

    # -- elasticity ------------------------------------------------------
    def resize(self, job_id: str, n_workers: int, col_map=None,
               model: Optional[RuntimeModel] = None, members=None):
        """Per-job worker-set change, ElasticController protocol: remap
        the window (survivors column-exact), then either swap in a
        ``model`` fitted at the new width (job stays on the batched DMM
        path) or degrade to a warm-seeded Elfving fallback until the
        refit lands (``_maybe_refit``)."""
        self.flush()
        job = self.registry[job_id]
        n_new = int(n_workers)
        if (n_new == job.width and col_map is None and model is None
                and members is None):
            return          # idempotent: re-asserting the current width
                            # must not degrade a healthy DMM job
        if model is not None and model.n_workers != n_new:
            raise ValueError(
                f"resize({n_new}) got a RuntimeModel of width "
                f"{model.n_workers}; refit it for the new width first")
        rows = None
        if job.mode == "dmm" and job.count > 0:
            rows = self.window_array(job_id)
        if job.bucket_sig is not None:
            self._remove(job)
        if job.trace:
            job.trace = [r for r in C.remap_columns(
                np.stack(job.trace), n_new, col_map)]
        if rows is not None:
            rows = C.remap_columns(np.asarray(rows, np.float64), n_new,
                                   col_map)
        elif job.trace:
            rows = np.stack(job.trace[-job.cap:])
        job.width = n_new
        job.members = self._resized_members(job.members, n_new, col_map,
                                            members)
        job.resize_count += 1
        job.fresh = 0
        job.pending = None
        job.pending_pred = None
        job.last_iter = None
        # abandon any in-flight refit WITHOUT waiting for its ELBO fit:
        # the daemon thread keeps filling its orphaned result box, and
        # _poll_refit_task would discard it by generation anyway
        job.refit_task = None
        if model is not None:
            job.model = model
            self._place(job, rows)
            return
        job.model = None
        job.mode = "fallback"
        job.count = 0
        job.fallback = C.ElfvingController(
            n_new, warmup=self.fallback_warmup, min_frac=job.min_frac)
        for r in job.trace[-50:]:
            job.fallback.buf.append(np.asarray(r, np.float64))

    @staticmethod
    def _resized_members(old: np.ndarray, n_new: int, col_map,
                         members) -> np.ndarray:
        """GLOBAL worker ids across a resize.  Survivors keep their ids
        (via ``col_map``, the same remap the window uses); workers whose
        global id the caller didn't supply are marked ``-1`` — never
        silently renumbered, so the per-job checkpoint group's
        restore-by-global-id protocol stays sound."""
        if members is not None:
            members = np.asarray(members, int)
            if members.shape != (n_new,):
                raise ValueError(f"members must be ({n_new},), got "
                                 f"{members.shape}")
            return members
        if old.size == 0:
            # np.clip(cm, 0, old.size - 1) on an empty member array would
            # clip to index -1: there are no surviving ids to carry over,
            # so demand them explicitly instead of aliasing
            raise ValueError(
                f"resize({n_new}) from a width-0 member set has no "
                "surviving global worker ids to remap; pass members= "
                "explicitly")
        if col_map is None:
            col_map = np.concatenate([
                np.arange(min(old.size, n_new)),
                np.full(max(0, n_new - old.size), -1, int)])
        cm = np.asarray(col_map, int)
        return np.where(cm >= 0, old[np.clip(cm, 0, old.size - 1)], -1)

    # -- refit plumbing (ElasticController's task shape, per job) --------
    def _fit_model(self, job: PSJob, rows: np.ndarray, n: int,
                   seed: int) -> RuntimeModel:
        """A RuntimeModel of width ``n`` fitted on ``rows``, on the job's
        device.  On the card the fit runs on a stream of its own, which is
        synchronized before the model is returned
        (``ElasticController._fit_model``)."""
        model = RuntimeModel(n_workers=n, lag=job.lag, z_dim=job.z_dim,
                             hidden=job.hidden, device=job.device)
        stream = (torch.cuda.Stream(job.device)
                  if job.device.type == "cuda" else None)
        with (torch.cuda.stream(stream) if stream is not None
              else contextlib.nullcontext()):
            model.fit(rows, steps=self.refit_steps, batch=self.refit_batch,
                      seed=seed)
        if stream is not None:
            stream.synchronize()
        return model

    def _maybe_refit(self, job: PSJob):
        # failed attempts back off: each demands twice the fresh rows
        need = self.refit_fresh * (2 ** job.refit_failures)
        if (job.fresh < need
                or len(job.trace) < job.cap + self.refit_batch):
            return
        # freeze width/seed now: a resize mid-fit must not retarget the
        # running fit (its result is discarded by generation anyway)
        rows = np.stack(job.trace)
        n = job.width
        seed = job.seed + job.resize_count + 1000 * job.refit_failures
        if self.obs is not None:
            self.obs.metrics.counter("ps.refits_started").inc()
        if self.refit_async:
            job.refit_task = C._spawn_refit(
                lambda: self._fit_model(job, rows, n, seed),
                job.resize_count)
        else:
            span = (self.obs.trace.span("ps.refit", track="ps",
                                        job=job.job_id, width=n)
                    if self.obs is not None else contextlib.nullcontext())
            with span:
                model = self._fit_model(job, rows, n, seed)
            self._install_refit(job, model)

    def _poll_refit(self, job: PSJob):
        if job.refit_task is None:
            return
        done, model, err = C._poll_refit_task(job.refit_task,
                                              job.resize_count, job.width)
        if not done:
            return
        job.refit_task = None
        if err is not None:
            job.refit_failures += 1
            if self.obs is not None:
                self.obs.metrics.counter("ps.refit_failures").inc()
            if job.refit_failures > self.refit_retries:
                raise C.RefitError(
                    f"job {job.job_id!r}: DMM refit failed "
                    f"{job.refit_failures} times at width {job.width} "
                    f"(retry budget {self.refit_retries} spent); last "
                    f"error: {err!r}") from err
            print(f"job {job.job_id!r}: DMM refit failed ({err!r}); "
                  f"retrying after "
                  f"{self.refit_fresh * 2 ** job.refit_failures} fresh "
                  f"observations")
            job.fresh = 0
            return
        if model is not None and job.mode == "fallback":
            job.refit_failures = 0
            self._install_refit(job, model)

    def _install_refit(self, job: PSJob, model: RuntimeModel):
        job.model = model
        job.mode = "dmm"
        job.fallback = None
        self._place(job, np.stack(job.trace[-job.cap:]))
        if self.obs is not None:
            # a host counter only: _poll_refit reaches here from the hot
            # predict path
            self.obs.metrics.counter("ps.refits_installed").inc()

    def wait_refits(self, job_ids=None):
        """Block until every in-flight async refit for ``job_ids``
        (default: all) has finished and, if still current, been
        installed.  Deterministic sync point for tests and benches — the
        tick path itself never waits for a fit."""
        ids = job_ids if job_ids is not None else self.registry.ids()
        for i in ids:
            job = self.registry[i]
            if job.refit_task is not None:
                job.refit_task[0].join()
                self._poll_refit(job)


# ---------------------------------------------------------------------------
# Controller-protocol facade.
# ---------------------------------------------------------------------------


class JobHandle:
    """One job's controller-shaped view of the shared server.

    Implements the full controller protocol (`predict_cutoff`, `observe`,
    `resize`, `seed_window`, `window_array`, `predicted_order_stats`,
    `_step`), so a ``launch.train.Trainer`` drives the multi-tenant
    server without knowing it — including the checkpoint ``"ctl"`` group
    and the elastic ``_sync_membership`` path.
    """

    def __init__(self, server: PSServer, job_id: str):
        self.server = server
        self.job_id = job_id

    @property
    def job(self) -> PSJob:
        return self.server.registry[self.job_id]

    @property
    def n(self) -> int:
        return self.job.width

    @property
    def warmed_up(self) -> bool:
        return self.job.warmed_up

    @property
    def mode(self) -> str:
        return self.job.mode

    @property
    def _step(self) -> int:
        return self.job.step

    @_step.setter
    def _step(self, value: int):
        self.job.step = int(value)

    def predict_cutoff(self) -> int:
        return self.server.predict_cutoff(self.job_id)

    def observe(self, times, finished_mask=None):
        return self.server.observe(self.job_id, times, finished_mask)

    def resize(self, n_workers: int, col_map=None, model=None,
               members=None):
        return self.server.resize(self.job_id, n_workers, col_map=col_map,
                                  model=model, members=members)

    def seed_window(self, traces):
        return self.server.seed_window(self.job_id, traces)

    def window_array(self) -> np.ndarray:
        return self.server.window_array(self.job_id)

    def predicted_order_stats(self):
        return self.server.predicted_order_stats(self.job_id)

    def predicted_samples(self):
        return self.server.predicted_samples(self.job_id)

    def snapshot_samples(self):
        return self.server.snapshot_samples(self.job_id)

    def predicted_iter_time(self) -> Optional[float]:
        return self.server.predicted_iter_time(self.job_id)
