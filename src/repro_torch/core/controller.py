"""Cutoff controllers — the parameter-server decision logic (paper Alg. 1).

Each controller implements::

    c = ctl.predict_cutoff()            # before the step (paper Alg. 1 l.23)
    ctl.observe(times, finished_mask)   # after the step (lines 25-26)

and ``resize(n_workers, col_map=None, model=None, members=None)`` for
elastic membership.  The port of ``repro.core.controller``:

  * CutoffController — the paper's method: DMM + amortized inference, MC
    order statistics, censored imputation.  ``backend="device"`` keeps
    the lag window in a ring buffer on the model's device; ``observe``
    uploads one packed row and launches ONE fused observe+decide
    (:func:`_observe_decide_core`: censored-imputation append + guide →
    transition → emission → sample → sort → argmax → predictive moments)
    for the next step.  On the card that is one replay of a captured CUDA
    graph on the controller's own stream, so it overlaps the workers'
    compute, and ``predict_cutoff`` only waits for the cutoff in pinned
    host memory — the single host/device sync per step.  On the CPU the
    same body runs eagerly.  ``backend="numpy"`` is the float64 host
    reference the device path is held against.
  * FullSyncController, StaticCutoffController (Chen et al.'s fixed
    cutoff), FirstKController (their backup workers) and
    ElfvingController (the analytic iid-normal "order" baseline, Eq. 3):
    copies of the prior-art baselines.
  * AnytimeController and StaleReuseController: the straggler-policy
    wrappers, which keep any controller above for the cutoff and change
    only what a dropped worker contributes.
  * ElasticController: the DMM controller for a worker set that changes
    mid-run.  Across a resize it remaps its window, decides through a
    warm Elfving fallback, refits the DMM at the new width (on a worker
    thread with ``refit_async=True``: on the card the fit runs on a
    stream of its own) and swaps the refitted DMM back in.
    ``_spawn_refit`` / ``_poll_refit_task`` are the refit task's shape.
  * The ragged batched decision of the multi-tenant parameter server
    (``repro_torch.ps``): ``_batched_observe_decide_ragged`` /
    ``_batched_decide_ragged`` over an explicit leading job axis, and the
    host-built key rows (``_prng_key_rows``, ``stacked_prng_keys``,
    ``_batched_impute_keys``) its packed upload carries.
"""
from __future__ import annotations

import contextlib
import math
import threading
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from repro_torch import random as R
from repro_torch.cluster.simulator import microbatch_progress
from repro_torch.core.cutoff import censoring, elfving, order_stats
from repro_torch.core.runtime_model.api import RuntimeModel, colwise_uniform


class FullSyncController:
    def __init__(self, n_workers: int):
        self.n = n_workers

    def predict_cutoff(self) -> int:
        return self.n

    def observe(self, times, finished_mask=None):
        pass

    def resize(self, n_workers: int, col_map=None, model=None,
               members=None):
        """Elastic membership change: track the new worker count
        (width-only controllers ignore the global ``members`` ids)."""
        self.n = int(n_workers)


class StaticCutoffController(FullSyncController):
    """Chen et al. (2016): fixed c < n for the whole run."""

    def __init__(self, n_workers: int, cutoff: Optional[int] = None,
                 drop_frac: float = 0.06):
        super().__init__(n_workers)
        self.drop_frac = drop_frac
        self._cutoff = cutoff        # the configured cutoff, never clamped
        self.c = cutoff if cutoff is not None else max(
            1, int(round(n_workers * (1 - drop_frac))))

    def predict_cutoff(self) -> int:
        return self.c

    def resize(self, n_workers: int, col_map=None, model=None,
               members=None):
        super().resize(n_workers, col_map, model, members)
        if self._cutoff is not None:
            # clamp to the live width but keep the configured value, so a
            # transient shrink doesn't permanently lower the baseline
            self.c = min(self._cutoff, self.n)
        else:
            self.c = max(1, int(round(self.n * (1 - self.drop_frac))))


class FirstKController(FullSyncController):
    """Chen et al. (2016) backup-workers baseline: accept the first
    ``n - b`` gradient arrivals BY COUNT, where ``b`` backup workers are
    provisioned to absorb stragglers.

    The distinction from :class:`StaticCutoffController` is the
    parameterization: the backup COUNT is fixed capacity (Chen et al.
    provision b extra machines), so a resize keeps ``b`` constant and the
    cutoff moves with the live width — shrink a 32-worker job to 24 and a
    4-backup config still accepts the first 20, not ``24 * (1 - 4/32)``.
    Count-based acceptance never consults the runtime distribution, which
    is exactly the error–runtime trade-off the paper's DMM controller
    beats (tests/test_controllers.py races it on wall-clock-to-loss).
    """

    def __init__(self, n_workers: int, backup: Optional[int] = None,
                 backup_frac: float = 0.04):
        super().__init__(n_workers)
        self.backup = (int(backup) if backup is not None
                       else max(1, int(round(n_workers * backup_frac))))

    def predict_cutoff(self) -> int:
        return max(1, self.n - self.backup)

    # resize: FullSyncController already tracks the live width; the backup
    # count deliberately stays fixed (it is provisioned capacity).


class ElfvingController(FullSyncController):
    """Analytic normality baseline: running (mu, sigma) -> Eq. 3 cutoff."""

    def __init__(self, n_workers: int, warmup: int = 5,
                 min_frac: float = 0.5):
        super().__init__(n_workers)
        self.buf: list = []
        self.warmup = warmup
        self.min_frac = min_frac

    def predict_cutoff(self) -> int:
        if len(self.buf) < self.warmup:
            return self.n
        data = np.concatenate(self.buf[-50:])
        return elfving.elfving_cutoff(self.n, float(data.mean()),
                                      float(data.std()), self.min_frac)

    def observe(self, times, finished_mask=None):
        t = np.asarray(times, np.float64)
        if finished_mask is not None:
            m = np.asarray(finished_mask, bool)
            if not m.any():
                raise ValueError(
                    "observe got an all-False finished_mask: a step with "
                    "zero finished workers has no observed cutoff time to "
                    "impute the censored entries at")
            if not m.all():
                # keeping only finished workers' times would bias the
                # running (mu, sigma) toward the fast workers once cutoffs
                # engage; a censored entry takes the observed cutoff time,
                # a lower bound on its true runtime (§4.2's truncation,
                # analytically)
                t = np.where(m, t, t[m].max())
        self.buf.append(t)


# ---------------------------------------------------------------------------
# Straggler-policy frontier: what a dropped worker contributes.
#
# The controllers above share one straggler policy, discard: a worker
# outside the cutoff contributes nothing.  The two wrappers below keep any
# of them for the CUTOFF decision and change only what the dropped workers
# contribute (src/repro/core/README.md has the policy table).
# ---------------------------------------------------------------------------


def snapshot(samples, stream=None):
    """A copy of a decision's sample cloud that the caller owns, as
    ``(copy, event)``; None when ``samples`` is.

    The controllers write their sample cloud in place (the device state's
    ``samples``, a bucket's output), so a handle to it is valid only until
    the next decision.  On the card the copy is issued on ``stream``, the
    stream whose next launch overwrites ``samples``: that launch is then
    ordered after the copy.  ``event`` marks the copy's end for whoever
    reads it on another stream (None off the card).  Host arrays are
    copied too."""
    if samples is None:
        return None
    if not isinstance(samples, torch.Tensor):
        return np.array(samples, copy=True), None
    if stream is None:
        return samples.clone(), None
    with torch.cuda.stream(stream):
        copy = samples.clone()
        event = torch.cuda.Event()
        event.record(stream)
    return copy, event


class _PolicyWrapper:
    """Delegating base for straggler-policy wrappers: the inner controller
    owns the cutoff decision, the observe window, its step count and the
    elastic resize protocol; the wrapper changes only the contribution
    semantics."""

    def __init__(self, inner):
        self.inner = inner

    @property
    def n(self) -> int:
        return self.inner.n

    @property
    def _step(self) -> int:
        # the decision keys are (seed, step): a checkpoint restores the
        # inner controller's step through the wrapper (AttributeError, so
        # ``hasattr`` is False, when the inner keeps none)
        return self.inner._step

    @_step.setter
    def _step(self, value: int):
        self.inner._step = value

    def predict_cutoff(self) -> int:
        return self.inner.predict_cutoff()

    def observe(self, times, finished_mask=None):
        return self.inner.observe(times, finished_mask)

    def resize(self, n_workers: int, col_map=None, model=None,
               members=None):
        return self.inner.resize(n_workers, col_map=col_map, model=model,
                                 members=members)

    def _inner_call(self, name: str):
        fn = getattr(self.inner, name, None)
        return fn() if fn is not None else None

    def predicted_order_stats(self):
        return self._inner_call("predicted_order_stats")

    def predicted_samples(self):
        return self._inner_call("predicted_samples")

    def snapshot_samples(self):
        return self._inner_call("snapshot_samples")

    def predicted_iter_time(self):
        return self._inner_call("predicted_iter_time")

    def window_array(self) -> np.ndarray:
        fn = getattr(self.inner, "window_array", None)
        if fn is None:
            # the contract of an empty CutoffController window: the
            # checkpoint skips controllers with nothing to persist
            raise ValueError("inner controller keeps no window")
        return fn()

    def seed_window(self, traces: np.ndarray):
        fn = getattr(self.inner, "seed_window", None)
        if fn is not None:
            return fn(traces)


class AnytimeController(_PolicyWrapper):
    """Anytime SGD (Ferdinand & Draper): stragglers contribute PARTIAL
    gradient sums at the cutoff instead of being discarded.

    The inner controller picks the cutoff c; :meth:`contribution` returns
    a per-worker f32 vector: 1.0 for the c finishers (tie-consistent with
    the bit array), and for everyone else the fraction of its ``n_micro``
    microbatches completed by the cutoff time
    (``cluster.simulator.microbatch_progress``).  With ``n_micro=1`` the
    vector is the discard bit array, bit for bit.  ``observe`` keeps the
    discard policy's finished mask: a straggler's full-step runtime is
    still censored at the cutoff time.
    """

    def __init__(self, inner, n_micro: int = 1):
        super().__init__(inner)
        if n_micro < 1:
            raise ValueError(f"n_micro must be >= 1, got {n_micro}")
        self.n_micro = int(n_micro)

    def contribution(self, times, c: int) -> np.ndarray:
        """Per-worker f32 contribution vector for a step decided at
        cutoff ``c``."""
        times = np.asarray(times, np.float64)
        order = np.argsort(times, kind="stable")
        cutoff_time = float(times[order[c - 1]])
        contrib = microbatch_progress(times, cutoff_time,
                                      self.n_micro).astype(np.float32)
        contrib[order[:c]] = 1.0       # finishers, exactly (tie-consistent)
        return contrib


class StaleReuseController(_PolicyWrapper):
    """Stale-gradient reuse (Dutta et al.): a dropped worker's LATE
    gradient is buffered by the Trainer and folded into the NEXT step with
    a staleness-decayed weight.

    The wrapper carries only the policy knob: ``stale_decay`` is the
    weight a one-step-stale gradient enters the next step's masked mean
    with (a fresh gradient's is 1.0).  The Trainer detects the attribute
    and the ``stale_reuse=True`` train step does the fold
    (``launch.train.make_train_step``, mask_agg="psum" only).
    ``stale_decay=0`` is exactly the discard policy.
    """

    def __init__(self, inner, decay: float = 0.5):
        super().__init__(inner)
        if not 0.0 <= decay <= 1.0:
            raise ValueError(f"decay must be in [0, 1], got {decay}")
        self.stale_decay = float(decay)


# ---------------------------------------------------------------------------
# Elastic membership: window remapping across worker-set changes.
# ---------------------------------------------------------------------------


def remap_columns(rows: np.ndarray, n_new: int,
                  col_map: Optional[np.ndarray] = None) -> np.ndarray:
    """Remap (T, n_old) worker-indexed rows onto a resized worker set.

    ``col_map`` is (n_new,) of old column indices — survivors carry their
    runtime series over column-exactly — with ``-1`` marking NEW workers,
    whose column is seeded row-by-row from the cluster mean of the
    surviving columns.  Default: identity prefix (old worker i -> new
    column i, extra columns new).
    """
    rows = np.asarray(rows)
    if rows.ndim != 2:
        raise ValueError(f"rows must be (T, n), got {rows.shape}")
    n_old = rows.shape[1]
    if col_map is None:
        col_map = np.concatenate([
            np.arange(min(n_old, n_new)),
            np.full(max(0, n_new - n_old), -1, int)])
    col_map = np.asarray(col_map, int)
    if col_map.shape != (n_new,):
        raise ValueError(f"col_map must be ({n_new},), got {col_map.shape}")
    if np.any(col_map >= n_old):
        raise ValueError(f"col_map references old columns >= {n_old}")
    surv = col_map[col_map >= 0]
    fill = (rows[:, surv].mean(axis=1) if surv.size
            else rows.mean(axis=1))
    out = np.where((col_map >= 0)[None, :],
                   rows[:, np.clip(col_map, 0, n_old - 1)],
                   fill[:, None])
    return out.astype(rows.dtype)


# ---------------------------------------------------------------------------
# The fused observe+decide: one body, run eagerly on the CPU and captured
# once per (mode, decide, k_samples, lo, n) as a CUDA graph on the card.
#
# Its state is a dict of fixed tensors (:func:`_state`): the (lag+1, n)
# f32 ring and its 0-d int64 head (the OLDEST row); ``obs``, one packed
# f64 upload per step: the (n,) times, the (n,) finished mask, the decide
# key and the impute key (32-bit words are exact in f64); and the outputs
# of the last decision: samples, moments and ``pack``, the cutoff beside
# the bits of E[x_(c)] (one 8-byte fetch).  The censored append reads the
# moments of the decision the previous predict_cutoff consumed, which are
# still in the output tensors when it runs.
# ---------------------------------------------------------------------------


def _state(n: int, cap: int, k_samples: int, device) -> dict:
    f32 = dict(dtype=torch.float32, device=device)
    return {"ring": torch.zeros((cap, n), **f32),
            "head": torch.zeros((), dtype=torch.int64, device=device),
            "obs": torch.zeros((2 * n + 4,), dtype=torch.float64,
                               device=device),
            "samples": torch.zeros((k_samples, n), **f32),
            "mu": torch.zeros((n,), **f32),
            "std": torch.zeros((n,), **f32),
            "pack": torch.zeros((2,), dtype=torch.int32, device=device)}


def _append_core(st: dict, mode: str):
    """Ring append in place; ``mode`` picks the imputation.

    "plain": censored entries take the observed cutoff time (warmup
    fallback, and the full-sync case).  "censored": fused truncated-normal
    imputation (paper §4.2) — the uniform draw, the inverse-CDF, the
    where-merge and the ring write all stay on the device.
    """
    ring, head, obs = st["ring"], st["head"], st["obs"]
    cap, n = ring.shape
    times = obs[:n].to(torch.float32)
    mask = obs[n:2 * n] > 0.5
    cutoff_time = torch.max(torch.where(mask, times, -math.inf))
    if mode == "censored":
        u = colwise_uniform(obs[2 * n + 2:].to(torch.int64), n)
        row = censoring.impute_censored_torch(times, mask, st["mu"],
                                              st["std"], cutoff_time, u)
    else:
        row = torch.where(mask, times, cutoff_time)
    ring.index_copy_(0, head.reshape(1), row[None])
    head.copy_((head + 1) % cap)


def _observe_decide_core(params, st: dict, *, mode: str, decide: bool,
                         k_samples: int, lo: int, norm_scale: float):
    """One whole controller iteration on the state ``st``, in place: flush
    the deferred observation (``mode`` "plain" or "censored"; "none"
    skips it) into the ring, then, when ``decide``, run the full decision
    on the updated window and write its outputs."""
    if mode != "none":
        _append_core(st, mode)
    if not decide:
        return
    n = st["ring"].shape[1]
    key = st["obs"][2 * n:2 * n + 2].to(torch.int64)
    cutoff, samples, mu, std, it = RuntimeModel._decide_core(
        params, st["ring"], st["head"], key, norm_scale, k_samples, lo)
    st["samples"].copy_(samples)
    st["mu"].copy_(mu)
    st["std"].copy_(std)
    st["pack"].copy_(torch.stack([cutoff, it.view(torch.int32)]))


def _impute_key(seed: int, step: int):
    """The words of the per-step key both backends draw imputation
    uniforms from: ``fold_in(PRNGKey(seed + 1_000_003), step)``, hashed
    on the host from python ints.  Offset so it can never collide with the
    prediction keys (``PRNGKey(seed + step)``)."""
    return R.threefry2x32(0, (seed + 1_000_003) & 0xFFFFFFFF,
                          0, step & 0xFFFFFFFF)


# ---------------------------------------------------------------------------
# The ragged batched decision of the multi-tenant parameter server
# (``repro_torch.ps``): J jobs of one DMM architecture, mixed widths
# included, decided by ONE body over an explicit leading job axis.  Every
# operand carries the (J,) axis: params stacked by
# ``api.stack_models_padded`` (laid out by ``api.batched_layout``), the
# (J, lag+1, n_pad) ring stack, heads, the observation rows, masks and
# moments, keys, norm scales, widths, argmax floors and censor flags.  The
# server captures the body as one CUDA graph a bucket on the card.
# ---------------------------------------------------------------------------


def _ragged_append_core(rings, heads, obs):
    """Ragged twin of :func:`_append_core`, functional, with the imputation
    mode chosen per job by ``obs["cen"]`` ((J,) bool): both rows are
    computed (cheap elementwise work) and where-merged, so a mixed
    plain/censored job set shares one launch.  Padded columns (mask True,
    time 0) write 0.0, which the decision's column mask never reads.
    Returns the new (rings, heads)."""
    times, mask = obs["times"], obs["mask"]
    cutoff_time = torch.amax(torch.where(mask, times, -math.inf),
                             dim=-1)[:, None]
    u = colwise_uniform(obs["key"], times.shape[-1])
    crow = censoring.impute_censored_torch(times, mask, obs["mu"],
                                           obs["std"], cutoff_time, u)
    prow = torch.where(mask, times, cutoff_time)
    row = torch.where(obs["cen"][:, None], crow, prow)
    cap = rings.shape[1]
    at = (torch.arange(cap, device=rings.device)[None, :]
          == heads[:, None])
    return (torch.where(at[:, :, None], row[:, None, :], rings),
            (heads + 1) % cap)


def _batched_observe_decide_ragged(params, rings, heads, obs, keys,
                                   norm_scales, widths, los, *,
                                   k_samples: int):
    """J whole RAGGED controller iterations at once (the reference's
    ``_ragged_observe_decide_core`` under ``jax.vmap``): the traced-mode
    append (:func:`_ragged_append_core`), then the ragged decision
    (``RuntimeModel._decide_core(width=...)``) on the updated rings.
    Returns (rings, heads, cutoffs (J,), samples (J, K, n_pad), mu, std
    (J, n_pad), iter (J,))."""
    rings, heads = _ragged_append_core(rings, heads, obs)
    out = RuntimeModel._decide_core(params, rings, heads, keys, norm_scales,
                                    k_samples, los, width=widths)
    return (rings, heads) + tuple(out)


def _batched_decide_ragged(params, rings, heads, keys, norm_scales, widths,
                           los, *, k_samples: int):
    """Decide-only twin of :func:`_batched_observe_decide_ragged`: the
    first post-seeding decision of a batch of jobs."""
    return RuntimeModel._decide_core(params, rings, heads, keys, norm_scales,
                                     k_samples, los, width=widths)


def _prng_key_rows(seeds) -> np.ndarray:
    """(J, 2) uint32 HOST array, row j bit-identical to
    ``jax.random.PRNGKey(seeds[j])`` with x64 off: the seed's low 32 bits
    after a zero high word.  Built on the host so the server's flush can
    splice decide and impute keys into one packed upload."""
    seeds = np.asarray(list(seeds), np.uint64)
    out = np.zeros((seeds.shape[0], 2), np.uint32)
    out[:, 1] = (seeds & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    return out


def stacked_prng_keys(seeds, device=None) -> torch.Tensor:
    """(J, 2) key stack (the twin's int64 words), row j equal to
    ``random.PRNGKey(seeds[j])``: ONE upload instead of J."""
    return torch.as_tensor(_prng_key_rows(seeds).astype(np.int64),
                           device=device)


def _batched_impute_keys(base_keys, steps):
    """The folded keys of a stack: row j equals ``_impute_key(seed_j,
    step_j)`` when ``base_keys[j] == PRNGKey(seed_j + 1_000_003)``
    (``random.fold_in`` broadcasts a (J, 2) stack against (J,) data)."""
    return R.fold_in(base_keys, steps)


@dataclass
class CutoffController:
    """The paper's dynamic controller (DMM + amortized inference).

    Keeps the lag-l window of (imputed) runtime vectors; each iteration:
      1. predict K samples of the next joint runtime vector (Eq. 5),
      2. c* = argmax_c E[c / x_(c)]  (throughput-optimal cutoff),
      3. after the step, impute censored runtimes from the predictive
         distribution left-truncated at the observed cutoff time (§4.2).

    ``backend="device"`` (default): the window lives in a (lag+1, n) f32
    ring on the model's device; ``observe`` uploads one packed row and
    launches the fused append+decide for the next step (on the card: one
    graph replay on the controller's stream), and ``predict_cutoff``
    fetches the cutoff.  A capture that fails raises; nothing falls back
    to eager launches on the card.  ``backend="numpy"``: the float64 host
    reference.  Both draw the same imputation uniforms
    (``colwise_uniform`` under :func:`_impute_key`), so their cutoff
    sequences are identical and their windows agree to f32 precision on
    seeded runs.
    """
    model: RuntimeModel
    k_samples: int = 64
    min_frac: float = 0.5
    seed: int = 0
    backend: str = "device"

    _window: list = field(default_factory=list)       # numpy backend
    _st: Optional[dict] = None                        # device backend
    _count: int = 0
    _pending_pred: Optional[tuple] = None
    _pending_step: Optional[int] = None   # step of the decision in flight
    _last_iter: Optional[object] = None   # E[x_(c)] of the last decision
    _step: int = 0
    #: CUDA graphs by (mode, decide, k_samples, lo, n), and what they
    #: captured: the params tree and the norm scale
    graphs: dict = field(default_factory=dict)
    #: graph replays on the card (one a decision or warmup append)
    replays: int = 0
    _graph_model: Optional[tuple] = None
    _stream: Optional[object] = None
    _event: Optional[object] = None
    _obs_host: Optional[torch.Tensor] = None
    _pack_host: Optional[torch.Tensor] = None

    def __post_init__(self):
        if self.backend not in ("device", "numpy"):
            raise ValueError(f"unknown backend {self.backend!r}")

    @property
    def n(self) -> int:
        return self.model.n_workers

    @property
    def _cap(self) -> int:
        return self.model.lag + 1

    @property
    def warmed_up(self) -> bool:
        if self.backend == "numpy":
            return len(self._window) >= self._cap
        return self._count >= self._cap

    # -- device state ---------------------------------------------------
    def _ensure_ring(self):
        if self._st is not None:
            return
        dev = self.model.device
        self._st = _state(self.n, self._cap, self.k_samples, dev)
        self.graphs = {}
        if dev.type == "cuda":
            self._stream = torch.cuda.Stream(dev)
            self._event = torch.cuda.Event()
            self._obs_host = torch.zeros(self._st["obs"].shape,
                                         dtype=torch.float64, pin_memory=True)
            self._pack_host = torch.zeros((2,), dtype=torch.int32,
                                          pin_memory=True)
        else:
            self._stream = self._event = None
            self._obs_host, self._pack_host = self._st["obs"], self._st["pack"]

    @contextlib.contextmanager
    def _on_stream(self):
        """Device work on the controller's stream, its end marked by the
        controller's event (on the CPU: nothing to order)."""
        if self._stream is None:
            yield
            return
        with torch.cuda.stream(self._stream):
            yield
            self._event.record(self._stream)

    def _wait(self):
        """Block until the controller's device work is done (the pinned
        buffers may then be read and rewritten)."""
        if self._event is not None:
            # reprolint: disable=host-sync-in-hot-path -- THE designated wait: the pinned buffers are read and rewritten only after the controller's device work is done
            self._event.synchronize()

    def _launch(self, mode: str, decide: bool):
        """Run the fused body on the state: eagerly on the CPU; on the card
        upload the packed row, replay the graph for this shape (captured at
        its first use) and fetch ``pack`` into pinned host memory."""
        lo = order_stats.min_frac_floor(self.n, self.min_frac)
        params, norm_scale = self.model.params, self.model.norm_scale

        def run(st):
            _observe_decide_core(params, st, mode=mode, decide=decide,
                                 k_samples=self.k_samples, lo=lo,
                                 norm_scale=norm_scale)

        if self._stream is None:
            run(self._st)
            return
        if self._graph_model is None or any(
                a is not b for a, b in zip((params, norm_scale),
                                           self._graph_model)):
            self.graphs = {}               # a new model: capture anew
            self._graph_model = (params, norm_scale)
        with self._on_stream():
            self._st["obs"].copy_(self._obs_host, non_blocking=True)
        key = (mode, decide, self.k_samples, lo, self.n)
        if key not in self.graphs:
            # reprolint: disable=static-argnum-width -- one controller, one width: lo and n change only on an elastic resize (a new graph then, never one a tick), as the reference's single-job path keeps lo static
            self.graphs[key] = self._capture(run)
        with self._on_stream():
            self.graphs[key].replay()
            self.replays += 1
            if decide:
                self._pack_host.copy_(self._st["pack"], non_blocking=True)

    def _capture(self, run):
        """Capture ``run(state)`` as a CUDA graph on the controller's
        stream.  It first runs once, eagerly, on a copy of the state (the
        libraries' lazy set-up must not happen inside the capture, and the
        warm-up must not step the real ring).  A capture that fails
        raises.

        The capture is thread-local: a call that is unsafe during a
        capture (a sync, a blocking copy, a cudaMalloc) still breaks it
        when this thread makes it, but not when another thread does.  An
        ``ElasticController`` refit may be fitting a model on a worker
        thread, on a stream of its own, while the trainer's thread
        captures a new controller's graphs; in the default global mode
        such a call from the fit (an allocation, a pageable index copy, its
        final fetch) may
        invalidate the capture and fail the fit."""
        with self._on_stream():
            run({k: v.clone() for k, v in self._st.items()})
        self._wait()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=self._stream,
                              capture_error_mode="thread_local"):
            run(self._st)
        return graph

    def _pack(self, times=None, mask=None, decide_step=None,
              impute_step=None):
        """Write the step's packed upload (host side)."""
        self._wait()
        # reprolint: disable=host-sync-in-hot-path -- a view of the pinned upload buffer on the host (no copy, no wait), written after _wait
        o, n = self._obs_host.numpy(), self.n
        if times is not None:
            o[:n] = np.asarray(times, np.float32)
            o[n:2 * n] = (np.ones(n) if mask is None
                          else np.asarray(mask, bool))
        if decide_step is not None:
            o[2 * n:2 * n + 2] = (0, (self.seed + decide_step) & 0xFFFFFFFF)
        if impute_step is not None:
            o[2 * n + 2:] = _impute_key(self.seed, impute_step)

    # -- window plumbing ------------------------------------------------
    def window_array(self) -> np.ndarray:
        """The current lag window, oldest row first, as a numpy array.

        Raises ValueError while the window is empty (both backends).
        """
        if self.backend == "numpy":
            if not self._window:
                raise ValueError("window is empty")
            return np.stack(self._window[-self._cap:])
        self._ensure_ring()
        if self._count == 0:
            raise ValueError("window is empty")
        self._wait()
        ring = self._st["ring"].cpu().numpy()
        w = np.roll(ring, -int(self._st["head"]), axis=0)
        return w[-self._count:] if self._count < self._cap else w

    def seed_window(self, traces: np.ndarray):
        """Warm-start the lag window from recorded traces.

        Device backend: built host-side and uploaded in ONE transfer (the
        rows as f32, verbatim, as a plain append with a full mask writes
        them)."""
        rows = np.asarray(traces)[-self._cap:]
        if self.backend == "numpy":
            for row in rows:
                self._window.append(np.asarray(row, np.float64))
            return
        self._ensure_ring()
        self._pending_step = None
        merged = np.asarray(rows, np.float32)
        if self._count:
            merged = np.concatenate(
                [np.asarray(self.window_array(), np.float32), merged])
        merged = merged[-self._cap:]
        m = merged.shape[0]
        ring = np.zeros((self._cap, self.n), np.float32)
        ring[:m] = merged
        self._wait()
        with self._on_stream():
            self._st["ring"].copy_(torch.from_numpy(ring))
            self._st["head"].fill_(m % self._cap)
        self._count = min(self._count + rows.shape[0], self._cap)

    def resize(self, n_workers: int, col_map=None,
               model: Optional[RuntimeModel] = None, members=None):
        """Remap the lag window across a worker-set change.

        Survivor columns (``col_map`` entries >= 0) move column-exactly
        into the resized ring; NEW workers' columns are seeded from the
        per-row cluster mean of the survivors (:func:`remap_columns`).
        ``model`` must be a :class:`RuntimeModel` of the NEW width (the
        DMM's emission layer is shaped by n_workers); the device backend
        captures its graphs anew for it.
        """
        n_new = int(n_workers)
        model = model if model is not None else self.model
        if model.n_workers != n_new:
            raise ValueError(
                f"resize({n_new}) needs a RuntimeModel of that width, got "
                f"n_workers={model.n_workers}; refit first")
        have_rows = (len(self._window) > 0 if self.backend == "numpy"
                     else self._count > 0)
        rows = self.window_array() if have_rows else None
        self.model = model
        self._pending_step = None
        self._pending_pred = None
        self._last_iter = None
        if self.backend == "numpy":
            self._window = []
            if rows is not None:
                remapped = remap_columns(np.asarray(rows, np.float64), n_new,
                                         col_map)
                self._window = [row for row in remapped]
            return
        self._wait()
        self._st = None
        self._graph_model = None
        self._count = 0
        self._ensure_ring()
        if rows is not None:
            self.seed_window(remap_columns(rows, n_new, col_map))

    def _dispatch_decision(self, mode: str, step: int, times=None,
                           mask=None):
        """Launch the fused observe+decide for ``step`` (asynchronous on
        the card: nothing waits until the cutoff is read)."""
        self._pack(times, mask, decide_step=step,
                   impute_step=self._step if mode == "censored" else None)
        self._launch(mode, decide=True)
        self._pending_step = step

    # -- decision -------------------------------------------------------
    def predict_cutoff(self) -> int:
        self._step += 1
        if not self.warmed_up:
            self._pending_pred = None
            return self.n
        if self.backend == "numpy":
            w = np.stack(self._window[-self._cap:])
            samples, mu, std = self.model.predict_next(
                w, self.k_samples, seed=self.seed + self._step)
            # per-worker predictive moments (for censoring) from MC samples:
            # the K draws form a Gaussian mixture, so the variance is
            # E[std^2] + Var[mu] (mixture-variance law)
            self._pending_pred = (
                mu.mean(axis=0),
                np.sqrt(np.mean(std ** 2, axis=0) + mu.var(axis=0)),
                samples)
            c = order_stats.optimal_cutoff(samples, self.min_frac)
            # lazy: the extra sort only runs if a scheduler actually asks
            self._last_iter = ("lazy", samples, c)
            return c
        if self._pending_step != self._step:
            # no decision in flight for this step (first decision after
            # warmup/seeding, or out-of-cadence call): launch one now
            self._dispatch_decision("none", self._step)
        self._pending_step = None
        st = self._st
        self._pending_pred = (st["mu"], st["std"], st["samples"])
        # the ONLY host/device sync on the decision path: the cutoff (and
        # the bits of E[x_(c)] beside it) in pinned host memory
        self._wait()
        pack = self._pack_host.numpy()
        self._last_iter = float(pack[1:].view(np.float32)[0])
        return int(pack[0])

    def predicted_samples(self):
        """The predictive sample cloud (K, n) behind the decision just
        made: the device backend's output tensor (valid until the next
        ``observe``), the numpy backend's host samples.  None before
        warmup and after ``observe`` consumed the cache."""
        if self._pending_pred is None:
            return None
        return self._pending_pred[2]

    def snapshot_samples(self):
        """:meth:`predicted_samples` copied into storage the caller owns
        (:func:`snapshot`), on the card on the controller's stream,
        where the next decision's replay rewrites the state's samples;
        the controller's event covers the copy, so a resize waits for it
        before it drops the state."""
        with self._on_stream():
            return snapshot(self.predicted_samples(), self._stream)

    def predicted_iter_time(self):
        """Posterior-predictive E[x_(c)] of the step just decided (raw
        seconds); None before the first warmed-up decision.  The device
        backend gets it out of the fused decision's shared sort; the numpy
        backend computes it here, on demand."""
        if self._last_iter is None:
            return None
        if isinstance(self._last_iter, tuple):
            _, samples, c = self._last_iter
            self._last_iter = float(
                np.sort(samples, axis=1)[:, c - 1].mean())
        return float(self._last_iter)

    def predicted_order_stats(self):
        """(mean, std) of predicted order statistics for the next step.

        Reuses the samples drawn by the preceding ``predict_cutoff``;
        after ``observe`` consumed them, a fresh prediction over the
        updated window.
        """
        if not self.warmed_up:
            return None
        samples = self.predicted_samples()
        if samples is not None:
            samples = (samples.cpu().numpy()
                       if isinstance(samples, torch.Tensor) else samples)
        else:
            samples, _, _ = self.model.predict_next(
                self.window_array(), self.k_samples,
                seed=self.seed + self._step)
        return order_stats.mc_order_stats(samples)

    # -- observation ----------------------------------------------------
    def observe(self, times, finished_mask=None):
        if finished_mask is not None and not bool(np.any(finished_mask)):
            # no coherent cutoff time exists: the device path would impute
            # at max(where(False, ..)) = -inf and poison the ring
            raise ValueError(
                "observe got an all-False finished_mask: a step with zero "
                "finished workers has no observed cutoff time to impute "
                "the censored entries at")
        if self.backend == "numpy":
            return self._observe_numpy(times, finished_mask)
        self._ensure_ring()
        all_finished = finished_mask is None or bool(np.all(finished_mask))
        mode = ("plain" if self._pending_pred is None or all_finished
                else "censored")
        if self._pending_pred is not None:
            # the moments stay valid for the append; the sample cache does
            # not survive a window change
            self._pending_pred = self._pending_pred[:2] + (None,)
        self._count = min(self._count + 1, self._cap)
        if self.warmed_up:
            # pipeline: fuse this append (imputation included) with the
            # NEXT step's decision and launch it now, so the decision runs
            # while the workers compute (paper §1: the controller must
            # decide faster than the workers step)
            self._dispatch_decision(mode, self._step + 1, times,
                                    finished_mask)
        else:
            self._pack(times, finished_mask,
                       impute_step=self._step if mode == "censored" else None)
            self._launch(mode, decide=False)

    def _observe_numpy(self, times, finished_mask=None):
        t = np.asarray(times, np.float64)
        if self._pending_pred is not None:
            # moments stay valid for a repeated observe; the sample cache
            # does not survive a window change
            self._pending_pred = self._pending_pred[:2] + (None,)
        # every read uses only the last lag+1 rows
        del self._window[:-self._cap]
        if finished_mask is None or bool(np.all(finished_mask)):
            self._window.append(t)
            return
        mask = np.asarray(finished_mask, bool)
        cutoff_time = float(t[mask].max())
        if self._pending_pred is None:
            # warmup fallback: impute with the max observed time
            imputed = np.where(mask, t, cutoff_time)
        else:
            mu, std = self._pending_pred[0], self._pending_pred[1]
            key = torch.tensor(_impute_key(self.seed, self._step))
            # reprolint: disable=host-sync-in-hot-path -- the numpy backend: the key and its draw live on the host
            u = colwise_uniform(key, t.shape[0]).numpy().astype(np.float64)
            imputed = censoring.impute_censored(t, mask, mu, std,
                                                cutoff_time, u=u)
        self._window.append(imputed)


# ---------------------------------------------------------------------------
# Elastic membership: DMM controller + analytic fallback + refit.
# ---------------------------------------------------------------------------


class RefitError(RuntimeError):
    """An async DMM refit raised, and the retry budget is spent.

    Raised from the POLL (``predict_cutoff`` / ``observe``), not lost on
    the worker thread: the owner keeps serving decisions through its
    fallback while one seeded retry is in flight, and only escalates
    when the retry fails too.
    """


def _spawn_refit(fit_fn, gen: int) -> tuple:
    """Start a DMM refit on a daemon thread.

    Returns the ``(thread, result_box, generation)`` refit-task triple:
    the thread fills ``result_box["model"]`` when the fit finishes, or
    ``result_box["error"]`` when it RAISES (captured, never swallowed:
    :func:`_poll_refit_task` hands it back to the owner's poll).  The
    generation tag (the owner's resize count at spawn time) lets the poll
    discard results that a later resize made stale.  Dropping the triple
    abandons the fit without ever blocking a decision on it.
    """
    box: dict = {}

    def work():
        try:
            box["model"] = fit_fn()
        except BaseException as e:         # surfaced by the poll
            box["error"] = e

    thread = threading.Thread(target=work, daemon=True)
    task = (thread, box, gen)
    thread.start()
    return task


def _poll_refit_task(task: tuple, gen: int, width: int):
    """Non-blocking poll of a :func:`_spawn_refit` triple.

    Returns ``(done, model, error)``: ``(False, None, None)`` while the
    fit thread is still running; ``(True, model, None)`` once it finished
    AND the result is still current (generation matches and the fitted
    width is the owner's width); ``(True, None, exc)`` when the fit RAISED
    and the failure is still current; ``(True, None, None)`` for a
    finished-but-stale fit, which is discarded, never installed.
    """
    thread, box, task_gen = task
    if thread.is_alive():
        return False, None, None
    thread.join()
    if task_gen != gen:
        return True, None, None
    error = box.get("error")
    if error is not None:
        return True, None, error
    model = box.get("model")
    if model is None or model.n_workers != width:
        return True, None, None
    return True, model, None


class ElasticController:
    """Membership-elastic cutoff controller (DMM + Elfving fallback + refit).

    While the cluster shape matches the fitted :class:`RuntimeModel` every
    decision is the DMM :class:`CutoffController`'s.  Across a
    :meth:`resize` it:

      1. remaps its imputed trace onto the new worker set (survivors
         column-exact, new workers seeded from the cluster mean:
         :func:`remap_columns`);
      2. falls back to :class:`ElfvingController`, warm-seeded from the
         remapped trace;
      3. refits the DMM at the new width once ``refit_fresh`` post-resize
         observations have arrived (synchronously by default;
         ``refit_async=True`` fits on a worker thread and swaps the DMM
         back in when the poll finds it done), then decides through the
         DMM again, its window seeded from the trace.

    The refit's model lives on the device of the model given here.  On
    the card the fit runs on a stream of its own and synchronizes it
    before the thread hands the model over, so its params are complete
    when the trainer's thread installs it (and captures the new
    controller's graphs: ``CutoffController._capture`` is thread-local
    for that reason).  A DMM controller is dropped only after its
    decision in flight has finished: its graph replays on its own stream
    into pinned memory, and its graphs' memory goes with it.

    The rolling imputed trace (plain imputation at the observed cutoff
    time) is the refit's training data; ``window_array`` / ``seed_window``
    expose its lag-window tail for checkpoints.
    """

    def __init__(self, model: RuntimeModel, *, k_samples: int = 64,
                 min_frac: float = 0.5, seed: int = 0,
                 backend: str = "device", history: int = 512,
                 refit_steps: int = 150, refit_batch: int = 8,
                 refit_fresh: int = 4, refit_async: bool = False,
                 fallback_warmup: int = 3, refit_retries: int = 1):
        self.k_samples = k_samples
        self.min_frac = min_frac
        self.seed = seed
        self.backend = backend
        self.history = history
        self.refit_steps = refit_steps
        self.refit_batch = refit_batch
        self.refit_fresh = refit_fresh
        self.refit_async = refit_async
        self.fallback_warmup = fallback_warmup
        self.refit_retries = refit_retries
        self._refit_failures = 0          # consecutive failed async fits
        # architecture template for refits (widths change, shapes don't)
        self._lag = model.lag
        self._z_dim = model.z_dim
        self._hidden = model.hidden
        self._device = model.device
        self._n = model.n_workers
        self._trace: list = []            # imputed full rows, rolling
        self._fresh = 0                   # post-resize observations
        self._resize_count = 0
        # async refit in flight: (thread, result_box, resize generation)
        self._refit_job: Optional[tuple] = None
        self.fallback_steps = 0           # observes served by the fallback
        self._dmm: Optional[CutoffController] = None
        self._fallback = ElfvingController(self._n,
                                           warmup=fallback_warmup,
                                           min_frac=min_frac)
        self._install_dmm(model)

    # -- bookkeeping ----------------------------------------------------
    @property
    def n(self) -> int:
        return self._n

    @property
    def mode(self) -> str:
        """"dmm" when the fitted controller decides, "fallback" while a
        resize awaits its refit."""
        return "dmm" if self._dmm is not None else "fallback"

    @property
    def warmed_up(self) -> bool:
        return len(self._trace) >= self._lag + 1

    def _drop_dmm(self):
        if self._dmm is not None:
            self._dmm._wait()       # its decision in flight, on its stream
            self._dmm = None

    def _install_dmm(self, model: RuntimeModel):
        if model.n_workers != self._n:
            raise ValueError(f"a RuntimeModel of width {model.n_workers} "
                             f"for a controller of width {self._n}")
        self._drop_dmm()
        ctl = CutoffController(
            model, k_samples=self.k_samples, min_frac=self.min_frac,
            seed=self.seed + 101 * self._resize_count, backend=self.backend)
        rows = self._trace[-(self._lag + 1):]
        if rows:
            ctl.seed_window(np.stack(rows))
        self._dmm = ctl

    def _active(self):
        return self._dmm if self._dmm is not None else self._fallback

    # -- window persistence (checkpoint contract) -----------------------
    def window_array(self) -> np.ndarray:
        """The lag-window tail of the imputed trace, oldest row first."""
        return np.stack(self._trace[-(self._lag + 1):])

    def seed_window(self, traces: np.ndarray):
        """Warm-start from recorded rows at the CURRENT width."""
        rows = [np.asarray(r, np.float64) for r in np.asarray(traces)]
        if rows and rows[0].shape != (self._n,):
            raise ValueError(f"seed rows have width {rows[0].shape}, "
                             f"controller width is {self._n}")
        self._trace = (self._trace + rows)[-self.history:]
        for r in rows[-50:]:
            self._fallback.buf.append(r)
        if self._dmm is not None:
            self._dmm.seed_window(np.stack(self._trace[-(self._lag + 1):]))

    # -- decision / observation -----------------------------------------
    def predict_cutoff(self) -> int:
        self._poll_refit()
        return self._active().predict_cutoff()

    def predicted_order_stats(self):
        if self._dmm is not None:
            return self._dmm.predicted_order_stats()
        return None

    def predicted_samples(self):
        if self._dmm is not None:
            return self._dmm.predicted_samples()
        return None

    def snapshot_samples(self):
        if self._dmm is not None:
            return self._dmm.snapshot_samples()
        return None

    def observe(self, times, finished_mask=None):
        t = np.asarray(times, np.float64)
        if t.shape != (self._n,):
            raise ValueError(
                f"observe got {t.shape[0]} runtimes at width {self._n}; "
                f"call resize() before observing the resized step")
        row = t
        if finished_mask is not None:
            m = np.asarray(finished_mask, bool)
            if not m.any():
                raise ValueError(
                    "observe got an all-False finished_mask: a step with "
                    "zero finished workers has no observed cutoff time to "
                    "impute the trace row at")
            if not m.all():
                # plain imputation at the observed cutoff time is enough
                # for refit TRAINING data; the active DMM still runs the
                # truncated-normal imputation for its own window
                row = np.where(m, t, t[m].max())
        self._trace = (self._trace + [row])[-self.history:]
        if self._dmm is None:
            self.fallback_steps += 1
        self._active().observe(times, finished_mask)
        self._fresh += 1
        self._poll_refit()
        if self._dmm is None and self._refit_job is None:
            self._maybe_refit()

    # -- resize protocol -------------------------------------------------
    def resize(self, n_workers: int, col_map=None,
               model: Optional[RuntimeModel] = None, members=None):
        """Worker-set change: remap, fall back, schedule the refit.

        ``col_map`` as in :func:`remap_columns`.  If ``model`` (already
        fitted at the new width) is supplied, the DMM controller resumes
        immediately; otherwise decisions route through the Elfving
        fallback until the refit lands.
        """
        n_new = int(n_workers)
        if model is not None and model.n_workers != n_new:
            raise ValueError(
                f"resize({n_new}) got a RuntimeModel of width "
                f"{model.n_workers}; refit it for the new width first")
        if n_new == self._n and col_map is None and model is None:
            return
        # abandon any in-flight refit WITHOUT blocking on its fit: the
        # daemon thread keeps filling its orphaned result box, and
        # _poll_refit_task discards it by generation
        self._refit_job = None
        if self._trace:
            rows = remap_columns(np.stack(self._trace), n_new, col_map)
            self._trace = [row for row in rows]
        self._n = n_new
        self._resize_count += 1
        self._fresh = 0
        self._drop_dmm()
        self._fallback = ElfvingController(n_new,
                                           warmup=self.fallback_warmup,
                                           min_frac=self.min_frac)
        for r in self._trace[-50:]:
            self._fallback.buf.append(r)
        if model is not None:
            self._install_dmm(model)

    # -- refit plumbing --------------------------------------------------
    def _enough_rows(self) -> bool:
        # RuntimeModel.fit needs strictly more than lag+1 rows; demand a
        # small margin so the first refit windows aren't degenerate
        return len(self._trace) >= self._lag + 1 + self.refit_batch

    def _maybe_refit(self):
        # failed attempts back the respawn off exponentially: each one
        # demands twice the fresh observations before the next try
        need = self.refit_fresh * (2 ** self._refit_failures)
        if self._fresh < need or not self._enough_rows():
            return
        # freeze width/seed now: a resize mid-fit must not retarget the
        # running fit (its result is discarded by generation anyway)
        rows = np.stack(self._trace)
        n = self._n
        seed = self.seed + self._resize_count + 1000 * self._refit_failures
        if self.refit_async:
            self._refit_job = _spawn_refit(
                lambda: self._fit_model(rows, n, seed), self._resize_count)
        else:
            self._install_dmm(self._fit_model(rows, n, seed))

    def _poll_refit(self):
        if self._refit_job is None:
            return
        # a resize since the fit started makes the result stale (wrong
        # membership, possibly even the wrong width): dropped by
        # generation/width
        done, model, err = _poll_refit_task(self._refit_job,
                                            self._resize_count, self._n)
        if not done:
            return
        self._refit_job = None
        if err is not None:
            self._refit_failures += 1
            if self._refit_failures > self.refit_retries:
                raise RefitError(
                    f"DMM refit failed {self._refit_failures} times at "
                    f"width {self._n} (retry budget {self.refit_retries} "
                    f"spent); last error: {err!r}") from err
            # log + retry: stay on the fallback, reschedule with backoff
            print(f"DMM refit failed ({err!r}); retrying after "
                  f"{self.refit_fresh * 2 ** self._refit_failures} fresh "
                  f"observations")
            self._fresh = 0
            return
        if model is not None:
            self._refit_failures = 0
            self._install_dmm(model)

    def _fit_model(self, rows: np.ndarray, n: int,
                   seed: int) -> RuntimeModel:
        """A RuntimeModel of width ``n`` fitted on ``rows``, on the device
        of the controller's model.  On the card the fit runs on a stream
        of its own, which is synchronized before the model is returned:
        its params are complete for whichever thread installs it."""
        model = RuntimeModel(n_workers=n, lag=self._lag, z_dim=self._z_dim,
                             hidden=self._hidden, device=self._device)
        stream = (torch.cuda.Stream(self._device)
                  if self._device.type == "cuda" else None)
        with (torch.cuda.stream(stream) if stream is not None
              else contextlib.nullcontext()):
            model.fit(rows, steps=self.refit_steps, batch=self.refit_batch,
                      seed=seed)
        if stream is not None:
            stream.synchronize()
        return model
