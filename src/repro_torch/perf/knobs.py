"""Performance knobs (the port's ``repro.perf.knobs``).

Set per experiment through a context variable, so model code stays clean.
Every knob defaults to the paper-faithful baseline.  The port has the
knobs it reads: ``ce_impl`` and ``ce_chunk`` (``launch.train.make_loss_fn``),
``moe_capacity_factor`` (``models.moe.capacity_for``) and ``fsdp_gather``
(``dist.collectives.Zero3``: ``"wsc"`` gathers a block's shards in one
all-gather of a flat buffer; ``"shardmap"`` gathers each leaf sharded on
dim 0 by an all-gather of its own, straight into the full weight, and
the other leaves as ``"wsc"`` does) and ``attn_halo``
(``models.attention.attention_sp``: under ``train_sp`` a sliding-window
layer whose window reaches fewer than T - 1 chunks back fetches only
those chunks by point-to-point sends instead of gathering the whole
sequence).  Setting one of
the reference's other knobs raises ``NotImplementedError`` naming the
ROADMAP item it waits for (``UNPORTED``); an unknown name raises
``TypeError``.
"""
from __future__ import annotations

import contextlib
import contextvars
from dataclasses import dataclass, replace

from repro_torch.dist.sharding import WAITS_FOR


@dataclass(frozen=True)
class Knobs:
    ce_impl: str = "dense"      # dense | ring  (vocab-ring fused CE)
    ce_chunk: int = 0           # >0: vocab chunking of the head and CE
    moe_capacity_factor: float = 0.0  # >0 overrides the config value
    fsdp_gather: str = "wsc"    # wsc | shardmap (the ZeRO-3 use-site gather)
    attn_halo: bool = False     # train_sp: window layers fetch their halo


FSDP_GATHERS = ("wsc", "shardmap")


#: the reference's knobs the port does not implement yet, by what each
#: waits for
UNPORTED = {
    "q_chunk": WAITS_FOR["aot"],
    "window_slice": WAITS_FOR["aot"],
    "remat": WAITS_FOR["aot"],
    "attn_scores_bf16": WAITS_FOR["aot"],
}


_current: contextvars.ContextVar[Knobs] = contextvars.ContextVar(
    "repro_torch_knobs", default=Knobs())


def knobs() -> Knobs:
    return _current.get()


@contextlib.contextmanager
def use_knobs(**kw):
    for name in sorted(kw):
        if name in UNPORTED:
            raise NotImplementedError(
                f"the knob {name!r} is not ported yet: it waits for "
                f"{UNPORTED[name]}")
    if kw.get("fsdp_gather", "wsc") not in FSDP_GATHERS:
        raise ValueError(f"fsdp_gather={kw['fsdp_gather']!r}: want one of "
                         f"{FSDP_GATHERS}")
    if not isinstance(kw.get("attn_halo", False), bool):
        raise ValueError(f"attn_halo={kw['attn_halo']!r}: want True or "
                         f"False")
    tok = _current.set(replace(_current.get(), **kw))
    try:
        yield _current.get()
    finally:
        _current.reset(tok)
