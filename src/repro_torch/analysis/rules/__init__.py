"""Rule registry of the port's reprolint: the seven reference ids.

Each rule module exports one :class:`repro_torch.analysis.core.Rule` subclass;
``all_rules()`` instantiates the full set in catalog order and
``rule_ids()`` is the vocabulary valid in ``disable=`` pragmas.
"""
from __future__ import annotations

from typing import List, Set

from repro_torch.analysis.core import BAD_SUPPRESSION, PARSE_ERROR, Rule
from repro_torch.analysis.rules.host_sync import HostSyncInHotPath
from repro_torch.analysis.rules.donation import DonationAfterUse
from repro_torch.analysis.rules.colwise_rng import ColwiseRng
from repro_torch.analysis.rules.checkpoint_write import (
    NonatomicCheckpointWrite)
from repro_torch.analysis.rules.event_kinds import EventKindDrift
from repro_torch.analysis.rules.static_width import StaticArgnumWidth
from repro_torch.analysis.rules.twin_epsilon import TwinEpsilonDrift

RULE_CLASSES = (HostSyncInHotPath, DonationAfterUse, ColwiseRng,
                NonatomicCheckpointWrite, EventKindDrift,
                StaticArgnumWidth, TwinEpsilonDrift)


def all_rules() -> List[Rule]:
    return [cls() for cls in RULE_CLASSES]


def rule_ids() -> Set[str]:
    return ({cls.id for cls in RULE_CLASSES}
            | {BAD_SUPPRESSION, PARSE_ERROR})
