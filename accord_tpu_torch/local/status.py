"""The protocol knowledge lattice: Status, SaveStatus, Durability, Known.

Rebuild of ref: accord-core/src/main/java/accord/local/Status.java:47-806 and
SaveStatus.java:55-175.  Status is the consensus progress ladder; the Known
sub-lattice {KnownRoute, Definition, KnownExecuteAt, KnownDeps, Outcome} is
what CheckStatus replies merge through; SaveStatus refines Status with local
execution / truncation states.  Ordinals of each enum form its join order —
``at_least`` is pointwise max.
"""

from __future__ import annotations

import enum
from typing import NamedTuple, Optional


class Phase(enum.IntEnum):
    """(ref: Status.java:99-115)."""
    NONE = 0
    PreAccept = 1
    Accept = 2
    Commit = 3
    Execute = 4
    Persist = 5
    Cleanup = 6

    @property
    def tie_break_with_ballot(self) -> bool:
        return self in (Phase.Accept, Phase.Commit)


class KnownRoute(enum.IntEnum):
    """(ref: Status.java:427-470)."""
    Maybe = 0
    Covering = 1
    Full = 2

    def has_full(self) -> bool:
        return self is KnownRoute.Full

    def at_least(self, that: "KnownRoute") -> "KnownRoute":
        return self if self >= that else that

    def reduce(self, that: "KnownRoute") -> "KnownRoute":
        if self == that:
            return self
        if KnownRoute.Full in (self, that):
            return KnownRoute.Full
        return KnownRoute.Maybe

    def valid_for_all(self) -> "KnownRoute":
        return KnownRoute.Maybe if self is KnownRoute.Covering else self


class Definition(enum.IntEnum):
    """(ref: Status.java:641-694)."""
    DefinitionUnknown = 0
    DefinitionErased = 1
    NoOp = 2
    DefinitionKnown = 3

    def is_known(self) -> bool:
        return self is Definition.DefinitionKnown

    def is_or_was_known(self) -> bool:
        return self is not Definition.DefinitionUnknown

    def at_least(self, that: "Definition") -> "Definition":
        return self if self >= that else that

    def reduce(self, that: "Definition") -> "Definition":
        return self if self <= that else that

    def valid_for_all(self) -> "Definition":
        return Definition.DefinitionUnknown if self is Definition.DefinitionKnown else self


class KnownExecuteAt(enum.IntEnum):
    """(ref: Status.java:473-537)."""
    ExecuteAtUnknown = 0
    ExecuteAtProposed = 1
    ExecuteAtErased = 2
    ExecuteAtKnown = 3
    NoExecuteAt = 4

    def is_decided(self) -> bool:
        return self >= KnownExecuteAt.ExecuteAtErased

    def is_decided_and_known_to_execute(self) -> bool:
        return self is KnownExecuteAt.ExecuteAtKnown

    def at_least(self, that: "KnownExecuteAt") -> "KnownExecuteAt":
        return self if self >= that else that

    def reduce(self, that: "KnownExecuteAt") -> "KnownExecuteAt":
        return self.at_least(that)

    def valid_for_all(self) -> "KnownExecuteAt":
        return (KnownExecuteAt.ExecuteAtUnknown
                if self <= KnownExecuteAt.ExecuteAtErased else self)

    def can_propose_invalidation(self) -> bool:
        return self is KnownExecuteAt.ExecuteAtUnknown


class KnownDeps(enum.IntEnum):
    """(ref: Status.java:539-640)."""
    DepsUnknown = 0
    DepsProposed = 1
    DepsCommitted = 2
    DepsErased = 3
    DepsKnown = 4
    NoDeps = 5

    @property
    def phase(self) -> Phase:
        return {KnownDeps.DepsUnknown: Phase.PreAccept,
                KnownDeps.DepsProposed: Phase.Accept,
                KnownDeps.DepsCommitted: Phase.Commit,
                KnownDeps.DepsErased: Phase.Cleanup,
                KnownDeps.DepsKnown: Phase.Execute,
                KnownDeps.NoDeps: Phase.Persist}[self]

    def has_proposed_deps(self) -> bool:
        return self is KnownDeps.DepsProposed

    def has_decided_deps(self) -> bool:
        return self is KnownDeps.DepsKnown

    def can_propose_invalidation(self) -> bool:
        return self is KnownDeps.DepsUnknown

    def at_least(self, that: "KnownDeps") -> "KnownDeps":
        return self if self >= that else that

    def reduce(self, that: "KnownDeps") -> "KnownDeps":
        return self if self <= that else that

    def valid_for_all(self) -> "KnownDeps":
        return KnownDeps.DepsUnknown if self is not KnownDeps.NoDeps else self


class Outcome(enum.IntEnum):
    """(ref: Status.java:695-806)."""
    Unknown = 0
    Erased = 1
    WasApply = 2
    Apply = 3
    Invalidated = 4

    def is_or_was_apply(self) -> bool:
        return self in (Outcome.Apply, Outcome.WasApply)

    def is_satisfied_by(self, other: "Outcome") -> bool:
        if self is Outcome.Unknown:
            return True
        if self is Outcome.WasApply and other is Outcome.Apply:
            return True
        return other is self

    def can_propose_invalidation(self) -> bool:
        return self is Outcome.Unknown

    def is_invalidated(self) -> bool:
        return self is Outcome.Invalidated

    def at_least(self, that: "Outcome") -> "Outcome":
        return self if self >= that else that

    def reduce(self, that: "Outcome") -> "Outcome":
        return self.at_least(that)

    def valid_for_all(self) -> "Outcome":
        return Outcome.Unknown if self is Outcome.Erased else self


class Known(NamedTuple):
    """What a replica knows about a transaction
    (ref: Status.java:124-420 Known)."""

    route: KnownRoute = KnownRoute.Maybe
    definition: Definition = Definition.DefinitionUnknown
    execute_at: KnownExecuteAt = KnownExecuteAt.ExecuteAtUnknown
    deps: KnownDeps = KnownDeps.DepsUnknown
    outcome: Outcome = Outcome.Unknown

    def at_least(self, that: "Known") -> "Known":
        return Known(self.route.at_least(that.route),
                     self.definition.at_least(that.definition),
                     self.execute_at.at_least(that.execute_at),
                     self.deps.at_least(that.deps),
                     self.outcome.at_least(that.outcome))

    def reduce(self, that: "Known") -> "Known":
        return Known(self.route.reduce(that.route),
                     self.definition.reduce(that.definition),
                     self.execute_at.reduce(that.execute_at),
                     self.deps.reduce(that.deps),
                     self.outcome.reduce(that.outcome))

    def valid_for_all(self) -> "Known":
        return Known(self.route.valid_for_all(),
                     self.definition.valid_for_all(),
                     self.execute_at.valid_for_all(),
                     self.deps.valid_for_all(),
                     self.outcome.valid_for_all())

    def is_satisfied_by(self, that: "Known") -> bool:
        return (self.definition <= that.definition
                and self.execute_at <= that.execute_at
                and self.deps <= that.deps
                and self.outcome.is_satisfied_by(that.outcome))

    def is_definition_known(self) -> bool:
        return self.definition.is_known()

    def is_invalidated(self) -> bool:
        return self.outcome.is_invalidated()

    def can_propose_invalidation(self) -> bool:
        return (self.execute_at.can_propose_invalidation()
                and self.deps.can_propose_invalidation()
                and self.outcome.can_propose_invalidation())

    def fetch_epoch(self, txn_id, execute_at) -> int:
        from ..primitives.timestamp import Timestamp
        if execute_at is None:
            return txn_id.epoch()
        if self.outcome.is_or_was_apply() and execute_at != Timestamp.NONE:
            return execute_at.epoch()
        return txn_id.epoch()


Known.Nothing = Known()
Known.DefinitionOnly = Known(KnownRoute.Maybe, Definition.DefinitionKnown)
Known.DefinitionAndRoute = Known(KnownRoute.Full, Definition.DefinitionKnown)
Known.ExecuteAtOnly = Known(execute_at=KnownExecuteAt.ExecuteAtKnown)
Known.Decision = Known(KnownRoute.Full, Definition.DefinitionKnown,
                       KnownExecuteAt.ExecuteAtKnown, KnownDeps.DepsKnown)
Known.Apply = Known(KnownRoute.Full, Definition.DefinitionUnknown,
                    KnownExecuteAt.ExecuteAtKnown, KnownDeps.DepsKnown,
                    Outcome.Apply)
Known.Invalidated = Known(outcome=Outcome.Invalidated)


class Durability(enum.IntEnum):
    """Global durability knowledge (ref: Status.java:807-850)."""
    NotDurable = 0
    Local = 1
    ShardUniversal = 2
    MajorityOrInvalidated = 3
    Majority = 4
    UniversalOrInvalidated = 5
    Universal = 6

    def is_durable(self) -> bool:
        return self in (Durability.Majority, Durability.Universal)

    def is_durable_or_invalidated(self) -> bool:
        return self >= Durability.MajorityOrInvalidated

    def merge(self, that: "Durability") -> "Durability":
        return self if self >= that else that


class Status(enum.IntEnum):
    """Consensus progress ladder (ref: Status.java:49-86)."""
    NotDefined = 0
    PreAccepted = 1
    AcceptedInvalidate = 2
    Accepted = 3
    PreCommitted = 4
    Committed = 5
    Stable = 6
    PreApplied = 7
    Applied = 8
    Truncated = 9
    Invalidated = 10

    @property
    def phase(self) -> Phase:
        return _STATUS_PHASE[self]

    @property
    def min_known(self) -> Known:
        return _STATUS_KNOWN[self]

    def has_been(self, status: "Status") -> bool:
        return self >= status

    def is_committed(self) -> bool:
        return self in (Status.Committed, Status.Stable, Status.PreApplied,
                        Status.Applied)


_STATUS_PHASE = {
    Status.NotDefined: Phase.NONE,
    Status.PreAccepted: Phase.PreAccept,
    Status.AcceptedInvalidate: Phase.Accept,
    Status.Accepted: Phase.Accept,
    Status.PreCommitted: Phase.Accept,
    Status.Committed: Phase.Commit,
    Status.Stable: Phase.Execute,
    Status.PreApplied: Phase.Persist,
    Status.Applied: Phase.Persist,
    Status.Truncated: Phase.Cleanup,
    Status.Invalidated: Phase.Persist,
}

_STATUS_KNOWN = {
    Status.NotDefined: Known.Nothing,
    Status.PreAccepted: Known.DefinitionAndRoute,
    Status.AcceptedInvalidate: Known.Nothing,
    Status.Accepted: Known(KnownRoute.Covering, Definition.DefinitionUnknown,
                           KnownExecuteAt.ExecuteAtProposed, KnownDeps.DepsProposed),
    Status.PreCommitted: Known(KnownRoute.Maybe, Definition.DefinitionUnknown,
                               KnownExecuteAt.ExecuteAtKnown),
    Status.Committed: Known(KnownRoute.Full, Definition.DefinitionKnown,
                            KnownExecuteAt.ExecuteAtKnown, KnownDeps.DepsCommitted),
    Status.Stable: Known(KnownRoute.Full, Definition.DefinitionKnown,
                         KnownExecuteAt.ExecuteAtKnown, KnownDeps.DepsKnown),
    Status.PreApplied: Known(KnownRoute.Full, Definition.DefinitionKnown,
                             KnownExecuteAt.ExecuteAtKnown, KnownDeps.DepsKnown,
                             Outcome.Apply),
    Status.Applied: Known(KnownRoute.Full, Definition.DefinitionKnown,
                          KnownExecuteAt.ExecuteAtKnown, KnownDeps.DepsKnown,
                          Outcome.Apply),
    Status.Truncated: Known(KnownRoute.Maybe, Definition.DefinitionErased,
                            KnownExecuteAt.ExecuteAtErased, KnownDeps.DepsErased,
                            Outcome.Erased),
    Status.Invalidated: Known(KnownRoute.Maybe, Definition.NoOp,
                              KnownExecuteAt.NoExecuteAt, KnownDeps.NoDeps,
                              Outcome.Invalidated),
}


def recovery_rank(status: "Status", accepted) -> tuple:
    """Knowledge ordering for recovery replies (ref: Status.java:871
    Status.max): higher phase wins; within a ballot-tie-broken phase
    (Accept/Commit) the higher ballot wins even over a higher status —
    AcceptedInvalidate@b1 beats Accepted@ZERO."""
    from ..primitives.timestamp import Ballot
    phase = status.phase
    ballot = accepted if phase.tie_break_with_ballot else Ballot.ZERO
    return (phase, ballot, status)


class LocalExecution(enum.IntEnum):
    """Local progress refinement (ref: SaveStatus.java LocalExecution)."""
    NotReady = 0
    ReadyToExclude = 1
    WaitingToExecute = 2
    ReadyToExecute = 3
    WaitingToApply = 4
    Applying = 5
    Applied = 6
    CleaningUp = 7


class SaveStatus(enum.IntEnum):
    """Disk/local-oriented refinement of Status (ref: SaveStatus.java:55-90)."""
    Uninitialised = 0
    NotDefined = 1
    PreAccepted = 2
    AcceptedInvalidate = 3
    AcceptedInvalidateWithDefinition = 4
    Accepted = 5
    AcceptedWithDefinition = 6
    PreCommitted = 7
    PreCommittedWithAcceptedDeps = 8
    PreCommittedWithDefinition = 9
    PreCommittedWithDefinitionAndAcceptedDeps = 10
    Committed = 11
    Stable = 12
    ReadyToExecute = 13
    PreApplied = 14
    Applying = 15
    Applied = 16
    TruncatedApplyWithDeps = 17
    TruncatedApplyWithOutcome = 18
    TruncatedApply = 19
    ErasedOrInvalidated = 20
    Erased = 21
    Invalidated = 22

    @property
    def status(self) -> Status:
        return _SAVE_STATUS[self][0]

    @property
    def phase(self) -> Phase:
        return self.status.phase

    @property
    def known(self) -> Known:
        return _SAVE_STATUS[self][1]

    @property
    def execution(self) -> LocalExecution:
        return _SAVE_STATUS[self][2]

    def has_been(self, status: Status) -> bool:
        return self.status >= status

    def is_uninitialised(self) -> bool:
        return self is SaveStatus.Uninitialised

    def is_complete(self) -> bool:
        return self in (SaveStatus.Applied, SaveStatus.Invalidated)

    def is_truncated(self) -> bool:
        return self.status is Status.Truncated

    def compare_knowledge(self, that: "SaveStatus") -> int:
        """Which SaveStatus carries more knowledge (for merge)."""
        return -1 if self < that else (0 if self == that else 1)

    @staticmethod
    def merge(a: "SaveStatus", b: "SaveStatus") -> "SaveStatus":
        return a if a >= b else b


def _sk(status: Status, known: Optional[Known] = None,
        execution: LocalExecution = LocalExecution.NotReady):
    return (status, known if known is not None else status.min_known, execution)


_SAVE_STATUS = {
    SaveStatus.Uninitialised: _sk(Status.NotDefined),
    SaveStatus.NotDefined: _sk(Status.NotDefined),
    SaveStatus.PreAccepted: _sk(Status.PreAccepted),
    SaveStatus.AcceptedInvalidate: _sk(Status.AcceptedInvalidate),
    SaveStatus.AcceptedInvalidateWithDefinition: _sk(
        Status.AcceptedInvalidate,
        Known(KnownRoute.Full, Definition.DefinitionKnown)),
    SaveStatus.Accepted: _sk(Status.Accepted),
    SaveStatus.AcceptedWithDefinition: _sk(
        Status.Accepted,
        Known(KnownRoute.Full, Definition.DefinitionKnown,
              KnownExecuteAt.ExecuteAtProposed, KnownDeps.DepsProposed)),
    SaveStatus.PreCommitted: _sk(Status.PreCommitted, None,
                                 LocalExecution.ReadyToExclude),
    SaveStatus.PreCommittedWithAcceptedDeps: _sk(
        Status.PreCommitted,
        Known(KnownRoute.Covering, Definition.DefinitionUnknown,
              KnownExecuteAt.ExecuteAtKnown, KnownDeps.DepsProposed),
        LocalExecution.ReadyToExclude),
    SaveStatus.PreCommittedWithDefinition: _sk(
        Status.PreCommitted,
        Known(KnownRoute.Full, Definition.DefinitionKnown,
              KnownExecuteAt.ExecuteAtKnown),
        LocalExecution.ReadyToExclude),
    SaveStatus.PreCommittedWithDefinitionAndAcceptedDeps: _sk(
        Status.PreCommitted,
        Known(KnownRoute.Full, Definition.DefinitionKnown,
              KnownExecuteAt.ExecuteAtKnown, KnownDeps.DepsProposed),
        LocalExecution.ReadyToExclude),
    SaveStatus.Committed: _sk(Status.Committed, None, LocalExecution.ReadyToExclude),
    SaveStatus.Stable: _sk(Status.Stable, None, LocalExecution.WaitingToExecute),
    SaveStatus.ReadyToExecute: _sk(Status.Stable, None, LocalExecution.ReadyToExecute),
    SaveStatus.PreApplied: _sk(Status.PreApplied, None, LocalExecution.WaitingToApply),
    SaveStatus.Applying: _sk(Status.PreApplied, None, LocalExecution.Applying),
    SaveStatus.Applied: _sk(Status.Applied, None, LocalExecution.Applied),
    SaveStatus.TruncatedApplyWithDeps: _sk(
        Status.Truncated,
        Known(KnownRoute.Full, Definition.DefinitionErased,
              KnownExecuteAt.ExecuteAtKnown, KnownDeps.DepsKnown, Outcome.Apply),
        LocalExecution.CleaningUp),
    SaveStatus.TruncatedApplyWithOutcome: _sk(
        Status.Truncated,
        Known(KnownRoute.Full, Definition.DefinitionErased,
              KnownExecuteAt.ExecuteAtKnown, KnownDeps.DepsErased, Outcome.Apply),
        LocalExecution.CleaningUp),
    SaveStatus.TruncatedApply: _sk(
        Status.Truncated,
        Known(KnownRoute.Full, Definition.DefinitionErased,
              KnownExecuteAt.ExecuteAtKnown, KnownDeps.DepsErased, Outcome.WasApply),
        LocalExecution.CleaningUp),
    SaveStatus.ErasedOrInvalidated: _sk(
        Status.Truncated,
        Known(KnownRoute.Maybe, Definition.DefinitionUnknown,
              KnownExecuteAt.ExecuteAtUnknown, KnownDeps.DepsUnknown,
              Outcome.Unknown),
        LocalExecution.CleaningUp),
    SaveStatus.Erased: _sk(
        Status.Truncated,
        Known(KnownRoute.Maybe, Definition.DefinitionErased,
              KnownExecuteAt.ExecuteAtErased, KnownDeps.DepsErased, Outcome.Erased),
        LocalExecution.CleaningUp),
    SaveStatus.Invalidated: _sk(Status.Invalidated, None, LocalExecution.CleaningUp),
}


def save_status_for(status: Status, known: Optional[Known] = None) -> SaveStatus:
    """Pick the SaveStatus that encodes (status, known)
    (ref: SaveStatus.get/enrich)."""
    base = {
        Status.NotDefined: SaveStatus.NotDefined,
        Status.PreAccepted: SaveStatus.PreAccepted,
        Status.AcceptedInvalidate: SaveStatus.AcceptedInvalidate,
        Status.Accepted: SaveStatus.Accepted,
        Status.PreCommitted: SaveStatus.PreCommitted,
        Status.Committed: SaveStatus.Committed,
        Status.Stable: SaveStatus.Stable,
        Status.PreApplied: SaveStatus.PreApplied,
        Status.Applied: SaveStatus.Applied,
        Status.Truncated: SaveStatus.Erased,
        Status.Invalidated: SaveStatus.Invalidated,
    }[status]
    if known is None:
        return base
    if status is Status.AcceptedInvalidate and known.is_definition_known():
        return SaveStatus.AcceptedInvalidateWithDefinition
    if status is Status.Accepted and known.is_definition_known():
        return SaveStatus.AcceptedWithDefinition
    if status is Status.PreCommitted:
        if known.is_definition_known():
            return (SaveStatus.PreCommittedWithDefinitionAndAcceptedDeps
                    if known.deps.has_proposed_deps()
                    else SaveStatus.PreCommittedWithDefinition)
        return (SaveStatus.PreCommittedWithAcceptedDeps
                if known.deps.has_proposed_deps() else SaveStatus.PreCommitted)
    return base
