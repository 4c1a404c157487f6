from .timestamp import (Ballot, Domain, Kinds, Timestamp, TxnId, TxnKind,
                        max_timestamp)
from .keys import (IntKey, Key, Keys, Range, Ranges, Route, RoutingKeys,
                   Seekables, Unseekables, MIN_TOKEN, MAX_TOKEN)
from .deps import (Deps, DepsBuilder, KeyDeps, KeyDepsBuilder, PartialDeps,
                   RangeDeps, RangeDepsBuilder)
from .txn import PartialTxn, Txn
from .writes import ProgressToken, SyncPoint, Writes

__all__ = [
    "Ballot", "Domain", "Kinds", "Timestamp", "TxnId", "TxnKind", "max_timestamp",
    "IntKey", "Key", "Keys", "Range", "Ranges", "Route", "RoutingKeys",
    "Seekables", "Unseekables", "MIN_TOKEN", "MAX_TOKEN",
    "Deps", "DepsBuilder", "KeyDeps", "KeyDepsBuilder", "PartialDeps",
    "RangeDeps", "RangeDepsBuilder",
    "PartialTxn", "Txn", "ProgressToken", "SyncPoint", "Writes",
]
