"""ShardDistributor: how a node's owned ranges split across command stores.

Rebuild of ref: accord-core/src/main/java/accord/local/
ShardDistributor.java:32-107 — a pluggable policy with the EvenSplit
default: chunk the added ranges into N contiguous pieces of equal token
span.  CommandStores keeps assignment STICKY (ranges never migrate between
sibling stores) and only distributes net-new ranges through the policy.
"""

from __future__ import annotations

from typing import List

from ..primitives.keys import Range, Ranges


class ShardDistributor:
    """Policy seam (ref: local/ShardDistributor.java)."""

    def split(self, ranges: Ranges, n: int) -> List[Ranges]:
        raise NotImplementedError


class EvenSplit(ShardDistributor):
    """Equal token-span chunks (ref: ShardDistributor.EvenSplit over the
    key hash space; our tokens are already uniformly hashed)."""

    def split(self, ranges: Ranges, n: int) -> List[Ranges]:
        if n == 1 or ranges.is_empty():
            return [ranges] + [Ranges.empty()] * (n - 1)
        total = sum(r.end - r.start for r in ranges)
        per = max(1, total // n)
        chunks: List[List[Range]] = [[] for _ in range(n)]
        i, budget = 0, per
        for r in ranges:
            start = r.start
            while start < r.end:
                take = min(budget, r.end - start)
                chunks[i].append(Range(start, start + take))
                start += take
                budget -= take
                if budget == 0:
                    if i < n - 1:
                        i += 1
                        budget = per
                    else:
                        budget = total  # remainder lands in the last chunk
        return [Ranges(c) for c in chunks]
