"""Single-threaded async composition monad.

Rebuild of the reference's AsyncChain/AsyncResult machinery
(ref: accord-core/src/main/java/accord/utils/async/AsyncChain.java:29-120,
AsyncChains.java:47, AsyncResult.java).  Everything cross-store composes
through this.  Unlike the Java version there are no threads: callbacks fire
inline (or via an executor callable when store-affinity is required), which
is exactly what the deterministic simulator needs — the whole system stays a
pure function of (seed, workload).
"""

from __future__ import annotations

import traceback
from typing import Any, Callable, Generic, List, Optional, Sequence, TypeVar

T = TypeVar("T")
U = TypeVar("U")

Callback = Callable[[Optional[T], Optional[BaseException]], None]


class AsyncChain(Generic[T]):
    """A computation that will deliver (result, failure) exactly once."""

    def begin(self, callback: Callback) -> None:
        raise NotImplementedError

    # -- combinators --------------------------------------------------------
    def map(self, fn: Callable[[T], U]) -> "AsyncChain[U]":
        return _Mapped(self, fn)

    def flat_map(self, fn: Callable[[T], "AsyncChain[U]"]) -> "AsyncChain[U]":
        return _FlatMapped(self, fn)

    def recover(self, fn: Callable[[BaseException], Optional[T]]) -> "AsyncChain[T]":
        return _Recovered(self, fn)

    def add_callback(self, callback: Callback) -> "AsyncChain[T]":
        self.begin(callback)
        return self

    def begin_as_result(self) -> "AsyncResult[T]":
        r = AsyncResult()
        self.begin(r.settle)
        return r


class ImmediateChain(AsyncChain[T]):
    __slots__ = ("value", "failure")

    def __init__(self, value: Optional[T] = None,
                 failure: Optional[BaseException] = None):
        self.value = value
        self.failure = failure

    def begin(self, callback: Callback) -> None:
        callback(self.value, self.failure)


def success(value: T) -> AsyncChain[T]:
    return ImmediateChain(value)


def failure(exc: BaseException) -> AsyncChain[Any]:
    return ImmediateChain(None, exc)


class _Mapped(AsyncChain[U]):
    def __init__(self, src: AsyncChain[T], fn: Callable[[T], U]):
        self.src, self.fn = src, fn

    def begin(self, callback: Callback) -> None:
        def on(result, fail):
            if fail is not None:
                callback(None, fail)
                return
            try:
                callback(self.fn(result), None)
            except BaseException as e:  # noqa: BLE001 - propagate as failure
                callback(None, e)
        self.src.begin(on)


class _FlatMapped(AsyncChain[U]):
    def __init__(self, src: AsyncChain[T], fn: Callable[[T], AsyncChain[U]]):
        self.src, self.fn = src, fn

    def begin(self, callback: Callback) -> None:
        def on(result, fail):
            if fail is not None:
                callback(None, fail)
                return
            try:
                self.fn(result).begin(callback)
            except BaseException as e:  # noqa: BLE001
                callback(None, e)
        self.src.begin(on)


class _Recovered(AsyncChain[T]):
    def __init__(self, src: AsyncChain[T], fn: Callable[[BaseException], Optional[T]]):
        self.src, self.fn = src, fn

    def begin(self, callback: Callback) -> None:
        def on(result, fail):
            if fail is None:
                callback(result, None)
                return
            try:
                callback(self.fn(fail), None)
            except BaseException as e:  # noqa: BLE001
                callback(None, e)
        self.src.begin(on)


class AsyncResult(AsyncChain[T]):
    """Settable promise; also usable as a chain
    (ref: utils/async/AsyncResults.java SettableResult)."""

    __slots__ = ("_done", "_value", "_failure", "_callbacks")

    def __init__(self):
        self._done = False
        self._value: Optional[T] = None
        self._failure: Optional[BaseException] = None
        self._callbacks: List[Callback] = []

    def is_done(self) -> bool:
        return self._done

    def is_success(self) -> bool:
        return self._done and self._failure is None

    def settle(self, value: Optional[T], fail: Optional[BaseException]) -> None:
        if self._done:
            return
        self._done = True
        self._value, self._failure = value, fail
        cbs, self._callbacks = self._callbacks, []
        for cb in cbs:
            cb(value, fail)

    def set_success(self, value: T) -> None:
        self.settle(value, None)

    def set_failure(self, fail: BaseException) -> None:
        self.settle(None, fail)

    def begin(self, callback: Callback) -> None:
        if self._done:
            callback(self._value, self._failure)
        else:
            self._callbacks.append(callback)

    def result(self) -> T:
        """Value if settled successfully; raises otherwise (sim-only helper)."""
        if not self._done:
            raise RuntimeError("AsyncResult not settled")
        if self._failure is not None:
            raise self._failure
        return self._value  # type: ignore[return-value]


def all_of(chains: Sequence[AsyncChain[T]]) -> AsyncChain[List[T]]:
    """Combine: list of all results, or the first failure
    (ref: AsyncChainCombiner.all)."""
    if not chains:
        return success([])
    out: AsyncResult[List[T]] = AsyncResult()
    results: List[Any] = [None] * len(chains)
    remaining = [len(chains)]

    def make(i):
        def on(result, fail):
            if fail is not None:
                out.set_failure(fail)
                return
            results[i] = result
            remaining[0] -= 1
            if remaining[0] == 0:
                out.set_success(list(results))
        return on

    for i, c in enumerate(chains):
        c.begin(make(i))
    return out


def reduce(chains: Sequence[AsyncChain[T]],
           fn: Callable[[T, T], T]) -> AsyncChain[T]:
    """Pairwise reduction of results (ref: AsyncChains.reduce)."""
    if not chains:
        return success(None)  # type: ignore[arg-type]
    return all_of(chains).map(lambda rs: _reduce_list(rs, fn))


def _reduce_list(rs: List[T], fn: Callable[[T, T], T]) -> T:
    acc = rs[0]
    for r in rs[1:]:
        acc = fn(acc, r)
    return acc


def defer(executor: Callable[[Callable[[], None]], None],
          supplier: Callable[[], T]) -> AsyncChain[T]:
    """Run supplier on the given executor; chain settles with its outcome."""
    out: AsyncResult[T] = AsyncResult()

    def run():
        try:
            out.set_success(supplier())
        except BaseException as e:  # noqa: BLE001
            out.set_failure(e)

    executor(run)
    return out
