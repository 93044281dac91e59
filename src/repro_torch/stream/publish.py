"""Weight publication: online trainer -> serving fleet, no restarts
(counterpart of ``repro.stream.publish``).

Transport is an ``ObjectStore`` — a minimal versioned-blob interface with
one backend today (``LocalDirStore``, over ``train.checkpoint``'s atomic
``tmp.<v>`` -> ``os.replace`` -> ``step_<v>`` protocol) and room for
remote stores later; the publisher/subscriber pair never touches paths
directly, so swapping the backend swaps the fleet's transport. Versions are
the online trainer's step numbers: monotonic, so ``poll`` is one listing.
A store holds the port's own tree format (``train.checkpoint``), not the
reference's.

Fleet semantics:

* **one store, many subscribers** — every serving shard runs its own
  ``ParamSubscriber`` over the shared store (``replicated_subscribers``),
  each with an independent cursor, so shards converge on the newest
  version without coordinating with each other.
* **fault tolerance** — ``poll`` *skips* unreadable versions instead of
  raising: a torn/partial write (only reachable if the backend loses the
  atomic-replace guarantee, e.g. a copied-in checkpoint or a crashed
  remote store) or a version GC'd between listing and read falls back to
  the next-newest good version, or to None (keep serving the current
  weights). Skipped versions are remembered (``skipped``) and never
  re-read. A *gap* in the version sequence is not an error — subscribers
  only care about the newest readable version.
* **device faults are not store faults** — a restore places every leaf on
  the template's device. An out-of-memory or CUDA error there says the
  serving process is sick, not the version: it propagates (the reference
  skips a version on any exception, which on the card would leave a server
  quietly on its old weights).

Consumers:

* ``ServeScheduler.attach_param_source(sub.poll)`` — the continuous-
  batching scheduler polls between decode steps and swaps params in place.
  By default in-flight slots are NOT dropped: their already-cached context
  KV stays (computed under the old weights), so a request straddling a
  swap is scored under mixed versions — bounded staleness traded for zero
  dropped traffic. ``drain_before_swap=True`` trades a drain bubble for
  version purity instead.
* ``CTRServer.update_params`` — prefill-path hot-swap; params are an
  argument of every call, so a swap rebuilds nothing.
"""
from __future__ import annotations

from typing import Any, List, Optional, Tuple, Union

from repro_torch.train.checkpoint import CheckpointManager

#: What ``ObjectStore.get`` raises for a version it cannot read — the
#: faults ``ParamSubscriber.poll`` skips. ``LocalDirStore`` raises them
#: for a torn or truncated leaf file (``ValueError``, ``EOFError``), a
#: corrupt ``meta.json`` (``ValueError``), a missing leaf (``KeyError``), a
#: leaf of another shape (``ValueError``) and a version removed by GC
#: between listing and read (``OSError``). Anything else —
#: ``torch.OutOfMemoryError``, a CUDA error, any ``RuntimeError`` from
#: placing a leaf on the device — is not a store fault and propagates.
STORE_FAULTS = (OSError, EOFError, KeyError, ValueError)


class ObjectStore:
    """Versioned object store: integer versions -> trees of tensors.

    ``put`` must be atomic (a reader never sees a half-written version) and
    ``versions`` must list only complete versions — the two properties the
    subscriber protocol rides on. ``get`` may raise one of
    ``STORE_FAULTS`` on a version that is corrupt or vanished (GC race);
    callers are expected to fall back.
    """

    def put(self, version: int, obj: Any) -> None:
        raise NotImplementedError

    def get(self, template: Any, version: int) -> Any:
        raise NotImplementedError

    def versions(self) -> List[int]:
        raise NotImplementedError

    def latest(self) -> Optional[int]:
        vs = self.versions()
        return vs[-1] if vs else None


class LocalDirStore(ObjectStore):
    """Local-directory backend over ``CheckpointManager``: atomic writes
    via tmp-dir + ``os.replace``, ``keep`` newest versions retained so slow
    subscribers never watch their version vanish mid-restore. ``get``
    restores onto the template's leaves' devices and dtypes."""

    def __init__(self, directory: str, *, keep: int = 3):
        self.directory = directory
        self.mgr = CheckpointManager(directory, keep=keep, save_interval=1,
                                     async_write=False)

    def put(self, version: int, obj: Any) -> None:
        self.mgr.save(version, obj, meta={"version": version}, block=True)

    def get(self, template: Any, version: int) -> Any:
        return self.mgr.restore(template, step=version)

    def versions(self) -> List[int]:
        return self.mgr.all_steps()


def _as_store(store: Union[str, ObjectStore], **kw) -> ObjectStore:
    return store if isinstance(store, ObjectStore) else \
        LocalDirStore(store, **kw)


class ParamPublisher:
    """Writes versioned params to an ``ObjectStore`` (or a directory path,
    wrapped in a ``LocalDirStore``)."""

    def __init__(self, store: Union[str, ObjectStore], *, keep: int = 3):
        self.store = _as_store(store, keep=keep)

    def publish(self, version: int, params: Any) -> None:
        self.store.put(version, params)

    def latest_version(self) -> Optional[int]:
        return self.store.latest()


class ParamSubscriber:
    """Polls an ``ObjectStore``; returns ``(version, params)`` when a newer
    *readable* version than the last one seen exists, else None.
    ``template`` pins the expected tree structure, shapes, devices and
    dtypes (shape drift is rejected by the store's codec, not silently
    loaded).

    ``poll`` never raises on store-side faults (``STORE_FAULTS``):
    unreadable versions land in ``skipped`` and the scan falls back toward
    the newest good version — a serving shard keeps scoring under its
    current weights rather than crashing on a bad publish. Errors of the
    device the params are restored onto propagate."""

    def __init__(self, store: Union[str, ObjectStore], template: Any, *,
                 version: Optional[int] = None):
        self.store = _as_store(store)
        self.template = template
        self.version = -1 if version is None else version
        self.skipped: List[int] = []
        self._bad: set = set()

    def poll(self) -> Optional[Tuple[int, Any]]:
        try:
            vs = self.store.versions()
        except OSError:
            return None                    # store unreachable: keep serving
        for v in reversed(vs):
            if v <= self.version:
                break
            if v in self._bad:
                continue
            try:
                params = self.store.get(self.template, v)
            except STORE_FAULTS:           # torn write / GC race: skip it
                self._bad.add(v)
                self.skipped.append(v)
                continue
            self.version = v
            self.template = params
            return v, params
        return None


def replicated_subscribers(store: Union[str, ObjectStore], template: Any,
                           n: int, *, version: Optional[int] = None
                           ) -> List[ParamSubscriber]:
    """``n`` independent subscribers over one shared store — one per
    serving shard. Each keeps its own cursor (and its own restored copy of
    the params), so a fleet-wide publish reaches every shard on its next
    poll without any cross-shard coordination; pair with
    ``ServeScheduler(drain_before_swap=True)`` for a fleet-wide
    version-pure swap."""
    st = _as_store(store)
    return [ParamSubscriber(st, template, version=version)
            for _ in range(n)]


__all__ = ["ObjectStore", "LocalDirStore", "ParamPublisher",
           "ParamSubscriber", "replicated_subscribers", "STORE_FAULTS"]
