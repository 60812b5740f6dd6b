"""StorageClient: one bound facade over the storage free-function surface.

Every public storage entry point in this repo is a free function threading
``(store, step, acfg, ...)`` by hand, and the kwarg vocabulary drifted as
layers accreted: the scheduler says ``topo=``, the archive says
``topology=``; the chain layer sizes stripes in ``superchunk_words=``, the
archive in ``superchunk_bytes=``; device placement is ``order=`` here and a
scheduler plan there. :class:`StorageClient` binds ``(store, acfg)`` — plus
the cluster-shaped defaults ``topology`` / ``node_speeds`` / ``use_devices``
— ONCE, and exposes the whole object lifecycle as methods speaking exactly
one vocabulary:

====================  =====================================================
canonical kwarg        meaning
====================  =====================================================
``topology=``          a topology for the scheduler (chain order and chunk
                       count from its plan — there is no separate ``topo=``
                       or ``order=``); the scheduler is not ported yet, so
                       a topology raises NotImplementedError
``node_speeds=``       relative node speeds for the slow-to-the-ends
                       heuristic (ignored when ``topology`` is given)
``use_devices=``       force the device chain on/off (default: on)
``device=``            the card or the CPU the chain runs on (default:
                       CUDA; ``"cpu"`` runs the kernels' plain versions)
``superchunk_bytes=``  streaming stripe size in BYTES (the word-sized
                       ``superchunk_words=`` spelling is chain-internal)
``reclaim_hot=``       drop replicas during archival (False = two-phase)
``heal=``              re-materialize missing shards on the read path
====================  =====================================================

A drifted spelling (``topo=``, ``order=``, ``superchunk_words=``, ...)
raises ``ValueError`` naming the accepted one instead of vanishing into
``**kwargs``. Return shapes are normalized the same way: write-side methods
return manifests (``archive_many`` a list of them, in step order), read-side
methods return :class:`repro_torch.storage.archive.ReadResult` (bytes/blocks
plus ``served_from``/``nodes``/``healed``), repair methods return repaired
codeword rows. The free functions keep their exact signatures and behavior
— every method here delegates, adding nothing but the binding, so parity
with the free-function surface is bit-exact. The kwarg checks are the JAX
package's (``repro.storage.client``).
"""
from __future__ import annotations

import numpy as np

from repro_torch.storage import archive as arc
from repro_torch.storage.archive import ArchiveConfig, ReadResult  # noqa: F401  (re-export)
from repro_torch.storage.object_store import NodeStore

#: drifted spelling -> the one the facade accepts (ValueError text)
_CANON = {
    "topo": "topology",
    "order": "topology",          # placement comes from the scheduler plan
    "mesh": "use_devices",
    "devices": "use_devices",
    "speeds": "node_speeds",
    "superchunk_words": "superchunk_bytes",
    "sc_words": "superchunk_bytes",
    "sc_bytes": "superchunk_bytes",
    "replacements": "replacement_nodes",
}


def _reject_unknown(method: str, kwargs: dict) -> None:
    """ValueError for any non-canonical kwarg, naming the accepted spelling
    when the name is a known drift (``topo=``, ``superchunk_words=``, ...)."""
    for name in kwargs:
        if name in _CANON:
            raise ValueError(
                f"StorageClient.{method}() got {name!r} — the accepted "
                f"spelling is {_CANON[name]!r}")
        raise ValueError(
            f"StorageClient.{method}() got unknown keyword {name!r}")


class StorageClient:
    """The bound facade; see the module docstring for the vocabulary.

    ``topology`` / ``node_speeds`` / ``use_devices`` / ``device`` given
    here are the defaults for every call; a method-level
    ``superchunk_bytes`` etc. is
    per-call. One client is cheap (it holds no caches beyond what the
    underlying layers already keep) — bind one per (cluster, code config).
    """

    def __init__(self, store: NodeStore, acfg: ArchiveConfig, *,
                 topology=None, node_speeds=None,
                 use_devices: bool | None = None, device=None, **kwargs):
        _reject_unknown("__init__", kwargs)
        self.store = store
        self.acfg = acfg
        self.topology = topology
        self.node_speeds = (None if node_speeds is None
                            else np.asarray(node_speeds))
        self.use_devices = use_devices
        self.device = device

    # -- hot tier -----------------------------------------------------------

    def put_hot(self, step: int, blocks: np.ndarray, **kwargs) -> dict:
        """Store (k, B) uint8 blocks as two overlapped replicas; -> manifest."""
        _reject_unknown("put_hot", kwargs)
        return arc.hot_save(self.store, step, blocks, self.acfg)

    # -- archival migration -------------------------------------------------

    def archive(self, step: int, *, reclaim_hot: bool = True,
                superchunk_bytes: int | None = None, **kwargs) -> dict:
        """Migrate one hot step to the coded tier; -> updated manifest."""
        _reject_unknown("archive", kwargs)
        return arc.archive_step(
            self.store, step, self.acfg, node_speeds=self.node_speeds,
            use_devices=self.use_devices, topology=self.topology,
            reclaim_hot=reclaim_hot, superchunk_bytes=superchunk_bytes,
            device=self.device)

    def archive_many(self, steps: list[int], *, stagger: int = 1,
                     reclaim_hot: bool = True, **kwargs) -> list[dict]:
        """Batched migration of B hot steps; -> manifests in step order."""
        _reject_unknown("archive_many", kwargs)
        return arc.archive_many(
            self.store, steps, self.acfg, node_speeds=self.node_speeds,
            use_devices=self.use_devices, stagger=stagger,
            topology=self.topology, reclaim_hot=reclaim_hot, device=self.device)

    def reclaim(self, step: int, **kwargs) -> dict | None:
        """Phase two of a ``reclaim_hot=False`` migration; -> manifest, or
        None while unverified shards defer the reclaim."""
        _reject_unknown("reclaim", kwargs)
        return arc.reclaim_replicas(self.store, step)

    # -- reads --------------------------------------------------------------

    def read(self, step: int, *, heal: bool = False, **kwargs) -> ReadResult:
        """Whole object; ``.data`` is the (k, B) uint8 block array."""
        _reject_unknown("read", kwargs)
        return arc.restore_blocks_ex(self.store, step, self.acfg, heal=heal,
                                     device=self.device)

    def read_range(self, step: int, offset: int, nbytes: int, *,
                   heal: bool = False, **kwargs) -> ReadResult:
        """Byte range without full-object decode; ``.data`` is bytes."""
        _reject_unknown("read_range", kwargs)
        return arc.read_range_ex(self.store, step, self.acfg, offset, nbytes,
                                 heal=heal, device=self.device)

    # -- repair -------------------------------------------------------------

    def repair(self, step: int, *,
               replacement_nodes: dict[int, int] | None = None,
               superchunk_bytes: int | None = None, **kwargs) -> list[int]:
        """Recompute one step's lost coded blocks; -> repaired rows."""
        _reject_unknown("repair", kwargs)
        return arc.repair(self.store, step, self.acfg,
                          replacement_nodes=replacement_nodes,
                          use_devices=self.use_devices,
                          superchunk_bytes=superchunk_bytes, device=self.device)

    def repair_many(self, steps: list[int], *,
                    replacement_nodes: dict[int, int] | None = None,
                    stagger: int = 1, superchunk_bytes: int | None = None,
                    **kwargs) -> list[list[int]]:
        """Batched heal; -> repaired rows per step, in step order."""
        _reject_unknown("repair_many", kwargs)
        return arc.repair_many(self.store, steps, self.acfg,
                               replacement_nodes=replacement_nodes,
                               use_devices=self.use_devices, stagger=stagger,
                               superchunk_bytes=superchunk_bytes, device=self.device)

    # -- metadata -----------------------------------------------------------

    def manifest(self, step: int, **kwargs) -> dict:
        """The step's (validated) manifest."""
        _reject_unknown("manifest", kwargs)
        return arc.get_manifest(self.store, step)

    def steps(self, **kwargs) -> list[int]:
        """All steps with a published manifest, sorted."""
        _reject_unknown("steps", kwargs)
        return arc.list_steps(self.store)
