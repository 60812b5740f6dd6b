"""Checkpoint manager: training-facing API over the two-tier store.

The lifecycle of the JAX package's manager (``repro.checkpoint.manager``),
over torch states:

  save(step, state)            -> hot tier: 2 replicas over n nodes
                                  (pipelined insertion layout, paper §V)
  save_sharded(step, state)    -> device-direct: pack + erasure-code the
                                  train state straight from its tensors
                                  into the coded tier (repro_torch.checkpoint.devio)
  restore_sharded(step, like)  -> decode + rebuild leaves in one cached
                                  program; optional shardings re-place them
  archive(step)                -> RapidRAID pipelined migration; 2x -> 1.45x
  archive_many(steps)          -> batched migration: all steps encoded
                                  concurrently (staggered multi-chain /
                                  one batched kernel launch, paper §VI)
  restore(step, like)          -> from hot if present, else decode any k of n
  restore_latest(like)         -> newest restorable step (crash recovery);
                                  sharded=True decodes on the device
  manager.store.fail_node(i)   -> simulate node loss; restore still works
  repair(step)                 -> re-materialize lost coded blocks (targeted
                                  pipelined repair, digest-verified)
  repair_many(steps)           -> heal a batch through one staggered launch
  read_range(step, off, n)     -> serve blob bytes without materializing;
                                  degraded read when shards are lost

Every coding step runs on ``device`` (CUDA unless the caller passes
``device="cpu"``, where the kernels' plain versions run). Elasticity:
``restore`` returns host tensors and arrays; ``place`` puts them on any
device, so a job can resume somewhere else than it checkpointed from.
"""
from __future__ import annotations

import dataclasses

from repro_torch.checkpoint import devio
from repro_torch.checkpoint.devio import place  # noqa: F401  (the elastic hook)
from repro_torch.storage import archive as arc
from repro_torch.storage import object_store as obj


@dataclasses.dataclass(frozen=True)
class CheckpointConfig:
    root: str
    n: int = 16
    k: int = 11
    l: int = 16
    seed: int = 0
    hot_keep: int = 2          # newest checkpoints kept hot (replicated)
    archive_old: bool = True   # migrate older checkpoints to RapidRAID
    device_direct: bool = False  # save straight from device buffers (devio)


class CheckpointManager:
    def __init__(self, ccfg: CheckpointConfig, device=None):
        self.ccfg = ccfg
        self.device = device
        self.acfg = arc.ArchiveConfig(n=ccfg.n, k=ccfg.k, l=ccfg.l,
                                      seed=ccfg.seed)
        self.store = obj.NodeStore(ccfg.root, ccfg.n)

    # -- write path --------------------------------------------------------

    def save(self, step: int, state, node_speeds=None) -> dict:
        """Hot-save ``state`` (any checkpoint tree); auto-archive older steps."""
        blob = obj.tree_to_bytes(state)
        # 64-byte lanes: whole uint32 packing lanes for GF(2^8/16) AND a
        # block length divisible by the pipeline chunk count
        blocks = obj.split_blocks(blob, self.ccfg.k, lane_bytes=64)
        manifest = arc.hot_save(self.store, step, blocks, self.acfg)
        manifest["blob_len"] = len(blob)
        arc._put_manifest(self.store, step, manifest)
        if self.ccfg.archive_old:
            self._migrate_old(node_speeds)
        return manifest

    def save_sharded(self, step: int, state, mesh=None, **kwargs) -> dict:
        """Device-direct save: pack + erasure-code ``state`` from its
        tensors in ONE cached program — no host blob, no hot replicas; the
        optimizer state is coded instead of replicated. Still
        bit-compatible with ``restore``. ``mesh`` (a ``DeviceMesh``, in
        place of the manager's device) puts chain position p on its p-th
        device. ``kwargs`` go to ``devio.save_state`` (``use_devices``,
        ``footprint_bytes``, ``num_chunks``)."""
        manifest = devio.save_state(self.store, step, state, self.acfg,
                                    mesh=mesh, device=self._device(mesh), **kwargs)
        if self.ccfg.archive_old:
            self._migrate_old()
        return manifest

    def restore_sharded(self, step: int, like, mesh=None, shardings=None, **kwargs):
        """Decode + rebuild the state for ``step`` in one cached program.
        ``like`` fixes the tree and dtypes (tensor leaves come back on the
        manager's device, or the mesh's first device); pass ``shardings``
        (devices or ``sharding.Placement``s) to re-place leaves, onto a
        smaller mesh after failures, say. Tolerates n-k lost shards like
        ``restore``."""
        return devio.restore_state(self.store, step, like, self.acfg,
                                   mesh=mesh, shardings=shardings,
                                   device=self._device(mesh), **kwargs)

    def _device(self, mesh):
        """The manager's device, unless a mesh says where the chain runs."""
        return self.device if mesh is None else None

    def archive(self, step: int, node_speeds=None) -> dict:
        return arc.archive_step(self.store, step, self.acfg,
                                node_speeds=node_speeds, device=self.device)

    def archive_many(self, steps: list[int], node_speeds=None,
                     stagger: int = 1) -> list[dict]:
        """Migrate several hot steps in one concurrent batched encode."""
        return arc.archive_many(self.store, steps, self.acfg,
                                node_speeds=node_speeds, stagger=stagger,
                                device=self.device)

    def _migrate_old(self, node_speeds=None) -> None:
        steps = arc.list_steps(self.store)
        pending = []
        for s in steps[: -self.ccfg.hot_keep or None]:
            m = arc.get_manifest(self.store, s)
            if m["tier"] == "hot":
                pending.append(s)
        if len(pending) > 1:
            self.archive_many(pending, node_speeds=node_speeds)
        elif pending:
            self.archive(pending[0], node_speeds=node_speeds)

    # -- read path ----------------------------------------------------------

    def restore(self, step: int, like):
        """Rebuild the tree (host tensors and arrays) for ``step``;
        tolerates n-k lost nodes in the archive tier / one replica set in
        the hot tier."""
        manifest = arc.get_manifest(self.store, step)
        blocks = arc.restore_blocks(self.store, step, self.acfg, device=self.device)
        blob = obj.join_blocks(blocks, manifest["blob_len"])
        return obj.bytes_to_leaves(blob, like)

    def restore_latest(self, like, sharded: bool = False, **kwargs):
        """Newest restorable step (skips unrecoverable ones). Returns
        (step, state), or (None, None) when the store holds no checkpoints
        at all (a fresh run). When steps EXIST but none is restorable —
        too many shards lost, corrupt decodes — raises ValueError naming
        the root, the available steps, and why each one failed, instead of
        silently restarting the run from scratch. ``sharded=True`` reads
        each step through ``restore_sharded`` (coded steps decode on the
        manager's device) instead of ``restore`` (the host decode);
        ``kwargs`` (``mesh``, ``shardings``) go to ``restore_sharded``."""
        if kwargs and not sharded:
            raise ValueError("restore_latest: mesh / shardings need sharded=True")
        def read(step, like):
            return self.restore_sharded(step, like, **kwargs) if sharded else \
                self.restore(step, like)
        steps = arc.list_steps(self.store)
        errors = []
        for step in reversed(steps):
            try:
                return step, read(step, like)
            except (FileNotFoundError, AssertionError, ValueError) as e:
                errors.append(f"step {step}: {type(e).__name__}: {e}")
        if steps:
            raise ValueError(
                f"no restorable checkpoint under {self.ccfg.root!r} "
                f"(available steps {steps}): " + "; ".join(errors))
        return None, None

    def read_range(self, step: int, offset: int, nbytes: int,
                   heal: bool = False) -> bytes:
        """Serve checkpoint-blob bytes [offset, offset+nbytes) without
        materializing the object — degraded read when shards are lost."""
        manifest = arc.get_manifest(self.store, step)
        blob_len = manifest.get("blob_len", manifest["k"] * manifest["block_bytes"])
        offset = max(0, min(offset, blob_len))   # EOF-probing reads -> b""
        nbytes = max(0, min(nbytes, blob_len - offset))
        return arc.read_range(self.store, step, self.acfg, offset, nbytes,
                              heal=heal, device=self.device)

    def repair(self, step: int, replacement_nodes=None) -> list[int]:
        return arc.repair(self.store, step, self.acfg,
                          replacement_nodes=replacement_nodes, device=self.device)

    def repair_many(self, steps: list[int], replacement_nodes=None,
                    stagger: int = 1) -> list[list[int]]:
        """Heal several archived steps in one batched (staggered) repair."""
        return arc.repair_many(self.store, steps, self.acfg,
                               replacement_nodes=replacement_nodes,
                               stagger=stagger, device=self.device)

    def steps(self) -> list[int]:
        return arc.list_steps(self.store)

    def tier(self, step: int) -> str:
        try:
            return arc.get_manifest(self.store, step)["tier"]
        except FileNotFoundError:
            raise ValueError(
                f"unknown checkpoint step {step} under "
                f"{self.ccfg.root!r}; available steps: "
                f"{arc.list_steps(self.store)}") from None
