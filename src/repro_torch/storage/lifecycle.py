"""Tick-driven cluster lifecycle: replication -> RapidRAID encoding under churn.

The paper's operating scenario is a LIVE archival system, not a one-shot
encode: fresh objects are kept replicated for fast access, age past a policy
threshold, and are migrated to RapidRAID coding in the background while the
cluster's nodes fail and rejoin continuously (XORing Elephants; Cook et al.
— see PAPERS.md). This engine runs that scenario end to end on the repo's
real data plane. Each ``tick()``:

1. **churn** — the trace's fail/join events hit the store: a failed node is
   wiped AND off the network (``ChurnNodeStore``: its writes are dropped,
   its reads fail) until it rejoins empty.
2. **arrivals** — ``arrival_rate`` new objects land via ``hot_save`` (two
   overlapped replicas over n nodes, the paper's pre-archival placement).
3. **hot scrub** — blocks that lost a replica to churn are re-replicated
   from the surviving copy (replication's repair story).
4. **migration** — hot objects older than ``archive_age`` are batch-encoded
   through ``archive_many`` (staggered pipelined chains of ``chain_tick``
   launches on the card, one cached program per batch shape for the whole
   soak) with ``reclaim_hot=False``: the replicas stay on disk.
5. **coded scrub** — missing/corrupt coded shards (wiped disks, writes that
   landed on a down node mid-archival) are healed in ONE batched
   ``pipelined_repair_many`` run of ``repair_tick`` launches; manifests are
   re-replicated to nodes that missed an update while down. A step whose
   manifest is corrupt everywhere is REPORTED (``scrub_errors``), never a
   crash; any other failure (a kernel's CUDA error inside ``archive_many``,
   say) raises out of ``tick()``.
6. **reclaim** — ``reclaim_replicas`` drops an object's replicas only once
   every coded shard is digest-verified on its node; storage falls from
   2x + n/k to n/k. Unverifiable steps stay replicated (the backlog).

Per-tick metrics (bytes replicated vs encoded, storage overhead, repair
backlog, objects at risk, lost objects) make the run a measurable
experiment; ``metrics_json`` is what the nightly soak CI uploads. Under a
``repro_torch.core.churn.bounded_trace`` (at most n-k unhealed nodes, hot
replica pairs protected) a soak of any length must end with
``lost_objects == 0`` — the testable form of the paper's "without
compromising data reliability".

The JAX package's engine (``repro.storage.lifecycle``) on the port's
archive. Where the JAX package encodes on the host unless the mesh holds n
devices, ``LifecycleConfig.use_devices=None`` (the default) means the card
here: migration runs ``chain_tick`` and the coded scrub ``repair_tick`` on
``device`` (CUDA unless the caller passes ``device="cpu"``, which runs the
kernels' plain versions); ``False`` keeps the host oracle and the
static-coefficient route. Either way the per-tick rows, summaries and store
trees are the JAX package's, byte for byte.
"""
from __future__ import annotations

import dataclasses
import json

import numpy as np

from repro_torch.core import churn as churn_lib
from repro_torch.storage import archive as arc
from repro_torch.storage.object_store import ChurnNodeStore, digests

HOT = arc.HOT
ARC = arc.ARC
MANIFEST = arc.MANIFEST


@dataclasses.dataclass(frozen=True)
class LifecycleConfig:
    """Policy knobs for the engine (code geometry lives in ArchiveConfig)."""
    arrival_rate: float = 1.0     # new objects per tick (fractional carries)
    block_bytes: int = 512        # per-block payload (lane-aligned)
    archive_age: int = 3          # ticks an object stays hot before migrating
    batch_max: int = 4            # archive_many batch cap per tick
    seed: int = 0                 # payload generator seed
    use_devices: bool | None = None   # None: the card; False: the host route
    # temperature-aware family selection (core.scheduler.CodePolicy);
    # None = every object archives with ``acfg.family``
    code_policy: object = None


class ClusterLifecycle:
    """The engine: one instance owns a ``ChurnNodeStore`` and drives it.

    Deterministic by construction: same (ArchiveConfig, LifecycleConfig,
    trace) => identical per-tick metrics, manifests, and stored bytes.
    ``device`` is where every archive call runs (``archive_many``,
    ``repair_many``, ``restore_blocks`` in ``verify_all``).
    """

    def __init__(self, root: str, acfg: arc.ArchiveConfig,
                 lcfg: LifecycleConfig, trace: churn_lib.ChurnTrace,
                 topology=None, admission=None, device=None):
        if trace.n_nodes != acfg.n:
            raise ValueError(f"trace is for {trace.n_nodes} nodes, "
                             f"code needs n={acfg.n}")
        if lcfg.block_bytes % 8:
            raise ValueError(f"block_bytes {lcfg.block_bytes} must be a "
                             f"multiple of 8 (uint32-lane alignment)")
        self.store = ChurnNodeStore(root, acfg.n)
        self.acfg = acfg
        self.lcfg = lcfg
        self.topology = topology
        self.device = device
        # optional repro_torch.core.admission.AdmissionController: migration and
        # routine coded scrub draw one token per step and defer when denied
        # (retrying next tick); repairs racing undecodability bypass it.
        # None (the default) = every phase runs unthrottled, exactly the
        # pre-admission engine.
        self.admission = admission
        self.events = trace.by_tick()
        self.tick_now = 0
        self.next_step = 1
        self._arrival_credit = 0.0
        # step -> {"born": tick, "state": hot|archived|sealed|lost}
        self.objects: dict[int, dict] = {}
        self.metrics: list[dict] = []
        self.scrub_errors: list[str] = []

    # -- payloads ----------------------------------------------------------

    def _payload(self, step: int) -> np.ndarray:
        rng = np.random.default_rng((self.lcfg.seed, step))
        return rng.integers(0, 256, size=(self.acfg.k, self.lcfg.block_bytes),
                            dtype=np.uint8)

    # -- tick phases -------------------------------------------------------

    def _apply_churn(self, t: int) -> tuple[int, int]:
        fails = joins = 0
        for ev in self.events.get(t, []):
            if ev.op == "fail":
                self.store.fail(ev.node)
                fails += 1
            else:
                self.store.rejoin(ev.node)
                joins += 1
        return fails, joins

    def _arrive(self, t: int) -> int:
        self._arrival_credit += self.lcfg.arrival_rate
        born = 0
        while self._arrival_credit >= 1.0:
            self._arrival_credit -= 1.0
            step = self.next_step
            self.next_step += 1
            arc.hot_save(self.store, step, self._payload(step), self.acfg)
            self.objects[step] = {"born": t, "state": "hot"}
            born += 1
        return born

    def _scrub_hot(self, manifests: dict[int, dict]) -> tuple[int, int, int]:
        """Re-replicate hot blocks down to one copy; count losses.

        Returns (re_replicated_blocks, single_copy_blocks, lost_steps).
        Applies to hot steps AND archived steps with retained replicas —
        the retained tier is a real copy until reclaim verifies the coded
        one, so it is scrubbed like any other.
        """
        re_rep = single = lost = 0
        for step, st in self.objects.items():
            if st["state"] not in ("hot", "archived"):
                continue
            manifest = manifests.get(step)
            if manifest is None or (st["state"] == "archived"
                                    and not manifest.get("hot_retained")):
                continue
            step_lost = False
            # every present replica of the step read, then hashed at once
            # (in parallel past PARALLEL_DIGEST_BYTES); each block is then
            # judged in order, as one replica at a time would be
            holders_of = {j: [i for i, held in enumerate(manifest["placement"])
                              if j in held] for j in range(manifest["k"])}
            raws = {(j, node): self.store.get(node, HOT.format(step=step, j=j))
                    for j in range(manifest["k"]) for node in holders_of[j]
                    if self.store.has(node, HOT.format(step=step, j=j))}
            sums = dict(zip(raws, digests(list(raws.values()))))
            for j in range(manifest["k"]):
                rel = HOT.format(step=step, j=j)
                holders = holders_of[j]
                live = []
                for node in holders:
                    if (j, node) not in raws:
                        continue
                    if sums[(j, node)] == manifest["digests"][j]:
                        live.append((node, raws[(j, node)]))
                    else:
                        self.store.delete(node, rel)  # corrupt copy: demote
                if not live:
                    step_lost = True
                    continue
                missing = [node for node in holders
                           if self.store.is_up(node)
                           and not self.store.has(node, rel)]
                for node in missing:
                    self.store.put(node, rel, live[0][1])
                    re_rep += 1
                if len(live) + len(missing) < len(holders):
                    single += 1          # a holder is still down
            if step_lost and st["state"] == "hot":
                st["state"] = "lost"
                lost += 1
        return re_rep, single, lost

    def _migrate(self, t: int, manifests: dict[int, dict]) -> list[int]:
        """Archive the oldest due hot steps (one batched encode)."""
        due = [step for step, st in self.objects.items()
               if st["state"] == "hot"
               and t - st["born"] >= self.lcfg.archive_age]
        due = sorted(due)[: self.lcfg.batch_max]
        ready = []
        for step in due:
            manifest = manifests.get(step)
            if manifest is None:         # corrupt manifest: already reported
                continue
            ok = all(any(self.store.has(i, HOT.format(step=step, j=j))
                         for i, held in enumerate(manifest["placement"])
                         if j in held)
                     for j in range(manifest["k"]))
            if ok:
                ready.append(step)
        if self.admission is not None:
            # one token per archived step; a denied step simply stays hot
            # and retries next tick (it is already past archive_age, so
            # deferral costs replica bytes, never durability)
            ready = [step for step in ready
                     if self.admission.acquire("archive")]
        if not ready:
            return []
        policy = self.lcfg.code_policy
        fam_of = {
            step: (policy.family_for(t - self.objects[step]["born"])
                   if policy is not None else self.acfg.family)
            for step in ready}
        for fam in sorted(set(fam_of.values())):
            grp = [s for s in ready if fam_of[s] == fam]
            arc.archive_many(self.store, grp,
                             dataclasses.replace(self.acfg, family=fam),
                             use_devices=self.lcfg.use_devices,
                             topology=self.topology, reclaim_hot=False,
                             device=self.device)
        for step in ready:
            self.objects[step]["state"] = "archived"
        return ready

    def _scrub_coded(self, manifests: dict[int, dict]) -> tuple[int, int, int]:
        """Heal missing coded shards; returns (repaired, backlog, at_risk).

        ``backlog`` counts archived steps still carrying missing shards
        after this pass (their home nodes are down); ``at_risk`` counts
        steps within one further loss of undecodability.

        With an admission controller attached, each healable step draws
        one token; a step within one further loss of undecodability (and
        not backed by retained replicas) is URGENT and bypasses the
        bucket — throttling must never turn bounded churn into data loss.
        Denied steps stay in the backlog and retry next tick.
        """
        heal: list[tuple[int, bool]] = []
        for step, st in self.objects.items():
            if st["state"] not in ("archived", "sealed"):
                continue
            manifest = manifests.get(step)
            if manifest is None:
                continue
            perm = manifest["perm"]
            missing = [pos for pos in range(manifest["n"])
                       if not self.store.has(perm[pos],
                                             ARC.format(step=step, i=pos))]
            alive = [pos for pos in range(manifest["n"])
                     if pos not in missing]
            # decodability is the CODE's call (LRC is not MDS: a loss
            # pattern within n-k can still be fatal; MBR tolerates more)
            code = arc._manifest_code(manifest)
            if missing and not code.decodable(alive):
                if manifest.get("hot_retained"):
                    continue            # replicas still back the object
                st["state"] = "lost"
                continue
            if any(self.store.is_up(perm[pos]) for pos in missing):
                urgent = (not manifest.get("hot_retained")
                          and any(not code.decodable(
                                      [p for p in alive if p != q])
                                  for q in alive))
                heal.append((step, urgent))
        if self.admission is not None:
            heal = [(step, urgent) for step, urgent in heal
                    if self.admission.acquire("repair", urgent=urgent)]
        heal = [step for step, _ in heal]
        repaired = 0
        if heal:
            rows = arc.repair_many(self.store, heal, self.acfg,
                                   use_devices=self.lcfg.use_devices,
                                   device=self.device)
            repaired = sum(len(r) for r in rows)
            for step in heal:
                manifests[step] = arc.get_manifest(self.store, step)
        backlog = at_risk = 0
        for step, st in self.objects.items():
            if st["state"] not in ("archived", "sealed"):
                continue
            manifest = manifests.get(step)
            if manifest is None:
                continue
            perm = manifest["perm"]
            alive = [pos for pos in range(manifest["n"])
                     if self.store.has(perm[pos],
                                       ARC.format(step=step, i=pos))]
            if len(alive) < manifest["n"]:
                backlog += 1
            code = arc._manifest_code(manifest)
            if any(not code.decodable([p for p in alive if p != q])
                   for q in alive):
                at_risk += 1
        return repaired, backlog, at_risk

    def _scrub_manifests(self, manifests: dict[int, dict]) -> int:
        """Re-replicate manifests to up nodes that missed an update while
        down — otherwise enough failure cycles could wipe every copy."""
        fixed = 0
        for step, manifest in manifests.items():
            if self.objects[step]["state"] == "lost":
                continue
            rel = MANIFEST.format(step=step)
            data = None
            for i in range(self.store.n_nodes):
                if self.store.is_up(i) and not self.store.has(i, rel):
                    if data is None:
                        data = json.dumps(manifest).encode()
                    self.store.put(i, rel, data)
                    fixed += 1
        return fixed

    def _reclaim(self, manifests: dict[int, dict]) -> int:
        sealed = 0
        for step, st in self.objects.items():
            if st["state"] != "archived" or step not in manifests:
                continue
            manifest = arc.reclaim_replicas(self.store, step)
            if manifest is not None and manifest.get("hot_retained") is False:
                st["state"] = "sealed"
                manifests[step] = manifest
                sealed += 1
        return sealed

    # -- accounting --------------------------------------------------------

    def _account(self, manifests: dict[int, dict]) -> dict:
        """Stored-bytes accounting from live files (replicas + shards)."""
        hot_bytes = coded_bytes = logical = 0
        for step, st in self.objects.items():
            if st["state"] == "lost":
                continue
            manifest = manifests.get(step)
            if manifest is None:
                continue
            B = manifest["block_bytes"]
            logical += manifest["k"] * B
            for j in range(manifest["k"]):
                rel = HOT.format(step=step, j=j)
                hot_bytes += B * sum(
                    1 for i, held in enumerate(manifest["placement"])
                    if j in held and self.store.has(i, rel))
            if st["state"] in ("archived", "sealed"):
                perm = manifest["perm"]
                # actual on-disk sizes: regenerating codes store alpha
                # sub-blocks per node, so a shard is NOT one block
                coded_bytes += sum(
                    self.store.size(perm[pos], ARC.format(step=step, i=pos))
                    for pos in range(manifest["n"])
                    if self.store.has(perm[pos],
                                      ARC.format(step=step, i=pos)))
        return {"bytes_hot": hot_bytes, "bytes_coded": coded_bytes,
                "bytes_logical": logical,
                "storage_overhead": round(
                    (hot_bytes + coded_bytes) / logical, 4) if logical else 0.0}

    def _manifests(self) -> dict[int, dict]:
        out: dict[int, dict] = {}
        for step, st in self.objects.items():
            if st["state"] == "lost":
                continue
            try:
                out[step] = arc.get_manifest(self.store, step)
            except (FileNotFoundError, ValueError) as e:
                # a reportable scrub finding, never a mid-soak crash; both
                # cases are terminal — failed nodes rejoin WIPED, so no
                # valid replica can ever resurface — so the object is lost
                # (and reported exactly once, not once per tick)
                self.scrub_errors.append(f"tick {self.tick_now} step {step}: "
                                         f"{e}")
                st["state"] = "lost"
        return out

    # -- the tick ----------------------------------------------------------

    def tick(self, foreground_load: float | None = None) -> dict:
        t = self.tick_now
        if self.admission is not None:
            # one refill per tick, scaled by the serving layer's foreground
            # read load (None = idle: the backlog drains at full rate)
            self.admission.begin_tick(foreground_load or 0.0)
        fails, joins = self._apply_churn(t)
        born = self._arrive(t)
        manifests = self._manifests()
        re_rep, single, lost_hot = self._scrub_hot(manifests)
        migrated = self._migrate(t, manifests)
        for step in migrated:
            manifests[step] = arc.get_manifest(self.store, step)
        repaired, backlog, at_risk = self._scrub_coded(manifests)
        sealed = self._reclaim(manifests)
        manifest_fixes = self._scrub_manifests(manifests)
        states = [st["state"] for st in self.objects.values()]
        row = {
            "tick": t, "fails": fails, "joins": joins,
            "down_nodes": len(self.store.down),
            "arrived": born, "archived": len(migrated), "sealed": sealed,
            "re_replicated": re_rep, "single_copy_blocks": single,
            "repaired_shards": repaired, "repair_backlog": backlog,
            "manifest_fixes": manifest_fixes,
            "objects_hot": states.count("hot"),
            "objects_archived": states.count("archived"),
            "objects_sealed": states.count("sealed"),
            "objects_at_risk": at_risk,
            "lost_objects": states.count("lost"),
            **self._account(manifests),
        }
        if self.admission is not None:
            # admission accounting only when a controller is attached, so
            # admission-free runs keep their exact pre-admission rows
            row["bg_granted"] = self.admission.tick_granted
            row["bg_urgent"] = self.admission.tick_urgent
            row["bg_denied"] = self.admission.tick_denied
        self.metrics.append(row)
        self.tick_now += 1
        return row

    def run(self, ticks: int) -> list[dict]:
        for _ in range(ticks):
            self.tick()
        return self.metrics

    # -- reporting ---------------------------------------------------------

    def verify_all(self) -> int:
        """Digest-verified restore of every non-lost object (the soak's
        zero-data-loss check is end-to-end, not bookkeeping)."""
        restored = 0
        for step, st in self.objects.items():
            if st["state"] == "lost":
                continue
            blocks = arc.restore_blocks(self.store, step, self.acfg,
                                        device=self.device)
            np.testing.assert_array_equal(blocks, self._payload(step))
            restored += 1
        return restored

    def summary(self) -> dict:
        last = self.metrics[-1] if self.metrics else {}
        return {
            "ticks": len(self.metrics),
            "objects": len(self.objects),
            "lost_objects": last.get("lost_objects", 0),
            "final_overhead": last.get("storage_overhead", 0.0),
            "coded_overhead": round(self.acfg.n / self.acfg.k, 4),
            "total_repaired_shards": sum(r["repaired_shards"]
                                         for r in self.metrics),
            "total_re_replicated": sum(r["re_replicated"]
                                       for r in self.metrics),
            "max_repair_backlog": max((r["repair_backlog"]
                                       for r in self.metrics), default=0),
            "scrub_errors": len(self.scrub_errors),
        }

    def metrics_json(self) -> str:
        """The run as JSON: configs, summary and per-tick rows. Equal to the
        JAX engine's output for the same run but in ``lcfg.use_devices``,
        whose default here is None (the card) where the JAX package's is
        False."""
        return json.dumps({"config": {
            "acfg": dataclasses.asdict(self.acfg),
            "lcfg": dataclasses.asdict(self.lcfg)},
            "summary": self.summary(), "ticks": self.metrics}, indent=1)
