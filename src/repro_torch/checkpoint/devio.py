"""Device-direct erasure-coded checkpoint I/O: a torch state <-> coded shards.

The host path (``manager.save``) serializes the train state with
``tree_to_bytes``: every leaf crosses to the host, is copied into one blob,
split into blocks, and only then coded. Here the same packing happens on
the card, from the state's own tensors:

  save:    leaves --byte views, copied--> (k, B) uint8 blocks on the card
           --its int32 view, read in place--> chain encode (``chain_tick``)
           --> (n, B) coded words                          [ONE cached program]
  restore: (k, B) survivor words --pipelined decode (``repair_tick``)-->
           blob --slices, viewed as each leaf's dtype--> leaves
                                                           [ONE cached program]

so the state is erasure-coded instead of replicated, and the only host
transfers are the blocks and the codeword headed for the node disks (their
digests and files). The blob is BYTE-IDENTICAL to ``tree_to_bytes`` (shared
``object_store.leaf_metas`` / ``tree_header``), and to the JAX package's
for a state of the same containers, so ``manager.restore`` reads
device-saved checkpoints, ``restore_state`` reads host-archived ones, and
either package restores the other's.

``use_devices=False`` is the static route: one ``gf_encode`` launch of the
generator (save) or of the survivors' decode matrix (restore) over the same
blocks, with the same coded blobs. Either way the program is built once per
``(entry, code, route, state layout, block bytes, chunks, device)`` key
through ``repro_torch.core.jitcache``: repeated saves of same-shaped states
reuse one program.

A leaf is a device leaf when it is a ``torch.Tensor`` (a tensor on the
``meta`` device describes a layout with no data, as a
``jax.ShapeDtypeStruct`` does) or a ``sharding.ShardedTensor`` (a state laid
out over a training mesh: each distinct block is copied into its place in
the blob from the device that holds it, never assembled on one device
first, so the blob — and every coded shard — is that of the same state
saved whole); every other leaf (numpy arrays and scalars,
such as an ``np.int64`` step counter) is copied in from its host bytes, at
the exact ``tree_to_bytes`` offset. A state whose modeled footprint passes
a budget is serialized on the host and streamed through the card
(``save_state``'s ``footprint_bytes``).

``mesh=`` (a ``DeviceMesh``, the training mesh) draws the chain from its
devices: chain position p is its p-th device (``sharding.chain_order``), so
each position encodes or decodes on a device of the mesh
(``chain.pipelined_encode``'s placement), and the coded blobs are those of
a save with no mesh. A mesh with fewer devices than the chain has
positions takes the static route, one ``gf_encode`` launch on its first
device, as the JAX package's does. ``shardings=`` (a ``torch.device``, or
a tree of devices or of ``sharding.Placement``s, as
``sharding.state_shardings`` gives) places each restored leaf: the
elastic restore onto another, smaller mesh.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.core import codes, gf, jitcache, streaming
from repro_torch.kernels.gf_encode import ops
from repro_torch.launch.mesh import DeviceMesh
from repro_torch.storage import archive as arc
from repro_torch.storage import chain as chain_lib
from repro_torch.storage import object_store as obj
from repro_torch.train import sharding

LANE_BYTES = 64   # whole uint32 packing lanes AND chunk-divisible blocks


# ---------------------------------------------------------------------------
# state layout: the tree_to_bytes-compatible byte plan
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class StateLayout:
    """Byte plan for one train-state shape: where every leaf's bytes live in
    the blob, which leaves are device-resident, and a hashable cache key."""

    treedef: Any
    metas: tuple
    prefix: bytes               # MAGIC + header length + header JSON
    blob_len: int
    device_leaf: tuple          # per-leaf: a tensor (vs host bytes)
    key: tuple                  # (prefix digest, device classification)


def state_layout(state) -> StateLayout:
    """Layout for ``state`` (tensors, ``meta`` tensors as templates, numpy
    leaves). The prefix (and therefore the whole blob) is byte-identical to
    what ``tree_to_bytes`` writes for the same tree."""
    leaves, treedef = _flatten(state)
    metas = obj.leaf_metas(leaves)
    prefix = obj.tree_header(treedef, metas)
    body_len = (metas[-1]["offset"] + metas[-1]["nbytes"]) if metas else 0
    device_leaf = tuple(isinstance(x, (torch.Tensor, sharding.ShardedTensor)) for x in leaves)
    return StateLayout(
        treedef=treedef, metas=tuple(metas), prefix=prefix,
        blob_len=len(prefix) + body_len, device_leaf=device_leaf,
        key=(obj.digest(prefix), device_leaf))


def _flatten(tree):
    """(leaves, treedef) of a state whose leaves may be ``ShardedTensor``s."""
    return obj.tree_flatten(tree, is_leaf=lambda x: isinstance(x, sharding.ShardedTensor))


def _byte_rows(x, shape: tuple) -> torch.Tensor:
    """A tensor's (or a blob region's) bytes as uint8 of ``shape`` with the
    last dim counted in bytes, so a block's slice of it is a block of bytes."""
    if x.ndim == 0 or not shape:
        return x.reshape(-1)
    return x.reshape(tuple(shape[:-1]) + (-1,))


def _write_sharded(region: torch.Tensor, st: sharding.ShardedTensor) -> None:
    """Each distinct block of ``st`` into ``region`` (the leaf's uint8 bytes
    in the blob), copied from the device that holds it."""
    item = st.dtype.itemsize
    dest = _byte_rows(region, st.shape)
    for block, shard, own in zip(st.blocks(), st.shards, st.owners()):
        if not own:
            continue
        if not st.shape:
            dest.copy_(shard.detach().reshape(1).view(torch.uint8))
            continue
        src = shard.detach().contiguous().view(torch.uint8)
        last = block[-1]
        idx = block[:-1] + (slice(last.start * item, last.stop * item),)
        dest[idx] = _byte_rows(src, shard.shape).to(dest.device)


def _leaf_u8(x: torch.Tensor) -> torch.Tensor:
    """A tensor leaf's blob bytes, 1-D uint8: its byte view, no copy for a
    contiguous leaf (a bool leaf views as uint8 too)."""
    if x.device.type == "meta":
        raise ValueError("cannot save a tensor on the meta device: it describes a "
                         "layout and holds no data")
    return x.detach().contiguous().reshape(-1).view(torch.uint8)


def _host_u8(leaf) -> torch.Tensor:
    """A host leaf's blob bytes, 1-D uint8."""
    return torch.from_numpy(np.ascontiguousarray(np.asarray(leaf)).reshape(-1).view(np.uint8))


# ---------------------------------------------------------------------------
# cached programs
# ---------------------------------------------------------------------------


class _StateProgram:
    """A cached checkpoint program: ``run`` closed over what does not depend
    on the state's values (prefix, layout, the chain program or matrix)."""

    def __init__(self, run):
        self.run = run

    def __call__(self, *args):
        return self.run(*args)

    def _cache_size(self) -> int:   # jitcache.compile_counts: built once
        return 1


def _build_save(code, layout: StateLayout, num_chunks: int, use_chain: bool,
                block_bytes: int, device: torch.device, chain_mesh=None) -> _StateProgram:
    """One program: state leaves -> ((k, B) blocks, (n, B / (l/8)) coded
    words), both on ``device``.

    The original blocks come back beside the codeword so the caller can
    record ``orig_digests`` (what host restore verifies decode against)
    without re-deriving them. ``chain_mesh``: the chain's positions on
    the mesh's devices (``_chain_mesh``), the first of them ``device``.
    """
    l, k = code.l, code.k
    prefix = torch.frombuffer(bytearray(layout.prefix), dtype=torch.uint8).to(device)
    plen = len(layout.prefix)
    if use_chain:
        encode = chain_lib.encode_program(code, block_bytes * 8 // l, num_chunks,
                                          **_on(chain_mesh, device))
    else:
        def encode(words):
            return ops.encode_words(code.G, words, l)

    def run(leaves):
        buf = torch.empty(k * block_bytes, dtype=torch.uint8, device=device)
        buf[:plen] = prefix
        for leaf, meta, is_dev in zip(leaves, layout.metas, layout.device_leaf):
            if meta["nbytes"]:
                a = plen + meta["offset"]
                if isinstance(leaf, sharding.ShardedTensor):
                    _write_sharded(buf[a:a + meta["nbytes"]], leaf)
                else:
                    buf[a:a + meta["nbytes"]] = _leaf_u8(leaf) if is_dev else _host_u8(leaf)
        buf[layout.blob_len:] = 0
        blocks = buf.view(k, block_bytes)
        # the chain reads the blocks' int32 view in place (gf.pack_u32)
        return blocks, encode(blocks.view(gf.TORCH_WORD_DTYPE[l]))
    return _StateProgram(run)


def _build_restore(code, ids: tuple, layout: StateLayout, num_chunks: int,
                   use_chain: bool, block_bytes: int,
                   device: torch.device, chain_mesh=None) -> _StateProgram:
    """One program: (k, Bw) survivor words on ``device`` -> tuple of leaves.

    Device-classified leaves come out in their stored dtype and shape
    (each a copy of its slice of the decoded blob, viewed as its dtype);
    host-classified leaves come out as raw uint8 on the host, for the
    caller to view as numpy dtypes.
    """
    l = code.l
    if use_chain:
        decode = chain_lib.decode_program(code, ids, block_bytes * 8 // l, num_chunks,
                                          **_on(chain_mesh, device))
    else:
        D = code.decode_matrix(list(ids))

        def decode(shards_w):
            return ops.encode_words(D, shards_w, l)
    plen = len(layout.prefix)

    def run(shards_w):
        blob = decode(shards_w).view(torch.uint8).reshape(-1)
        out = []
        for meta, is_dev in zip(layout.metas, layout.device_leaf):
            a = plen + meta["offset"]
            raw = blob[a:a + meta["nbytes"]]
            if is_dev:
                out.append(raw.clone().view(obj.torch_dtype(meta["dtype"]))
                           .reshape(meta["shape"]))
            else:
                out.append(raw.cpu())
        return tuple(out)
    return _StateProgram(run)


def _chunk_count(Bw: int, l: int, num_chunks: int) -> int:
    """Largest feasible chunk count (same reduction as ``archive_step``)."""
    nc = num_chunks
    while nc > 1 and Bw % (gf.LANES[l] * nc):
        nc //= 2
    return nc


def _on(chain_mesh, device) -> dict:
    """The placement keywords of a chain program: the mesh, or the device."""
    return {"device": device} if chain_mesh is None else {"mesh": chain_mesh}


def _run_device(mesh, device, what: str) -> torch.device:
    """The device a program runs on: ``device``, or a mesh's first device."""
    if mesh is None:
        return chain_lib._resolve_device(device)
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"{what}: mesh must be a DeviceMesh, got {type(mesh).__name__}")
    if device is not None:
        raise ValueError(f"{what}: pass either mesh or device, not both")
    return chain_lib._resolve_device(mesh.flat[0])


def _chain_mesh(mesh, n: int) -> DeviceMesh | None:
    """The n-position chain drawn from ``mesh``: position p on the mesh's
    p-th device (``sharding.chain_order``). None for no mesh, and for a
    mesh of fewer than n devices, which takes the static route."""
    order = None if mesh is None else sharding.chain_order(mesh, n)
    if order is None:
        return None
    return DeviceMesh((chain_lib.AXIS,), (n,), mesh.flat[:n], ids=order)


def _place_leaf(a, target):
    if isinstance(a, sharding.ShardedTensor):
        a = a.full()
    x = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.array(a))
    if isinstance(target, sharding.Placement):
        return sharding.shard(x, target)
    return x.to(target)


def place(tree, shardings):
    """Each leaf of ``tree`` on its devices: ``shardings`` is one
    ``torch.device`` (or name) for every leaf, or a tree matching ``tree``
    of devices or of ``sharding.Placement``s (a leaf then becomes a
    ``sharding.ShardedTensor`` over the placement's mesh). The
    elastic-restart hook: a state restored anywhere resumes on the devices
    of the new run's mesh."""
    leaves, treedef = _flatten(tree)
    target = (torch.device, str, sharding.Placement)
    if isinstance(shardings, target):
        targets = [shardings] * len(leaves)
    else:
        targets, sdef = obj.tree_flatten(shardings, is_leaf=lambda x: isinstance(x, target))
        if str(sdef) != str(treedef):
            raise ValueError(f"shardings {sdef} do not match the state {treedef}")
    return treedef.unflatten(_place_leaf(a, d) for a, d in zip(leaves, targets))


# ---------------------------------------------------------------------------
# save / restore entry points
# ---------------------------------------------------------------------------


def save_state(store, step: int, state, acfg: arc.ArchiveConfig,
               mesh=None, num_chunks: int | None = None,
               use_devices: bool | None = None,
               footprint_bytes: int | None = None, device=None) -> dict:
    """Erasure-code ``state`` straight from its tensors into the coded tier
    (no hot replicas, no host blob). Returns the manifest.

    The program runs on ``device`` (CUDA unless the caller passes
    ``device="cpu"``, where the kernels' plain versions run): the pipelined
    chain encode (``chain_tick``), or with ``use_devices=False`` one
    ``gf_encode`` launch of the generator; the coded blobs are the same.

    ``footprint_bytes`` (default: the ``RAPIDRAID_STREAM_BUDGET_BYTES``
    env knob) bounds the encode's device bytes: a state whose modeled
    footprint (``streaming.estimate_stripe_bytes``) exceeds it routes
    through the STREAMING path instead — host serialization, then
    super-chunk stripes through one cached chain program into atomic framed
    writes (``archive.publish_streaming_archive``) — so a state larger than
    the card checkpoints under a fixed device budget. States that fit keep
    the zero-host-blob device-direct program.

    ``mesh`` (a ``DeviceMesh``, in place of ``device``): chain position p
    encodes on the mesh's p-th device (``sharding.chain_order``); a mesh of
    fewer than n devices takes the ``gf_encode`` route on its first device
    unless ``use_devices=True``. The coded blobs are the same either way.
    """
    code = acfg.code()
    if not code.positionwise:
        raise ValueError(
            f"device-direct checkpointing needs a positionwise code; "
            f"{code.family!r} is sub-packetized — archive via the host "
            f"path (manager.save) or pick family='rapidraid'/'lrc'")
    dev = _run_device(mesh, device, "save_state")
    layout = state_layout(state)
    B = obj.block_bytes_for(layout.blob_len, acfg.k, lane_bytes=LANE_BYTES)
    if footprint_bytes is None:
        footprint_bytes = streaming.budget_from_env()
    if (footprint_bytes is not None
            and streaming.estimate_stripe_bytes(code, B * 8 // acfg.l)
            > footprint_bytes):
        blob = obj.tree_to_bytes(state)
        blocks = obj.split_blocks(blob, acfg.k, lane_bytes=LANE_BYTES)
        sc_words = streaming.superchunk_words_for(
            footprint_bytes, code, num_chunks or acfg.num_chunks)
        return arc.publish_streaming_archive(
            store, step, acfg, blocks, len(blob),
            superchunk_bytes=sc_words * (acfg.l // 8),
            state_key=layout.key[0], use_devices=use_devices, device=dev)
    nc = _chunk_count(B * 8 // acfg.l, acfg.l, num_chunks or acfg.num_chunks)
    chain_mesh = _chain_mesh(mesh, acfg.n)
    if mesh is not None and use_devices is None:
        use_devices = chain_mesh is not None
    use_chain = arc._use_devices(use_devices) and code.supports_chain_encode
    chain_mesh = chain_mesh if use_chain else None
    fn = jitcache.get(
        ("ckpt_save", code.cache_key, chain_mesh, use_chain, layout.key, B, nc, dev),
        lambda: _build_save(code, layout, nc, use_chain, B, dev, chain_mesh))
    blocks, coded_w = fn(_flatten(state)[0])
    return arc.publish_device_archive(
        store, step, acfg, blocks.cpu().numpy(), arc._u8(coded_w.cpu().numpy()),
        layout.blob_len, state_key=layout.key[0])


def restore_state(store, step: int, like, acfg: arc.ArchiveConfig,
                  mesh=None, shardings=None,
                  num_chunks: int | None = None,
                  use_devices: bool | None = None, device=None):
    """Decode step's shards and rebuild the train state in one cached
    program; tolerates up to n-k lost shards (digest-verified survivors).

    ``like`` supplies the tree structure and the device/host classification
    (tensor leaves, ``meta`` templates included, come back as tensors on
    ``device``; numpy leaves as host arrays). ``shardings`` (one
    ``torch.device``, or a matching tree of devices or of
    ``sharding.Placement``s) places each restored leaf (``place``): the
    elastic restore onto another mesh. ``mesh`` (in place of ``device``)
    runs the decode chain's position p on the mesh's p-th device, or, for
    a mesh of fewer devices than the k helpers, one ``gf_encode`` launch on
    its first device. Hot-tier, streamed and sub-packetized steps restore
    through the host decode (``archive.restore_blocks``), as the JAX
    package's do.
    """
    dev = _run_device(mesh, device, "restore_state")
    manifest = arc.get_manifest(store, step)
    layout = state_layout(like)
    blob_len = manifest.get("blob_len")
    if blob_len is not None and blob_len != layout.blob_len:
        raise ValueError(
            f"step {step}: template does not match the archived state "
            f"(blob {blob_len} bytes, template describes "
            f"{layout.blob_len})")
    if (manifest.get("state_key") is not None
            and manifest["state_key"] != layout.key[0]):
        raise ValueError(
            f"step {step}: template layout {layout.key[0]} does not match "
            f"the archived state layout {manifest['state_key']} "
            f"(different treedef, dtypes, or shapes)")

    coded = (arc._manifest_code(manifest)
             if manifest["tier"] == "archive" else None)
    if (manifest["tier"] != "archive" or manifest.get("hot_retained")
            or manifest.get("streaming") or not coded.positionwise):
        # sub-packetized families and STREAMED archives restore through the
        # host decode path (restore_blocks reads streamed steps stripe-by-
        # stripe against the manifest's per-stripe digests)
        blocks = arc.restore_blocks(store, step, acfg, device=dev)
        blob = obj.join_blocks(blocks, blob_len or layout.blob_len)
        leaves = [x.to(dev) if isinstance(x, torch.Tensor) else x
                  for x in obj.tree_flatten(obj.bytes_to_leaves(blob, like))[0]]
    else:
        code = coded
        alive = arc._alive_coded(store, step, manifest)
        if len(alive) < manifest["k"]:
            raise FileNotFoundError(
                f"step {step}: only {len(alive)} of n={manifest['n']} coded "
                f"blocks alive, need k={manifest['k']}")
        alive_ids = [pos for pos, _ in alive]
        try:
            chosen = codes.independent_rows(
                code.G[alive_ids], manifest["k"], manifest["l"])
        except ValueError as e:
            raise FileNotFoundError(
                f"step {step}: survivors not decodable ({e})") from None
        helpers = tuple(alive_ids[p] for p in chosen)
        raws = dict(alive)
        shards_w = arc._words(
            np.stack([np.frombuffer(raws[h], dtype=np.uint8)
                      for h in helpers]), manifest["l"])
        nc = _chunk_count(shards_w.shape[1], manifest["l"],
                          num_chunks or acfg.num_chunks)
        chain_mesh = _chain_mesh(mesh, len(helpers))
        if mesh is not None and use_devices is None:
            use_devices = chain_mesh is not None
        use_chain = arc._use_devices(use_devices) and code.positionwise
        chain_mesh = chain_mesh if use_chain else None
        fn = jitcache.get(
            ("ckpt_restore", code.cache_key, helpers, chain_mesh, use_chain, layout.key,
             manifest["block_bytes"], nc, dev),
            lambda: _build_restore(code, helpers, layout, nc, use_chain,
                                   manifest["block_bytes"], dev, chain_mesh))
        out_leaves = fn(torch.from_numpy(shards_w).to(dev))
        leaves = []
        for leaf, meta, is_dev in zip(out_leaves, layout.metas,
                                      layout.device_leaf):
            if is_dev:
                leaves.append(leaf)
            else:
                leaves.append(leaf.numpy().view(np.dtype(meta["dtype"]))
                              .reshape(meta["shape"]))
    tree = layout.treedef.unflatten(leaves)
    if shardings is not None:
        tree = place(tree, shardings)
    return tree
