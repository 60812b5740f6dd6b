"""Directory-backed distributed object store and the block codec.

Storage nodes are directories (``root/node_07/...``) so the full paper
lifecycle — replicated hot tier, pipelined archival, node loss, repair —
runs and is testable in one process; on a real cluster each node_* maps to
one host's local disk. Blocks are the unit of placement and coding: an
object's bytes are split into k equal blocks (padded to whole lanes), the
"object o = (o_1, ..., o_k)" of the paper.

Codec: a checkpoint tree (nested ``dict`` / ``OrderedDict`` / ``list`` /
``tuple`` / ``None`` over tensors, numpy arrays and numbers) is serialized
to one contiguous buffer (header JSON + raw leaf bytes), then split into k
blocks.

The on-disk layout, the block split and the digests are the JAX package's
(``repro.storage.object_store``), and so is the blob: the tree is flattened
in JAX's order (a ``dict`` by sorted keys, an ``OrderedDict`` in insertion
order, ``None`` an empty subtree) and the header records the
``str(treedef)`` that jax prints for the same containers. A state built
from the same containers therefore serializes to the same bytes in both
packages, and either package restores the other's checkpoints.
"""
from __future__ import annotations

import collections
import concurrent.futures
import dataclasses
import hashlib
import json
import numbers
import os
import shutil

import numpy as np
import torch

MAGIC = b"RRCK"


# ---------------------------------------------------------------------------
# trees (of tensors / numpy arrays / numbers) <-> bytes
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TreeDef:
    """The structure of a flattened tree: ``kind`` is ``"leaf"``, ``"none"``,
    ``"dict"``, ``"odict"``, ``"list"`` or ``"tuple"``; ``keys`` the dict
    keys in flatten order; ``children`` the subtrees in that order.

    ``str()`` is jax's ``PyTreeDef(...)`` of the same containers, which the
    checkpoint header records (``tree_header``)."""

    kind: str
    keys: tuple = ()
    children: tuple = ()

    @property
    def num_leaves(self) -> int:
        if self.kind == "leaf":
            return 1
        return sum(c.num_leaves for c in self.children)

    def _body(self) -> str:
        if self.kind == "leaf":
            return "*"
        if self.kind == "none":
            return "None"
        kids = [c._body() for c in self.children]
        if self.kind == "dict":
            return "{" + ", ".join(f"{k!r}: {v}" for k, v in zip(self.keys, kids)) + "}"
        if self.kind == "odict":
            return f"CustomNode(OrderedDict[{self.keys!r}], [{', '.join(kids)}])"
        if self.kind == "list":
            return "[" + ", ".join(kids) + "]"
        return "(" + ", ".join(kids) + ("," if len(kids) == 1 else "") + ")"

    def __str__(self) -> str:
        return f"PyTreeDef({self._body()})"

    def unflatten(self, leaves):
        """The tree of this structure over ``leaves`` (flatten order)."""
        leaves = list(leaves)
        if len(leaves) != self.num_leaves:
            raise ValueError(f"{str(self)} takes {self.num_leaves} leaves, "
                             f"got {len(leaves)}")
        it = iter(leaves)
        return self._build(it)

    def _build(self, it):
        if self.kind == "leaf":
            return next(it)
        if self.kind == "none":
            return None
        kids = [c._build(it) for c in self.children]
        if self.kind == "dict":
            return dict(zip(self.keys, kids))
        if self.kind == "odict":
            return collections.OrderedDict(zip(self.keys, kids))
        return kids if self.kind == "list" else tuple(kids)


def _is_leaf(x) -> bool:
    return isinstance(x, (torch.Tensor, np.ndarray, np.generic, numbers.Number))


def tree_flatten(tree, is_leaf=None) -> tuple[list, TreeDef]:
    """(leaves, treedef) in jax's flatten order: a ``dict`` by sorted keys,
    an ``OrderedDict`` in insertion order, ``list`` / ``tuple`` in order,
    ``None`` an empty subtree. Leaves are tensors, numpy arrays, numpy
    scalars and Python numbers, and whatever ``is_leaf`` accepts; any other
    container raises TypeError."""
    leaves: list = []
    treedef = _walk(tree, leaves, is_leaf)
    return leaves, treedef


def _walk(x, leaves: list, is_leaf) -> TreeDef:
    """``tree_flatten``'s recursion, a module function: a closure that calls
    itself is a reference cycle, and it would keep every leaf alive until
    the garbage collector runs."""
    if x is None:
        return TreeDef("none")
    if _is_leaf(x) or (is_leaf is not None and is_leaf(x)):
        leaves.append(x)
        return TreeDef("leaf")
    if type(x) is collections.OrderedDict:
        keys = tuple(x)
        return TreeDef("odict", keys, tuple(_walk(x[k], leaves, is_leaf) for k in keys))
    if type(x) is dict:
        keys = tuple(sorted(x))
        return TreeDef("dict", keys, tuple(_walk(x[k], leaves, is_leaf) for k in keys))
    if type(x) in (list, tuple):
        return TreeDef("list" if type(x) is list else "tuple", (),
                       tuple(_walk(c, leaves, is_leaf) for c in x))
    raise TypeError(f"cannot flatten a {type(x).__name__}: checkpoint trees are "
                    f"dict / OrderedDict / list / tuple / None over tensors, "
                    f"numpy arrays and numbers")


def tree_unflatten(treedef: TreeDef, leaves):
    return treedef.unflatten(leaves)


def _dtype_name(dt) -> tuple[str, int]:
    """(numpy-style name, itemsize) of a torch or numpy dtype: the names a
    checkpoint header records (``float32``, ``bfloat16``, ``bool``, ...)."""
    if isinstance(dt, torch.dtype):
        return str(dt).removeprefix("torch."), dt.itemsize
    dt = np.dtype(dt)
    return str(dt), dt.itemsize


def leaf_metas(leaves) -> list[dict]:
    """Header metadata ({dtype, shape, offset, nbytes}) for flattened leaves
    (torch tensors, numpy arrays or scalars), laid out back to back.

    The JAX package's layout, dtype names included, so a checkpoint header
    written from a torch state describes its bytes as the JAX package's
    does. dtype and shape come from the leaf's own attributes where it has
    them, so a device tensor needs no transfer.
    """
    metas = []
    off = 0
    for idx, leaf in enumerate(leaves):
        if hasattr(leaf, "dtype") and hasattr(leaf, "shape"):
            dt, shape = leaf.dtype, tuple(leaf.shape)
        else:
            arr = np.asarray(leaf)
            dt, shape = arr.dtype, arr.shape
        if not isinstance(dt, torch.dtype) and np.dtype(dt).hasobject:
            raise TypeError(
                f"cannot serialize leaf {idx} of dtype object "
                f"(type {type(leaf).__name__}): checkpoint leaves must be "
                f"numeric/bool arrays with a fixed byte layout")
        name, itemsize = _dtype_name(dt)
        nbytes = int(np.prod(shape, dtype=np.int64)) * itemsize
        metas.append({"dtype": name, "shape": list(shape),
                      "offset": off, "nbytes": int(nbytes)})
        off += nbytes
    return metas


def tree_header(treedef, metas: list[dict]) -> bytes:
    """Blob prefix: magic + header length + header JSON. The body (raw leaf
    bytes at the metas' offsets) follows immediately after."""
    header = json.dumps({"treedef": str(treedef), "leaves": metas}).encode()
    return MAGIC + len(header).to_bytes(8, "little") + header


def leaf_bytes(leaf) -> bytes:
    """A leaf's raw little-endian bytes, as the blob holds them. A tensor is
    read through its uint8 view (a bfloat16 never passes through numpy)."""
    if isinstance(leaf, torch.Tensor):
        x = leaf.detach().contiguous().reshape(-1)
        if x.device.type == "meta":
            raise ValueError("a tensor on the meta device has no bytes to save")
        return x.view(torch.uint8).cpu().numpy().tobytes()
    return np.ascontiguousarray(np.asarray(leaf)).tobytes()


def tree_to_bytes(tree) -> bytes:
    leaves, treedef = tree_flatten(tree)
    metas = leaf_metas(leaves)
    return tree_header(treedef, metas) + b"".join(leaf_bytes(x) for x in leaves)


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype a header's numpy-style dtype name records."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"corrupt checkpoint blob: unknown dtype {name!r}")
    return dt


def bytes_leaf(raw, meta: dict, like):
    """One leaf from its blob bytes ``raw`` (a uint8 buffer of
    ``meta["nbytes"]``), in the kind of its template ``like``: a CPU tensor
    for a tensor template (read as uint8 and viewed as its dtype, bfloat16
    included), else a numpy array."""
    if isinstance(like, torch.Tensor):
        u8 = (torch.frombuffer(bytearray(raw), dtype=torch.uint8) if len(raw)
              else torch.empty(0, dtype=torch.uint8))
        return u8.view(torch_dtype(meta["dtype"])).reshape(meta["shape"])
    return np.frombuffer(raw, dtype=np.uint8).view(np.dtype(meta["dtype"])) \
        .reshape(meta["shape"])


def bytes_to_leaves(blob: bytes, like_tree):
    """Rebuild the tree; its structure comes from ``like_tree``, each leaf
    in its template's kind (``bytes_leaf``)."""
    # real exceptions, not asserts: corruption checks must survive python -O
    if blob[:4] != MAGIC:
        raise ValueError(
            f"corrupt checkpoint blob: bad magic {blob[:4]!r} (want {MAGIC!r})")
    hlen = int.from_bytes(blob[4:12], "little")
    if 12 + hlen > len(blob):
        raise ValueError(
            f"corrupt checkpoint blob: header length {hlen} exceeds blob")
    try:
        header = json.loads(blob[12:12 + hlen])
    except json.JSONDecodeError as e:
        raise ValueError(f"corrupt checkpoint blob: bad header ({e})") from None
    body = memoryview(blob)[12 + hlen:]
    leaves_like, treedef = tree_flatten(like_tree)
    metas = header["leaves"]
    if len(metas) != len(leaves_like):
        raise ValueError(
            f"checkpoint has {len(metas)} leaves, expected {len(leaves_like)}")
    out = []
    for idx, (meta, like) in enumerate(zip(metas, leaves_like)):
        a = meta["offset"]
        raw = body[a:a + meta["nbytes"]]
        if len(raw) != meta["nbytes"]:
            raise ValueError(f"corrupt checkpoint blob: leaf {idx} ends past the blob")
        out.append(bytes_leaf(raw, meta, like))
    return treedef.unflatten(out)


def block_bytes_for(blob_len: int, k: int, lane_bytes: int = 8) -> int:
    """Per-block byte length of a k-way split: ceil(blob_len / k) rounded up
    to whole lanes. The device-direct packer sizes its padding with this so
    its blocks match ``split_blocks`` exactly."""
    per = -(-blob_len // k)
    return -(-per // lane_bytes) * lane_bytes


def split_blocks(blob: bytes, k: int, lane_bytes: int = 8) -> np.ndarray:
    """(k, B) uint8 blocks, zero-padded so B is a lane multiple."""
    per = block_bytes_for(len(blob), k, lane_bytes)
    buf = np.zeros(k * per, dtype=np.uint8)
    buf[:len(blob)] = np.frombuffer(blob, dtype=np.uint8)
    return buf.reshape(k, per)


def join_blocks(blocks: np.ndarray, orig_len: int) -> bytes:
    return blocks.reshape(-1)[:orig_len].tobytes()


# ---------------------------------------------------------------------------
# node store
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class NodeStore:
    """n storage nodes backed by directories; nodes can fail (be wiped)."""

    root: str
    n_nodes: int

    def __post_init__(self):
        for i in range(self.n_nodes):
            os.makedirs(self.node_dir(i), exist_ok=True)

    def node_dir(self, i: int) -> str:
        return os.path.join(self.root, f"node_{i:02d}")

    def path(self, i: int, rel: str) -> str:
        return os.path.join(self.node_dir(i), rel)

    def put(self, i: int, rel: str, data: bytes) -> None:
        p = self.path(i, rel)
        os.makedirs(os.path.dirname(p), exist_ok=True)
        tmp = p + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, p)  # atomic publish

    def get(self, i: int, rel: str) -> bytes:
        with open(self.path(i, rel), "rb") as f:
            return f.read()

    def get_range(self, i: int, rel: str, offset: int, nbytes: int) -> bytes:
        """Read only [offset, offset+nbytes) of an object — the degraded-read
        primitive: a slice read costs the slice, not the block."""
        with open(self.path(i, rel), "rb") as f:
            f.seek(offset)
            return f.read(nbytes)

    def size(self, i: int, rel: str) -> int:
        return os.path.getsize(self.path(i, rel))

    def has(self, i: int, rel: str) -> bool:
        return os.path.exists(self.path(i, rel))

    def put_stream(self, i: int, rel: str) -> "StreamWriter":
        """Open a frame-at-a-time write; ``close()`` publishes atomically."""
        return StreamWriter(self.path(i, rel))

    def get_stream(self, i: int, rel: str, frame_bytes: int):
        """Iterate an object's bytes in ``frame_bytes`` frames (streaming
        ``get``): the dual of ``put_stream``, never holding the object."""
        if frame_bytes < 1:
            raise ValueError(f"get_stream: frame_bytes must be >= 1, "
                             f"got {frame_bytes}")
        with open(self.path(i, rel), "rb") as f:
            while True:
                frame = f.read(frame_bytes)
                if not frame:
                    return
                yield frame

    def delete(self, i: int, rel: str) -> None:
        p = self.path(i, rel)
        if os.path.exists(p):
            os.remove(p)

    def fail_node(self, i: int) -> None:
        """Simulate a node loss: wipe its disk."""
        shutil.rmtree(self.node_dir(i), ignore_errors=True)
        os.makedirs(self.node_dir(i), exist_ok=True)

    def alive(self, i: int, rel: str) -> bool:
        return self.has(i, rel)


class StreamWriter:
    """Frame-at-a-time object write with atomic publish (streaming ``put``).

    The streaming archival path emits one coded frame per super-chunk;
    frames append to ``<path>.tmp`` and ``close()`` publishes via
    ``os.replace`` — readers never observe a half-written object, exactly
    the ``NodeStore.put`` invariant. The writer hashes every frame
    incrementally, so ``digest()`` equals ``object_store.digest`` of the
    whole concatenation without the caller ever holding it; ``abort()``
    discards the partial write (nothing was published). Usable as a
    context manager (publishes on clean exit, aborts on exception).
    """

    def __init__(self, path: str):
        self._final = path
        self._tmp = path + ".tmp"
        os.makedirs(os.path.dirname(path), exist_ok=True)
        self._f = open(self._tmp, "wb")
        self._sha = hashlib.sha256()
        self.nbytes = 0

    def write(self, frame: bytes) -> None:
        self._f.write(frame)
        self._sha.update(frame)
        self.nbytes += len(frame)

    def digest(self) -> str:
        """Digest of everything written so far (== ``digest(all frames)``)."""
        return self._sha.hexdigest()[:16]

    def close(self) -> None:
        """Atomic publish: the object appears whole or not at all."""
        if self._f.closed:
            return
        self._f.close()
        os.replace(self._tmp, self._final)

    def abort(self) -> None:
        """Drop the partial write; the target path is untouched."""
        if not self._f.closed:
            self._f.close()
        if os.path.exists(self._tmp):
            os.remove(self._tmp)

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            self.close()
        else:
            self.abort()
        return False


class _NullStreamWriter(StreamWriter):
    """Streaming write addressed to a down node: every frame is lost.

    Mirrors ``ChurnNodeStore.put`` dropping the payload — the interface
    (including the incremental digest, which hashes what WOULD have been
    written) stays identical so streaming callers need no down-node case.
    """

    def __init__(self):
        self._sha = hashlib.sha256()
        self.nbytes = 0

    def write(self, frame: bytes) -> None:
        self._sha.update(frame)
        self.nbytes += len(frame)

    def close(self) -> None:
        pass

    def abort(self) -> None:
        pass


class ChurnNodeStore(NodeStore):
    """A NodeStore whose nodes can be DOWN, not just wiped.

    ``NodeStore.fail_node`` models a disk loss; a live cluster also has the
    window where the node is off the network: writes addressed to it are
    dropped (the data never lands), reads and existence probes fail. Every
    storage-layer caller (archive, repair, scrub) sees a down node exactly
    as a node with nothing on it, which is what the rejoined empty disk
    will look like anyway.
    """

    def __post_init__(self):
        super().__post_init__()
        self.down: set[int] = set()

    def fail(self, i: int) -> None:
        """Node i dies: disk wiped AND off the network until ``rejoin``."""
        self.fail_node(i)
        self.down.add(i)

    def rejoin(self, i: int) -> None:
        """Node i returns with an empty disk (repair refills it)."""
        self.down.discard(i)

    def is_up(self, i: int) -> bool:
        return i not in self.down

    def put(self, i: int, rel: str, data: bytes) -> None:
        if i in self.down:
            return                      # write addressed to a dead node: lost
        super().put(i, rel, data)

    def put_stream(self, i: int, rel: str) -> StreamWriter:
        if i in self.down:
            return _NullStreamWriter()  # every frame is lost, like put
        return super().put_stream(i, rel)

    def get_stream(self, i: int, rel: str, frame_bytes: int):
        if i in self.down:
            raise FileNotFoundError(f"node {i} is down ({rel})")
        return super().get_stream(i, rel, frame_bytes)

    def get(self, i: int, rel: str) -> bytes:
        if i in self.down:
            raise FileNotFoundError(f"node {i} is down ({rel})")
        return super().get(i, rel)

    def get_range(self, i: int, rel: str, offset: int, nbytes: int) -> bytes:
        if i in self.down:
            raise FileNotFoundError(f"node {i} is down ({rel})")
        return super().get_range(i, rel, offset, nbytes)

    def size(self, i: int, rel: str) -> int:
        if i in self.down:
            raise FileNotFoundError(f"node {i} is down ({rel})")
        return super().size(i, rel)

    def has(self, i: int, rel: str) -> bool:
        return i not in self.down and super().has(i, rel)


def digest(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()[:16]


#: bytes from which ``digests`` hashes its blobs in parallel threads
PARALLEL_DIGEST_BYTES = 16 << 20


def digests(blobs: list[bytes]) -> list[str]:
    """``digest`` of each blob, in order. Past ``PARALLEL_DIGEST_BYTES`` in
    all, the blobs are hashed in parallel threads: hashlib releases the
    interpreter lock while it hashes, and a store of 176 MiB objects spends
    its scrub in sha256."""
    if len(blobs) < 2 or sum(len(b) for b in blobs) < PARALLEL_DIGEST_BYTES:
        return [digest(b) for b in blobs]
    with concurrent.futures.ThreadPoolExecutor(min(len(blobs), os.cpu_count() or 1)) as pool:
        return list(pool.map(digest, blobs))
