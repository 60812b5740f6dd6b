"""Directory-backed distributed object store and the block codec.

Storage nodes are directories (``root/node_07/...``) so the full paper
lifecycle — replicated hot tier, pipelined archival, node loss, repair —
runs and is testable in one process; on a real cluster each node_* maps to
one host's local disk. Blocks are the unit of placement and coding: an
object's bytes are split into k equal blocks (padded to whole lanes), the
"object o = (o_1, ..., o_k)" of the paper.

The on-disk layout, the block split and the digests are the JAX package's
(``repro.storage.object_store``), so either package reads what the other
wrote. Its checkpoint tree serializers are not here: they write a JAX
pytree's ``str(treedef)`` into the blob, and a torch state's blob is a
design of its own (the checkpoint slice).
"""
from __future__ import annotations

import dataclasses
import hashlib
import os
import shutil

import numpy as np
import torch


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


def block_bytes_for(blob_len: int, k: int, lane_bytes: int = 8) -> int:
    """Per-block byte length of a k-way split: ceil(blob_len / k) rounded up
    to whole lanes."""
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
