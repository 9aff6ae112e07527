"""Octomap `.bt` (binary occupancy octree) reader/writer, pure Python.

Capability parity with the reference's octomap world-file path
(reference: src/map_manager.cpp:59-80 — `octree_ptr->readBinary(world
file)` when the mission's world file is not a CSV). The reference links
the octomap C++ library; here the `.bt` wire format is implemented
directly so binary octomap worlds load without any native dependency.

Format (octomap's OcTree binary serialization):

    # Octomap OcTree binary file
    # (comments)
    id OcTree
    size <node count>
    res <resolution>
    data
    <binary>

Binary payload: nodes in depth-first pre-order; each inner node is two
bytes holding 2 bits per child i (i = 0..3 in byte 1, 4..7 in byte 2,
child i's bits at positions 2i, 2i+1 LSB-first):

    00 — child absent (unknown)     01 — occupied leaf
    10 — free leaf                  11 — inner node (serialized next)

Key space: 16 tree levels; cell centers at ((key − 32768) + ½)·res, so
the root cube is centered at the origin. Child i of a node splits
+x/−x by bit 0, +y/−y by bit 1, +z/−z by bit 2.

A copy of `lsc_dr_planner_tpu/world/octomap.py`,
with its imports pointed at the port (numpy only).
"""

from __future__ import annotations

import io
from typing import List, Optional, Tuple

import numpy as np

_TREE_DEPTH = 16
_KEY_OFFSET = 1 << (_TREE_DEPTH - 1)  # 32768

# child-value codes
_ABSENT, _OCC, _FREE, _INNER = 0, 1, 2, 3


# ======================================================================
# Reading
# ======================================================================


def read_bt(path: str) -> Tuple[np.ndarray, float]:
    """Read a `.bt` file → (boxes [B, 6] as (cx, cy, cz, sx, sy, sz),
    resolution). Each occupied leaf becomes one axis-aligned box (leaves
    above the max depth cover 2^k cells per axis). Free/unknown leaves
    are ignored (the planner treats non-occupied space as free, matching
    the EDT's occupied-only distance queries)."""
    with open(path, "rb") as f:
        data = f.read()
    header_end = data.find(b"data\n")
    if header_end < 0:
        raise ValueError(f"{path}: no 'data' marker — not a .bt file?")
    header = data[: header_end].decode("ascii", errors="replace")
    payload = data[header_end + 5 :]

    tree_id: Optional[str] = None
    size: Optional[int] = None
    res: Optional[float] = None
    for line in header.splitlines():
        line = line.strip()
        if line.startswith("#") or not line:
            continue
        key, _, val = line.partition(" ")
        if key == "id":
            tree_id = val.strip()
        elif key == "size":
            size = int(val)
        elif key == "res":
            res = float(val)
    if tree_id != "OcTree":
        raise ValueError(f"{path}: unsupported octree id {tree_id!r}")
    if res is None:
        raise ValueError(f"{path}: missing resolution")

    boxes: List[Tuple[float, float, float, float]] = []  # (cx, cy, cz, size)
    stream = io.BytesIO(payload)
    _read_node(stream, np.zeros(3), res * (1 << _TREE_DEPTH), 0, res, boxes)

    out = np.zeros((len(boxes), 6))
    for b, (cx, cy, cz, s) in enumerate(boxes):
        out[b] = (cx, cy, cz, s, s, s)
    return out, res


def _read_node(stream, center, node_size, depth, res, boxes) -> None:
    raw = stream.read(2)
    if len(raw) < 2:
        raise ValueError("truncated .bt payload")
    b1, b2 = raw[0], raw[1]
    codes = [(b1 >> (2 * i)) & 3 for i in range(4)] + [
        (b2 >> (2 * i)) & 3 for i in range(4)
    ]
    q = 0.25 * node_size
    for i, code in enumerate(codes):
        if code == _ABSENT or code == _FREE:
            continue
        child_center = center + q * np.array(
            [1 if i & 1 else -1, 1 if i & 2 else -1, 1 if i & 4 else -1],
            dtype=np.float64,
        )
        if code == _OCC:
            boxes.append(
                (child_center[0], child_center[1], child_center[2],
                 0.5 * node_size)
            )
    # recurse into inner children AFTER scanning the bitmap (pre-order:
    # node record first, then children 0..7 depth-first)
    for i, code in enumerate(codes):
        if code == _INNER:
            child_center = center + q * np.array(
                [1 if i & 1 else -1, 1 if i & 2 else -1, 1 if i & 4 else -1],
                dtype=np.float64,
            )
            _read_node(stream, child_center, 0.5 * node_size, depth + 1,
                       res, boxes)


# ======================================================================
# Writing
# ======================================================================


def write_bt(path: str, occ: np.ndarray, origin_idx, resolution: float) -> None:
    """Write an occupancy grid as a `.bt` file. `occ` [X, Y, Z] bool with
    cell (i, j, k) covering world box [(idx)·res, (idx+1)·res) where
    idx = origin_idx + (i, j, k). Occupied cells become depth-16 leaves
    (with full sibling groups pruned to coarser leaves)."""
    idx = np.argwhere(occ).astype(np.int64)
    keys = (idx + np.asarray(origin_idx, np.int64) + _KEY_OFFSET).astype(
        np.uint32
    )
    if np.any(keys >= (1 << _TREE_DEPTH)):
        raise ValueError("occupied cells outside the 16-level key space")

    tree = _build_tree(keys, 0)
    if tree == "occ":  # fully-occupied root: keep one level unpruned
        tree = ["occ"] * 8

    buf = io.BytesIO()
    n_nodes = _write_node(buf, tree) + 1  # + root
    with open(path, "wb") as f:
        f.write(b"# Octomap OcTree binary file\n")
        f.write(
            b"# (feel free to add / change comments, but leave the first"
            b" line as it is!)\n#\n"
        )
        f.write(b"id OcTree\n")
        f.write(f"size {n_nodes}\n".encode())
        f.write(f"res {resolution:.17g}\n".encode())
        f.write(b"data\n")
        f.write(buf.getvalue())


def _build_tree(keys: np.ndarray, depth: int):
    """Recursive tree build over occupied cell keys. Returns 'occ' for a
    fully-occupied subtree (pruned leaf) or an 8-list of children
    (None = absent)."""
    if depth == _TREE_DEPTH:
        return "occ"
    b = _TREE_DEPTH - 1 - depth
    xb = (keys[:, 0] >> b) & 1
    yb = (keys[:, 1] >> b) & 1
    zb = (keys[:, 2] >> b) & 1
    cid = xb | (yb << 1) | (zb << 2)
    children = []
    for i in range(8):
        sub = keys[cid == i]
        children.append(_build_tree(sub, depth + 1) if len(sub) else None)
    if all(c == "occ" for c in children):
        return "occ"
    return children


def _write_node(buf, children) -> int:
    """Serialize one inner node (pre-order). Returns the number of child
    nodes written (for the header's size field)."""
    b1 = b2 = 0
    for i, c in enumerate(children):
        if c is None:
            code = _ABSENT
        elif c == "occ":
            code = _OCC
        else:
            code = _INNER
        if i < 4:
            b1 |= code << (2 * i)
        else:
            b2 |= code << (2 * (i - 4))
    buf.write(bytes([b1, b2]))
    count = sum(1 for c in children if c is not None)
    for c in children:
        if isinstance(c, list):
            count += _write_node(buf, c)
    return count
