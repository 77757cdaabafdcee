"""Versioned parameter-layout manifests (counterpart of
``mxnet_tpu/parallel/layout.py``): where every parameter shard lives in
an N-way run.

Checkpoint restore at another world size reads them: a run killed at
world N resumes at world N-k (or N+k) by gathering each parameter from
the old layout and re-slicing it per the new one, the optimizer and
random state carried along (``checkpoint.reshard_checkpoint``,
``CheckpointManager.restore_resharded``).

A manifest is a plain JSON-able dict: schema version, world size, and a
``key -> entry`` map where an entry is either ``replicated`` (every rank
holds the full array) or ``sharded`` (contiguous blocks along one axis,
``parts`` listing each rank's ``[rank, start, stop]`` row range).
``fingerprint()`` hashes the canonical form, so two processes agree on
"same layout" with a 12-hex string. The format, the fingerprints and the
resharded states are the JAX package's, bit for bit: a manifest written
by either package reads in the other.

numpy and the standard library only.
"""
from __future__ import annotations

import hashlib
import json

import numpy as _np

__all__ = ["LayoutManifest", "partition", "gather_state", "shard_state",
           "reshard_states", "infer_manifest", "SCHEMA_VERSION"]

FORMAT = "mxtpu-layout"
SCHEMA_VERSION = 1

# state-dict keys that are opaque per-run blobs, not arrays: they ride
# the reshard replicated (every new rank gets rank 0's copy) because the
# training math they feed is world-size invariant by the DDP contract
# (fixed global batch, replicated params, seed-derived RNG chains)
_BLOB_KEYS = ("__opt__", "__rng__")
# the data cursor is rank/world-fingerprinted (a foreign seek
# raises) — it is DROPPED across a world change; the resumed run starts
# a fresh epoch at the checkpointed step
_DROP_KEYS = ("__data_cursor__",)


def partition(n, world):
    """Contiguous near-even split of ``n`` rows over ``world`` ranks:
    ``[(start, stop), ...]`` with the remainder spread over the leading
    ranks (the same arithmetic everywhere, so two processes computing a
    layout independently always agree). Ranks past ``n`` get empty
    ``(n, n)`` slices — a 3-row table on 5 hosts is legal, just idle."""
    n, world = int(n), int(world)
    if world <= 0:
        raise ValueError("layout: world must be >= 1, got %d" % world)
    base, rem = divmod(n, world)
    bounds = []
    start = 0
    for r in range(world):
        stop = start + base + (1 if r < rem else 0)
        bounds.append((start, stop))
        start = stop
    return bounds


class LayoutManifest:
    """Param -> shard map at one world size, fingerprinted + versioned.

    ``entries`` maps a state-dict key to either
    ``{"kind": "replicated", "shape": [...]}`` or
    ``{"kind": "sharded", "axis": a, "shape": [...global...],
    "parts": [[rank, start, stop], ...]}``.
    """

    def __init__(self, world, entries, mesh=None,
                 schema_version=SCHEMA_VERSION):
        self.world = int(world)
        self.entries = dict(entries)
        self.mesh = dict(mesh or {})
        self.schema_version = int(schema_version)

    # -- construction --------------------------------------------------------
    @classmethod
    def build(cls, shapes, world, sharded_axes=None, mesh=None):
        """Manifest over ``shapes`` (key -> global shape): every key is
        replicated unless ``sharded_axes`` names its shard axis."""
        sharded_axes = dict(sharded_axes or {})
        entries = {}
        for key, shape in shapes.items():
            shape = [int(d) for d in shape]
            axis = sharded_axes.get(key)
            if axis is None:
                entries[key] = {"kind": "replicated", "shape": shape}
            else:
                axis = int(axis)
                if not 0 <= axis < len(shape):
                    raise ValueError(
                        "layout: shard axis %d out of range for %r "
                        "shape %s" % (axis, key, shape))
                parts = [[r, s, e] for r, (s, e)
                         in enumerate(partition(shape[axis], world))]
                entries[key] = {"kind": "sharded", "axis": axis,
                                "shape": shape, "parts": parts}
        return cls(world, entries, mesh=mesh)

    @classmethod
    def replicated(cls, shapes, world, mesh=None):
        """All-replicated manifest (the DDP layout)."""
        return cls.build(shapes, world, sharded_axes=None, mesh=mesh)

    def reshard_to(self, new_world):
        """The same logical layout re-partitioned for ``new_world``:
        replicated entries stay replicated, sharded entries get fresh
        contiguous parts over the new rank count."""
        entries = {}
        for key, e in self.entries.items():
            if e["kind"] == "replicated":
                entries[key] = dict(e)
            else:
                axis = int(e["axis"])
                shape = list(e["shape"])
                parts = [[r, s, t] for r, (s, t)
                         in enumerate(partition(shape[axis], new_world))]
                entries[key] = {"kind": "sharded", "axis": axis,
                                "shape": shape, "parts": parts}
        return LayoutManifest(new_world, entries, mesh=self.mesh,
                              schema_version=self.schema_version)

    # -- identity ------------------------------------------------------------
    def fingerprint(self):
        """Short stable hash of schema+world+entries — what a fleet
        replica registers under and the router compares across a split
        (mirrors ``tune/cache.Cache.fingerprint``)."""
        h = hashlib.sha256()
        h.update(("%s/%d/%d" % (FORMAT, self.schema_version,
                                self.world)).encode())
        h.update(json.dumps(self.mesh, sort_keys=True).encode())
        for k in sorted(self.entries):
            h.update(k.encode())
            h.update(json.dumps(self.entries[k], sort_keys=True).encode())
        return h.hexdigest()[:12]

    # -- (de)serialization ---------------------------------------------------
    def to_dict(self):
        return {
            "format": FORMAT,
            "schema_version": self.schema_version,
            "world": self.world,
            "mesh": dict(self.mesh),
            "entries": {k: dict(v) for k, v in self.entries.items()},
            "fingerprint": self.fingerprint(),
        }

    @classmethod
    def from_dict(cls, d):
        if not isinstance(d, dict) or d.get("format") != FORMAT:
            raise ValueError("layout: not a %s manifest: %r"
                             % (FORMAT, type(d).__name__))
        man = cls(d["world"], d.get("entries") or {},
                  mesh=d.get("mesh"),
                  schema_version=d.get("schema_version", SCHEMA_VERSION))
        man.validate()
        return man

    def validate(self):
        """Structural check: sharded parts must tile [0, shape[axis])
        contiguously in rank order. Returns self."""
        for key, e in self.entries.items():
            kind = e.get("kind")
            if kind == "replicated":
                continue
            if kind != "sharded":
                raise ValueError("layout: entry %r has unknown kind %r"
                                 % (key, kind))
            axis, shape = int(e["axis"]), list(e["shape"])
            parts = e.get("parts") or []
            if len(parts) != self.world:
                raise ValueError(
                    "layout: entry %r has %d parts for world %d"
                    % (key, len(parts), self.world))
            cursor = 0
            for r, (rank, start, stop) in enumerate(parts):
                if rank != r or start != cursor or stop < start:
                    raise ValueError(
                        "layout: entry %r parts are not a contiguous "
                        "rank-ordered tiling (part %d = %s)"
                        % (key, r, parts[r]))
                cursor = stop
            if cursor != shape[axis]:
                raise ValueError(
                    "layout: entry %r parts cover %d of %d rows"
                    % (key, cursor, shape[axis]))
        return self

    # -- per-key geometry ----------------------------------------------------
    def part_for(self, key, rank):
        """(start, stop) of ``rank``'s block of ``key`` (replicated
        entries span the full leading axis)."""
        e = self.entries[key]
        if e["kind"] == "replicated":
            return 0, int(e["shape"][0]) if e["shape"] else 0
        rank = int(rank)
        _, start, stop = e["parts"][rank]
        return int(start), int(stop)

    def shard_array(self, key, rank, full):
        """``rank``'s slice of the global array ``full`` for ``key``."""
        e = self.entries.get(key)
        if e is None or e["kind"] == "replicated":
            return full
        axis = int(e["axis"])
        start, stop = self.part_for(key, rank)
        index = [slice(None)] * _np.ndim(full)
        index[axis] = slice(start, stop)
        return full[tuple(index)]


def infer_manifest(state, world, mesh=None):
    """Fallback manifest for a checkpoint that predates layout metadata
    (or whose layout record was corrupted): every array key is assumed
    REPLICATED — exactly the DDP contract every training path in this
    repo upholds. Blob keys (optimizer/RNG/cursor) are never manifest
    entries; they are handled by name in :func:`reshard_states`."""
    shapes = {k: list(_np.shape(v)) for k, v in state.items()
              if not isinstance(v, (bytes, bytearray))
              and not k.startswith("__")}
    return LayoutManifest.replicated(shapes, world, mesh=mesh)


def gather_state(states_by_rank, manifest):
    """Reassemble the GLOBAL state dict from per-rank state dicts
    (``{rank: state}``) laid out per ``manifest``: replicated keys come
    from the lowest present rank, sharded keys concatenate their parts
    in rank order. Blob keys are taken from the lowest rank. Raises
    ``KeyError`` when a rank a sharded entry needs is missing."""
    if not states_by_rank:
        raise ValueError("layout: no rank states to gather")
    ranks = sorted(states_by_rank)
    first = states_by_rank[ranks[0]]
    out = {}
    for key, value in first.items():
        if key in _DROP_KEYS:
            continue
        e = manifest.entries.get(key)
        if e is None or e["kind"] == "replicated" \
                or isinstance(value, (bytes, bytearray)):
            out[key] = value
            continue
        axis = int(e["axis"])
        blocks = []
        for rank, start, stop in e["parts"]:
            if stop <= start:
                continue
            if rank not in states_by_rank:
                raise KeyError(
                    "layout: gather of %r needs rank %d's shard but no "
                    "state for that rank was given" % (key, rank))
            blocks.append(_np.asarray(states_by_rank[rank][key]))
        out[key] = (blocks[0] if len(blocks) == 1
                    else _np.concatenate(blocks, axis=axis))
    return out


def shard_state(full_state, manifest, rank):
    """One rank's state dict, sliced out of the global ``full_state``
    per ``manifest``. Blob keys pass through whole."""
    out = {}
    for key, value in full_state.items():
        if key in _DROP_KEYS:
            continue
        if isinstance(value, (bytes, bytearray)):
            out[key] = value
        else:
            out[key] = manifest.shard_array(key, rank, _np.asarray(value))
    return out


def reshard_states(states_by_rank, manifest, new_world):
    """Gather per-rank checkpoint states from ``manifest``'s layout and
    re-slice them for ``new_world`` ranks.

    Returns ``(states_by_new_rank, new_manifest)``. Optimizer and RNG
    blobs are carried replicated (rank 0's copy — valid because the
    training math is world-size invariant: fixed global batch,
    replicated dense params, seed-derived RNG chains). The data cursor
    is dropped: data cursors fingerprint (rank, world, seed) and a
    resharded resume starts a fresh pass at the restored step."""
    full = gather_state(states_by_rank, manifest)
    new_manifest = manifest.reshard_to(new_world)
    out = {r: shard_state(full, new_manifest, r)
           for r in range(int(new_world))}
    return out, new_manifest
