"""On-disk edge-list formats and bounded-memory windowed reading (port of
``repro/graph/io.py``).

Three interchangeable formats, the reference's byte for byte, so one file
feeds both packages:

  ``.txt`` / ``.tsv`` / ``.edges`` / ``.el``
      SNAP-style text: one ``src dst [weight]`` line per edge, ``#``/``%``/
      ``//`` comment and header lines skipped.  Text defaults to
      ``undirected=True``; ``index_base=1`` for 1-indexed ids.
  ``.npz``
      ``numpy.savez`` archive with ``src``/``dst``/``weight`` plus
      ``num_nodes`` and ``undirected`` scalars (not memory-mappable).
  ``.geeb``
      A 32-byte header (magic, version, flags, N, E) followed by contiguous
      ``src int32[E]``, ``dst int32[E]``, ``weight float32[E]`` blocks,
      memory-mapped with numpy.

``open_edge_list`` dispatches on the suffix and returns a
``ChunkedEdgeList`` whose ``windows()`` yield padded ``EdgeList`` windows
of one shape (the ragged tail padded with weight-0 no-op entries).  Windows
of a file stay on the host (CPU tensors over the mapped pages, copied only
where a tail is padded) until a fold stages them onto the device
(``repro_torch.graph.prefetch``).  A ``ChunkedEdgeList`` over an in-memory
``EdgeList`` (``from_edge_list``) keeps the list's tensors: its windows are
slices on the list's own device, never copied to the host and back.
"""

from __future__ import annotations

import dataclasses
import os
import struct
from typing import Iterator, Protocol, Tuple, runtime_checkable

import numpy as np
import torch

from repro_torch.graph.containers import (EdgeList, edge_list_from_numpy,
                                          symmetrize)

# Default streaming window: 1M edges = 12 MB of host memory per window.
DEFAULT_CHUNK_EDGES = 1 << 20

TEXT_SUFFIXES = (".txt", ".tsv", ".edges", ".el")
_COMMENT_PREFIXES = ("#", "%", "//")

# .geeb header: magic, u32 version, u32 flags, i64 num_nodes, i64 num_edges
_GEEB_MAGIC = b"GEEB"
_GEEB_VERSION = 1
_GEEB_HEADER = struct.Struct("<4sIIqq")
_GEEB_HEADER_SIZE = 32
_FLAG_UNDIRECTED = 1
if _GEEB_HEADER.size > _GEEB_HEADER_SIZE:
    raise ImportError("the .geeb header does not fit its 32 bytes")

_HOST = torch.device("cpu")


# ---------------------------------------------------------------------------
# the window-source protocol + windowed container
# ---------------------------------------------------------------------------

@runtime_checkable
class WindowSource(Protocol):
    """Anything the folds can stream fixed-shape edge windows from.

    ``windows()`` yields padded ``EdgeList`` views whose arrays are all
    exactly ``window_edges`` long (or ``pad_to``); weight-0 padding entries
    are exact no-ops.
    """

    num_nodes: int
    undirected: bool

    @property
    def num_edges(self) -> int: ...

    @property
    def window_edges(self) -> int: ...

    @property
    def num_windows(self) -> int: ...

    def windows(self, pad_to: int | None = None) -> Iterator[EdgeList]: ...


def _host(a) -> np.ndarray:
    """A backing array as host numpy (tensors copied to the host)."""
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _window(src, dst, weight, num_nodes: int, pad: int) -> EdgeList:
    """One window of backing-array slices as an ``EdgeList`` padded to
    ``pad``: numpy slices become CPU tensors (over the same memory where no
    padding is needed), tensor slices stay on their device."""
    e = int(src.shape[0])
    if isinstance(src, np.ndarray):
        if (e == pad and (src.dtype, dst.dtype, weight.dtype)
                == (np.int32, np.int32, np.float32)
                and src.flags.c_contiguous and dst.flags.c_contiguous
                and weight.flags.c_contiguous):
            # full-width typed window: no tail to write, so no copy
            return EdgeList(src=torch.from_numpy(src),
                            dst=torch.from_numpy(dst),
                            weight=torch.from_numpy(weight),
                            num_nodes=num_nodes, num_edges=e)
        return edge_list_from_numpy(src, dst, weight, num_nodes, pad_to=pad,
                                    device=_HOST)
    if e < pad:
        tail = pad - e
        src = torch.cat([src, src.new_zeros(tail)])
        dst = torch.cat([dst, dst.new_zeros(tail)])
        weight = torch.cat([weight, weight.new_zeros(tail)])
    return EdgeList(src=src, dst=dst, weight=weight, num_nodes=num_nodes,
                    num_edges=e)


@dataclasses.dataclass(frozen=True)
class ChunkedEdgeList:
    """Edge list read in fixed-size windows.

    ``src``/``dst``/``weight`` are 1-D numpy arrays (``np.memmap`` views
    for ``.geeb`` files, so a window touches only its pages) or tensors of
    an in-memory ``EdgeList`` on its device.

    ``undirected`` means the storage holds one entry per undirected edge;
    the folds then process each window in both directions (self loops
    counted once), as ``symmetrize`` would materialize.
    """

    src: object
    dst: object
    weight: object
    num_nodes: int
    chunk_edges: int = DEFAULT_CHUNK_EDGES
    undirected: bool = False

    def __post_init__(self):
        if self.chunk_edges < 1:
            raise ValueError(f"chunk_edges must be >= 1, got "
                             f"{self.chunk_edges}")

    @property
    def num_edges(self) -> int:
        return int(self.src.shape[0])

    @property
    def device(self) -> torch.device | None:
        """The device the windows already live on; ``None`` for host
        numpy storage, which a fold stages window by window."""
        return self.src.device if isinstance(self.src, torch.Tensor) \
            else None

    @property
    def effective_chunk_edges(self) -> int:
        """``chunk_edges`` clamped to the edge count, so a graph smaller
        than one window is not padded up to it."""
        return max(1, min(self.chunk_edges, self.num_edges))

    @property
    def num_chunks(self) -> int:
        """Stored windows: an upper bound on what ``chunks()`` yields
        (all-padding windows are skipped)."""
        return max(1, -(-self.num_edges // self.effective_chunk_edges))

    # WindowSource protocol aliases ---------------------------------------
    @property
    def window_edges(self) -> int:
        return self.effective_chunk_edges

    @property
    def num_windows(self) -> int:
        return self.num_chunks

    def windows(self, pad_to: int | None = None) -> Iterator[EdgeList]:
        return self.chunks(pad_to=pad_to)

    def rechunked(self, chunk_edges: int) -> "ChunkedEdgeList":
        """O(1) view with another window width; nothing is copied or
        re-read."""
        return dataclasses.replace(self, chunk_edges=int(chunk_edges))

    def chunks(self, pad_to: int | None = None) -> Iterator[EdgeList]:
        """Yield padded ``EdgeList`` windows of one shape.

        Every window is ``effective_chunk_edges`` long (or ``pad_to``, if
        larger); ``num_edges`` is each window's valid count.  Windows whose
        valid entries all weigh 0 are skipped; an edgeless graph still
        yields its one all-padding window.
        """
        c = self.effective_chunk_edges
        pad = max(c, pad_to or 0)
        if self.num_edges == 0:
            yield edge_list_from_numpy(
                np.empty(0, np.int32), np.empty(0, np.int32),
                np.empty(0, np.float32), self.num_nodes, pad_to=pad,
                device=self.device or _HOST)
            return
        for lo in range(0, self.num_edges, c):
            hi = min(lo + c, self.num_edges)
            w = self.weight[lo:hi]
            if not bool(w.any()):
                continue               # all-padding window: exact no-op
            yield _window(self.src[lo:hi], self.dst[lo:hi], w,
                          self.num_nodes, pad)

    def _raw_slices(self) -> Iterator[Tuple[np.ndarray, np.ndarray,
                                            np.ndarray]]:
        """Every stored window's host ``(src, dst, weight)``, all-padding
        ones included: the save paths round-trip stored zero weights."""
        c = self.effective_chunk_edges
        for lo in range(0, max(self.num_edges, 1), c):
            hi = min(lo + c, self.num_edges)
            yield (_host(self.src[lo:hi]), _host(self.dst[lo:hi]),
                   _host(self.weight[lo:hi]))

    def to_edge_list(self, pad_to: int | None = None,
                     device=None) -> EdgeList:
        """Materialize in memory (symmetrized if stored undirected), on
        ``device``: ``None`` keeps tensor storage where it is and puts host
        storage on the card.  Defeats the purpose at out-of-core scale."""
        if self.device is not None:
            edges = _window(self.src, self.dst, self.weight, self.num_nodes,
                            max(self.num_edges, pad_to or 0))
            edges = edges.to(self.device if device is None else device)
        else:
            edges = edge_list_from_numpy(
                np.asarray(self.src), np.asarray(self.dst),
                np.asarray(self.weight), self.num_nodes, pad_to=pad_to,
                device=device)
        return symmetrize(edges) if self.undirected else edges

    @staticmethod
    def from_edge_list(edges: EdgeList,
                       chunk_edges: int = DEFAULT_CHUNK_EDGES,
                       ) -> "ChunkedEdgeList":
        """Window an in-memory (already-directed) ``EdgeList``'s valid
        prefix, on its own device.

        Zero-weight entries inside the valid prefix are dropped (they are
        exact no-ops), so no stored window is ever all-padding.
        """
        e = edges.num_edges
        src, dst, w = edges.src[:e], edges.dst[:e], edges.weight[:e]
        keep = w != 0
        if not bool(keep.all()):
            src, dst, w = src[keep], dst[keep], w[keep]
        return ChunkedEdgeList(
            src=src, dst=dst, weight=w, num_nodes=edges.num_nodes,
            chunk_edges=min(max(1, int(src.shape[0])), chunk_edges),
            undirected=False)


# ---------------------------------------------------------------------------
# .geeb raw binary (the mmap format)
# ---------------------------------------------------------------------------

def write_binary_header(f, num_nodes: int, num_edges: int,
                        undirected: bool) -> None:
    flags = _FLAG_UNDIRECTED if undirected else 0
    hdr = _GEEB_HEADER.pack(_GEEB_MAGIC, _GEEB_VERSION, flags,
                            int(num_nodes), int(num_edges))
    f.write(hdr.ljust(_GEEB_HEADER_SIZE, b"\0"))


def read_binary_header(path: str) -> Tuple[int, int, bool]:
    """``(num_nodes, num_edges, undirected)`` of a ``.geeb`` file."""
    with open(path, "rb") as f:
        raw = f.read(_GEEB_HEADER_SIZE)
    if len(raw) < _GEEB_HEADER_SIZE:
        raise ValueError(f"{path}: truncated .geeb header")
    magic, version, flags, n, e = _GEEB_HEADER.unpack(
        raw[: _GEEB_HEADER.size])
    if magic != _GEEB_MAGIC:
        raise ValueError(f"{path}: not a .geeb file (magic {magic!r})")
    if version != _GEEB_VERSION:
        raise ValueError(f"{path}: unsupported .geeb version {version}")
    return int(n), int(e), bool(flags & _FLAG_UNDIRECTED)


def _geeb_offsets(num_edges: int) -> Tuple[int, int, int]:
    src_off = _GEEB_HEADER_SIZE
    dst_off = src_off + 4 * num_edges
    w_off = dst_off + 4 * num_edges
    return src_off, dst_off, w_off


class BinaryEdgeWriter:
    """Streaming ``.geeb`` writer: appends into a preallocated
    memory-mapped file, so large fixtures never sit whole in memory.  The
    block layout needs ``num_edges`` up front.  Use as a context manager:
    ``close`` checks the fill."""

    def __init__(self, path: str, num_nodes: int, num_edges: int,
                 undirected: bool = False):
        self.path = path
        self.num_nodes = int(num_nodes)
        self.num_edges = int(num_edges)
        self._filled = 0
        so, do, wo = _geeb_offsets(self.num_edges)
        with open(path, "wb") as f:
            write_binary_header(f, num_nodes, num_edges, undirected)
            f.truncate(wo + 4 * self.num_edges)
        shape = (self.num_edges,)
        if self.num_edges == 0:            # mmap cannot map an empty range
            self._src = np.empty(shape, np.int32)
            self._dst = np.empty(shape, np.int32)
            self._w = np.empty(shape, np.float32)
        else:
            self._src = np.memmap(path, np.int32, "r+", so, shape)
            self._dst = np.memmap(path, np.int32, "r+", do, shape)
            self._w = np.memmap(path, np.float32, "r+", wo, shape)

    def append(self, src, dst, weight=None) -> None:
        src = np.asarray(src, np.int32)
        dst = np.asarray(dst, np.int32)
        weight = (np.ones(src.shape, np.float32) if weight is None
                  else np.asarray(weight, np.float32))
        lo, hi = self._filled, self._filled + src.shape[0]
        if hi > self.num_edges:
            raise ValueError(f"{self.path}: writing {hi} edges into a file "
                             f"sized for {self.num_edges}")
        self._src[lo:hi] = src
        self._dst[lo:hi] = dst
        self._w[lo:hi] = weight
        self._filled = hi

    def close(self) -> None:
        if self._filled != self.num_edges:
            raise ValueError(f"{self.path}: wrote {self._filled} of "
                             f"{self.num_edges} declared edges")
        for m in (self._src, self._dst, self._w):
            if isinstance(m, np.memmap):
                m.flush()
        self._src = self._dst = self._w = None

    def __enter__(self) -> "BinaryEdgeWriter":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is None:
            self.close()


def write_binary(path: str, src, dst, weight, num_nodes: int,
                 undirected: bool = False) -> str:
    """One-shot in-memory arrays -> ``.geeb``."""
    src = np.asarray(src, np.int32)
    with BinaryEdgeWriter(path, num_nodes, src.shape[0], undirected) as w:
        w.append(src, dst, weight)
    return path


def open_binary(path: str, chunk_edges: int = DEFAULT_CHUNK_EDGES,
                undirected: bool | None = None) -> ChunkedEdgeList:
    """Memory-map a ``.geeb`` file; O(1) host memory until windows are
    read.  The maps are copy-on-write: nothing ever writes the file, and
    tensors can wrap the pages without a read-only warning."""
    n, e, und = read_binary_header(path)
    so, do, wo = _geeb_offsets(e)
    shape = (e,)
    if e == 0:                             # mmap cannot map an empty range
        src = np.empty(shape, np.int32)
        dst = np.empty(shape, np.int32)
        w = np.empty(shape, np.float32)
    else:
        src = np.memmap(path, np.int32, "c", so, shape)
        dst = np.memmap(path, np.int32, "c", do, shape)
        w = np.memmap(path, np.float32, "c", wo, shape)
    return ChunkedEdgeList(
        src=src, dst=dst, weight=w, num_nodes=n, chunk_edges=chunk_edges,
        undirected=und if undirected is None else undirected)


# ---------------------------------------------------------------------------
# .npz (numpy archive; convenience, not mmap-able)
# ---------------------------------------------------------------------------

def write_npz(path: str, src, dst, weight, num_nodes: int,
              undirected: bool = False) -> str:
    src = np.asarray(src, np.int32)
    dst = np.asarray(dst, np.int32)
    weight = (np.ones(src.shape, np.float32) if weight is None
              else np.asarray(weight, np.float32))
    np.savez(path, src=src, dst=dst, weight=weight,
             num_nodes=np.int64(num_nodes), undirected=np.bool_(undirected))
    return path


def open_npz(path: str, chunk_edges: int = DEFAULT_CHUNK_EDGES,
             undirected: bool | None = None) -> ChunkedEdgeList:
    with np.load(path) as z:
        src = np.asarray(z["src"], np.int32)
        dst = np.asarray(z["dst"], np.int32)
        weight = (np.asarray(z["weight"], np.float32) if "weight" in z
                  else np.ones(src.shape, np.float32))
        n = int(z["num_nodes"]) if "num_nodes" in z else (
            int(max(src.max(initial=-1), dst.max(initial=-1))) + 1)
        und = bool(z["undirected"]) if "undirected" in z else False
    return ChunkedEdgeList(src=src, dst=dst, weight=weight, num_nodes=n,
                           chunk_edges=chunk_edges,
                           undirected=und if undirected is None
                           else undirected)


# ---------------------------------------------------------------------------
# SNAP-style text
# ---------------------------------------------------------------------------

def iter_text_chunks(path: str, chunk_edges: int = DEFAULT_CHUNK_EDGES,
                     index_base: int = 0):
    """Stream ``(src, dst, weight)`` numpy triples of <= chunk_edges rows,
    skipping blank and comment lines; 2 columns (unweighted) or 3+; ids
    less ``index_base``."""
    srcs: list = []
    dsts: list = []
    ws: list = []

    def flush():
        s = np.asarray(srcs, np.int64) - index_base
        d = np.asarray(dsts, np.int64) - index_base
        if s.size and (s.min() < 0 or d.min() < 0):
            raise ValueError(f"{path}: negative node id after subtracting "
                             f"index_base={index_base}")
        return (s.astype(np.int32), d.astype(np.int32),
                np.asarray(ws, np.float32))

    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith(_COMMENT_PREFIXES):
                continue
            parts = line.replace(",", " ").split()
            srcs.append(int(parts[0]))
            dsts.append(int(parts[1]))
            ws.append(float(parts[2]) if len(parts) > 2 else 1.0)
            if len(srcs) == chunk_edges:
                yield flush()
                srcs, dsts, ws = [], [], []
    if srcs:
        yield flush()


def scan_text(path: str, index_base: int = 0) -> Tuple[int, int]:
    """Streaming pass over a text edge file: ``(num_edges, max_node_id)``."""
    e, mx = 0, -1
    for s, d, _ in iter_text_chunks(path, index_base=index_base):
        e += s.shape[0]
        if s.size:
            mx = max(mx, int(s.max()), int(d.max()))
    return e, mx


def text_to_binary(path: str, out: str,
                   chunk_edges: int = DEFAULT_CHUNK_EDGES,
                   index_base: int = 0, num_nodes: int | None = None,
                   undirected: bool = True) -> str:
    """SNAP text -> ``.geeb`` in two streaming passes (count, fill)."""
    e, mx = scan_text(path, index_base=index_base)
    n = max(mx + 1, 0 if num_nodes is None else int(num_nodes))
    with BinaryEdgeWriter(out, n, e, undirected) as w:
        for s, d, wt in iter_text_chunks(path, chunk_edges, index_base):
            w.append(s, d, wt)
    return out


def write_text(path: str, chunked: ChunkedEdgeList) -> str:
    """Stream a ``ChunkedEdgeList`` out as SNAP-style text."""
    with open(path, "w") as f:
        f.write(f"# nodes {chunked.num_nodes} edges {chunked.num_edges} "
                f"undirected {int(chunked.undirected)}\n")
        for s, d, w in chunked._raw_slices():
            f.writelines(f"{si} {di} {wi:.9g}\n"   # .9g round-trips float32
                         for si, di, wi in zip(s, d, w))
    return path


def _text_header_hint(path: str) -> dict:
    """The ``# nodes N edges E undirected U`` hint ``write_text`` emits
    ({} for foreign files)."""
    with open(path) as f:
        first = f.readline().split()
    if first[:2] == ["#", "nodes"] and len(first) >= 7:
        try:
            return {"num_nodes": int(first[2]),
                    "undirected": bool(int(first[6]))}
        except ValueError:
            return {}
    return {}


def open_text(path: str, chunk_edges: int = DEFAULT_CHUNK_EDGES,
              index_base: int = 0, num_nodes: int | None = None,
              undirected: bool | None = None,
              cache_binary: bool = True) -> ChunkedEdgeList:
    """Open SNAP text for windowed reading: converted once to a
    ``<path>.geeb`` sidecar (refreshed when the text is newer) and
    memory-mapped; ``cache_binary=False`` parses into host memory
    instead."""
    hint = _text_header_hint(path)
    und = hint.get("undirected", True) if undirected is None else undirected
    if cache_binary:
        # the sidecar holds only what the file itself says; the caller's
        # num_nodes / undirected apply at open time
        sidecar = path + (f".ib{index_base}.geeb" if index_base else ".geeb")
        if (not os.path.exists(sidecar)
                or os.path.getmtime(sidecar) < os.path.getmtime(path)):
            text_to_binary(path, sidecar, chunk_edges=chunk_edges,
                           index_base=index_base,
                           num_nodes=hint.get("num_nodes"),
                           undirected=hint.get("undirected", True))
        out = open_binary(sidecar, chunk_edges, undirected=und)
        if num_nodes is not None and num_nodes > out.num_nodes:
            out = dataclasses.replace(out, num_nodes=int(num_nodes))
        return out
    parts = list(iter_text_chunks(path, chunk_edges, index_base))
    src = (np.concatenate([p[0] for p in parts]) if parts
           else np.empty(0, np.int32))
    dst = (np.concatenate([p[1] for p in parts]) if parts
           else np.empty(0, np.int32))
    w = (np.concatenate([p[2] for p in parts]) if parts
         else np.empty(0, np.float32))
    n = max(int(src.max(initial=-1)), int(dst.max(initial=-1))) + 1
    n = max(n, hint.get("num_nodes") or 0,
            0 if num_nodes is None else int(num_nodes))
    return ChunkedEdgeList(src=src, dst=dst, weight=w, num_nodes=n,
                           chunk_edges=chunk_edges, undirected=und)


# ---------------------------------------------------------------------------
# front door + converters + labels sidecar
# ---------------------------------------------------------------------------

def open_edge_list(path: str, chunk_edges: int = DEFAULT_CHUNK_EDGES,
                   index_base: int = 0, num_nodes: int | None = None,
                   undirected: bool | None = None,
                   cache_binary: bool = True) -> ChunkedEdgeList:
    """Open any supported edge file as a ``ChunkedEdgeList`` (by suffix;
    ``undirected=None`` defers to the stored flag, text defaults True)."""
    suffix = os.path.splitext(path)[1].lower()
    if suffix == ".geeb":
        out = open_binary(path, chunk_edges, undirected=undirected)
    elif suffix == ".npz":
        out = open_npz(path, chunk_edges, undirected=undirected)
    elif suffix in TEXT_SUFFIXES:
        out = open_text(path, chunk_edges, index_base=index_base,
                        num_nodes=num_nodes, undirected=undirected,
                        cache_binary=cache_binary)
    else:
        raise ValueError(f"unsupported edge-file suffix {suffix!r} ({path}); "
                         f"expected .geeb, .npz, or one of {TEXT_SUFFIXES}")
    if num_nodes is not None and num_nodes > out.num_nodes:
        out = dataclasses.replace(out, num_nodes=int(num_nodes))
    return out


def open_window_parallel(path: str, num_shards: int,
                         chunk_edges: int = DEFAULT_CHUNK_EDGES,
                         **open_kw) -> ChunkedEdgeList:
    """The window-parallel reader of the multi-device fold:
    ``open_edge_list`` with the window width rounded up to a multiple of
    ``num_shards``, so every window splits into ``num_shards`` equal,
    disjoint, contiguous sub-windows (O(1) offsets into the mapped file).
    An O(1) view: nothing is read until windows are iterated."""
    out = open_edge_list(path, chunk_edges=chunk_edges, **open_kw)
    per = -(-out.effective_chunk_edges // num_shards)
    return out.rechunked(per * num_shards)


def as_window_source(obj, chunk_edges: int = DEFAULT_CHUNK_EDGES
                     ) -> WindowSource:
    """Coerce to a ``WindowSource``: a ``ChunkedEdgeList`` passes through,
    an ``EdgeList`` is windowed on its device, anything with ``windows()``
    is trusted."""
    if isinstance(obj, ChunkedEdgeList):
        return obj
    if isinstance(obj, EdgeList):
        return ChunkedEdgeList.from_edge_list(obj, chunk_edges)
    if hasattr(obj, "windows"):
        return obj
    raise TypeError(f"cannot stream edge windows from "
                    f"{type(obj).__name__!r}; expected an EdgeList, a "
                    f"ChunkedEdgeList, or a WindowSource")


def save_edge_list(path: str, chunked: ChunkedEdgeList) -> str:
    """Write a ``ChunkedEdgeList`` to any supported format (by suffix)."""
    suffix = os.path.splitext(path)[1].lower()
    if suffix == ".geeb":
        with BinaryEdgeWriter(path, chunked.num_nodes, chunked.num_edges,
                              chunked.undirected) as w:
            for s, d, wt in chunked._raw_slices():
                w.append(s, d, wt)
        return path
    if suffix == ".npz":
        return write_npz(path, _host(chunked.src), _host(chunked.dst),
                         _host(chunked.weight), chunked.num_nodes,
                         chunked.undirected)
    if suffix in TEXT_SUFFIXES:
        return write_text(path, chunked)
    raise ValueError(f"unsupported edge-file suffix {suffix!r} ({path})")


def convert(src_path: str, dst_path: str,
            chunk_edges: int = DEFAULT_CHUNK_EDGES,
            index_base: int = 0) -> str:
    """Convert between any two supported formats; streams when the source
    is text or ``.geeb`` (``.npz`` sources load into memory)."""
    src_suffix = os.path.splitext(src_path)[1].lower()
    if (src_suffix in TEXT_SUFFIXES
            and os.path.splitext(dst_path)[1].lower() == ".geeb"):
        hint = _text_header_hint(src_path)
        return text_to_binary(src_path, dst_path, chunk_edges=chunk_edges,
                              index_base=index_base,
                              num_nodes=hint.get("num_nodes"),
                              undirected=hint.get("undirected", True))
    return save_edge_list(dst_path, open_edge_list(
        src_path, chunk_edges=chunk_edges, index_base=index_base))


def labels_path(path: str) -> str:
    """Canonical labels-sidecar filename for an edge file."""
    return path + ".labels.npy"


def save_labels(path: str, labels) -> str:
    """Write the int32 labels sidecar next to edge file ``path``."""
    out = labels_path(path)
    np.save(out, np.asarray(labels, np.int32))
    return out


def load_labels(path: str) -> np.ndarray | None:
    """Read the labels sidecar for edge file ``path``, or None if absent."""
    p = labels_path(path)
    return np.load(p).astype(np.int32) if os.path.exists(p) else None


__all__ = ["DEFAULT_CHUNK_EDGES", "TEXT_SUFFIXES", "WindowSource",
           "ChunkedEdgeList", "write_binary_header", "read_binary_header",
           "BinaryEdgeWriter", "write_binary", "open_binary", "write_npz",
           "open_npz", "iter_text_chunks", "scan_text", "text_to_binary",
           "write_text", "open_text", "open_edge_list",
           "open_window_parallel", "as_window_source", "save_edge_list",
           "convert", "labels_path", "save_labels", "load_labels"]
