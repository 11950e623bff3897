"""2D-mesh topology and dimension-ordered (XY) routing.

Routes are pure functions of ``(src, dst)``, so :func:`xy_route` /
:func:`links_of` are memoized — the simulator replays the same few hundred
(src, dst) pairs millions of times across a sweep, and deriving the path
per packet dominated ``enqueue`` without the memo (DESIGN.md S10).  The
uncached derivations stay exposed (``xy_route_uncached``) as the ground
truth the regression tests compare against; ``ROUTE_STATS`` counts actual
derivations so tests can assert repeated enqueues never re-derive.

The memo tables are *bounded* (FIFO eviction at :data:`ROUTE_CACHE_MAX`
entries, counted in ``ROUTE_STATS["evicted"]``) and clearable
(:func:`clear_route_caches`): multi-chip hierarchy sweeps enqueue
thousands of distinct (src, dst) pairs per chip shape, and an unbounded
``lru_cache`` would grow without limit across a long sweep.  Flat
8x8-mesh pairs (the hot set) stay resident — the hierarchy regression in
``tests/test_hierarchy.py`` pins that a multi-chip sweep re-derives zero
warm flat-mesh routes.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

#: ``derived`` increments once per *derived* (not cache-served) route;
#: ``evicted`` once per FIFO eviction from a full cache.
ROUTE_STATS = {"derived": 0, "evicted": 0}

#: Per-table entry bound.  32k (src, dst) pairs cover a 180-node mesh's
#: full pair set; bigger sweeps recycle cold entries FIFO.
ROUTE_CACHE_MAX = 1 << 15

_ROUTE_CACHE: dict = {}
_LINK_CACHE: dict = {}


def clear_route_caches() -> None:
    """Drop every memoized route/link tuple (stats are cumulative)."""
    _ROUTE_CACHE.clear()
    _LINK_CACHE.clear()


def route_cache_sizes() -> dict[str, int]:
    return {"routes": len(_ROUTE_CACHE), "links": len(_LINK_CACHE)}


def _trim(cache: dict) -> None:
    while len(cache) > ROUTE_CACHE_MAX:
        del cache[next(iter(cache))]          # FIFO: dicts keep insert order
        ROUTE_STATS["evicted"] += 1


def memo_route(key, derive) -> tuple:
    """Memoize an arbitrary derived route in the bounded route cache.

    The reference's fault layer (``repro.core.noc.faults``, not copied into
    the port) keys detour routes as ``(src, dst, fault_key)``, disjoint
    from the plain ``(src, dst)`` XY keys.
    """
    hit = _ROUTE_CACHE.get(key)
    if hit is None:
        hit = _ROUTE_CACHE[key] = tuple(derive())
        _trim(_ROUTE_CACHE)
    return hit


@dataclass(frozen=True)
class Mesh:
    """A W x H 2D mesh.  Nodes are (x, y) with x = column, y = row.

    ``n`` is the width in columns; ``rows`` is the height (None = square,
    the paper's N x N).  Rectangular shapes are part of the mapper's search
    space (DESIGN.md S9).
    """

    n: int
    rows: Optional[int] = None

    @property
    def width(self) -> int:
        return self.n

    @property
    def height(self) -> int:
        return self.rows if self.rows is not None else self.n

    def node_id(self, x: int, y: int) -> int:
        return y * self.width + x

    def coords(self, nid: int) -> tuple[int, int]:
        return nid % self.width, nid // self.width

    @property
    def num_nodes(self) -> int:
        return self.width * self.height


def xy_route_uncached(src: tuple[int, int],
                      dst: tuple[int, int]) -> list[tuple[int, int]]:
    """Dimension-ordered XY route: list of nodes visited, inclusive of
    endpoints.  Unmemoized ground truth (regression tests compare the
    cached path against this)."""
    ROUTE_STATS["derived"] += 1
    x, y = src
    dx, dy = dst
    path = [(x, y)]
    step = 1 if dx > x else -1
    while x != dx:
        x += step
        path.append((x, y))
    step = 1 if dy > y else -1
    while y != dy:
        y += step
        path.append((x, y))
    return path


def xy_route_tuple(src: tuple[int, int],
                   dst: tuple[int, int]) -> tuple[tuple[int, int], ...]:
    """Memoized XY route as an immutable tuple (safe to share)."""
    key = (src, dst)
    hit = _ROUTE_CACHE.get(key)
    if hit is None:
        hit = _ROUTE_CACHE[key] = tuple(xy_route_uncached(src, dst))
        _trim(_ROUTE_CACHE)
    return hit


def xy_route(src: tuple[int, int], dst: tuple[int, int]) -> list[tuple[int, int]]:
    """Dimension-ordered XY route (memoized; returns a fresh list)."""
    return list(xy_route_tuple(src, dst))


def route_links(src: tuple[int, int], dst: tuple[int, int],
                ) -> tuple[tuple[tuple[int, int], tuple[int, int]], ...]:
    """Memoized directed links of the XY route (the ``enqueue`` hot path)."""
    key = (src, dst)
    hit = _LINK_CACHE.get(key)
    if hit is None:
        path = xy_route_tuple(src, dst)
        hit = _LINK_CACHE[key] = tuple(zip(path[:-1], path[1:]))
        _trim(_LINK_CACHE)
    return hit


def yx_route(src: tuple[int, int], dst: tuple[int, int]) -> list[tuple[int, int]]:
    """Dimension-ordered YX route (vertical dimension resolved first)."""
    return [(x, y) for y, x in xy_route(src[::-1], dst[::-1])]


def route(src: tuple[int, int], dst: tuple[int, int],
          order: str = "xy") -> list[tuple[int, int]]:
    """Dimension-ordered route under the given dimension order."""
    if order == "xy":
        return xy_route(src, dst)
    if order == "yx":
        return yx_route(src, dst)
    raise ValueError(f"unknown route order: {order!r}")


def links_of(path: list[tuple[int, int]]) -> list[tuple[tuple[int, int], tuple[int, int]]]:
    """Directed links traversed along a node path."""
    return list(zip(path[:-1], path[1:]))
