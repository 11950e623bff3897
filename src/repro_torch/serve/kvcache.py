"""Paged KV cache (counterpart of ``repro.serve.kvcache``).

The serving engine keeps two views of decode state:

* a **monolithic working cache** (``model.init_cache(slots, max_seq)``)
  that the decode and prefill steps read and write;
* this **paged pool**, the authoritative per-request store.  The leaves the
  model API names as paged (:func:`repro_torch.models.api.
  paged_cache_leaves`: those with a sequence axis, the dense and moe
  families' K/V, MLA's latents and rope keys) are chopped into fixed-size
  position blocks owned by a free-list :class:`BlockAllocator`.  Every
  other leaf (the ssm family's recurrent state and token-shift rows) is
  stored whole per request, its latest value.

A leaf is named by its path in the cache tree (``"moe/latent"`` for MLA's
nested ``cache["moe"]["latent"]``, :func:`repro_torch.models.api.
cache_leaves`), and a ``row`` is a flat dict by those paths.

Each leaf keeps its own dtype (the ssm state is float32 in a bf16 model).
The pool is torch tensors on the model's device.  :meth:`PagedKVCache.
write_range` copies only the positions asked for of a paged leaf, and the
whole row of an unpaged one, device to device; the reference copies the
whole slot row to the host at every decode step.  A request's row
round-trips bit-identically: :meth:`PagedKVCache.gather_row` reassembles
exactly the row the monolithic cache held (zeros past the request's length,
which decode attention masks out).

Admission reserves a request's worst-case length (prompt + max_new) up
front, as in the reference.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch import _device


def _raise_findings(findings) -> None:
    """Raise ``AssertionError`` naming every ``kvcache`` finding: its
    message, led by the table or request it names."""
    if findings:
        raise AssertionError("; ".join(
            f.message if f.where in ("free-list", "length", "state")
            else f"{f.where}: {f.message}" for f in findings))


class BlockAllocator:
    """Free-list allocator over ``num_blocks`` fixed-size blocks.

    Invariants (checked by :meth:`check`): every block is either free or
    owned by exactly one request (no aliasing), and ``free + live ==
    total`` (no leaks).  Allocation order is deterministic (lowest block
    id first).
    """

    def __init__(self, num_blocks: int) -> None:
        if num_blocks <= 0:
            raise ValueError(f"num_blocks must be positive, got {num_blocks}")
        self.num_blocks = num_blocks
        self._free = list(range(num_blocks - 1, -1, -1))   # pop() -> lowest id
        self.tables: dict[object, list[int]] = {}

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def live_blocks(self) -> int:
        return sum(len(t) for t in self.tables.values())

    def can_alloc(self, n: int) -> bool:
        return len(self._free) >= n

    def alloc(self, rid, n: int) -> list[int]:
        """Reserve ``n`` blocks for ``rid`` (must not already own any)."""
        if rid in self.tables:
            raise KeyError(f"request {rid!r} already has a block table")
        if n < 0 or not self.can_alloc(n):
            raise MemoryError(
                f"need {n} blocks, {len(self._free)} free "
                f"(of {self.num_blocks})")
        blocks = [self._free.pop() for _ in range(n)]
        self.tables[rid] = blocks
        return blocks

    def extend(self, rid, n: int) -> list[int]:
        """Append ``n`` more blocks to an existing table."""
        if rid not in self.tables:
            raise KeyError(f"request {rid!r} has no block table to extend")
        if n < 0 or not self.can_alloc(n):
            raise MemoryError(f"need {n} more blocks, {len(self._free)} free")
        new = [self._free.pop() for _ in range(n)]
        self.tables[rid].extend(new)
        return new

    def free(self, rid) -> int:
        """Release every block ``rid`` owns; returns how many."""
        blocks = self.tables.pop(rid)
        self._free.extend(reversed(blocks))
        self._free.sort(reverse=True)    # keep pop() order deterministic
        return len(blocks)

    def check(self) -> None:
        """Raise ``AssertionError`` on any no-alias / no-leak violation
        (explicitly, so the check survives ``python -O``).  The invariants
        are the static verifier's (:func:`repro_torch.analysis.verify.
        verify_allocator`)."""
        from repro_torch.analysis.verify import verify_allocator
        _raise_findings(verify_allocator(self))


@dataclasses.dataclass(frozen=True)
class _LeafMeta:
    """Layout of one cache leaf, batch axis removed (a 'row')."""

    name: str
    batch_axis: int        # axis index in the *batched* leaf; a paged
                           # leaf's max_seq axis sits there once the batch
                           # axis is removed
    paged: bool            # stored by position in blocks, else whole
    row_shape: tuple       # shape with the batch axis removed
    dtype: torch.dtype


class PagedKVCache:
    """Paged store for one engine's decode state.

    ``row`` dicts below always mean a single request's cache with the batch
    axis removed (what ``leaf.select(batch_axis, slot)`` yields); paged
    leaves keep their native axis order, with the sequence axis sitting
    where the batch axis used to be.
    """

    def __init__(self, cfg, max_seq: int, block_size: int, num_blocks: int,
                 *, device="cuda", world: int = 1, rank: int = 0) -> None:
        """The pool of rank ``rank`` of ``world``: the dense, moe, hybrid,
        encdec and vlm families' pages hold that rank's KV heads, the
        mla_moe family's the whole latent, the ssm and hybrid families'
        states that rank's heads (and hybrid's conv tails its channels)."""
        from repro_torch.models.api import (cache_batch_axes, cache_leaves,
                                            get_model, paged_cache_leaves)
        if max_seq % block_size:
            raise ValueError(f"block_size {block_size} must divide "
                             f"max_seq {max_seq}")
        self.cfg = cfg
        self.device = _device.resolve(device)
        self.max_seq = max_seq
        self.block_size = block_size
        self.allocator = BlockAllocator(num_blocks)

        # shapes and dtypes without allocating (``jax.eval_shape`` there)
        proto = cache_leaves(get_model(cfg).init_cache(
            1, max_seq, device="meta", world=world, rank=rank))
        baxes = cache_batch_axes(cfg)
        paged = paged_cache_leaves(cfg)
        self.leaves: list[_LeafMeta] = []
        self._pools: dict[str, torch.Tensor] = {}
        for name, leaf in proto.items():
            a = baxes[name]
            row = tuple(leaf.shape[:a]) + tuple(leaf.shape[a + 1:])
            if name in paged:
                if not (a < len(row) and row[a] == max_seq):
                    raise ValueError(
                        f"paged cache leaf {name!r} {tuple(leaf.shape)} has "
                        f"no max_seq {max_seq} axis after its batch axis {a}")
                self._pools[name] = torch.zeros(
                    (num_blocks, block_size) + row[:a] + row[a + 1:],
                    dtype=leaf.dtype, device=self.device)
            self.leaves.append(_LeafMeta(name, a, name in paged, row,
                                         leaf.dtype))
        # unpaged leaves: each request's whole row, its latest value
        self._state: dict[object, dict[str, torch.Tensor]] = {}
        self._length: dict[object, int] = {}

    # ------------------------------------------------------------------ #
    def blocks_for(self, positions: int) -> int:
        return math.ceil(positions / self.block_size)

    def can_admit(self, positions: int) -> bool:
        return self.allocator.can_alloc(self.blocks_for(positions))

    def admit(self, rid, positions: int) -> None:
        """Reserve blocks for ``positions`` cache slots (prompt + max new
        tokens: worst case up front)."""
        self.allocator.alloc(rid, self.blocks_for(positions))
        self._state[rid] = {}
        self._length[rid] = 0

    def release(self, rid) -> int:
        self._state.pop(rid)
        self._length.pop(rid)
        return self.allocator.free(rid)

    def length(self, rid) -> int:
        return self._length[rid]

    # ------------------------------------------------------------------ #
    def _slots(self, rid, pos0: int, length: int):
        """(block ids, offsets) of positions ``[pos0, pos0+length)``."""
        table = torch.tensor(self.allocator.tables[rid], dtype=torch.long,
                             device=self.device)
        pos = torch.arange(pos0, pos0 + length, device=self.device)
        return table[pos // self.block_size], pos % self.block_size

    def write_range(self, rid, pos0: int, row: dict, length: int) -> None:
        """Store positions ``[pos0, pos0+length)`` of ``row``'s paged leaves
        (which carry >= pos0+length positions; only those positions are
        copied) and the whole of its unpaged leaves."""
        blk, off = self._slots(rid, pos0, length)
        for meta in self.leaves:
            if not meta.paged:
                self._state[rid][meta.name] = row[meta.name].to(
                    self.device, meta.dtype, copy=True)
                continue
            seq_front = row[meta.name].movedim(meta.batch_axis, 0)
            self._pools[meta.name][blk, off] = \
                seq_front[pos0:pos0 + length].to(meta.dtype)
        self._length[rid] = max(self._length[rid], pos0 + length)

    def gather_row(self, rid, length: int | None = None) -> dict:
        """Reassemble ``rid``'s row (native layout): block contents for
        positions < length, zeros beyond (exactly the monolithic slot); an
        unpaged leaf's latest value, zeros before its first write."""
        length = self._length[rid] if length is None else length
        blk, off = self._slots(rid, 0, length)
        out = {}
        for meta in self.leaves:
            if not meta.paged:
                st = self._state[rid].get(meta.name)
                out[meta.name] = st.clone() if st is not None else torch.zeros(
                    meta.row_shape, dtype=meta.dtype, device=self.device)
                continue
            pool = self._pools[meta.name]
            seq_front = torch.zeros((self.max_seq,) + pool.shape[2:],
                                    dtype=meta.dtype, device=self.device)
            seq_front[:length] = pool[blk, off]
            out[meta.name] = seq_front.movedim(0, meta.batch_axis)
        return out

    def assert_matches(self, rid, row: dict, length: int) -> None:
        """Bitwise: pooled content == ``row`` on positions < length of the
        paged leaves, and whole on the others (the paged==monolithic
        invariant)."""
        mine = self.gather_row(rid, length)
        for meta in self.leaves:
            theirs, ours = row[meta.name], mine[meta.name]
            if meta.paged:
                theirs = theirs.narrow(meta.batch_axis, 0, length)
                ours = ours.narrow(meta.batch_axis, 0, length)
            if not torch.equal(theirs.to(ours.device), ours):
                raise AssertionError(
                    f"paged/monolithic mismatch on leaf {meta.name} "
                    f"for request {rid!r}")

    def check(self) -> None:
        """Allocator invariants plus the paged bookkeeping: length and
        state keys match block tables, and every length is covered by
        blocks (:func:`repro_torch.analysis.verify.verify_kvcache`)."""
        from repro_torch.analysis.verify import verify_kvcache
        _raise_findings(verify_kvcache(self))
