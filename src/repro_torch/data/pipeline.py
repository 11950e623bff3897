"""Deterministic, shard-aware synthetic token pipeline (counterpart of
``repro.data.pipeline``).

Every batch is a pure function of ``(seed, step)``, drawn through an
explicit ``torch.Generator`` seeded from both, so a restart after
preemption replays exactly and any host can regenerate any shard.  The
distribution is the reference's: a Zipf unigram over the vocabulary with
the three special tokens rare, and BOS resets (document boundaries) with
probability ``1 / mean_doc_len`` a position; ``labels`` are the tokens
shifted by one.  Torch cannot reproduce ``jax.random``'s draws, so the
two pipelines give different tokens from one seed.  Batches are int32 on
the CPU; the caller moves them to its device.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    bos: int = 1
    eos: int = 2
    mean_doc_len: int = 256


class TokenPipeline:
    """``batch(step)`` -> {tokens, labels} [global_batch, seq_len] for the
    global batch; ``host_batch`` gives one host's rows of it."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        ranks = torch.arange(1, cfg.vocab + 1, dtype=torch.float64)
        probs = 1.0 / ranks
        probs[:3] = probs.max() * 0.01          # special tokens are rare
        self._probs = (probs / probs.sum()).float()

    def _generator(self, step: int) -> torch.Generator:
        """A generator seeded from ``(seed, step)``: the CPU generator
        keeps 32 bits of its seed, so the pair is mixed (splitmix64) into
        them rather than packed side by side."""
        z = (self.cfg.seed * 0x9E3779B97F4A7C15 + step) % 2 ** 64
        z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9 % 2 ** 64
        z = (z ^ (z >> 27)) * 0x94D049BB133111EB % 2 ** 64
        return torch.Generator().manual_seed((z ^ (z >> 31)) >> 32)

    def batch(self, step: int) -> dict:
        c = self.cfg
        gen = self._generator(step)
        shape = (c.global_batch, c.seq_len + 1)
        toks = torch.multinomial(self._probs, shape[0] * shape[1],
                                 replacement=True, generator=gen)
        toks = toks.reshape(shape)
        # document boundaries: geometric(1/mean_doc_len) resets to BOS
        resets = torch.rand(shape, generator=gen) < 1.0 / c.mean_doc_len
        toks = torch.where(resets, c.bos, toks).to(torch.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def host_batch(self, step: int, host_id: int, num_hosts: int) -> dict:
        """The rows of the global batch that ``host_id`` of ``num_hosts``
        owns (every host can regenerate any other's)."""
        full = self.batch(step)
        rows = self.cfg.global_batch // num_hosts
        sl = slice(host_id * rows, (host_id + 1) * rows)
        return {k: v[sl] for k, v in full.items()}
