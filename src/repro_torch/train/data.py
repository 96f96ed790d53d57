"""Synthetic LM data with background host prefetch, ported from
``repro.train.data``.

Next-token-prediction batches from a deterministic synthetic corpus (a
mixture of Zipfian unigrams and repeated n-gram motifs, so a real model
shows a real learning curve).  :class:`SyntheticCorpus` is a copy of the
reference's and draws the same numpy stream, so the batches are bit-equal
to the reference's for the same config, sizes and seed.  A worker thread
builds numpy batches ahead of the caller; the copy to the device happens on
the caller's thread, from pinned memory and without blocking the host when
the device is a card; with ``sharding`` (a tree of
:class:`~repro_torch.dist.sharding.NamedSharding` in the batch's
structure, as ``batch_shardings`` gives) each batch is then distributed
onto it, every rank keeping its slice of the batch its own loader made.
:meth:`DataLoader.close` stops the worker and joins it.

The worker keeps every batch it makes.  The reference's worker drops a
batch when the queue stays full for a second and makes the next one, so
its stream skips ahead when its consumer is slower than that; the two
streams agree while the reference's consumer keeps up.
"""
from __future__ import annotations

import queue
import threading
from typing import Any, Dict, Iterator, Optional

import numpy as np
import torch


class SyntheticCorpus:
    """Deterministic pseudo-corpus: Zipf unigrams + injected repeating motifs."""

    def __init__(self, vocab: int, seed: int = 0, motif_len: int = 16, n_motifs: int = 64):
        self.vocab = vocab
        self.rng = np.random.default_rng(seed)
        ranks = np.arange(1, vocab + 1, dtype=np.float64)
        probs = 1.0 / ranks ** 1.1
        self.probs = probs / probs.sum()
        self.motifs = self.rng.integers(0, vocab, (n_motifs, motif_len))

    def sample(self, batch: int, seq_len: int) -> np.ndarray:
        toks = self.rng.choice(self.vocab, size=(batch, seq_len + 1), p=self.probs)
        # splice motifs so there is learnable structure
        n_splice = max(1, seq_len // 64)
        for b in range(batch):
            for _ in range(n_splice):
                m = self.motifs[self.rng.integers(0, len(self.motifs))]
                start = self.rng.integers(0, seq_len + 1 - len(m))
                toks[b, start : start + len(m)] = m
        return toks.astype(np.int32)


class DataLoader:
    """Background-thread prefetching loader yielding batches on ``device``."""

    def __init__(self, cfg, batch: int, seq_len: int, seed: int = 0, prefetch: int = 2,
                 device="cpu", sharding: Optional[Any] = None):
        self.cfg = cfg
        self.sharding = sharding
        self.batch = batch
        self.seq_len = seq_len
        self.device = torch.device(device)
        self.corpus = SyntheticCorpus(cfg.vocab, seed)
        self._q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _make(self) -> Dict[str, np.ndarray]:
        """Hidden length S = n_prefix + T; tokens: (B,T); labels/mask: (B,S)."""
        cfg = self.cfg
        t = self.seq_len - cfg.n_prefix
        toks = self.corpus.sample(self.batch, t)              # (B, T+1)
        prefix_zeros = np.zeros((self.batch, cfg.n_prefix), np.int32)
        batch: Dict[str, Any] = {
            "tokens": toks[:, :t],
            "labels": np.concatenate([prefix_zeros, toks[:, 1 : t + 1]], axis=1),
        }
        mask = np.ones((self.batch, self.seq_len), np.float32)
        if cfg.n_prefix:
            mask[:, : cfg.n_prefix] = 0.0
            batch["prefix_embeds"] = np.asarray(
                self.corpus.rng.normal(0, 0.02, (self.batch, cfg.n_prefix, cfg.d_model)),
                np.float32,
            )
        batch["mask"] = mask
        return batch

    def like(self) -> Dict[str, torch.Tensor]:
        """A batch's shapes as meta tensors (no data drawn): what
        ``batch_shardings`` needs to make this loader's ``sharding``."""
        cfg = self.cfg
        shapes = {"tokens": (self.batch, self.seq_len - cfg.n_prefix),
                  "labels": (self.batch, self.seq_len)}
        if cfg.n_prefix:
            shapes["prefix_embeds"] = (self.batch, cfg.n_prefix, cfg.d_model)
        shapes["mask"] = (self.batch, self.seq_len)
        return {k: torch.empty(s, device="meta") for k, s in shapes.items()}

    def _worker(self) -> None:
        while not self._stop.is_set():
            b = self._make()
            while not self._stop.is_set():
                try:
                    self._q.put(b, timeout=0.1)
                    break
                except queue.Full:
                    continue

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        return self

    def __next__(self) -> Dict[str, torch.Tensor]:
        host = self._q.get()
        out = {}
        for k, a in host.items():
            t = torch.from_numpy(np.ascontiguousarray(a))
            if self.device.type == "cuda":
                t = t.pin_memory()
            out[k] = t.to(self.device, non_blocking=True)
        if self.sharding is not None:
            from repro_torch.dist.sharding import distribute

            return distribute(out, self.sharding)
        return out

    def close(self) -> None:
        """Stop the worker and wait for it to end."""
        self._stop.set()
        self._thread.join()
