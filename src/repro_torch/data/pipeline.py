"""Synthetic data on numpy generators: a seedable Markov-bigram token source
for serving prompts and training batches (``DataLoader``), and the
calibration activations that neuron-importance profiling runs on (the JAX
package draws the same distributions with ``jax.random``, so the values
differ between the packages)."""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Tuple

import numpy as np
import torch

from ..device import resolve_device


@dataclasses.dataclass
class SyntheticLM:
    """Markov bigram source: P(t | prev) ∝ zipf(t) * affinity(prev, t)."""
    vocab_size: int
    seed: int = 0
    n_clusters: int = 16
    zipf_a: float = 1.2

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        ranks = np.arange(1, self.vocab_size + 1)
        self.unigram = ranks ** (-self.zipf_a)
        self.unigram /= self.unigram.sum()
        self.cluster = rng.integers(0, self.n_clusters, self.vocab_size)

    def sample_batch(self, rng: np.random.Generator, batch: int,
                     seq: int) -> Dict[str, np.ndarray]:
        """Cluster-boosted resampling of iid zipf tokens (int32 arrays)."""
        base = rng.choice(self.vocab_size, size=(batch, seq + 1),
                          p=self.unigram)
        # with prob 0.5, resample each token from its predecessor's cluster
        resampled = np.empty((batch, seq), np.int64)
        for c in range(self.n_clusters):
            members = np.flatnonzero(self.cluster == c)
            p = self.unigram[members] / self.unigram[members].sum()
            sel = self.cluster[base[:, :-1]] == c
            resampled[sel] = rng.choice(members, size=int(sel.sum()), p=p)
        use = rng.random((batch, seq)) < 0.5
        nxt = np.where(use, resampled, base[:, 1:])
        tokens = np.concatenate([base[:, :1], nxt], axis=1)
        return {"tokens": tokens[:, :-1].astype(np.int32),
                "targets": tokens[:, 1:].astype(np.int32)}


@dataclasses.dataclass
class DataLoader:
    """Deterministic epoch-less loader; step -> batch of int32 numpy
    arrays, drawn from ``np.random.default_rng((seed, step))``. With
    ``audio`` = (n_frames, d_model) each batch also carries the audio
    stub's float32 ``audio_embeds`` ``0.1 * N(0, 1)`` of (batch, n_frames,
    d_model), drawn after the tokens."""
    source: SyntheticLM
    batch: int
    seq: int
    seed: int = 0
    audio: Tuple[int, ...] = ()

    def get_batch(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, step))
        out = self.source.sample_batch(rng, self.batch, self.seq)
        if self.audio:
            out["audio_embeds"] = (rng.standard_normal(
                (self.batch,) + tuple(self.audio)) * 0.1).astype(np.float32)
        return out

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.get_batch(step)
            step += 1


def make_loader(cfg, batch: int, seq: int, seed: int = 0) -> DataLoader:
    """The training loader of ``cfg``: token batches, with the audio stub's
    frame embeddings for an audio-frontend model (the encoder's input)."""
    audio = (cfg.n_frontend_tokens, cfg.d_model) \
        if cfg.frontend == "audio" else ()
    return DataLoader(SyntheticLM(cfg.vocab_size, seed=seed), batch, seq,
                      seed=seed, audio=audio)


def calibration_activations(rng: np.random.Generator, n_tokens: int,
                            d_model: int, scale: float = 0.7,
                            device="cuda") -> torch.Tensor:
    """(n_tokens, d_model) float32 activations entering a MoE layer, with a
    power-law feature spectrum plus a few dominant directions, on
    ``device`` (default the card)."""
    scales = np.arange(1, d_model + 1) ** -0.3
    x = rng.standard_normal((n_tokens, d_model)) * scales[None, :]
    dirs = rng.standard_normal((4, d_model)) / np.sqrt(d_model)
    coef = rng.standard_normal((n_tokens, 4))
    out = (x + coef @ dirs * 3.0) * scale
    return torch.from_numpy(out.astype(np.float32)).to(
        resolve_device(device))
