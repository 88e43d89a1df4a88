"""Synthetic dataset generators (offline stand-ins for the paper's datasets).

Own numpy copy of the reference's ``repro.data.synthetic``: the same seed
gives byte-identical arrays.

MNIST/FMNIST/CIFAR/CINIC/CRITEO are replaced by Gaussian-mixture
classification problems with controllable difficulty and an image-like or
tabular layout, where (a) features are informative and (b) the vertical
split leaves each party with partial information.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Tuple

import numpy as np


@dataclass
class SyntheticClassification:
    x_train: np.ndarray
    y_train: np.ndarray
    x_test: np.ndarray
    y_test: np.ndarray
    n_classes: int
    image_hw: Tuple[int, int] = (0, 0)

    @property
    def n_features(self) -> int:
        return self.x_train.shape[-1]


def make_dataset(name: str, *, n_train: int = 4096, n_test: int = 1024,
                 seed: int = 0, n_parties_design: int = 4
                 ) -> SyntheticClassification:
    """name: mnist_like | fmnist_like | cifar_like | cinic_like |
    cifar100_like | criteo_like.

    Vertical-federated by construction: the feature vector is laid out in
    ``n_parties_design`` column groups; group p only distinguishes the class
    modulo m_p (CRT-style aliasing), so any single party's slice caps far
    below joint accuracy — the regime the paper's Tables II/IV measure.
    For the binary (criteo_like) task the label is the sign of a sum of
    per-party latents, giving each party a weak-but-real local signal.
    """
    rng = np.random.default_rng(seed)
    spec = {
        "mnist_like": dict(n_classes=10, hw=(28, 28), sep=2.0, noise=1.0),
        "fmnist_like": dict(n_classes=10, hw=(28, 28), sep=1.5, noise=1.2),
        "cifar_like": dict(n_classes=10, hw=(32, 32), sep=1.0, noise=1.5),
        "cifar100_like": dict(n_classes=20, hw=(32, 32), sep=0.9, noise=1.5),
        "cinic_like": dict(n_classes=10, hw=(32, 32), sep=0.9, noise=1.8),
        "criteo_like": dict(n_classes=2, hw=(0, 0), n_feat=40, sep=1.0,
                            noise=1.2),
    }[name]
    n_cls = spec["n_classes"]
    hw = spec["hw"]
    F = spec.get("n_feat", hw[0] * hw[1])
    P = n_parties_design
    # contiguous column groups, matching vertical_partition's slicing
    if hw[0]:
        cols = np.array_split(np.arange(hw[1]), P)
        groups = [np.concatenate([np.arange(hw[0]) * hw[1] + c
                                  for c in cg]) for cg in cols]
    else:
        groups = [g for g in np.array_split(np.arange(F), P)]
    moduli = [4, 3, 5, 7, 4, 3, 5, 7][:P]
    basis = rng.normal(0, 1.0, (8, F))

    if n_cls == 2:
        dirs = [rng.normal(0, 1.0, len(g)) for g in groups]
        dirs = [d / np.linalg.norm(d) for d in dirs]

        def sample(n):
            u = rng.normal(0, 1.0, (n, P))
            y = (u.sum(-1) > 0).astype(np.int32)
            x = rng.normal(0, spec["noise"], (n, F))
            for p, g in enumerate(groups):
                x[:, g] += spec["sep"] * u[:, p:p + 1] * dirs[p][None]
            x += rng.normal(0, 1.0, (n, 8)) @ basis * 0.3
            return x.astype(np.float32), y
    else:
        mus = [rng.normal(0, spec["sep"], (moduli[p], len(g)))
               for p, g in enumerate(groups)]

        def sample(n):
            y = rng.integers(0, n_cls, n).astype(np.int32)
            x = rng.normal(0, spec["noise"], (n, F))
            for p, g in enumerate(groups):
                x[:, g] += mus[p][y % moduli[p]]
            x += rng.normal(0, 1.0, (n, 8)) @ basis * 0.3
            return x.astype(np.float32), y

    x_tr, y_tr = sample(n_train)
    x_te, y_te = sample(n_test)
    mu, sd = x_tr.mean(0), x_tr.std(0) + 1e-6
    x_tr = (x_tr - mu) / sd
    x_te = (x_te - mu) / sd
    return SyntheticClassification(x_tr, y_tr, x_te, y_te, n_cls, hw)


def lm_batch_iterator(vocab: int, batch: int, seq: int, *, seed: int = 0
                      ) -> Iterator[dict]:
    """Synthetic LM batches: Zipf-distributed tokens with local structure."""
    rng = np.random.default_rng(seed)
    probs = 1.0 / np.arange(1, vocab + 1) ** 1.1
    probs /= probs.sum()
    while True:
        toks = rng.choice(vocab, size=(batch, seq + 1), p=probs)
        yield {"tokens": toks[:, :-1].astype(np.int32),
               "labels": toks[:, 1:].astype(np.int32)}
