"""Skewed placement at the distribution layer (counterpart of
``repro.core.sharding_skew``, numpy only).

The paper's shift rule -- consecutive segments start one channel-step apart
so concurrent accesses spread over all controllers -- has an analogue one
level up: when the same logical resource index maps to the same device in
every layer, a persistently hot index serializes on one device.  The
canonical case is MoE expert parallelism: with ``expert e -> device e % D``
every layer's hot expert lands on device 0.

``skewed_expert_map`` rotates the expert -> device assignment by one device
per layer (the paper's one-channel-step shift), so layer l's expert e sits
on device (e + l) % D.  The rotation is a static permutation of the stacked
expert axis (``models.moe.make_perms``): zero operations at run time, a
pure relabelling of storage that never changes a result.
"""
from __future__ import annotations

import numpy as np


def skewed_expert_map(n_experts: int, n_devices: int, layer: int) -> np.ndarray:
    """expert -> device map for one layer, rotated by ``layer`` steps."""
    if n_experts <= 0 or n_devices <= 0:
        raise ValueError("n_experts and n_devices must be positive")
    return (np.arange(n_experts) + layer) % n_devices


def expert_permutation(n_experts: int, n_devices: int, layer: int) -> np.ndarray:
    """The permutation of expert indices that makes contiguous blocks of
    the permuted (stacked, E/D a device) expert axis hold exactly the
    experts the skewed map sends to each device: storage slot s holds
    expert ``perm[s]``.  A stable sort by device keeps the expert order
    within a device."""
    dev = skewed_expert_map(n_experts, n_devices, layer)
    return np.argsort(dev, kind="stable")


def inverse_permutation(perm: np.ndarray) -> np.ndarray:
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.size)
    return inv


def placement_imbalance(load_per_expert: np.ndarray, expert_to_device: np.ndarray,
                        n_devices: int) -> float:
    """Max-over-mean device load -- the controller-histogram metric of
    ``core.aliasing`` applied to expert placement.  1.0 = perfectly
    balanced."""
    loads = np.zeros(n_devices, dtype=np.float64)
    np.add.at(loads, expert_to_device, load_per_expert)
    mean = loads.mean()
    return float(loads.max() / mean) if mean > 0 else 1.0


def layer_skew_gain(load_per_expert: np.ndarray, n_devices: int,
                    n_layers: int) -> tuple[float, float]:
    """(naive, skewed) cross-layer worst-device load, max over mean, for a
    fixed per-expert load profile repeated over ``n_layers`` layers: the
    naive placement adds the same hot device every layer, the skewed one
    rotates it."""
    e = load_per_expert.size
    naive = np.zeros(n_devices)
    skew = np.zeros(n_devices)
    for layer in range(n_layers):
        np.add.at(naive, skewed_expert_map(e, n_devices, 0), load_per_expert)
        np.add.at(skew, skewed_expert_map(e, n_devices, layer),
                  load_per_expert)
    return (float(naive.max() / naive.mean()),
            float(skew.max() / skew.mean()))
