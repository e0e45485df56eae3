"""Hierarchical clustering, random-center init, and binning init (a copy
of ``poccala_tpu/ops/hierarchical.py``; the distances come from
:mod:`poccala_tpu_torch.ops.distance`).

Replaces the remaining ``ClusterInitialization`` algorithms:

* :func:`layercluster` — agglomerative (centroid-average linkage)
  clustering with a merge tree, ``Clustering.py:1088-1124``;
* :func:`theta` — cut the merge tree at ``k`` clusters and return
  (means, variances, alpha), ``Clustering.py:1128-1159``;
* :func:`randomcenter` — random centers + nearest assignment,
  ``Clustering.py:1057-1082``;
* :func:`binning` — the reference declares this ("装箱算法", after 高斯混合
  模型聚类中EM算法及初始化的研究 2006) but leaves it a stub
  (``Clustering.py:1166-1167``); implemented here as density binning:
  quantile-grid cells ranked by occupancy seed the k centers.

The pairwise-distance work runs as torch matmuls on the CPU; the merge
loop is host NumPy (inherently sequential, O(n) merges).
"""

from __future__ import annotations

import numpy as np

from poccala_tpu_torch.ops.distance import pairwise_euclidean

_VAR_FLOOR = 1e-4


def layercluster(x: np.ndarray, k: int):
    """Agglomerative clustering down to ``k`` clusters.

    Matches the reference's procedure (``Clustering.py:1096-1121``):
    repeatedly merge the two closest centers, the merged center being the
    simple average of the two (``k_index[i][0]/2 + k_index[j][0]/2``),
    and record the merge tree.

    :returns: (tree, clusters) where clusters maps cluster -> member
        indices and tree is a list of merge records
        ``(step, size, center, left, right)``.
    """
    x = np.asarray(x, np.float64)
    n = len(x)
    centers = {i: x[i].copy() for i in range(n)}
    members = {i: [i] for i in range(n)}
    tree = {i: (0, 1, x[i].copy(), None, None) for i in range(n)}
    step = 0
    while len(centers) > k:
        step += 1
        ids = sorted(centers)
        c = np.stack([centers[i] for i in ids])
        d = np.array(pairwise_euclidean(c, c))  # writable copy
        np.fill_diagonal(d, np.inf)
        a, b = np.unravel_index(np.argmin(d), d.shape)
        ia, ib = ids[a], ids[b]
        new_center = centers[ia] / 2 + centers[ib] / 2
        centers[ia] = new_center
        members[ia] = members[ia] + members[ib]
        tree[ia] = (step, len(members[ia]), new_center, tree[ia], tree[ib])
        del centers[ib], members[ib], tree[ib]
    clusters = {i: members[key] for i, key in enumerate(sorted(centers))}
    final_tree = [tree[key] for key in sorted(centers)]
    return final_tree, clusters


def theta(x: np.ndarray, clusters: dict):
    """Per-cluster (means, variances, alpha) — the reference's parameter
    harvest after ``layercluster`` (``Clustering.py:1128-1159``)."""
    x = np.asarray(x, np.float64)
    means, variances, alpha = [], [], []
    n = len(x)
    for idx in clusters.values():
        pts = x[idx]
        means.append(pts.mean(axis=0))
        variances.append(np.maximum(pts.var(axis=0), _VAR_FLOOR))
        alpha.append(len(idx) / n)
    return np.stack(means), np.stack(variances), np.asarray(alpha)


def randomcenter(rng: np.random.Generator, x: np.ndarray, k: int):
    """Random distinct centers + nearest assignment
    (``Clustering.randomcenter``, ``Clustering.py:1057-1082``).

    :returns: (means, variances, alpha)
    """
    x = np.asarray(x, np.float64)
    idx = rng.choice(len(x), size=k, replace=False)
    centers = x[idx]
    assign = np.argmin(np.asarray(pairwise_euclidean(x, centers)), axis=-1)
    means, variances, alpha = [], [], []
    for c in range(k):
        pts = x[assign == c]
        if len(pts) == 0:
            pts = centers[c][None]
        means.append(pts.mean(axis=0))
        variances.append(np.maximum(pts.var(axis=0), _VAR_FLOOR))
        alpha.append(len(pts) / len(x))
    return np.stack(means), np.stack(variances), np.asarray(alpha)


def binning(x: np.ndarray, k: int, bins_per_dim: int = 8):
    """Density-binning initialization (implements the reference's empty
    ``binning`` stub): quantile-bin each dimension, rank occupied cells
    by count, and take the ``k`` densest cells' member means as centers.

    :returns: (means, variances, alpha)
    """
    x = np.asarray(x, np.float64)
    n, d = x.shape
    # quantile edges per dimension -> cell ids
    cell = np.zeros(n, np.int64)
    for j in range(min(d, 8)):  # cap the dims forming the grid key
        q = np.quantile(x[:, j], np.linspace(0, 1, bins_per_dim + 1)[1:-1])
        cell = cell * bins_per_dim + np.searchsorted(q, x[:, j])
    ids, counts = np.unique(cell, return_counts=True)
    cell_means = np.stack([x[cell == cid].mean(axis=0) for cid in ids])
    # greedy diverse selection: densest cell first, then weight density by
    # squared distance to the already-chosen centers (k-means++-style)
    chosen_idx = [int(np.argmax(counts))]
    while len(chosen_idx) < min(k, len(ids)):
        chosen_centers = cell_means[chosen_idx]
        d2 = np.min(
            np.sum((cell_means[:, None] - chosen_centers[None]) ** 2, -1), -1
        )
        score = counts * d2
        score[chosen_idx] = -1
        chosen_idx.append(int(np.argmax(score)))
    chosen = ids[chosen_idx]
    means, variances, alpha = [], [], []
    for cid in chosen:
        pts = x[cell == cid]
        means.append(pts.mean(axis=0))
        variances.append(np.maximum(pts.var(axis=0), _VAR_FLOOR))
        alpha.append(len(pts))
    # fewer occupied cells than k: pad with perturbed copies
    while len(means) < k:
        means.append(means[len(means) % max(len(chosen), 1)] + 1e-3)
        variances.append(variances[len(variances) % max(len(chosen), 1)])
        alpha.append(1.0)
    alpha = np.asarray(alpha, np.float64)
    return np.stack(means)[:k], np.stack(variances)[:k], alpha[:k] / alpha[:k].sum()
