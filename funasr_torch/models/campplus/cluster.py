"""Speaker clustering and diarization utilities (port of
funasr_tpu/models/campplus/cluster.py; reference
funasr/models/campplus/cluster_backend.py ``ClusterBackend``, utils.py
``sv_chunk`` / ``distribute_spk``).  Host code, numpy only.

Spectral clustering on a refined cosine affinity, the speaker count from
the eigen-gap of the normalized Laplacian (or given), k-means on the
row-normalized leading eigenvectors, then small clusters merged into their
nearest and, without a given count, centroids merged while their cosine
reaches ``merge_thr``.  Under 20 chunks everything is one speaker.

The JAX package runs ``sklearn.cluster.KMeans(n_clusters=k, n_init=10,
random_state=0)``; the port has no scikit-learn and runs :func:`kmeans`
here: greedy k-means++ seeding from an explicit ``np.random.Generator``,
Lloyd iterations, 10 restarts, the lowest inertia kept.  Both relabel the
clusters in order of appearance, so the same partition gives the same
labels.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np


def cosine_affinity(emb: np.ndarray) -> np.ndarray:
    x = emb / np.maximum(np.linalg.norm(emb, axis=1, keepdims=True), 1e-8)
    return x @ x.T


def _refine(aff: np.ndarray, p: float = 0.2) -> np.ndarray:
    """Row-wise thresholding (keep each row's top ceil(n p)) and
    symmetrization."""
    n = aff.shape[0]
    keep = max(1, int(np.ceil(n * p)))
    out = aff.copy()
    for i in range(n):
        thresh = np.sort(out[i])[-keep]
        out[i, out[i] < thresh] = 0.0
    return np.maximum(out, out.T)


def _sq_dist(x: np.ndarray, c: np.ndarray) -> np.ndarray:
    """(n, d), (k, d) -> (n, k) squared Euclidean distances, >= 0."""
    d = (x * x).sum(1)[:, None] - 2.0 * x @ c.T + (c * c).sum(1)[None]
    return np.maximum(d, 0.0)


def _kmeans_pp(x: np.ndarray, k: int, rng: np.random.Generator) -> np.ndarray:
    """Greedy k-means++ seeding: each new center the best of 2 + ln k
    candidates drawn in proportion to the squared distance to the chosen
    ones (the seeding scikit-learn's KMeans uses)."""
    n = len(x)
    trials = 2 + int(np.log(k))
    centers = [x[rng.integers(n)]]
    d2 = _sq_dist(x, centers[0][None])[:, 0]
    for _ in range(1, k):
        total = d2.sum()
        if total <= 0.0:  # every point on a center: any point will do
            cand = rng.integers(n, size=trials)
        else:
            cand = np.searchsorted(np.cumsum(d2), rng.random(trials) * total)
            cand = np.minimum(cand, n - 1)
        cd = np.minimum(d2[None], _sq_dist(x, x[cand]).T)  # (trials, n)
        best = int(np.argmin(cd.sum(1)))
        centers.append(x[cand[best]])
        d2 = cd[best]
    return np.stack(centers)


def kmeans(x: np.ndarray, k: int, n_init: int = 10, max_iter: int = 300,
           tol: float = 1e-4, seed: int = 0) -> np.ndarray:
    """k-means labels (n,) int32 of ``x`` (n, d): ``n_init`` runs from
    k-means++ seeds of ``np.random.default_rng(seed)``, Lloyd iterations
    until the centers move less than ``tol`` times the mean per-feature
    variance (squared), the run of lowest inertia kept (the first on a
    tie).  An emptied cluster takes the point farthest from its center."""
    x = np.asarray(x, np.float64)
    rng = np.random.default_rng(seed)
    tol_sq = tol * float(np.mean(np.var(x, axis=0)))
    best_labels, best_inertia = None, np.inf
    for _ in range(n_init):
        centers = _kmeans_pp(x, k, rng)
        for _ in range(max_iter):
            d = _sq_dist(x, centers)
            labels = np.argmin(d, axis=1)
            new = centers.copy()
            for j in range(k):
                members = labels == j
                if members.any():
                    new[j] = x[members].mean(axis=0)
                else:
                    far = int(np.argmax(d[np.arange(len(x)), labels]))
                    new[j] = x[far]
            shift = float(((new - centers) ** 2).sum())
            centers = new
            if shift <= tol_sq:
                break
        d = _sq_dist(x, centers)
        labels = np.argmin(d, axis=1)
        inertia = float(d[np.arange(len(x)), labels].sum())
        if inertia < best_inertia:
            best_labels, best_inertia = labels, inertia
    return best_labels.astype(np.int32)


def _in_order_of_appearance(labels: np.ndarray) -> np.ndarray:
    remap = {}
    out = np.zeros_like(labels)
    for i, lab in enumerate(labels):
        if lab not in remap:
            remap[lab] = len(remap)
        out[i] = remap[lab]
    return out


class ClusterBackend:
    def __init__(self, merge_thr: float = 0.78, max_spk_num: int = 15,
                 min_cluster_points: int = 4):
        self.merge_thr = merge_thr
        self.max_spk_num = max_spk_num
        self.min_cluster_points = min_cluster_points

    def __call__(self, embeddings: np.ndarray,
                 oracle_num: Optional[int] = None) -> np.ndarray:
        """(n, d) embeddings -> (n,) int32 speaker labels, numbered in
        order of appearance; ``oracle_num`` fixes the speaker count."""
        n = len(embeddings)
        if n < 20:  # too few chunks to cluster (cluster_backend.py:154)
            return np.zeros((n,), np.int32)
        aff = _refine(cosine_affinity(embeddings))
        d = np.maximum(aff.sum(axis=1), 1e-8)
        d_inv = 1.0 / np.sqrt(d)
        lap = np.eye(n) - d_inv[:, None] * aff * d_inv[None, :]
        vals, vecs = np.linalg.eigh(lap)
        if oracle_num is not None:
            k = oracle_num
        else:
            kmax = min(self.max_spk_num, n - 1)
            k = max(1, int(np.argmax(np.diff(vals[: kmax + 1]))) + 1)
        if k == 1:
            labels = np.zeros((n,), np.int32)
        else:
            spec = vecs[:, :k]
            spec = spec / np.maximum(np.linalg.norm(spec, axis=1, keepdims=True), 1e-8)
            labels = kmeans(spec, k)
        labels = self._merge_small(embeddings, labels)
        if oracle_num is None:
            labels = self.merge_by_cos(embeddings, labels, self.merge_thr)
        return labels

    def merge_by_cos(self, emb, labels, cos_thr):
        """Merge the most similar pair of centroids while its cosine reaches
        ``cos_thr`` (cluster_backend.py:167)."""
        labels = labels.copy()
        while True:
            uniq = sorted(set(labels.tolist()))
            if len(uniq) == 1:
                break
            cents = np.stack([emb[labels == u].mean(axis=0) for u in uniq])
            cents = cents / np.maximum(np.linalg.norm(cents, axis=1, keepdims=True), 1e-8)
            aff = np.triu(cents @ cents.T, 1)
            i, j = np.unravel_index(int(np.argmax(aff)), aff.shape)
            if aff[i, j] < cos_thr:
                break
            labels[labels == uniq[j]] = uniq[i]
        return _in_order_of_appearance(labels)

    def _merge_small(self, emb, labels):
        """Fold each cluster of fewer than ``min_cluster_points`` into the
        one whose centroid is most similar, one at a time."""
        labels = labels.copy()
        changed = True
        while changed and len(set(labels.tolist())) > 1:
            changed = False
            uniq = sorted(set(labels.tolist()))
            cents = {u: emb[labels == u].mean(axis=0) for u in uniq}
            for u in uniq:
                if np.sum(labels == u) < self.min_cluster_points:
                    others = [v for v in uniq if v != u]
                    sims = [float(np.dot(cents[u], cents[v])
                                  / (np.linalg.norm(cents[u]) * np.linalg.norm(cents[v])
                                     + 1e-8)) for v in others]
                    labels[labels == u] = others[int(np.argmax(sims))]
                    changed = True
                    break
        return _in_order_of_appearance(labels)


def sv_chunk(segment: Sequence, chunk_s: float = 1.5, step_s: float = 0.75,
             fs: int = 16000) -> List[List]:
    """A [start_s, end_s, wav] VAD segment -> [start_s, end_s, chunk] sliding
    chunks for the embeddings (utils.py:66): the last chunk is right-aligned
    (its start pulled back to end - chunk_s), a segment shorter than a chunk
    is zero-padded to one."""
    start, _, wav = segment
    n = len(wav)
    chunk_len = int(chunk_s * fs)
    shift = int(step_s * fs)
    out = []
    last_ed = 0
    for st in range(0, n, shift):
        ed = min(st + chunk_len, n)
        if ed <= last_ed:
            break
        last_ed = ed
        st = max(0, ed - chunk_len)
        data = wav[st:ed]
        if len(data) < chunk_len:
            data = np.pad(data, (0, chunk_len - len(data)))
        out.append([start + st / fs, start + ed / fs, data])
    return out


def distribute_spk(sentence_list: List[dict], sd_segments: List[List]) -> List[dict]:
    """Give each sentence the speaker of the diarization segment it overlaps
    most (utils.py ``distribute_spk``); 0 where none overlaps."""
    for sent in sentence_list:
        best, best_overlap = 0, 0.0
        for start_ms, end_ms, spk in sd_segments:
            ov = min(sent["end"], end_ms) - max(sent["start"], start_ms)
            if ov > best_overlap:
                best_overlap = ov
                best = spk
        sent["spk"] = int(best)
    return sentence_list
