"""CLIP-embedding retrieval for the knn2img workflow: counterpart of
``diff_pruning_tpu/retrieval.py`` (the reference's scripts/train_searcher.py
and the ``Searcher`` of scripts/knn2img.py:60-166).

The reference builds a scaNN index. Here the search is exact: the
normalised queries against the normalised database in one numpy product,
the k best of each row in descending order (ties to the lower index), which
is what the JAX package's ``lax.top_k`` returns. The database files are the
reference's npz schema (``embedding``, ``img_id``, ``patch_coords``),
including the multi-file layout of train_searcher.py:36-56, and cross
between the two packages both ways.
"""

from __future__ import annotations

import glob
import os
import time
from typing import Dict, List, Sequence

import numpy as np
import torch


def load_datapool(dpath: str) -> Dict[str, np.ndarray]:
    """Reference load_datapool (train_searcher.py:29-59): one npz, or the
    multi-file layout whose arrays carry a leading singleton axis."""
    files = sorted(glob.glob(os.path.join(dpath, "*.npz")))
    if not files:
        raise ValueError(f'No npz-files in specified path "{dpath}"')
    if len(files) == 1:
        with np.load(files[0]) as z:
            return {k: z[k] for k in z.files}
    archives = [np.load(f) for f in files]
    out = {}
    for k in archives[0].files:
        parts = [a[k] for a in archives]
        if parts[0].ndim >= 2 and parts[0].shape[0] == 1:
            out[k] = np.concatenate(parts, axis=1)[0]
        else:
            out[k] = np.concatenate(parts, axis=0)
    for a in archives:
        a.close()
    return out


def build_database(clip_model, image_files: Sequence[str], *,
                   batch_size: int = 64) -> Dict[str, np.ndarray]:
    """Embeds an image folder with the CLIP vision tower (on the model's
    device) into a database of the reference's schema: whole-image
    embeddings, ``patch_coords`` the full frame."""
    from PIL import Image

    from .models.clip import clip_image_embed

    size = clip_model.cfg.image_size
    device = clip_model.logit_scale.device
    embs: List[np.ndarray] = []
    for start in range(0, len(image_files), batch_size):
        chunk = image_files[start:start + batch_size]
        batch = np.stack([np.asarray(Image.open(f).convert("RGB").resize((size, size)),
                                     np.float32) / 127.5 - 1.0 for f in chunk])
        with torch.inference_mode():
            embs.append(clip_image_embed(clip_model, torch.from_numpy(batch).to(device))
                        .cpu().numpy())
    embedding = np.concatenate(embs, axis=0)
    n = embedding.shape[0]
    return {"embedding": embedding.astype(np.float32),
            "img_id": np.arange(n, dtype=np.int64),
            "patch_coords": np.tile(np.array([[0, 0, size, size]], np.int64), (n, 1))}


class ExactSearcher:
    """knn2img.py's Searcher.search: exact dot-product top-k, the
    reference's result schema."""

    def __init__(self, database: Dict[str, np.ndarray]):
        self.database = database
        emb = np.asarray(database["embedding"], np.float32)
        self._normed = emb / np.linalg.norm(emb, axis=1, keepdims=True)

    def search(self, x, k: int) -> Dict[str, np.ndarray]:
        x = np.asarray(x, np.float32)
        if x.ndim == 3:  # (B, 1, D) context rows -> (B, D) (knn2img.py:142)
            x = x[:, 0]
        q = x / np.linalg.norm(x, axis=1, keepdims=True)
        start = time.time()
        nns = np.argsort(-(q @ self._normed.T), axis=1, kind="stable")[:, :k]
        end = time.time()
        out_emb = self.database["embedding"][nns]
        return {"nn_embeddings": out_emb / np.linalg.norm(out_emb, axis=-1, keepdims=True),
                "img_ids": self.database["img_id"][nns],
                "patch_coords": self.database["patch_coords"][nns],
                "queries": x, "exec_time": end - start, "nns": nns, "q_embeddings": q}

    def __call__(self, x, n: int):
        return self.search(x, n)


def save_searcher(database: Dict[str, np.ndarray], target_path: str) -> None:
    """train_searcher.py's output: the (single-file) database that the exact
    searcher loads; no index is needed."""
    os.makedirs(target_path, exist_ok=True)
    np.savez(os.path.join(target_path, "database.npz"), **database)


def load_searcher(path: str) -> ExactSearcher:
    return ExactSearcher(load_datapool(path))
