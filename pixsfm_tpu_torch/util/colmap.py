"""COLMAP database IO (reference: pixsfm/util/colmap.py).

Copy of ``pixsfm_tpu/util/colmap.py``: keypoints and matches read from a
COLMAP database (scores from the stored descriptors, when there are any),
refined keypoints written back.
"""

from __future__ import annotations

from contextlib import closing
from typing import Dict, List, Optional, Tuple

import numpy as np

from .database import (COLMAPDatabase, blob_to_array, pair_id_to_image_ids)

__all__ = [
    "read_image_id_to_name_from_db", "read_keypoints_from_db",
    "read_matches_from_db", "write_keypoints_to_db",
]


def read_image_id_to_name_from_db(database_path) -> Dict[int, str]:
    with closing(COLMAPDatabase.connect(database_path)) as db:
        return db.image_id_to_name()


def read_keypoints_from_db(database_path) -> Dict[str, np.ndarray]:
    out = {}
    with closing(COLMAPDatabase.connect(database_path)) as db:
        id2name = db.image_id_to_name()
        for image_id, rows, cols, data in db.execute(
                "SELECT * FROM keypoints"):
            kps = blob_to_array(data, np.float32, (rows, cols))
            out[id2name[image_id]] = kps.astype(np.float64)[:, :2]
    return out


def read_matches_from_db(database_path) -> Tuple[List[Tuple[str, str]],
                                                 List[np.ndarray],
                                                 Optional[List[np.ndarray]]]:
    """Pairs + matches (+ scores recomputed from descriptor dot products when
    descriptors are stored — reference util/colmap.py:37-55)."""
    with closing(COLMAPDatabase.connect(database_path)) as db:
        id2name = db.image_id_to_name()
        desc = {}
        for image_id, r, c, data in db.execute("SELECT * FROM descriptors"):
            d = blob_to_array(data, np.uint8, (-1, c)).astype(np.float64)
            n = np.linalg.norm(d, axis=1, keepdims=True)
            desc[image_id] = d / np.maximum(n, 1e-12)
        compute_scores = len(desc) > 0
        pairs, matches = [], []
        scores = [] if compute_scores else None
        for pair_id, data in db.execute("SELECT pair_id, data FROM matches"):
            if data is None:
                continue
            id1, id2 = pair_id_to_image_ids(pair_id)
            pairs.append((id2name[id1], id2name[id2]))
            m = blob_to_array(data, np.uint32, (-1, 2)).astype(np.int64)
            matches.append(m)
            if compute_scores:
                d1, d2 = desc[id1][m[:, 0]], desc[id2][m[:, 1]]
                scores.append(np.einsum("nd,nd->n", d1, d2))
    return pairs, matches, scores


def write_keypoints_to_db(database_path, keypoints: Dict[str, np.ndarray]
                          ) -> None:
    with closing(COLMAPDatabase.connect(database_path)) as db:
        db.execute("DELETE FROM keypoints")
        db.commit()
        name2id = {n: i for i, n in db.image_id_to_name().items()}
        for name, kps in keypoints.items():
            db.add_keypoints(name2id[name], kps)
        db.commit()
