"""Minimal COLMAP sqlite database access (public COLMAP schema).

Copy of ``pixsfm_tpu/util/database.py`` (no JAX in either): image id/name
mapping, camera, image, keypoint, descriptor and match writes on COLMAP's
public schema. ``sqlite3`` is in Python's standard library.
"""

from __future__ import annotations

import sqlite3
from typing import Dict, Tuple

import numpy as np

__all__ = ["COLMAPDatabase", "blob_to_array", "array_to_blob",
           "pair_id_to_image_ids", "image_ids_to_pair_id"]

MAX_IMAGE_ID = 2 ** 31 - 1


def array_to_blob(array: np.ndarray) -> bytes:
    return np.ascontiguousarray(array).tobytes()


def blob_to_array(blob, dtype, shape=(-1,)) -> np.ndarray:
    if blob is None:
        return np.zeros(0, dtype)
    return np.frombuffer(blob, dtype=dtype).reshape(*shape)


def image_ids_to_pair_id(image_id1: int, image_id2: int) -> int:
    if image_id1 > image_id2:
        image_id1, image_id2 = image_id2, image_id1
    return image_id1 * MAX_IMAGE_ID + image_id2


def pair_id_to_image_ids(pair_id: int) -> Tuple[int, int]:
    image_id2 = pair_id % MAX_IMAGE_ID
    image_id1 = (pair_id - image_id2) // MAX_IMAGE_ID
    return int(image_id1), int(image_id2)


_SCHEMA = """
CREATE TABLE IF NOT EXISTS cameras (
    camera_id INTEGER PRIMARY KEY AUTOINCREMENT NOT NULL,
    model INTEGER NOT NULL, width INTEGER NOT NULL, height INTEGER NOT NULL,
    params BLOB, prior_focal_length INTEGER NOT NULL);
CREATE TABLE IF NOT EXISTS images (
    image_id INTEGER PRIMARY KEY AUTOINCREMENT NOT NULL,
    name TEXT NOT NULL UNIQUE, camera_id INTEGER NOT NULL,
    prior_qw REAL, prior_qx REAL, prior_qy REAL, prior_qz REAL,
    prior_tx REAL, prior_ty REAL, prior_tz REAL);
CREATE TABLE IF NOT EXISTS keypoints (
    image_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB);
CREATE TABLE IF NOT EXISTS descriptors (
    image_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB);
CREATE TABLE IF NOT EXISTS matches (
    pair_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB);
CREATE TABLE IF NOT EXISTS two_view_geometries (
    pair_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB,
    config INTEGER NOT NULL, F BLOB, E BLOB, H BLOB,
    qvec BLOB, tvec BLOB);
"""


class COLMAPDatabase(sqlite3.Connection):

    @staticmethod
    def connect(path) -> "COLMAPDatabase":
        return sqlite3.connect(str(path), factory=COLMAPDatabase)

    def create_tables(self):
        self.executescript(_SCHEMA)

    # -- reads --------------------------------------------------------------
    def image_id_to_name(self) -> Dict[int, str]:
        return {iid: name for iid, name in
                self.execute("SELECT image_id, name FROM images")}

    # -- writes -------------------------------------------------------------
    def add_camera(self, model_id: int, width: int, height: int, params,
                   prior_focal_length: bool = False, camera_id=None) -> int:
        cur = self.execute(
            "INSERT INTO cameras VALUES (?, ?, ?, ?, ?, ?)",
            (camera_id, model_id, width, height,
             array_to_blob(np.asarray(params, np.float64)),
             int(prior_focal_length)))
        return cur.lastrowid

    def add_image(self, name: str, camera_id: int, image_id=None) -> int:
        cur = self.execute(
            "INSERT INTO images VALUES (?, ?, ?, ?, ?, ?, ?, ?, ?, ?)",
            (image_id, name, camera_id, None, None, None, None, None, None,
             None))
        return cur.lastrowid

    def add_keypoints(self, image_id: int, keypoints: np.ndarray):
        keypoints = np.asarray(keypoints, np.float32)
        self.execute(
            "INSERT OR REPLACE INTO keypoints VALUES (?, ?, ?, ?)",
            (image_id,) + keypoints.shape + (array_to_blob(keypoints),))

    def add_descriptors(self, image_id: int, descriptors: np.ndarray):
        descriptors = np.ascontiguousarray(descriptors, np.uint8)
        self.execute(
            "INSERT OR REPLACE INTO descriptors VALUES (?, ?, ?, ?)",
            (image_id,) + descriptors.shape + (array_to_blob(descriptors),))

    def add_matches(self, image_id1: int, image_id2: int,
                    matches: np.ndarray):
        if image_id1 > image_id2:
            matches = matches[:, ::-1]
        pair_id = image_ids_to_pair_id(image_id1, image_id2)
        matches = np.asarray(matches, np.uint32)
        self.execute(
            "INSERT OR REPLACE INTO matches VALUES (?, ?, ?, ?)",
            (pair_id,) + matches.shape + (array_to_blob(matches),))
