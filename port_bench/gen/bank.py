"""Banks of clouds made from a run's seed.

A bank is a list of float32 clouds [n, features]. Each cloud is one scene of
the named profile with its points in random order, as a sensor sweep's
azimuth interleave gives them (the voxelizer keeps the first points of a
pillar and the first ``max_voxels`` pillars, so a block-ordered cloud would
lose its objects to the background). The same seed gives the same bank.
"""

from __future__ import annotations

import hashlib
from typing import Dict, List, Optional

import numpy as np

from port_bench.gen import scenes

# profile -> (scene function, columns kept)
PROFILES = {
    "hard": (scenes.make_scene_hard, 3),
    "kitti3": (scenes.make_scene_kitti, 4),
}


def seeded_rng(seed: int, salt: str) -> np.random.RandomState:
    """A NumPy generator for ``seed`` (any whole number: the seed's bytes
    and ``salt`` go through a hash) and one use of it (``salt``)."""
    digest = hashlib.sha256(f"{int(seed)}:{salt}".encode()).digest()
    return np.random.RandomState(np.frombuffer(digest, dtype=np.uint32))


def make_bank(profile: str, count: int, seed: int,
              scene: Optional[Dict] = None,
              crop: Optional[str] = None) -> List[np.ndarray]:
    """``count`` clouds of ``profile`` ("hard" or "kitti3") from ``seed``.
    ``scene``: keyword arguments of the profile's scene function (a traffic
    file's ``scene``); ``crop``: a name of :data:`scenes.CROPS`, applied to
    each scene before its points are shuffled (a traffic file's ``crop``)."""
    make, columns = PROFILES[profile]
    cut = scenes.CROPS[crop] if crop else None
    rng = seeded_rng(seed, f"bank:{profile}")
    bank = []
    for _ in range(count):
        points = make(rng, **(scene or {}))[0]
        if cut is not None:
            points = cut(points)
        points = np.ascontiguousarray(points[:, :columns], dtype=np.float32)
        bank.append(points[rng.permutation(len(points))])
    return bank


def traffic_bank(profile: str, traffic: Dict, seed: int) -> List[np.ndarray]:
    """The bank a traffic file asks for: its ``bank`` clouds, with its
    ``scene`` arguments and its ``crop``."""
    return make_bank(profile, int(traffic["bank"]), seed,
                     scene=traffic.get("scene"), crop=traffic.get("crop"))


def checksum(bank: List[np.ndarray]) -> str:
    """sha256 over the bank's clouds, in order, with their shapes."""
    h = hashlib.sha256()
    for cloud in bank:
        h.update(np.asarray(cloud.shape, np.int64).tobytes())
        h.update(np.ascontiguousarray(cloud).tobytes())
    return h.hexdigest()
