"""The copied generators: pinned banks, and the same scenes as the
program's generators gave when they were copied."""

import numpy as np
import pytest

from port_bench.gen import bank, scenes

SEED = 2**31 + 11
PINNED = {
    ("hard", 4): "70297c751289cd7925bcc438cff742d73fb258c06acb42e6a024cb77bca71f54",
    ("kitti3", 2): "2076543fa8eaad6fc71cef69165d6479e8eaed4fb704591ac8607cde16da4dbe",
}


@pytest.mark.parametrize("profile,count", sorted(PINNED))
def test_bank_checksum_is_pinned(profile, count):
    b = bank.make_bank(profile, count, SEED)
    assert bank.checksum(b) == PINNED[(profile, count)]
    assert all(c.dtype == np.float32 and c.flags.c_contiguous for c in b)
    assert {c.shape[1] for c in b} == {bank.PROFILES[profile][1]}


@pytest.mark.parametrize("profile", sorted(bank.PROFILES))
def test_same_seed_same_bank_other_seed_other_bank(profile):
    a = bank.make_bank(profile, 2, 7)
    assert bank.checksum(a) == bank.checksum(bank.make_bank(profile, 2, 7))
    assert bank.checksum(a) != bank.checksum(bank.make_bank(profile, 2, 8))


@pytest.mark.parametrize("seed", [0, 2**31 + 5, 2**40 + 3, -3])
def test_any_whole_seed(seed):
    assert len(bank.make_bank("hard", 1, seed)) == 1


@pytest.mark.parametrize("name", ["make_scene_hard", "make_scene_kitti"])
def test_copy_matches_the_program_generator(name):
    """The frozen copy gives the scenes the program's generator gives (a
    later change to the program's generator fails this test, not the
    benchmark's traffic)."""
    from pillars_torch.data import synthetic

    ours = getattr(scenes, name)(np.random.RandomState(3))
    theirs = getattr(synthetic, name)(np.random.RandomState(3))
    np.testing.assert_array_equal(ours[0], theirs[0])
    np.testing.assert_array_equal(ours[1], theirs[1])


def test_hard_clouds_fit_the_d435i_width():
    b = bank.make_bank("hard", 16, 1)
    assert max(len(c) for c in b) <= 19968
    assert 13000 <= np.mean([len(c) for c in b]) <= 16000


def test_kitti_frustum_bank_opens_a_kitti_sweeps_pillars():
    """The kitti3 traffic's sweeps, thinned and cropped to the camera's
    view, open 6k-9k pillars of 0.16 m (the PointPillars paper's figure for
    a KITTI sweep), under the configuration's cap of 12000."""
    from port_bench import harness

    traffic = harness.traffic_file("kitti_frustum_b1_bank32")
    cap = harness.config_file("kitti_3class")["model"]["voxel"]["max_voxels"]
    b = bank.traffic_bank("kitti3", dict(traffic, bank=8), SEED)
    counts = []
    for c in b:
        ix = np.floor(c[:, 0] / 0.16).astype(np.int64)
        iy = np.floor((c[:, 1] + 39.68) / 0.16).astype(np.int64)
        inside = (c[:, 0] < 69.12) & (np.abs(c[:, 1]) < 39.68) \
            & (c[:, 2] >= -3.0) & (c[:, 2] < 1.0)
        counts.append(len(np.unique(ix[inside] * 1000 + iy[inside])))
    assert 6000 <= np.mean(counts) <= 9000 and max(counts) < cap, counts


def test_camera_frustum_keeps_what_the_camera_sees():
    pts = np.array([[10.0, 0.0, -1.7, 0.5],    # ahead on the ground
                    [-5.0, 0.0, -1.7, 0.5],    # behind
                    [10.0, 20.0, -1.7, 0.5],   # far to the left
                    [3.0, 0.0, -1.7, 0.5]],    # ground under the image
                   np.float32)
    np.testing.assert_array_equal(scenes.camera_frustum(pts), pts[:1])


def test_default_scene_arguments_draw_the_program_bank():
    a = bank.make_bank("kitti3", 1, 5)
    b = bank.make_bank("kitti3", 1, 5, scene={"background": 45000})
    assert bank.checksum(a) == bank.checksum(b)
