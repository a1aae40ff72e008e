"""The port's copy of the PCD reader/writer and the native codec: a round
trip through both formats, ``load_sequence`` of a ``.pcd`` folder, and the
wrapper's ``save_map`` / ``dump_submaps`` that write through them.  The
files must read back as the JAX package's reader reads them."""
import numpy as np
import pytest

from open3d_slam_tpu.io import pcd as jpcd
from open3d_slam_torch.io import datasets, native, pcd
from open3d_slam_torch.models.slam_wrapper import SlamWrapper
from open3d_slam_torch.utils import pointcloud as tpc

from torch_parity import small_jax_params, to_torch_params


@pytest.mark.parametrize("binary", [True, False])
def test_pcd_round_trip(tmp_path, rng, binary):
    pts = rng.normal(size=(500, 3)).astype(np.float32)
    nrm = rng.normal(size=(500, 3)).astype(np.float32)
    # Packed RGB survives only the binary format, as in the JAX package.
    col = rng.uniform(size=(500, 3)).astype(np.float32) if binary else None
    path = str(tmp_path / "c.pcd")
    pcd.write_pcd(path, pts, normals=nrm, colors=col, binary=binary)
    atol = 0.0 if binary else 1e-6        # ASCII keeps 6 decimals
    for reader in (pcd.read_pcd, jpcd.read_pcd):
        out = reader(path)
        np.testing.assert_allclose(out["points"], pts, rtol=0, atol=atol)
        np.testing.assert_allclose(out["normals"], nrm, rtol=0, atol=atol)
        if binary:
            np.testing.assert_allclose(out["colors"], col, atol=1.0 / 255)


def test_native_codec_matches_python(tmp_path, rng):
    if native.load() is None:
        pytest.skip("the native IO library cannot be built or loaded here")
    pts = rng.normal(size=(4000, 3)).astype(np.float32)
    path = str(tmp_path / "n.pcd")
    native.write_pcd_native(path, pts)
    np.testing.assert_array_equal(native.read_pcd_native(path)["points"], pts)
    np.testing.assert_array_equal(pcd.read_pcd(path)["points"], pts)


def test_load_sequence_of_a_pcd_folder(tmp_path, rng):
    scans = [rng.normal(size=(100 + 10 * i, 3)).astype(np.float32) for i in range(4)]
    for i, s in enumerate(scans):
        pcd.write_pcd(str(tmp_path / f"cloud_{i:03d}.pcd"), s)
    seq = datasets.load_sequence(str(tmp_path))
    assert len(seq.scans) == 4
    for got, want in zip(seq.scans, scans):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(np.diff(seq.timestamps), 0.1)


def test_save_map_and_dump_submaps(tmp_path, rng):
    slam = SlamWrapper(to_torch_params(small_jax_params()), device="cpu")
    slam.submaps.create_new_submap(np.eye(4))
    clouds = [rng.normal(size=(n, 3)).astype(np.float32) for n in (300, 200)]
    for s, c in zip(slam.submaps.submaps, clouds):
        s.map_cloud = tpc.from_numpy(c, capacity=512, normals=c * 0.5)
    path = slam.save_map(str(tmp_path))
    out = pcd.read_pcd(path)
    np.testing.assert_array_equal(out["points"], np.concatenate(clouds))
    np.testing.assert_array_equal(out["normals"], np.concatenate(clouds) * 0.5)
    slam.dump_submaps("before", folder=str(tmp_path))
    for i, c in enumerate(clouds):
        np.testing.assert_array_equal(jpcd.read_pcd(str(tmp_path / f"before_{i}.pcd"))["points"], c)
    # This configuration builds no dense map: one empty PCD per submap (the
    # dense round trip is in tests/test_torch_online.py).
    slam.dump_submaps("dense", dense=True, folder=str(tmp_path))
    for i in range(len(clouds)):
        assert pcd.read_pcd(str(tmp_path / f"dense_{i}.pcd"))["points"].shape == (0, 3)
