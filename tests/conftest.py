"""Test configuration: run JAX on a virtual 8-device CPU mesh.

Sharding/collective logic is exercised without several GPUs via
``--xla_force_host_platform_device_count``. The platform is forced both
through the environment and through jax.config before any backend
initializes (backend init is lazy).
"""

import os

xla_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in xla_flags:
    os.environ["XLA_FLAGS"] = (
        xla_flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ["JAX_PLATFORMS"] = "cpu"

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np
import pytest

assert len(jax.devices()) == 8, (
    "tests require the 8-device virtual CPU mesh; got "
    f"{jax.devices()} — was JAX initialized before conftest?")


@pytest.fixture(scope="session")
def frame0():
    """Frame 0 of seeded scene sequence 0 (xyz float32 (n,3)): a full-size
    64-beam street scan (io/scene.py)."""
    from lidar_processing.io.scene import frame_seed, scan
    xyz, _ = scan(frame_seed(0, 0))
    return xyz


@pytest.fixture(scope="session")
def scene_dir(tmp_path_factory):
    """A directory holding frames 0-2 of seeded sequence 0 as .pcd files."""
    from lidar_processing.io.scene import write_scenes
    d = tmp_path_factory.mktemp("scenes")
    write_scenes(str(d), 3, seed=0)
    return str(d)


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(seed=1234)
