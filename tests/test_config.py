"""Config dataclass tests."""

import pytest

from cfd_tpu.config import Config


def test_defaults():
    c = Config()
    assert c.scheme.order == 4 and not c.scheme.periodic
    assert c.jax_dtype.__name__ == "float32"


def test_validation():
    with pytest.raises(ValueError, match="bad dtype"):
        Config(dtype="float16")
    with pytest.raises(ValueError, match="bad method"):
        Config(method="magic")
    with pytest.raises(ValueError, match="bad method"):
        Config(dtype="float64", method="pallas")
    with pytest.raises(ValueError):
        Config(order=8)


def test_from_env(monkeypatch):
    monkeypatch.setenv("CFD_ORDER", "6")
    monkeypatch.setenv("CFD_PERIODIC", "true")
    monkeypatch.setenv("CFD_MESH", "1,2,4")
    monkeypatch.setenv("CFD_GRID", "32,64,128")
    c = Config.from_env(method="pcr")
    assert c.order == 6 and c.periodic
    assert c.mesh_shape == (1, 2, 4)
    assert c.grid_shape == (32, 64, 128)
    assert c.method == "pcr"


def test_make_grid():
    c = Config(mesh_shape=(2, 2, 2), grid_shape=(16, 16, 16), method="pcr")
    g = c.make_grid()
    assert g.local_shape == (8, 8, 8)


def test_from_env_spacing(monkeypatch):
    from cfd_tpu.config import Config

    monkeypatch.setenv("CFD_SPACING", "0.1,0.2,0.3")
    assert Config.from_env().spacing == (0.1, 0.2, 0.3)
    monkeypatch.setenv("CFD_SPACING", "0.05")
    assert Config.from_env().spacing == (0.05, 0.05, 0.05)
