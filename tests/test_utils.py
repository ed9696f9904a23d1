"""Utility-layer tests: timing helpers."""

import jax
import jax.numpy as jnp
import numpy as np

from cfd_tpu.utils import chain_time, phase_timer


def test_chain_time_positive_and_plausible():
    x = jnp.ones((64, 64))
    t = chain_time(lambda g: g * 1.000001 + 0.1, x, k_small=2, k_big=34, repeats=2)
    assert t > 0


def test_chain_time_shape_changing_step():
    # steps whose output shape differs are folded back via a scalar summary
    x = jnp.ones((16, 16))
    t = chain_time(lambda g: jnp.sum(g, axis=0), x, k_small=2, k_big=6, repeats=1)
    assert t > 0


def test_chain_time_pytree_step():
    # vector-field steps chain tuples (e.g. curl: (ux,uy,uz) -> (wx,wy,wz))
    x = (jnp.ones((16, 16)), jnp.full((16, 16), 2.0))
    t = chain_time(
        lambda u: (u[1] * 1.000001, u[0] + 0.1), x, k_small=2, k_big=6, repeats=1
    )
    assert t > 0


def test_chain_time_pytree_structure_changing_step():
    # tuple-in, single-array-out steps fold back into the full carry
    x = (jnp.ones((16, 16)), jnp.ones((16, 16)))
    t = chain_time(
        lambda u: u[0] + u[1], x, k_small=2, k_big=6, repeats=1
    )
    assert t > 0


def test_phase_timer_records():
    with phase_timer("unit", verbose=False) as t:
        sum(range(1000))
    assert t.elapsed is not None and t.elapsed >= 0


def test_chain_time_1d_output():
    # sync readback must not assume >= 2 trailing dims
    x = jnp.ones((128,))
    t = chain_time(lambda g: g * 1.000001, x, k_small=2, k_big=6, repeats=1)
    assert t > 0


def test_checkpoint_npz_roundtrip(tmp_path):
    from cfd_tpu.utils.checkpointing import restore_state, save_state

    state = {"f": jnp.arange(12.0).reshape(3, 4), "t": np.float64(0.25)}
    p = str(tmp_path / "ckpt")
    save_state(p, state, backend="npz")
    out = restore_state(p, backend="npz")
    np.testing.assert_allclose(out["f"], np.asarray(state["f"]))
    np.testing.assert_allclose(out["t"], 0.25)


def test_checkpoint_orbax_sharded_roundtrip(tmp_path):
    # sharded save/restore through orbax, re-sharded on restore
    pytest = __import__("pytest")
    pytest.importorskip("orbax.checkpoint")
    from jax.sharding import NamedSharding, PartitionSpec as P

    from cfd_tpu.parallel import make_mesh
    from cfd_tpu.utils.checkpointing import restore_state, save_state

    mesh = make_mesh((2, 2, 2))
    sh = NamedSharding(mesh, P("z", "y", "x"))
    f = jax.device_put(jnp.arange(8.0 * 8 * 8).reshape(8, 8, 8), sh)
    p = str(tmp_path / "orbax_ckpt")
    save_state(p, {"f": f}, backend="orbax")
    out = restore_state(
        p, distribute=lambda a: jax.device_put(jnp.asarray(a), sh), backend="orbax"
    )
    assert out["f"].sharding == sh
    np.testing.assert_allclose(np.asarray(out["f"]), np.asarray(f))

# ---------------------------------------------------------------- xplane


def _tag(fn, wt):
    return bytes([(fn << 3) | wt])


def _varint(x):
    out = bytearray()
    while True:
        b = x & 0x7F
        x >>= 7
        if x:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _ld(fn, payload):
    return _tag(fn, 2) + _varint(len(payload)) + payload


def _synthetic_xspace():
    """Hand-encode an XSpace with one GPU device plane: two modules, 3+2
    events, plus a decoy host plane."""

    def event(mid, dur_ps):
        return _ld(4, _tag(1, 0) + _varint(mid) + _tag(3, 0) + _varint(dur_ps))

    def meta(mid, name):
        inner = _tag(1, 0) + _varint(mid) + _ld(2, name.encode())
        return _ld(4, _tag(1, 0) + _varint(mid) + _ld(2, inner))

    line = _ld(2, b"XLA Modules") + b"".join(
        [event(1, 200_000_000), event(1, 250_000_000), event(1, 190_000_000),
         event(2, 205_000_000), event(2, 210_000_000)]
    )
    plane = (
        _ld(2, b"/device:GPU:0")
        + meta(1, "jit_kernel(123)")
        + meta(2, "jit__bench_scale(456)")
        + _ld(3, line)
        # a decoy host plane the parser must skip
    )
    host = _ld(2, b"/host:CPU") + meta(1, "python") + _ld(3, _ld(2, b"XLA Modules"))
    return _ld(1, plane) + _ld(1, host)


def test_xplane_parser_roundtrip(tmp_path):
    from cfd_tpu.utils.xplane import parse_device_durations

    p = tmp_path / "x.xplane.pb"
    p.write_bytes(_synthetic_xspace())
    durs = parse_device_durations(str(p))
    assert set(durs) == {"jit_kernel(123)", "jit__bench_scale(456)"}
    assert durs["jit_kernel(123)"] == [0.2, 0.25, 0.19]
    assert durs["jit__bench_scale(456)"] == [0.205, 0.21]


def test_xplane_latest_file_layout(tmp_path):
    from cfd_tpu.utils.xplane import device_module_durations_ms, latest_xplane_file

    d = tmp_path / "plugins" / "profile" / "2026_01_01"
    d.mkdir(parents=True)
    (d / "vm.xplane.pb").write_bytes(_synthetic_xspace())
    assert latest_xplane_file(str(tmp_path)).endswith("vm.xplane.pb")
    durs = device_module_durations_ms(str(tmp_path))
    assert min(durs["jit_kernel(123)"]) == 0.19


def _two_card_xspace():
    def event(mid, dur_ps):
        return _ld(4, _tag(1, 0) + _varint(mid) + _tag(3, 0) + _varint(dur_ps))

    def meta(mid, name):
        inner = _tag(1, 0) + _varint(mid) + _ld(2, name.encode())
        return _ld(4, _tag(1, 0) + _varint(mid) + _ld(2, inner))

    def plane(name, dur_ps):
        modules = _ld(2, b"XLA Modules") + event(1, dur_ps)
        stream = _ld(2, b"Stream #13") + event(2, dur_ps // 2)
        return _ld(
            1,
            _ld(2, name.encode())
            + meta(1, "jit_step(1)")
            + meta(2, "loop_fusion")
            + _ld(3, modules)
            + _ld(3, stream),
        )

    return plane("/device:GPU:0", 100_000_000) + plane("/device:GPU:1", 300_000_000)


def test_xplane_selects_gpu_plane_and_lines(tmp_path):
    from cfd_tpu.utils.xplane import parse_device_durations

    p = tmp_path / "x.xplane.pb"
    p.write_bytes(_two_card_xspace())
    assert parse_device_durations(str(p)) == {"jit_step(1)": [0.1]}
    assert parse_device_durations(str(p), plane="/device:GPU:1") == {
        "jit_step(1)": [0.3]
    }
    # a stream line lists the kernels launched on it
    assert parse_device_durations(str(p), line="Stream #13") == {
        "loop_fusion": [0.05]
    }
