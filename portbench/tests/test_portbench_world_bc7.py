"""The cell ``world_bc7.orbit`` at the world's small sizes on the CPU:
the BC7 world (``configs/world_bc7.json``, ``scenes/world_bc7.py``) is
correct, and the control, a block fault and the port's old reading of
BC7 partition 63 are not; its two per-layer metrics read a traced run,
and nothing where the program opens no ``shade.bc7`` span."""

import json
import time

import numpy as np
import pytest

from portbench import bench, faults
from portbench.scenes import builder

from .small import small

CELL = "world_bc7.orbit"

# two-subset partition 63 as the port read it before it followed the
# specification (0100 0100 0111 0111): texels 8, 10, 12, 14 swapped
OLD_P2_63 = np.array([0, 1, 0, 0, 0, 1, 0, 0, 1, 1, 0, 1, 1, 1, 0, 1],
                     np.uint8)


def _run(seed, traced=False, control=False):
    return bench.run_cell(CELL, seed, 0.3, traced,
                          t_start=time.perf_counter(), device="cpu",
                          overrides=small("world"), control=control)


def test_the_configuration_is_the_world_with_bc7_textures():
    b = bench.Bench()
    world, bc7 = b.config("world"), b.config("world_bc7")
    changed = {k for k in set(world) | set(bc7)
               if world.get(k) != bc7.get(k)}
    assert changed == {"name", "source", "builder", "pool",
                       "texture_format", "bc7_modes", "assumed"}
    assert bc7["pool"] == bc7["texture_format"] == "bc7"
    assert bc7["bc7_modes"] == list(range(8))
    entry = next(c for c in b.spec["configs"] if c["name"] == "world_bc7")
    assert entry["reduced"] == [] and entry["source"] == bc7["source"]
    arrays = builder(bc7["builder"]).build(dict(bc7, **small("world")),
                                           2**31 + 97)
    assert arrays.chain_format == "bc7"
    modes = {(int(x) & -int(x)).bit_length() - 1
             for c in arrays.chains for blocks, _, _ in c
             for x in blocks[:, 0]}
    assert modes == set(range(8))


def test_the_program_is_correct_and_the_control_is_not():
    out = _run(2**31 + 101, control=True)
    assert out["correct"] is True, out["checks"]
    for name, c in out["checks"].items():
        assert c["value"] <= c["limit"], name
    assert out["control"]["correct"] is False, out["control"]


def _old_partition63(setattr_):
    """The port's BC7 decode with its former partition 63, in the NumPy
    table its upload (the hint pool) and its sampler read."""
    from mt_renderer_tpu_torch.render import bcn

    old = bcn._P2.copy()
    old[63] = OLD_P2_63
    setattr_(bcn, "_P2", old)


@pytest.mark.parametrize("fault", ["bc7_subset0", "partition63"])
def test_a_decode_fault_fails_the_colour_number(monkeypatch, fault):
    if fault == "partition63":
        _old_partition63(monkeypatch.setattr)
    else:
        faults.plant(monkeypatch.setattr, CELL, fault)
    out = _run(2**31 + 103)
    assert out["correct"] is False, (fault, out["checks"])
    c = out["checks"]["color_off"]
    assert c["value"] > c["limit"], (fault, out["checks"])


def test_the_bc7_metrics_read_a_traced_run():
    out = _run(2**31 + 107, traced=True)
    assert out["correct"] is True, out["checks"]
    got = out["metrics"]
    assert got["bc7_shade_ms"]["value"] > 0.0
    assert got["bc7_shade_ms"]["unit"] == "ms"
    assert got["bc7_texels"]["value"] > 0.0
    # the shaded rows are whole 2048-pixel tiles, eight texels a pixel
    assert got["bc7_texels"]["value"] % (2048 * 8) == 0


def test_the_bc7_metrics_are_absent_without_the_span():
    from mt_renderer_tpu_torch.utils import profiling

    profiling.reset_spans()
    b = bench.Bench()
    for name in ("bc7_shade_ms", "bc7_texels"):
        assert b.reader(name)({}) is None
    spec = {m["name"]: m for m in b.spec["per_layer"]}
    assert spec["bc7_texels"]["workloads"] == [CELL]
    assert spec["bc7_shade_ms"]["workloads"] == [CELL]


def test_the_cell_reports_the_worlds_frame_metrics():
    b = bench.Bench()
    e2e = {m["name"] for m in b.end_to_end(CELL)}
    assert e2e == {"frame_ms", "frame_p95_ms", "setup_s"}
    layers = {m["name"] for m in b.per_layer(CELL)}
    assert layers == {"guard_ms", "device_busy_ms.frame", "idle_share.frame",
                      "k1_roofline.frame", "bc7_shade_ms", "bc7_texels"}
    assert json.loads((b.root / "limits" / f"{CELL}.json").read_text())
