"""The metric arithmetic: the rate over the whole window, the p95 over
every item, the busy union and the idle share, K1's frozen count."""

import pytest

from portbench import bench, loops, trace


def test_rate_is_the_whole_window_over_the_items():
    win = dict(ms=[100.0, 300.0, 50.0, 50.0], seconds=0.6, attempted=4)
    # 600 ms over 4 items, not the mean of the items' own times (125)
    assert loops.stats(win)["mean_ms"] == pytest.approx(150.0)


def test_p95_is_over_every_item():
    win = dict(ms=[float(i) for i in range(1, 101)], seconds=1.0,
               attempted=100)
    assert loops.stats(win)["p95_ms"] == pytest.approx(95.05)


def test_union_busy_and_labelled_gaps():
    raw = dict(device=[(10, 20, "k1"), (15, 30, "k2"), (50, 60, "Memcpy HtoD"),
                       (100, 110, "k1"), (130, 140, "k2")],
               spans=[(0, 120, "render"), (35, 45, "guard"),
                      (61, 95, "readback")],
               window=(0, 120))
    s = trace.summary(raw, items=2)
    assert trace.union([(10, 20), (15, 30), (50, 60)]) == [(10, 30), (50, 60)]
    assert s["busy_s"] == pytest.approx(40e-6)       # 10-30, 50-60, 100-110
    assert s["window_s"] == pytest.approx(120e-6)    # 130-140 lies outside
    assert s["launches"] == 3                        # the copy is no launch
    idle = dict(s["idle_gaps"])
    assert idle == pytest.approx({"render": 20e-6, "guard": 20e-6,
                                  "readback": 40e-6})
    assert s["device_ops"][0] == ["k1", pytest.approx(20e-6)]


def test_idle_share_and_busy_readers():
    b = bench.Bench()
    ctx = dict(trace=dict(busy_s=0.02, window_s=0.5, items=4, launches=4400,
                          kernel_s={}), guard_ms=None, cfg={})
    assert b.reader("idle_share.frame")(ctx) == pytest.approx(0.96)
    assert b.reader("idle_share.served")(ctx) == pytest.approx(0.96)
    assert b.reader("device_busy_ms.frame")(ctx) == pytest.approx(5.0)
    assert b.reader("launches.served")(ctx) == pytest.approx(1100.0)
    # no guard timed and no K1 in the trace: absent, never 0
    assert b.reader("guard_ms")(ctx) is None
    assert b.reader("k1_roofline.frame")(dict(ctx, cfg=b.config("headline"))) is None
    assert b.reader("guard_ms")(dict(ctx, guard_ms=[300.0, 310.0])) == 305.0
    assert b.reader("traced_p95_ms.served")(ctx) is None
    assert b.reader("traced_p95_ms.served")(dict(
        ctx, item_ms=[float(i) for i in range(100, 0, -1)])) == pytest.approx(
            95.05)


@pytest.mark.parametrize("config, nbytes, ops", [
    # tap: 196,608 triangles x 33 setup rows x 4 B
    #      + 1920 x 1080 pixels x 6 planes x 4 B
    ("headline", 196608 * 33 * 4 + 1920 * 1080 * 6 * 4, 12 * 196608),
    # mtap: 239,664 x 33 x 4 B + 1920 x 1080 x 17 x 4 B
    ("world", 239664 * 33 * 4 + 1920 * 1080 * 17 * 4, 12 * 239664),
])
def test_k1_count_is_frozen(config, nbytes, ops):
    """K1's least time counts from the configuration alone: triangles,
    frame size, setup rows and epilogue planes. It reads no ``maxc``,
    chunk list or tap cap of the program, which a change to the program
    could move, and a yardstick that moves with the program measures
    nothing."""
    b = bench.Bench()
    count = b.reader("k1_roofline.frame").__globals__["count"]
    c = count(b.config(config))
    assert (c["bytes"], c["ops"], c["bound"]) == (nbytes, ops, "bytes")
    assert nbytes == {"headline": 75_718_656, "world": 172_640_448}[config]
    assert c["least_s"] == pytest.approx(nbytes / 3.35e12)
    tr = dict(items=10, kernel_s={"void raster_fwd_kernel<0, false, false>":
                                  10 * 4 * c["least_s"],
                                  "raster_fwd_ml_kernel": 1.0})
    ctx = dict(cfg=b.config(config), trace=tr)
    assert b.reader("k1_roofline.frame")(ctx) == pytest.approx(25.0)
    assert b.reader("k1_roofline.served")(ctx) == pytest.approx(25.0)
