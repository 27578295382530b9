"""The readers of the program's span log (``mfbench.spans`` and the metrics
that read it), on hand-made logs: self time, the sums a traced frame or
step, and the scan's roofline refused where the recorded launches and the
profiled kernels differ in number."""

from types import SimpleNamespace

import pytest

from mfbench import arith, harness, spans

MS = 1_000_000       # ns


def rec(name, start, end, parent=-1, id_=1, kind="span", **values):
    return {"kind": kind, "name": name, "id": id_, "start_ns": start * MS,
            "end_ns": None if end is None else end * MS, "parent": parent,
            "tid": 0, "values": values}


def frame_log():
    """Two traced frames: odom with an overlapping pair of children, fuse
    with one, a host stage; and a frame_to_pose that began before them."""
    return [
        rec("process_frame", 100, 200, id_=5),                     # 0
        rec("odom", 105, 160, 0, 5),                               # 1
        rec("track_global", 110, 130, 1, 5),                       # 2
        rec("track_objects", 125, 150, 1, 5),                      # 3
        rec("fuse", 160, 195, 0, 5),                               # 4
        rec("fuse_global", 161, 170, 4, 5),                        # 5
        rec("host_stage", 100, 104, 0, 4),                         # 6
        rec("fetch", 100, 101, 6, 4),                              # 7
        rec("fetch_ids", 101, 102, 6, 4),                          # 8
        rec("frame_to_pose", 20, 101, -1, 4),                      # 9
        rec("process_frame", 200, 320, id_=6),                     # 10
        rec("host_stage", 200, 210, 10, 5),                        # 11
        rec("fetch", 200, 203, 11, 5),                             # 12
        rec("frame_to_pose", 100, 203, -1, 5),                     # 13
        rec("odom", 210, 300, 10, 6),                              # 14
        rec("scan_live", 215, 215, 14, 6, kind="counter", H=4, W=5,
            window=1, live=3, live_taps=20),                       # 15
    ]


def ctx(units=2, kernels=None):
    return SimpleNamespace(profile={"units": units,
                                    "kernels": kernels or {}})


def test_self_time_subtracts_the_union_of_the_children():
    log = frame_log()
    kids = spans.children(log)
    assert kids[1] == [2, 3] and kids[0] == [1, 4, 6]
    # odom 55 ms, its children cover 110-150 (the overlap counted once)
    assert spans.self_ns(log, 1, kids) == 15 * MS
    # frame 5: 100 ms less odom, fuse and host_stage (100-104, 105-195)
    assert spans.self_ns(log, 0, kids) == (100 - 4 - 90) * MS
    assert spans.self_ns(log, 2, kids) == 20 * MS     # a leaf: its length
    # self times and the children's durations add up to the root's length
    total = sum(spans.self_ns(log, i, kids) for i in (0, 1, 2, 3, 4, 5, 6,
                                                      7, 8))
    # (the children's overlap, 125-130, counts in both of theirs)
    assert total - (130 - 125) * MS == 100 * MS


def test_a_child_outside_its_parent_is_clipped():
    log = [rec("a", 0, 10), rec("b", 8, 14, 0), rec("c", -3, 1, 0)]
    assert spans.self_ns(log, 0, spans.children(log)) == 7 * MS


def test_sums_a_traced_unit():
    log = frame_log()
    c = ctx(units=2)
    assert spans.self_ms(c, "track_objects", log) == pytest.approx(12.5)
    assert spans.self_ms(c, "process_frame", log) == \
        pytest.approx((6 + (120 - 10 - 90)) / 2)
    assert spans.total_ms(c, ("fetch", "fetch_ids"), log) == \
        pytest.approx((1 + 1 + 3) / 2)
    assert spans.self_ms(c, "fuse_objects", log) is None
    assert spans.total_ms(c, ("rpn_nms",), log) is None
    assert spans.self_ms(ctx(units=0), "odom", log) is None
    assert spans.self_ms(c, "odom", []) is None


def use(monkeypatch, log):
    monkeypatch.setattr(spans, "program_log", lambda: log)


def test_readers_on_a_log(monkeypatch):
    use(monkeypatch, frame_log())
    c = ctx(units=2)
    assert harness.load_reader("self_ms.track_global")(c) == \
        pytest.approx(10.0)
    assert harness.load_reader("wait_ms.fetch")(c) == pytest.approx(2.5)
    use(monkeypatch, None)          # a program without the log
    for m in ("self_ms.track_global", "self_ms.process_frame",
              "roofline_pct.predict_scan", "self_ms.train_forward"):
        assert harness.load_reader(m)(c) is None


def test_train_readers(monkeypatch):
    use(monkeypatch, [
        rec("forward", 0, 40, id_=3), rec("rpn_nms", 5, 15, 0, 3),
        rec("rpn_nms", 20, 25, 0, 3), rec("backward", 40, 80, id_=3),
        rec("optimizer", 80, 99, id_=3)])
    c = ctx(units=1)
    read = {m: harness.load_reader(m)(c) for m in (
        "self_ms.train_forward", "self_ms.rpn_nms", "self_ms.train_backward",
        "self_ms.train_optimizer")}
    assert read == pytest.approx({
        "self_ms.train_forward": 25.0, "self_ms.rpn_nms": 15.0,
        "self_ms.train_backward": 40.0, "self_ms.train_optimizer": 19.0})


def test_scan_roofline_needs_every_launch(monkeypatch):
    vals = [dict(H=480, W=640, window=2, live=150_000, live_taps=3_700_000),
            dict(H=320, W=320, window=2, live=9_000, live_taps=220_000)]
    log = [rec("scan_live", 0, 0, kind="counter", **v) for v in vals]
    use(monkeypatch, log)
    read = harness.load_reader("roofline_pct.predict_scan")
    bound_ms = sum(arith.bound_record(
        10 * v["H"] * v["W"] + 27 * v["live_taps"],
        v["H"] * v["W"] * 9 + v["live"] * 28)["bound_ms"] for v in vals)
    k = {"void predict_l0_scan_kernel<false>(...)": {"us": 30.0, "n": 2},
         "bilateral_depth_kernel": {"us": 40.0, "n": 2}}
    assert read(ctx(kernels=k)) == pytest.approx(100 * bound_ms * 1e3 / 30)
    # a launch the log missed, or one more in it: no reading
    k["void predict_l0_scan_kernel<false>(...)"]["n"] = 3
    assert read(ctx(kernels=k)) is None
    use(monkeypatch, log + log[:1])
    k["void predict_l0_scan_kernel<false>(...)"]["n"] = 2
    assert read(ctx(kernels=k)) is None
    assert read(SimpleNamespace(profile=None)) is None
