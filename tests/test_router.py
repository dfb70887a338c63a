"""Host-vs-device engine router (ops/router.py + DfaMatcher wiring):
decision model at the measured calibration points, and bit-exactness of
the host path against the device path."""

import dataclasses

import numpy as np
import pytest

from regex_fpga_tpu import api
from regex_fpga_tpu.ops.router import (
    DEVICE_TILE_BPS,
    HOST_MULTI_BPS,
    HOST_SINGLE_BPS,
    choose_scan_backend,
    device_count_bps,
    host_count_bps,
)
from regex_fpga_tpu.utils.native import native_available


def test_decision_at_measured_points():
    # static priors from the router probes on the H100 machine
    # (router.py constants): device 4.01e9 per tile, host ~1e9
    assert choose_scan_backend(213, 31, 1) == "device"   # 3 tiles, 1.34
    assert choose_scan_backend(440, 36, 8) == "host"     # 5 tiles, 0.80
    # S=836: 8 tiles put the device at 0.50 against the host's ~1.0 for
    # BOTH stream shapes (the speculative segmented walk lifts single
    # streams to multi-cursor rate)
    assert choose_scan_backend(836, 36, 1) == "host"
    assert choose_scan_backend(836, 36, 8) == "host"
    # the reference's own ruleset scale (S=2794 densified): host wins
    assert choose_scan_backend(2794, 64, 1) == "host"    # 23 tiles, 0.19
    assert choose_scan_backend(2794, 64, 16) == "host"
    assert choose_scan_backend(1500, 64, 16) == "host"
    assert choose_scan_backend(1500, 64, 1) == "host"
    # small-S (kgram territory) is never host
    assert choose_scan_backend(23, 221, 64) == "device"
    # forcing overrides the model
    assert choose_scan_backend(836, 36, 1, mode="host") == "host"
    assert choose_scan_backend(2794, 64, 16, mode="device") == "device"


def test_model_reproduces_calibration():
    # the model's device rates must reproduce the measured probe shape
    # (best orientation: state-contracted for realistic S, +1 select tile)
    assert device_count_bps(440, 36) == DEVICE_TILE_BPS / 5
    assert device_count_bps(836, 36) == DEVICE_TILE_BPS / 8
    assert device_count_bps(213, 31) == DEVICE_TILE_BPS / 3
    # the class-contracted orientation still wins when C >> S
    assert device_count_bps(23, 221) == DEVICE_TILE_BPS / (2 * 1 + 1)
    assert host_count_bps(1) == HOST_SINGLE_BPS
    assert host_count_bps(4) == HOST_MULTI_BPS


def test_speculative_single_stream_host_path(big_matcher):
    """Single big streams through the host backend take the speculative
    segmented walk and stay bit-exact vs the device engine."""
    import numpy as np

    data = (b"zz error0031 .. warning099 ... fail3ure " * 2000)
    host = _force(big_matcher, "host")
    dev = _force(big_matcher, "device")
    rh, rd = host.scan(data), dev.scan(data)
    assert rh.metrics.engine == "dfa-host-native"
    np.testing.assert_array_equal(rh.counts, rd.counts)
    assert host.count(data) == dev.count(data) == rd.total


@pytest.fixture(scope="module")
def big_matcher():
    # the S=836 AC automaton from the bench sweep — above every gate
    words = [w % i for i in range(300)
             for w in (b"error%04d", b"warning%03d", b"GET /path%d HTTP",
                       b"user-agent: bot%d", b"fail%dure")]
    m = api.compile_literals(words[:300])
    assert m.num_states == 836
    return m


def _force(m, backend: str):
    cfg = dataclasses.replace(m.config, scan_backend=backend)
    import copy

    m2 = copy.copy(m)
    m2.config = cfg
    return m2


@pytest.mark.skipif(not native_available(), reason="native lib required")
def test_host_path_bit_exact_vs_device(big_matcher):
    rng = np.random.default_rng(3)
    frag = (b"xxerror0031yy warning099 GET /path7 HTTP fail3ure "
            b"user-agent: bot5 ")
    streams = [
        np.frombuffer((frag * 40)[:n], np.uint8).copy()
        for n in (0, 1, 977, 1024, 1999)
    ] + [rng.integers(0, 256, 4096, dtype=np.uint8).view(np.uint8)]
    host = _force(big_matcher, "host")
    dev = _force(big_matcher, "device")
    rh = host.scan(streams)
    rd = dev.scan(streams)
    assert rh.metrics.engine == "dfa-host-native"
    assert rd.metrics.engine != "dfa-host-native"
    np.testing.assert_array_equal(rh.counts, rd.counts)
    assert rh.total == rd.total
    assert host.count(streams) == dev.count(streams) == rd.total


@pytest.mark.skipif(not native_available(), reason="native lib required")
def test_auto_routing_and_host_positions(big_matcher):
    data = b"..error0031.." * 50
    # S=836 routes host for both stream shapes under the static priors
    r = big_matcher.scan(data)
    assert r.metrics.engine == "dfa-host-native"
    assert big_matcher._host_backend(1)
    # forced host: the positions path matches the device mask scan
    host = _force(big_matcher, "host")
    rp = host.scan(data, collect_positions=True)
    assert rp.metrics.engine == "dfa-host-native"
    rd = _force(big_matcher, "device").scan(data, collect_positions=True)
    np.testing.assert_array_equal(rp.counts, rd.counts)
    np.testing.assert_array_equal(
        rp.match_positions[0], rd.match_positions[0]
    )


def test_small_automata_stay_on_device():
    m = api.compile_regex(rb"[0-9]+\.[0-9]+")
    assert not m._host_backend(1)
    r = m.scan(b"pi=3.14")
    assert r.metrics.engine in ("dfa-fast", "dfa-fast-batch")


@pytest.fixture(autouse=True)
def _fresh_router_session():
    """Probe results are cached process-wide; isolate every test."""
    from regex_fpga_tpu.ops import router

    router.reset_session()
    yield
    router.reset_session()


def test_probe_cache_and_measured_decisions(big_matcher, monkeypatch):
    """r5 verdict item 1: the first contested call probes both engines
    once, caches the measured rates process-wide, and routes on them;
    later calls reuse the cache; forced modes and sub-threshold
    workloads never probe."""
    from regex_fpga_tpu.ops import router

    calls = {"host": 0, "dev": 0}

    def fake_host(tables, n):
        calls["host"] += 1
        router.record_host_rate(n, 2.0e9)
        return 2.0e9

    def fake_dev(tables, *a):
        calls["dev"] += 1
        router.record_device_rate(
            tables.num_states, tables.num_classes, 0.5e9)
        return 0.5e9

    monkeypatch.setattr(router, "probe_host", fake_host)
    monkeypatch.setattr(router, "probe_device", fake_dev)
    dts = big_matcher.tables
    # workload below threshold: static prior, no probe
    router.choose_scan_backend(dts.num_states, dts.num_classes, 16,
                               tables=dts, workload_bytes=1)
    assert calls == {"host": 0, "dev": 0}
    # forced mode: never probes
    router.choose_scan_backend(dts.num_states, dts.num_classes, 16,
                               mode="device", tables=dts,
                               workload_bytes=router.PROBE_MIN_WORKLOAD)
    assert calls == {"host": 0, "dev": 0}
    # big contested workload: both probes fire, measured host (2.0) wins
    got = router.choose_scan_backend(
        dts.num_states, dts.num_classes, 16,
        tables=dts, workload_bytes=router.PROBE_MIN_WORKLOAD)
    assert got == "host" and calls == {"host": 1, "dev": 1}
    # second call: cached — no new probes, same decision
    got = router.choose_scan_backend(
        dts.num_states, dts.num_classes, 16,
        tables=dts, workload_bytes=router.PROBE_MIN_WORKLOAD)
    assert got == "host" and calls == {"host": 1, "dev": 1}
    # measured rates flow through the public model functions
    assert router.host_count_bps(16) == 2.0e9
    # tile normalization: the recorded observation reproduces at its own
    # (S, C) point
    assert router.device_count_bps(
        dts.num_states, dts.num_classes) == pytest.approx(0.5e9)
    # a flipped measurement flips the decision
    router.reset_session()
    monkeypatch.setattr(
        router, "probe_host",
        lambda t, n: (router.record_host_rate(n, 0.1e9), 0.1e9)[1])
    monkeypatch.setattr(
        router, "probe_device",
        lambda t, *a: (router.record_device_rate(
            t.num_states, t.num_classes, 3.0e9), 3.0e9)[1])
    got = router.choose_scan_backend(
        dts.num_states, dts.num_classes, 16,
        tables=dts, workload_bytes=router.PROBE_MIN_WORKLOAD)
    assert got == "device"


def test_probe_outside_band_uses_prior(big_matcher, monkeypatch):
    from regex_fpga_tpu.ops import router

    boom = lambda *a, **k: (_ for _ in ()).throw(AssertionError("probed"))
    monkeypatch.setattr(router, "probe_host", boom)
    monkeypatch.setattr(router, "probe_device", boom)
    # S outside the contested band: no probe even at huge workloads
    assert router.choose_scan_backend(
        23, 221, 64, tables=big_matcher.tables,
        workload_bytes=1 << 40) == "device"
    assert router.choose_scan_backend(
        2794, 64, 16, tables=big_matcher.tables,
        workload_bytes=1 << 40) == "host"


@pytest.mark.skipif(not native_available(), reason="native lib required")
def test_real_probes_smoke(big_matcher, monkeypatch):
    """The actual probe machinery runs end-to-end (tiny sizes, CPU) and
    caches plausible positive rates."""
    from regex_fpga_tpu.ops import router

    monkeypatch.setattr(router, "PROBE_HOST_BYTES", 1 << 16)
    monkeypatch.setattr(router, "PROBE_DEVICE_BYTES", 1 << 16)
    monkeypatch.setattr(router, "PROBE_DEVICE_BLOCKS", 64)
    hb = router.probe_host(big_matcher.tables, 16)
    db = router.probe_device(big_matcher.tables)
    assert hb > 0 and db > 0
    sr = router.session_rates()
    assert set(sr) == {"host_multi_bps", "device_tile_bps"}
    # the cached tile rate reproduces the probed rate at the probe's (S, C)
    t = big_matcher.tables
    assert router.device_count_bps(
        t.num_states, t.num_classes) == pytest.approx(db)
    # cached: a second probe returns the same number without re-measuring
    assert router.probe_host(big_matcher.tables, 16) == hb
    assert router.probe_device(big_matcher.tables) == db


def test_device_margin_in_probed_band(big_matcher, monkeypatch):
    """Once probed, the contested band requires the device to clear the
    measured model-bias margin (DEVICE_MARGIN): near-parity routes host
    (rig-stable, cache-favorable on real traffic)."""
    from regex_fpga_tpu.ops import router

    monkeypatch.setattr(
        router, "probe_host",
        lambda t, n, *a: (router.record_host_rate(n, 1.0e9), 1.0e9)[1])
    monkeypatch.setattr(
        router, "probe_device",
        lambda t, *a: (router.record_device_rate(
            t.num_states, t.num_classes, 1.1e9), 1.1e9)[1])
    dts = big_matcher.tables
    got = router.choose_scan_backend(
        dts.num_states, dts.num_classes, 16,
        tables=dts, workload_bytes=router.PROBE_MIN_WORKLOAD)
    assert got == "host"  # 1.1 < 1.25 * 1.0
    # a clear device win still routes device
    router.reset_session()
    router.record_host_rate(16, 1.0e9)
    router.record_device_rate(dts.num_states, dts.num_classes, 1.5e9)
    got = router.choose_scan_backend(dts.num_states, dts.num_classes, 16)
    assert got == "device"
