"""Lazy subset determinization: host scan, device loop, exactness, resume."""

import numpy as np
import pytest

from regex_fpga_tpu.models import nfa_scan
from regex_fpga_tpu.models.lazy_dfa import LazyDfa
from regex_fpga_tpu.ops.lazy_scan import lazy_nfa_scan
from regex_fpga_tpu.utils import load_ruleset, load_trace_pair

from conftest import random_nfa


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lazy_host_scan_random(seed):
    rng = np.random.default_rng(seed)
    aut = random_nfa(rng, n_states=40, n_edges=300, n_accept=5)
    ld = LazyDfa(aut)
    stream = rng.integers(0, 256, size=3000).astype(np.uint8)
    counts, _, n = ld.host_scan(stream)
    assert n == 3000
    np.testing.assert_array_equal(counts, nfa_scan(aut, stream))


@pytest.mark.parametrize("seed", [0, 3])
def test_lazy_device_loop_random(seed):
    rng = np.random.default_rng(seed)
    aut = random_nfa(rng, n_states=40, n_edges=300, n_accept=5)
    ld = LazyDfa(aut)
    stream = rng.integers(0, 256, size=20_000).astype(np.uint8)
    st = lazy_nfa_scan(ld, stream, warm_bytes=256, host_step=256, num_blocks=64)
    np.testing.assert_array_equal(st.counts, nfa_scan(aut, stream))


def test_lazy_resume(rng):
    aut = random_nfa(rng, n_states=30, n_edges=250, n_accept=3)
    ld = LazyDfa(aut)
    stream = rng.integers(0, 256, size=8_000).astype(np.uint8)
    s1 = lazy_nfa_scan(ld, stream[:3_000], warm_bytes=128, num_blocks=32)
    s2 = lazy_nfa_scan(ld, stream[3_000:], carry=s1, num_blocks=32)
    np.testing.assert_array_equal(s2.counts, nfa_scan(aut, stream))
    assert s2.offset == 8_000


def test_lazy_reference_prefix(reference_available):
    aut = load_ruleset("l-7_filter")
    ld = LazyDfa(aut)
    lo, hi = load_trace_pair("l-7_filter", limit=20_000)
    for stream in (lo, hi):
        st = lazy_nfa_scan(ld, stream, warm_bytes=2048, num_blocks=256)
        np.testing.assert_array_equal(st.counts, nfa_scan(aut, stream))


@pytest.mark.slow
@pytest.mark.parametrize("name", ["l-7_filter", "snort_16"])
def test_lazy_full_conformance(reference_available, name):
    aut = load_ruleset(name)
    ld = LazyDfa(aut)
    lo, hi = load_trace_pair(name)
    for stream in (lo, hi):
        st = lazy_nfa_scan(ld, stream)
        np.testing.assert_array_equal(st.counts, nfa_scan(aut, stream))


def test_api_lazy_strategy(reference_available):
    import os

    from regex_fpga_tpu import api
    from regex_fpga_tpu.utils import reference_root

    m = api.compile_ruleset(
        os.path.join(reference_root(), "Block_Mem/CSR_BlockMem.coe")
    )
    lo, hi = load_trace_pair("l-7_filter", limit=30_000)
    rep = m.scan([lo, hi])
    assert rep.histogram(0) == {443: 1, 1386: 1}
    assert rep.metrics.engine == "nfa-lazy"


@pytest.mark.parametrize("seed", [0, 1])
def test_host_scan_multi_random(seed):
    """Multi-cursor speculative host scan == oracle on random NFAs."""
    rng = np.random.default_rng(seed)
    aut = random_nfa(rng, n_states=40, n_edges=300, n_accept=5)
    ld = LazyDfa(aut)
    stream = rng.integers(0, 256, size=300_000).astype(np.uint8)
    counts, final, n = ld.host_scan_multi(stream, chunks=16, overlap=64)
    assert n == len(stream)
    np.testing.assert_array_equal(counts, nfa_scan(aut, stream))
    # cross-check the final carry against the serial walk
    _, final_serial, _ = ld.host_scan(stream)
    assert final == final_serial


def test_host_scan_multi_small_falls_back(rng):
    aut = random_nfa(rng, n_states=20, n_edges=120, n_accept=3)
    ld = LazyDfa(aut)
    stream = rng.integers(0, 256, size=500).astype(np.uint8)
    counts, _, n = ld.host_scan_multi(stream)
    assert n == 500
    np.testing.assert_array_equal(counts, nfa_scan(aut, stream))


@pytest.mark.slow
def test_host_scan_multi_l7_conformance():
    """Multi-cursor scan reproduces the reference ground truth bit-exactly."""
    aut = load_ruleset("l-7_filter")
    lo, hi = load_trace_pair("l-7_filter")
    ld = LazyDfa(aut)
    counts, _, _ = ld.host_scan_multi(lo)
    hist = {i: int(c) for i, c in enumerate(counts) if c}
    assert hist == {443: 1, 840: 1, 1109: 1, 1386: 1, 1444: 1, 1670: 1, 2201: 1}
    counts, _, _ = ld.host_scan_multi(hi)
    hist = {i: int(c) for i, c in enumerate(counts) if c}
    assert hist == {443: 3, 1386: 1, 2575: 1}


def test_host_scan_batch_matches_serial(rng):
    """Batch (multi-cursor) scan == per-stream serial scan, bit-exact."""
    aut = random_nfa(rng, n_states=40, n_edges=300, n_accept=5)
    ld = LazyDfa(aut)
    streams = [
        rng.integers(0, 256, size=int(l)).astype(np.uint8)
        for l in (30_000, 17_001, 44_444, 9_999, 25_000, 31_337)
    ]
    counts, finals = ld.host_scan_batch(streams, threads=2)
    for i, s in enumerate(streams):
        ref = np.zeros(aut.num_states, np.int64)
        ref, fin, _ = ld.host_scan(s, None, ref)
        np.testing.assert_array_equal(counts[i], ref)
        assert int(finals[i]) == fin


def test_api_scan_batch_conformance():
    """api.scan on two flows (batch path) == per-stream serial walk, on the
    l7-filter-scale corpus exported to a reference-convention CSR NFA."""
    from regex_fpga_tpu import api
    from regex_fpga_tpu.models.export_csr import regexes_to_csr
    from regex_fpga_tpu.models.l7_corpus import gen_l7_patterns, gen_l7_traffic

    unanchored = [("(?i)" if icase else "") + pat
                  for _, pat, icase, _ in gen_l7_patterns()
                  if not pat.startswith("^")]
    aut, _ = regexes_to_csr(unanchored)
    m = api.compile_ruleset(aut)
    payloads, planted = gen_l7_traffic(n_payloads=120)
    lo = np.frombuffer(b"".join(payloads[:60]), np.uint8)
    hi = np.frombuffer(b"".join(payloads[60:]), np.uint8)
    rep = m.scan([lo, hi])
    assert rep.metrics.engine == "nfa-lazy"
    ser_lo, _, _ = m.lazy_dfa.host_scan(lo)
    ser_hi, _, _ = m.lazy_dfa.host_scan(hi)
    np.testing.assert_array_equal(rep.counts[0], ser_lo)
    np.testing.assert_array_equal(rep.counts[1], ser_hi)
    np.testing.assert_array_equal(rep.counts[0], nfa_scan(aut, lo))
    assert rep.total > 0  # planted protocol samples fire


def test_host_scan_batch_many_streams(rng):
    """>512 streams exceed the native walker's per-call cursor cap; the
    Python side must split groups so every cursor still advances."""
    aut = random_nfa(rng, n_states=20, n_edges=150, n_accept=3)
    ld = LazyDfa(aut)
    streams = [
        rng.integers(0, 256, size=200 + (i % 7)).astype(np.uint8)
        for i in range(530)
    ]
    counts, finals = ld.host_scan_batch(streams, threads=2)
    for i in (0, 263, 529):
        ref = np.zeros(aut.num_states, np.int64)
        ref, fin, _ = ld.host_scan(streams[i], None, ref)
        np.testing.assert_array_equal(counts[i], ref)
        assert int(finals[i]) == fin
