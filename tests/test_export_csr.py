"""Regex -> reference-format CSR export (interop with the FPGA design)."""

import os
import re

import numpy as np
import pytest

from regex_fpga_tpu.models import load_coe, nfa_scan
from regex_fpga_tpu.models.export_csr import export_coe, regex_to_csr
from regex_fpga_tpu.ops import build_nfa_tables, nfa_scan_jax


@pytest.mark.parametrize(
    "pat,data",
    [
        (rb"ab+c", b"zabcz abbbc xx abc!"),
        (rb"cat|dog", b"a cat, a dog, a catdog!"),
        (rb"[0-9]{3}", b"x123 45 6789 !"),
    ],
)
def test_export_matches_re_count(pat, data):
    aut = regex_to_csr(pat)
    assert aut.accept_mask.sum() >= 1
    # reference semantics: accept entered by the FINAL byte is dropped, so
    # pad one byte like the reference harness's fixed run length would
    padded = np.frombuffer(data + b"\x00", np.uint8)
    counts = nfa_scan(aut, padded)
    # the hub keeps every attempt alive -> OVERLAPPING occurrences, like the
    # shipped rulesets; compare against a lookahead count
    expect = len(re.findall(b"(?=" + pat + b")", data))
    assert int(counts.sum()) == expect


def test_export_coe_roundtrip(tmp_path):
    path = str(tmp_path / "rule.coe")
    aut = export_coe(rb"ab+c", path)
    aut2 = load_coe(path)
    data = np.frombuffer(b"zabc abbbc abcd!", np.uint8)
    np.testing.assert_array_equal(nfa_scan(aut, data), nfa_scan(aut2, data))


def test_exported_ruleset_runs_on_tpu_engine(tmp_path):
    """Full circle: our compiler -> reference format -> our device engine."""
    import jax.numpy as jnp

    path = str(tmp_path / "rule.coe")
    export_coe(rb"cat|dog", path)
    aut = load_coe(path)
    t = build_nfa_tables(aut)
    data = np.frombuffer(b"a cat and a dog and a cat!", np.uint8)
    res = nfa_scan_jax(t, jnp.asarray(data))
    np.testing.assert_array_equal(np.asarray(res.counts), nfa_scan(aut, data))
    assert int(np.asarray(res.counts).sum()) == 3


def test_truncate_flag_required():
    with pytest.raises(ValueError, match="accept states continue"):
        regex_to_csr(rb"a+", truncate_at_accept=False)


def test_determinism():
    """SS5.2: jit purity + integer math make scans bit-deterministic —
    identical inputs give identical outputs across runs."""
    import jax.numpy as jnp

    aut = regex_to_csr(rb"ab|ba")
    t = build_nfa_tables(aut)
    rng = np.random.default_rng(0)
    data = jnp.asarray(rng.integers(0, 256, size=5000).astype(np.uint8))
    a = np.asarray(nfa_scan_jax(t, data).counts)
    b = np.asarray(nfa_scan_jax(t, data).counts)
    np.testing.assert_array_equal(a, b)


def test_regex_set_per_rule_counts():
    """Multi-rule ruleset: per-rule counts equal each pattern's isolated
    single-rule automaton totals (the hub merge is exact)."""
    from regex_fpga_tpu import api
    from regex_fpga_tpu.models.export_csr import regex_to_csr

    patterns = [rb"abc", rb"[0-9][0-9]", rb"x.z"]
    rs = api.compile_regex_set(patterns)
    text = b"abc 12 xyz abc 99 x_z nothing 4 abcd 77"
    data = np.frombuffer(text, dtype=np.uint8)
    got = rs.scan([data]).rule_counts[0]
    for i, p in enumerate(patterns):
        solo = api.compile_ruleset(regex_to_csr(p))
        want = int(solo.scan([data]).counts.sum())
        assert int(got[i]) == want, (p, int(got[i]), want)
    assert got.sum() > 0


def test_regex_set_coe_roundtrip(tmp_path):
    """Exported multi-rule .coe reloads to identical per-rule totals."""
    from regex_fpga_tpu import api

    patterns = [rb"foo+", rb"ba[rz]"]
    rs = api.compile_regex_set(patterns)
    path = str(tmp_path / "ruleset.coe")
    rs.export_coe(path)
    reloaded = api.compile_ruleset(path)
    text = b"foo bar foooo baz barbar"
    data = np.frombuffer(text, dtype=np.uint8)
    a = rs.scan([data]).report.counts
    b = reloaded.scan([data]).counts
    np.testing.assert_array_equal(a, b)


def test_mixed_anchored_ruleset_partitions():
    """Mixed ^-anchored + unanchored rule sets scan correctly via two CSR
    partitions (one shared hub would re-fire anchored rules every byte)."""
    import numpy as np

    from regex_fpga_tpu.api import compile_regex_set

    rs = compile_regex_set([rb"abc", rb"^xy", rb"b+c", rb"^q[0-9]"])
    assert rs.num_rules == 4 and rs.automaton is None
    rep = rs.scan([b"xyabc q7", b"q7 xy abbc!"])
    # stream 0: abc at 2 (1), ^xy fires (1), b+c ends at abc's c (1), ^q no
    np.testing.assert_array_equal(rep.rule_counts[0], [1, 1, 1, 0])
    # stream 1: ^q7 fires; xy not at start; abbc: b+c fires (the trailing
    # '!' matters — accepts entered by the FINAL byte are dropped, the
    # reference's harness-stop semantics); abc absent
    np.testing.assert_array_equal(rep.rule_counts[1], [0, 0, 1, 1])
    with pytest.raises(ValueError, match="mixed"):
        rs.export_coe("/tmp/should_not_exist.coe")


def test_pure_ruleset_still_single_automaton(tmp_path):
    from regex_fpga_tpu.api import compile_regex_set

    rs = compile_regex_set([rb"abc", rb"b+c"])
    assert rs.automaton is not None
    rs.export_coe(str(tmp_path / "ok.coe"))
