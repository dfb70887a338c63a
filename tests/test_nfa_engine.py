"""NFA engine vs golden oracle: random automata, real rulesets, resume, batch."""

import numpy as np
import jax.numpy as jnp
import pytest

from regex_fpga_tpu.models import nfa_scan
from regex_fpga_tpu.ops import build_nfa_tables, nfa_scan_batch, nfa_scan_jax
from regex_fpga_tpu.utils import load_ruleset, load_trace_pair

from conftest import random_nfa


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_random_nfa_vs_oracle(seed):
    rng = np.random.default_rng(seed)
    aut = random_nfa(rng, n_states=50, n_edges=400, n_accept=5)
    t = build_nfa_tables(aut)
    stream = rng.integers(0, 256, size=2000).astype(np.uint8)
    res = nfa_scan_jax(t, jnp.asarray(stream), active_bound=64)
    assert not bool(res.overflowed)
    np.testing.assert_array_equal(np.asarray(res.counts), nfa_scan(aut, stream))


def test_overflow_detected(rng):
    # a dense NFA whose active set exceeds a tiny bound must flag, not drop:
    # concentrate all edges on a 2-byte alphabet so the frontier grows fast
    from regex_fpga_tpu.models import CsrAutomaton

    n, per_state = 40, 6
    chars = rng.integers(0, 2, size=n * per_state)
    targets = rng.integers(0, n, size=n * per_state)
    aut = CsrAutomaton(
        offsets=np.arange(n + 1, dtype=np.int64) * per_state,
        trans_char=chars.astype(np.uint8),
        trans_target=targets.astype(np.int32),
    )
    t = build_nfa_tables(aut)
    stream = rng.integers(0, 2, size=50).astype(np.uint8)
    res = nfa_scan_jax(t, jnp.asarray(stream), active_bound=4)
    assert bool(res.overflowed)


@pytest.mark.parametrize("name", ["l-7_filter", "snort_16"])
def test_ruleset_prefix_vs_oracle(reference_available, name):
    aut = load_ruleset(name)
    t = build_nfa_tables(aut)
    lo, hi = load_trace_pair(name, limit=10_000)
    for stream in (lo, hi):
        res = nfa_scan_jax(t, jnp.asarray(stream))
        assert not bool(res.overflowed)
        np.testing.assert_array_equal(np.asarray(res.counts), nfa_scan(aut, stream))


def test_chunked_resume_equals_single_scan(reference_available):
    """The checkpoint carry (active list + counts) is exact across chunk cuts."""
    aut = load_ruleset("l-7_filter")
    t = build_nfa_tables(aut)
    lo, _ = load_trace_pair("l-7_filter", limit=6_000)
    whole = nfa_scan_jax(t, jnp.asarray(lo))
    r1 = nfa_scan_jax(t, jnp.asarray(lo[:2_500]))
    r2 = nfa_scan_jax(
        t,
        jnp.asarray(lo[2_500:]),
        start_active=r1.final_active,
        counts_init=jnp.concatenate([r1.counts, jnp.zeros(1, jnp.int32)]),
    )
    np.testing.assert_array_equal(np.asarray(r2.counts), np.asarray(whole.counts))
    np.testing.assert_array_equal(np.asarray(r2.final_active), np.asarray(whole.final_active))


def test_batch_matches_per_stream(reference_available):
    """The batch axis generalizes the reference's dual-stream mode exactly."""
    aut = load_ruleset("l-7_filter")
    t = build_nfa_tables(aut)
    lo, hi = load_trace_pair("l-7_filter", limit=5_000)
    batch = jnp.stack([jnp.asarray(lo), jnp.asarray(hi)])
    res = nfa_scan_batch(t, batch)
    np.testing.assert_array_equal(np.asarray(res.counts[0]), nfa_scan(aut, lo))
    np.testing.assert_array_equal(np.asarray(res.counts[1]), nfa_scan(aut, hi))


@pytest.mark.slow
@pytest.mark.parametrize("name", ["l-7_filter", "snort_16"])
def test_full_conformance(reference_available, name):
    """The four-trace bit-exact gate (SURVEY.md SS4.2) through the device engine."""
    aut = load_ruleset(name)
    t = build_nfa_tables(aut)
    lo, hi = load_trace_pair(name)
    res = nfa_scan_batch(t, jnp.stack([jnp.asarray(lo), jnp.asarray(hi)]))
    assert not bool(res.overflowed.any())
    np.testing.assert_array_equal(np.asarray(res.counts[0]), nfa_scan(aut, lo))
    np.testing.assert_array_equal(np.asarray(res.counts[1]), nfa_scan(aut, hi))
