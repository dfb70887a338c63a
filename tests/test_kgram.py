"""k-gram precomposed throughput-mode scanning."""

import numpy as np
import jax.numpy as jnp
import pytest

from regex_fpga_tpu.models import build_tokenizer_dfa
from regex_fpga_tpu.ops import build_dfa_tables, dfa_scan_serial
from regex_fpga_tpu.ops.kgram import build_kgram, dfa_scan_kgram, map_kgram_classes

from conftest import random_dfa_table


@pytest.mark.parametrize("levels", [1, 2, 3])
def test_kgram_tokenizer_totals_exact(levels):
    tok = build_tokenizer_dfa()
    dt = build_dfa_tables(tok.table, tok.accept)
    kg = build_kgram(dt, levels=levels)
    assert kg is not None and kg.k == 1 << levels
    text = (b"Hello world, it's 2026! k-gram test 12.5% ... " * 200)[:8192]
    data = np.frombuffer(text, np.uint8)
    ck = map_kgram_classes(kg, data)
    assert len(ck) == len(data) // kg.k
    res = dfa_scan_kgram(
        jnp.asarray(kg.table), jnp.asarray(kg.acc_table), jnp.asarray(ck),
        num_blocks=32, start=tok.start,
    )
    ser = dfa_scan_serial(dt, jnp.asarray(data), start=tok.start)
    assert bool(res.converged)
    assert int(res.total) == int(np.asarray(ser.counts).sum())
    assert int(res.final_state) == int(ser.final_state)


def test_kgram_random_dfa(rng):
    table, accept = random_dfa_table(rng, 12, 3)
    dt = build_dfa_tables(table, accept)
    kg = build_kgram(dt, levels=1, max_classes=200_000)
    stream = rng.integers(0, 256, size=2048).astype(np.uint8)
    ck = map_kgram_classes(kg, stream)
    res = dfa_scan_kgram(
        jnp.asarray(kg.table), jnp.asarray(kg.acc_table), jnp.asarray(ck),
        num_blocks=16,
    )
    ser = dfa_scan_serial(dt, jnp.asarray(stream))
    assert int(res.total) == int(np.asarray(ser.counts).sum())
    assert int(res.final_state) == int(ser.final_state)


def test_kgram_blowup_guard(rng):
    table, accept = random_dfa_table(rng, 64, 4)
    dt = build_dfa_tables(table, accept)
    assert build_kgram(dt, levels=2, max_classes=512) is None


def test_kgram_speculation_fallback_mod3():
    """Mod-3 counter (never synchronizes) with block length not divisible
    by 3: speculation must fail and the Jacobi fallback must still produce
    the exact total."""
    import jax.numpy as jnp

    ptable = np.zeros((256, 3), dtype=np.int32)
    for s in range(3):
        ptable[:, s] = (s + 1) % 3
    pt = build_dfa_tables(ptable, np.array([False, True, False]))
    kg = build_kgram(pt, levels=1)
    stream = np.zeros(4 * 26, np.uint8)  # 26 bytes/block, 26 % 3 != 0
    ck = map_kgram_classes(kg, stream)
    res = dfa_scan_kgram(
        jnp.asarray(kg.table), jnp.asarray(kg.acc_table), jnp.asarray(ck),
        num_blocks=4, max_iters=16,
    )
    assert bool(res.converged)
    assert int(res.iterations) > 1  # speculation could not verify
    from regex_fpga_tpu.ops import dfa_scan_serial
    ser = dfa_scan_serial(pt, jnp.asarray(stream))
    assert int(res.total) == int(np.asarray(ser.counts).sum())


@pytest.mark.parametrize("s_states,levels,packed", [
    (48, 1, True),    # (47)*4 + 2 = 190 <= 256: packed bf16
    (100, 2, False),  # (99)*8 + 4 = 796 > 256: unpacked tables
])
def test_kgram_packed_limit_follows_exactness_rule(rng, s_states, levels,
                                                    packed):
    """The packed T*mult+A route is taken only while packed values stay
    bf16-exact (dfa_fast.table_encoding); either route is exact."""
    import jax
    import jax.numpy as jnp

    from regex_fpga_tpu.ops import dfa_scan_serial
    from regex_fpga_tpu.ops.kgram import make_kgram_step

    table, accept = random_dfa_table(rng, s_states, 6)
    table = table[np.arange(256) % 5]  # few byte classes -> kgram viable
    dt = build_dfa_tables(table, accept)
    kg = build_kgram(dt, levels=levels, max_classes=100_000)
    assert kg is not None
    tj, aj = jnp.asarray(kg.table), jnp.asarray(kg.acc_table)
    step = make_kgram_step(tj, aj, acc_bound=kg.k)
    jaxpr = jax.make_jaxpr(step)(jnp.zeros((4,), jnp.int32),
                                 jnp.zeros((4,), jnp.int32))
    dots = [e for e in jaxpr.jaxpr.eqns if e.primitive.name == "dot_general"]
    assert len(dots) == 1
    width = dots[0].invars[1].aval.shape[1]
    assert width == (s_states if packed else 2 * s_states)
    # the table operand is encoded in bf16 (widened to f32 only at the
    # dot on the CPU backend, dfa_fast.one_hot_dot)
    assert any(str(v.aval.dtype) == "bfloat16"
               for e in jaxpr.jaxpr.eqns for v in e.outvars)
    stream = rng.integers(0, 256, size=8 * 64 * kg.k).astype(np.uint8)
    ck = jnp.asarray(map_kgram_classes(kg, stream))
    res = dfa_scan_kgram(tj, aj, ck, num_blocks=8, acc_bound=kg.k)
    ser = dfa_scan_serial(dt, jnp.asarray(stream))
    assert bool(res.converged)
    assert int(res.total) == int(np.asarray(ser.counts).sum())
    assert int(res.final_state) == int(ser.final_state)


def test_kgram_packed_equals_split(rng):
    """acc_bound packed path (one select, T*mult+A) == split tables."""
    import jax.numpy as jnp

    table, accept = random_dfa_table(rng, 48, 6)
    dt = build_dfa_tables(table, accept)
    kg = build_kgram(dt, levels=1, max_classes=100_000)
    stream = rng.integers(0, 256, size=8 * 64 * 4).astype(np.uint8)
    ck = jnp.asarray(map_kgram_classes(kg, stream))
    tj, aj = jnp.asarray(kg.table), jnp.asarray(kg.acc_table)
    split = dfa_scan_kgram(tj, aj, ck, num_blocks=8)
    packed = dfa_scan_kgram(tj, aj, ck, num_blocks=8, acc_bound=kg.k)
    assert int(packed.total) == int(split.total)
    assert int(packed.final_state) == int(split.final_state)


def test_step_cost_routes_and_level_choice():
    """kgram_step_cost models the per-route table widths; the level chooser
    reproduces the measured optima (tokenizer L2; S=836-style split L1)."""
    from regex_fpga_tpu.ops.kgram import choose_kgram_level, kgram_step_cost

    # packed route (S=23, k=4: (22*8+4)=180 <= 256): S-wide, one select
    assert kgram_step_cost(23, 221, 2) == (2 * 1 + 1) / 4
    # unpacked route (S=213, k=4: 212*8+4 > 256): 2S-wide, two selects
    assert kgram_step_cost(213, 335, 2) == (3 * 4 + 2) / 4
    # byte-split route (S=836 > 256): 3S-wide, three selects
    assert kgram_step_cost(836, 175, 1) == (2 * 20 + 3) / 2
    # level 0 = the k=1 counts engine
    assert kgram_step_cost(836, 36, 0) == 1 * 14 + 1
    assert kgram_step_cost(23, 10, 0) == 1 * 1 + 1

    # tokenizer (measured optimum L2: BENCH_r02/r03)
    assert choose_kgram_level(23, [10, 41, 221]) == 2
    # S=836 AC automaton (split: composed classes can't pay 6x20 tiles)
    assert choose_kgram_level(836, [36, 175, 753]) == 1


def test_choose_scan_level_agrees_with_measured_gate():
    """r3 verdict #9: the ENGINE chooser and the API's S-gate are one
    constant — the model must never pick a k-gram level at a size where
    the measured sweep shows k=1 winning (S=213/440/836 all lost in
    BENCH_r03), and must keep the measured k-gram wins below the gate."""
    from regex_fpga_tpu.ops.kgram import (
        KGRAM_MAX_STATES, choose_scan_level,
    )

    # r4 re-measurement: the transposed k=1 engine moved the crossover to
    # the packed-single-select boundary (constant's docstring)
    assert KGRAM_MAX_STATES == 32
    # the tokenizer (S=23, inside the gate) stays k-gram at level 2
    assert choose_scan_level(23, [10, 41, 221]) == 2
    # every size where the r4 sweep measured k=1 winning routes to k=1
    assert choose_scan_level(67, [28, 100, 300]) == 0
    assert choose_scan_level(107, [31, 110, 320]) == 0
    assert choose_scan_level(213, [31, 120, 335]) == 0
    assert choose_scan_level(440, [34, 150, 500]) == 0
    assert choose_scan_level(836, [36, 175, 753]) == 0
    # degenerate inputs: no level info -> k=1
    assert choose_scan_level(23, None) == 0
    assert choose_scan_level(23, []) == 0
    # the api gate and the model share the constant (no drift possible)
    import inspect

    from regex_fpga_tpu import api

    src = inspect.getsource(api.DfaMatcher._kgram)
    assert "KGRAM_MAX_STATES" in src


def test_count_falls_back_to_k1_above_crossover():
    """DfaMatcher.count must use the k=1 counts engine for S > 128 (the
    measured engine crossover) and still equal scan().total."""
    from regex_fpga_tpu import api
    from regex_fpga_tpu.models import build_aho_corasick

    words = [b"error%04d" % i for i in range(40)]
    words += [b"w%darn" % i for i in range(40)] + [b"GET /x"]
    m = api.compile_literals(words)
    assert m.num_states > 128, "fixture must sit above the crossover"
    assert m._kgram() is None
    data = (b"xerror0031yerror0007 GET /x warn " * 97)[:2048]
    assert m.count(data) == m.scan([np.frombuffer(data, np.uint8)]).total


def test_large_s_spans_exact():
    """Span extraction on a >128-state automaton rides the k=1 mask
    engine and stays exact (the pair-composed mask2 alternative was
    pruned in r5 — docs/ENGINE_GRAVEYARD.md)."""
    from regex_fpga_tpu import api

    words = [b"error%04d" % i for i in range(40)] + [b"w%darn" % i
                                                    for i in range(40)]
    m = api.compile_literals(words)
    assert m.num_states > 128
    data = b"..error0007..w3arn..error0031.."
    spans = m.finditer(data)
    got = {(s, e) for s, e, _ in spans} if spans and len(spans[0]) == 3 \
        else {tuple(sp[:2]) for sp in spans}
    for w in (b"error0007", b"w3arn", b"error0031"):
        i = data.find(w)
        assert (i, i + len(w)) in got
