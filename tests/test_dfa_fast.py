"""Fast (one-hot GEMM) DFA engine vs serial oracle + convergence handling."""

import numpy as np
import jax.numpy as jnp
import pytest

from regex_fpga_tpu.ops import build_dfa_tables, dfa_scan_serial
from regex_fpga_tpu.ops.dfa_fast import dfa_scan_fast

from conftest import random_dfa_table


@pytest.mark.parametrize("seed,num_blocks", [(0, 8), (1, 16), (2, 64), (3, 1)])
def test_fast_vs_serial(seed, num_blocks):
    rng = np.random.default_rng(seed)
    table, accept = random_dfa_table(rng, 48, 6)
    dt = build_dfa_tables(table, accept)
    stream = rng.integers(0, 256, size=4096).astype(np.uint8)
    classes = np.asarray(dt.class_of)[stream]
    res = dfa_scan_fast(dt, jnp.asarray(classes), num_blocks=num_blocks)
    ser = dfa_scan_serial(dt, jnp.asarray(stream))
    assert bool(res.converged)
    assert int(res.final_state) == int(ser.final_state)
    np.testing.assert_array_equal(np.asarray(res.match_mask), np.asarray(ser.match_mask))
    counts = np.bincount(
        np.asarray(res.states)[np.asarray(res.match_mask)], minlength=dt.num_states
    )
    np.testing.assert_array_equal(counts, np.asarray(ser.counts))


def test_nonconvergence_flagged_and_recoverable():
    """Parity automaton with odd blocks: Jacobi needs NB iterations; a low
    budget must flag non-convergence instead of returning silent garbage."""
    ptable = np.zeros((256, 2), dtype=np.int32)
    ptable[:, 0] = 1
    pt = build_dfa_tables(ptable, np.zeros(2, bool))
    stream = np.zeros(127 * 8, np.int64)
    low = dfa_scan_fast(pt, jnp.asarray(stream), num_blocks=8, max_iters=4)
    assert not bool(low.converged)
    high = dfa_scan_fast(pt, jnp.asarray(stream), num_blocks=8, max_iters=16)
    assert bool(high.converged)
    ser = dfa_scan_serial(pt, jnp.asarray(np.zeros(127 * 8, np.uint8)))
    assert int(high.final_state) == int(ser.final_state)


def test_nonzero_start_state(rng):
    table, accept = random_dfa_table(rng, 32, 3)
    dt = build_dfa_tables(table, accept)
    stream = rng.integers(0, 256, size=2048).astype(np.uint8)
    classes = np.asarray(dt.class_of)[stream]
    res = dfa_scan_fast(dt, jnp.asarray(classes), num_blocks=16, start=5)
    ser = dfa_scan_serial(dt, jnp.asarray(stream), start=5)
    assert bool(res.converged)
    np.testing.assert_array_equal(np.asarray(res.match_mask), np.asarray(ser.match_mask))


def test_speculation_single_pass(rng):
    """Synchronizing input: overlap speculation must verify on the first
    full pass (iterations == 1) and match the serial oracle exactly."""
    table, accept = random_dfa_table(rng, 48, 6)
    dt = build_dfa_tables(table, accept)
    stream = rng.integers(0, 256, size=8192).astype(np.uint8)
    classes = np.asarray(dt.class_of)[stream]
    res = dfa_scan_fast(dt, jnp.asarray(classes), num_blocks=32)
    assert bool(res.converged)
    assert int(res.iterations) == 1  # speculation verified, no Jacobi
    ser = dfa_scan_serial(dt, jnp.asarray(stream))
    np.testing.assert_array_equal(
        np.asarray(res.match_mask), np.asarray(ser.match_mask)
    )


def test_speculation_disabled_matches(rng):
    """overlap=0 reverts to plain Jacobi and stays exact."""
    table, accept = random_dfa_table(rng, 32, 4)
    dt = build_dfa_tables(table, accept)
    stream = rng.integers(0, 256, size=2048).astype(np.uint8)
    classes = np.asarray(dt.class_of)[stream]
    res = dfa_scan_fast(dt, jnp.asarray(classes), num_blocks=16, overlap=0)
    ser = dfa_scan_serial(dt, jnp.asarray(stream))
    assert bool(res.converged)
    assert int(res.final_state) == int(ser.final_state)


def test_domain_guard_flags_corrupt_table(rng):
    """SURVEY.md SS5.2: a corrupted device table is FLAGGED, not silently
    mis-scanned (a one-hot select of an out-of-range target yields state 0
    without the guard)."""
    from regex_fpga_tpu.ops.dfa_fast import dfa_scan_fast_multi, table_domain_ok

    table, accept = random_dfa_table(rng, 16, 3)
    dt = build_dfa_tables(table, accept)
    stream = rng.integers(0, 256, size=4096).astype(np.uint8)
    classes = jnp.asarray(np.asarray(dt.class_of)[stream].astype(np.int32))

    clean = dfa_scan_fast(dt, classes, num_blocks=32)
    assert bool(clean.domain_ok)

    import dataclasses
    bad = dataclasses.replace(dt, table=dt.table.at[0, 0].set(999))
    assert not bool(table_domain_ok(bad))
    res = dfa_scan_fast(bad, classes, num_blocks=32)
    assert not bool(res.domain_ok)
    res_c = dfa_scan_fast(bad, classes, num_blocks=32, emit="counts")
    assert not bool(res_c.domain_ok)
    resm = dfa_scan_fast_multi(
        bad, classes[None, :], num_blocks=32, emit="counts"
    )
    assert not bool(resm.domain_ok)

    neg = dataclasses.replace(dt, table=dt.table.at[1, 2].set(-3))
    assert not bool(dfa_scan_fast(neg, classes, num_blocks=32).domain_ok)


def test_domain_guard_flags_bf16_lossy_table(rng):
    """A table whose values cannot ride losslessly in the matmul dtype is
    flagged even when every id is in range (the bf16 >256 trap)."""
    from regex_fpga_tpu.ops.dfa_fast import mm_dtype, table_domain_ok

    # mm_dtype picks f32 for an unsplit S=300 table, because bf16 would
    # truncate ids 257..299 (the broken contract the guard exists for)
    assert mm_dtype(300) == jnp.float32
    vals = jnp.arange(300, dtype=jnp.int32)
    lossy = jnp.any(vals.astype(jnp.bfloat16).astype(jnp.int32) != vals)
    assert bool(lossy)  # 257..300 do truncate in bf16
    table = np.zeros((256, 300), dtype=np.int64)
    table[:] = np.arange(300)[None, :]  # identity-ish, ids up to 299
    accept = np.zeros(300, dtype=bool)
    dt = build_dfa_tables(table, accept)
    # guard passes because mm_dtype(300) is f32 (lossless)
    assert bool(table_domain_ok(dt))


def test_split_state_encoding_exact(rng):
    """Byte-split bf16 tables (the rule's choice for 256 < S <= 2^16) ==
    serial scan: T = 256*Th + Tl recombination is exact."""
    import regex_fpga_tpu.ops.dfa_fast as df
    from regex_fpga_tpu.ops import dfa_scan_serial

    table, accept = random_dfa_table(rng, 501, 12)
    dt = build_dfa_tables(table, accept)
    assert df.step_plan(dt.num_classes, dt.num_states).encoding == "split"
    stream = rng.integers(0, 256, size=64 * 32).astype(np.uint8)
    classes = jnp.asarray(np.asarray(dt.class_of)[stream])
    res = df.dfa_scan_fast(dt, classes, num_blocks=32)
    ser = dfa_scan_serial(dt, jnp.asarray(stream))
    assert bool(res.converged) and bool(res.domain_ok)
    assert int(res.final_state) == int(ser.final_state)
    np.testing.assert_array_equal(
        np.asarray(res.match_mask), np.asarray(ser.match_mask)
    )
    rc = df.dfa_scan_fast(dt, classes, num_blocks=32, emit="counts")
    np.testing.assert_array_equal(np.asarray(rc.counts), np.asarray(ser.counts))


def test_split_state_kgram_exact(rng):
    """Byte-split [Tl|Th|A] k-gram step (S > 256) == serial totals."""
    import regex_fpga_tpu.ops.dfa_fast as df
    from regex_fpga_tpu.ops import dfa_scan_serial
    from regex_fpga_tpu.ops.kgram import (
        build_kgram, dfa_scan_kgram, map_kgram_classes,
    )

    table, accept = random_dfa_table(rng, 347, 20)
    table = table[np.arange(256) % 7]  # few byte classes -> kgram viable
    dt = build_dfa_tables(table, accept)
    assert df.split_states(dt.num_states)
    kg = build_kgram(dt, levels=2, max_classes=1 << 16)
    assert kg is not None
    stream = rng.integers(0, 256, size=16 * 64 * kg.k).astype(np.uint8)
    ck = map_kgram_classes(kg, stream)
    res = dfa_scan_kgram(
        jnp.asarray(kg.table), jnp.asarray(kg.acc_table), jnp.asarray(ck),
        num_blocks=16,
    )
    ser = dfa_scan_serial(dt, jnp.asarray(stream))
    assert bool(res.converged)
    assert int(res.total) == int(np.asarray(ser.counts).sum())
    assert int(res.final_state) == int(ser.final_state)


def test_split_state_multi_stream_exact(rng):
    """Byte-split encoding through the multi-stream batch engine ==
    per-stream serial scans."""
    import regex_fpga_tpu.ops.dfa_fast as df
    from regex_fpga_tpu.ops import dfa_scan_serial

    table, accept = random_dfa_table(rng, 333, 9)
    dt = build_dfa_tables(table, accept)
    assert df.split_states(dt.num_states)
    streams = rng.integers(0, 256, size=(3, 1024)).astype(np.uint8)
    classes = jnp.asarray(np.asarray(dt.class_of)[streams])
    res = df.dfa_scan_fast_multi(dt, classes, num_blocks=8, emit="counts")
    assert bool(res.converged) and bool(res.domain_ok)
    for i in range(3):
        ser = dfa_scan_serial(dt, jnp.asarray(streams[i]))
        assert int(res.final_states[i]) == int(ser.final_state)
        np.testing.assert_array_equal(
            np.asarray(res.counts[i]), np.asarray(ser.counts)
        )


def test_mask_positions_unit(rng):
    """Direct contract check of the device compaction kernel: positions ==
    nonzero(mask), count == popcount, overflow drops silently (caller's
    density cutoff handles it), empty and full masks behave."""
    import jax.numpy as jnp
    from regex_fpga_tpu.ops.dfa_fast import mask_positions

    for n, p in ((1, 0.5), (256, 0.0), (256, 1.0), (1024, 0.03), (4096, 0.2)):
        mask = rng.random(n) < p
        cap = max(8, n // 2)
        pos, count = mask_positions(jnp.asarray(mask), cap)
        want = np.nonzero(mask)[0]
        assert int(count) == len(want)
        take = min(len(want), cap)
        np.testing.assert_array_equal(np.asarray(pos)[:take], want[:take])


def test_transposed_step_decision():
    """Orientation chooser (r4): contract over the LARGER index dimension
    so the GEMM pads fewer tiles and the rows intermediate stays narrow."""
    import regex_fpga_tpu.ops.dfa_fast as df

    assert df.transposed_step(36, 836)      # 7 tiles vs 14, rows 2C vs 2S
    assert df.transposed_step(34, 440)      # 4 vs 7
    assert df.transposed_step(12, 501)
    assert not df.transposed_step(221, 23)  # tokenizer: C >> S
    # GEMM-tile ties break on the narrower rows intermediate
    assert df.transposed_step(31, 213)      # 2 vs 2 tiles; rows 31 vs 426
    assert not df.transposed_step(128, 128)  # true tie: keep original


def test_transposed_vs_original_orientation_exact(rng):
    """Both GEMM orientations produce bit-identical scans (forced via an
    explicit StepPlan), across the f32 and byte-split encodings."""
    import regex_fpga_tpu.ops.dfa_fast as df
    from regex_fpga_tpu.ops import dfa_scan_serial

    table, accept = random_dfa_table(rng, 391, 17)
    dt = build_dfa_tables(table, accept)
    stream = rng.integers(0, 256, size=64 * 32).astype(np.uint8)
    classes = jnp.asarray(np.asarray(dt.class_of)[stream])
    ser = dfa_scan_serial(dt, jnp.asarray(stream))
    for encoding in ("f32", "split"):
        results = []
        for forced in (True, False):
            plan = df.StepPlan(encoding, forced)
            res = df.dfa_scan_fast(dt, classes, num_blocks=32,
                                   emit="counts", plan=plan)
            assert bool(res.converged) and bool(res.domain_ok)
            assert int(res.final_state) == int(ser.final_state)
            np.testing.assert_array_equal(
                np.asarray(res.counts), np.asarray(ser.counts)
            )
            results.append(np.asarray(res.counts))
        np.testing.assert_array_equal(*results)


def _decode_step_table(st, num_states: int) -> np.ndarray:
    """Invert ``_step_tables``' encoding back to the (C, S) id table."""
    t = np.asarray(st.t.astype(jnp.float32)).astype(np.int64)
    if st.split:
        half = t.shape[1] // 2
        t = t[:, :half] + 256 * t[:, half:]
    return t.T if st.transposed else t


@pytest.mark.parametrize("s", [23, 256, 257, 440, 836, 65536, 65537])
def test_exactness_rule_round_trips_ids(s, monkeypatch):
    """The encoding the rule picks for S states carries every id 0..S-1
    exactly through the GEMM operand dtype, and the choice reads only the
    value range: it is the same whatever backend JAX reports."""
    import jax

    import regex_fpga_tpu.ops.dfa_fast as df
    from regex_fpga_tpu.ops.tables import DfaTables

    want = "bf16" if s <= 256 else ("split" if s <= 65536 else "f32")
    choices = set()
    for backend in ("cpu", "gpu", "rocm"):
        monkeypatch.setattr(jax, "default_backend", lambda b=backend: b)
        choices.add((df.table_encoding(s), df.split_states(s),
                     str(jnp.dtype(df.mm_dtype(s)))))
    assert len(choices) == 1
    assert df.table_encoding(s) == want
    ids = np.arange(s, dtype=np.int32)
    dt = DfaTables(
        table=jnp.asarray(ids.reshape(1, s)),
        accept=jnp.zeros((s,), bool),
        class_of=jnp.zeros((256,), jnp.int32),
        num_states=s,
    )
    st = df._step_tables(dt)
    np.testing.assert_array_equal(_decode_step_table(st, s)[0], ids)
    assert bool(df.table_domain_ok(dt))


def _dot_generals(jaxpr, out):
    """Every dot_general eqn in a jaxpr, nested jaxprs (scan, while, cond,
    pjit bodies) included."""
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            out.append(eqn)
        for v in eqn.params.values():
            for x in (v if isinstance(v, (tuple, list)) else (v,)):
                sub = getattr(x, "jaxpr", x)  # ClosedJaxpr -> Jaxpr
                if hasattr(sub, "eqns"):
                    _dot_generals(sub, out)
    return out


@pytest.mark.parametrize("s", [23, 300, 70000])
def test_every_f32_one_hot_dot_is_highest(s, rng):
    """An f32 dot without an explicit precision may run as TF32 on the GPU
    (exact only to 2,048): every f32-operand dot_general the fast and
    k-gram engines emit must carry Precision.HIGHEST."""
    import jax

    from regex_fpga_tpu.ops.dfa_fast import StepPlan, dfa_scan_fast
    from regex_fpga_tpu.ops.kgram import dfa_scan_kgram
    from regex_fpga_tpu.ops.tables import DfaTables

    c = 4
    table = jnp.asarray(rng.integers(0, s, size=(c, s), dtype=np.int32))
    dt = DfaTables(table=table, accept=jnp.zeros((s,), bool),
                   class_of=jnp.zeros((256,), jnp.int32),
                   num_states=s)
    classes = jnp.zeros((64,), jnp.int32)
    traced = [
        jax.make_jaxpr(lambda t, x, e=emit: dfa_scan_fast(
            t, x, num_blocks=8, emit=e))(dt, classes)
        for emit in ("full", "counts", "mask")
    ]
    traced.append(jax.make_jaxpr(lambda t, x: dfa_scan_fast(
        t, x, num_blocks=8, emit="counts", plan=StepPlan("f32", False)))(
            dt, classes))
    acc = jnp.ones((c, s), jnp.int32)
    for bound in (None, 4):
        traced.append(jax.make_jaxpr(
            lambda t, a, x, b=bound: dfa_scan_kgram(
                t, a, x, num_blocks=8, acc_bound=b))(table, acc, classes))
    seen_f32 = 0
    for closed in traced:
        for eqn in _dot_generals(closed.jaxpr, []):
            dtypes = {str(v.aval.dtype) for v in eqn.invars}
            if "float32" in dtypes:
                seen_f32 += 1
                prec = eqn.params["precision"]
                assert prec is not None and all(
                    p == jax.lax.Precision.HIGHEST for p in prec
                ), (s, prec)
    # the f32 route is exercised: forced at every S, chosen above 2^16
    assert seen_f32 > 0
