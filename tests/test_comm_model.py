"""Analytic collective-traffic model (parallel/comm_model.py): exactness
of the byte accounting against the shard_map code's shapes, and sanity of
the efficiency projection."""

from regex_fpga_tpu.parallel.comm_model import (
    comm_model_report,
    fast_dist_comm_bytes,
    min_shard_bytes_for_efficiency,
    project_efficiency,
)


def test_byte_accounting_matches_shapes():
    # batch=8 over n_data=2 -> b_loc=4; n_seq=4; overlap=64; iters=2
    c = fast_dist_comm_bytes(8, 1 << 20, 2, 4, overlap=64, iters=2)
    b = c["per_device_bytes"]
    assert b["seam_tail_ppermute"] == 4 * 64 * 4     # b_loc*ov*4
    assert b["finals_ppermute_x_iters"] == 2 * 4 * 4  # iters*b_loc*4
    assert b["counts_psum"] == 2 * (3 / 4) * 4 * 4    # ring allreduce
    assert b["finals_all_gather"] == 3 * 4 * 4        # (n_seq-1)*b_loc*4
    assert c["collective_phases"] == 1 + 2 * 2 + 2
    assert b["total"] == sum(
        v for k, v in b.items() if k != "total"
    )


def test_traffic_is_shard_length_independent():
    c1 = fast_dist_comm_bytes(8, 1 << 20, 2, 4)
    c2 = fast_dist_comm_bytes(8, 1 << 28, 2, 4)
    assert (c1["per_device_bytes"]["total"]
            == c2["per_device_bytes"]["total"])
    # so bytes-per-scanned-byte falls linearly with shard size
    assert c2["bytes_per_scanned_byte"] < c1["bytes_per_scanned_byte"] / 100


#: a per-device compute rate for the projection arithmetic below; the
#: model takes the rate as an argument, so any positive rate exercises it
RATE = 2.0e9


def test_efficiency_projection_monotone():
    c_small = fast_dist_comm_bytes(8, 1 << 18, 2, 4)
    c_big = fast_dist_comm_bytes(8, 1 << 26, 2, 4)
    e_small = project_efficiency(c_small, RATE)["efficiency"]
    e_big = project_efficiency(c_big, RATE)["efficiency"]
    assert e_small < e_big < 1.0
    # 64 MiB shards: >= 99%
    assert e_big > 0.99


def test_min_shard_inverts_projection():
    for target in (0.85, 0.99):
        m = min_shard_bytes_for_efficiency(target, 8, 2, 4, 3 * RATE)
        c = fast_dist_comm_bytes(8, m, 2, 4)
        assert project_efficiency(c, 3 * RATE)["efficiency"] >= target
        c_under = fast_dist_comm_bytes(8, int(m * 0.9), 2, 4)
        assert project_efficiency(c_under, 3 * RATE)["efficiency"] < target


def test_report_shape():
    r = comm_model_report(RATE)
    assert len(r["configs"]) == 5
    assert r["assumptions"]["compute_bps"] == RATE
    for row in r["configs"]:
        assert 0 < row["efficiency"] < 1
    # every 64 MiB config must clear the >=85% target with room
    for row in r["configs"]:
        if row["shard_bytes_per_device"] == 1 << 26:
            assert row["efficiency"] > 0.99
    assert r["min_shard_bytes_eff_85"] < (1 << 22)
    assert r["min_shard_bytes_eff_85"] < r["min_shard_bytes_eff_99"]
    assert ">=85%" in r["statement"]


# ------------------------------------------------------------------
# r4 verdict item 5: the comm model's collective inventory is machine-
# checked against the COMPILED program — if anyone adds a collective to
# dist_scan.py without updating comm_model.py, these tests fail.


def _collect_collectives(jaxpr, in_loop=False, out=None):
    """Walk a (closed) jaxpr recursively; return every collective eqn as
    (primitive, payload_in_bytes, payload_out_bytes, in_while_loop)."""
    import numpy as _np

    if out is None:
        out = []
    jx = getattr(jaxpr, "jaxpr", jaxpr)

    def nbytes(atoms):
        tot = 0
        for v in atoms:
            aval = getattr(v, "aval", None)
            if aval is not None and hasattr(aval, "shape"):
                tot += int(_np.prod(aval.shape, dtype=_np.int64)
                           * _np.dtype(aval.dtype).itemsize)
        return tot

    for eqn in jx.eqns:
        name = eqn.primitive.name
        if name.startswith(("ppermute", "psum", "all_gather",
                            "all_to_all", "reduce_scatter",
                            "all_reduce")):
            out.append((name.split("_invariant")[0],
                        nbytes(eqn.invars), nbytes(eqn.outvars), in_loop))
        child_loop = in_loop or name == "while"
        for p in eqn.params.values():
            vals = p if isinstance(p, (list, tuple)) else [p]
            for sub in vals:
                if hasattr(sub, "eqns") or hasattr(sub, "jaxpr"):
                    _collect_collectives(sub, child_loop, out)
    return out


def _audit(traced_fn, args, batch, n_data, n_seq, overlap, unit_bytes=4):
    """Extract the collective inventory from the traced program and
    re-derive the comm model's per-device byte table from it."""
    import jax

    colls = _collect_collectives(jax.make_jaxpr(traced_fn)(*args))
    b_loc = batch // n_data
    # --- the premise: exactly these collectives, nothing else
    outside = [c for c in colls if not c[3]]
    inside = [c for c in colls if c[3]]
    # outside the fixpoint loop: 1 seam-tail ppermute, 1 counts psum,
    # 1 finals all_gather
    kinds_out = sorted(c[0] for c in outside)
    assert kinds_out == ["all_gather", "ppermute", "psum"], colls
    # inside: 1 finals ppermute + 2 convergence psums (data, seq)
    kinds_in = sorted(c[0] for c in inside)
    assert kinds_in == ["ppermute", "psum", "psum"], colls
    seam = next(c for c in outside if c[0] == "ppermute")
    assert seam[1] == b_loc * overlap * unit_bytes
    it_pp = next(c for c in inside if c[0] == "ppermute")
    assert it_pp[1] == b_loc * unit_bytes
    for c in inside:
        if c[0] == "psum":
            assert c[1] == 4  # scalar int32 convergence flag
    counts_psum = next(c for c in outside if c[0] == "psum")
    assert counts_psum[1] == b_loc * 4
    ag = next(c for c in outside if c[0] == "all_gather")
    assert ag[1] == b_loc * 4 and ag[2] == n_seq * b_loc * 4
    # --- re-derive the model's table from the EXTRACTED payloads
    from regex_fpga_tpu.parallel.comm_model import fast_dist_comm_bytes

    iters = 2
    model = fast_dist_comm_bytes(
        batch, 1 << 20, n_data, n_seq, overlap=overlap, iters=iters
    )["per_device_bytes"]
    assert model["seam_tail_ppermute"] == seam[1]
    assert model["finals_ppermute_x_iters"] == iters * it_pp[1]
    assert model["convergence_psum_x_iters"] == iters * 2 * 4
    # ring formulas applied to the extracted payloads
    assert model["counts_psum"] == round(
        2 * (n_seq - 1) / n_seq * counts_psum[1], 1)
    assert model["finals_all_gather"] == ag[2] - ag[1]


def test_fast_dist_collectives_match_model():
    import jax.numpy as jnp
    import numpy as np

    from regex_fpga_tpu.ops import build_dfa_tables
    from regex_fpga_tpu.parallel.dist_scan import dfa_scan_fast_dist
    from regex_fpga_tpu.parallel.mesh import make_mesh

    mesh = make_mesh(2, 4)
    rng = np.random.default_rng(0)
    table = rng.integers(0, 9, size=(256, 9), dtype=np.int32)
    dt = build_dfa_tables(table, rng.random(9) < 0.3)
    batch, n_seq, nbps, ov = 8, 4, 4, 8
    classes = jnp.zeros((batch, n_seq * nbps * 16), jnp.int32)
    _audit(
        lambda c: dfa_scan_fast_dist(
            mesh, dt, c, blocks_per_shard=nbps, overlap=ov
        ),
        (classes,), batch, 2, n_seq, ov,
    )


def test_kgram_dist_collectives_match_model():
    import jax.numpy as jnp
    import numpy as np

    from regex_fpga_tpu.ops import build_dfa_tables
    from regex_fpga_tpu.ops.kgram import build_kgram
    from regex_fpga_tpu.parallel.dist_scan import dfa_scan_kgram_dist
    from regex_fpga_tpu.parallel.mesh import make_mesh

    mesh = make_mesh(2, 4)
    rng = np.random.default_rng(1)
    table = rng.integers(0, 7, size=(256, 7), dtype=np.int32)
    dt = build_dfa_tables(table[np.arange(256) % 5], rng.random(7) < 0.3)
    kg = build_kgram(dt, levels=1)
    batch, n_seq, nbps, ov = 8, 4, 4, 8
    classes_k = jnp.zeros((batch, n_seq * nbps * 8), jnp.int32)
    _audit(
        lambda c: dfa_scan_kgram_dist(
            mesh, jnp.asarray(kg.table), jnp.asarray(kg.acc_table), c,
            blocks_per_shard=nbps, overlap=ov, acc_bound=kg.k,
        ),
        (classes_k,), batch, 2, n_seq, ov,
    )
