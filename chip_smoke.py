"""Smoke run of the scan engines on an NVIDIA GPU, through the ``api``
entry points, at deployment sizes, each phase checked against a plain
reference.

    python chip_smoke.py                # one card: phases 0-6
    python chip_smoke.py --multi        # all cards (four): the mesh paths only

Every earlier line of standard output is one JSON record (a phase's engine,
bytes, compile and steady seconds, agreement with its reference; phase 6's
rates are for the record and never gate).  The last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``
and is printed only when every phase agreed.  Without a GPU the run exits
non-zero before any phase.  Everything runs in this one process; data
comes from ``--seed``.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import time
import traceback

import numpy as np

MIB = 1 << 20


def emit(record: dict) -> None:
    print(json.dumps(record), flush=True)


def nvidia_smi() -> list[str]:
    """``name, power.limit`` of every card, read by a child process that
    never imports JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]


def timed(fn, reps: int = 2):
    """(result, first-call seconds, steady seconds): the first call pays
    compilation; steady is the median of ``reps`` later calls.  Every call
    ends in ``jax.block_until_ready``."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    first = time.perf_counter() - t0
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return out, first, float(np.median(ts))


def record(phase: str, engine: str, nbytes: int, first: float,
           steady: float, agree: bool, **extra) -> dict:
    return {
        "phase": phase, "engine": engine, "bytes": int(nbytes),
        "compile_s": round(max(first - steady, 0.0), 3),
        "steady_s": round(steady, 4),
        "agree": bool(agree), **extra,
    }


# --------------------------------------------------------------------------
# seeded data


def _vocab(rng, extra: list[bytes] = ()) -> list[bytes]:
    """Word-like tokens with their trailing separators: lowercase and
    capitalised words, integers, decimals, contractions, punctuation runs,
    UTF-8 words and whitespace runs."""
    letters = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz", np.uint8)
    words = []
    for _ in range(3000):
        w = bytes(letters[rng.integers(0, 26, int(rng.integers(1, 10)))])
        if rng.random() < 0.15:
            w = w.capitalize()
        words.append(w)
    words += [str(int(x)).encode() for x in rng.integers(0, 10**6, 300)]
    words += [f"{rng.integers(0, 1000)}.{rng.integers(0, 100)}".encode()
              for _ in range(200)]
    words += [b"it's", b"don't", b"we'll", b"I'm", b"they've",
              "été".encode(), "naïve".encode(),
              "日本".encode(), "über".encode()]
    words += list(extra)
    seps = [b" ", b" ", b" ", b" ", b", ", b". ", b"!\n", b"  ", b"\n",
            b"... ", b"? ", b" - "]
    return [w + seps[int(rng.integers(len(seps)))] for w in words]


def gen_text(rng, nbytes: int, extra: list[bytes] = ()) -> np.ndarray:
    """``nbytes`` of seeded text: vocabulary tokens drawn with a heavy-tailed
    (Zipf-like) popularity, joined by a vectorised gather."""
    vocab = _vocab(rng, extra)
    flat = np.frombuffer(b"".join(vocab), np.uint8)
    vlen = np.array([len(v) for v in vocab], np.int64)
    voff = np.concatenate([[0], np.cumsum(vlen)[:-1]])
    p = 1.0 / (np.arange(len(vocab)) + 10.0)
    p = p[rng.permutation(len(vocab))]
    p /= p.sum()
    out, have = [], 0
    while have < nbytes:
        idx = rng.choice(len(vocab), size=1 << 20, p=p)
        lens = vlen[idx]
        starts = np.cumsum(lens) - lens
        src = np.repeat(voff[idx] - starts, lens) + np.arange(lens.sum())
        piece = flat[src]
        out.append(piece)
        have += len(piece)
    return np.concatenate(out)[:nbytes]


def ragged_lengths(rng, n: int, total: int) -> np.ndarray:
    """``n`` heavy-tailed (Pareto) flow lengths summing to ``total``, the
    longest capped at 8x the mean (the ragged batch pads every flow to the
    longest one)."""
    w = rng.pareto(1.2, n) + 0.05
    w = np.minimum(w / w.sum() * n, 8.0)
    lens = np.maximum((w / w.sum() * total).astype(np.int64), 1)
    lens[np.argmin(lens)] += total - lens.sum()
    return lens


def literal_words(n: int) -> list[bytes]:
    """The IDS-style literal list whose Aho-Corasick DFA has S=440 at 150
    words and S=836 at 300 words."""
    return [w % i for i in range(300)
            for w in (b"error%04d", b"warning%03d", b"GET /path%d HTTP",
                      b"user-agent: bot%d", b"fail%dure")][:n]


def l7_ruleset():
    """The l7-filter-scale corpus's 110 protocols as one reference-
    convention CSR NFA (~2,054 states).  One ruleset cannot mix anchored
    and unanchored rules, so the leading ``^`` is dropped: every protocol
    matches anywhere in a flow, as the reference images' rules do."""
    from regex_fpga_tpu.models.export_csr import regexes_to_csr
    from regex_fpga_tpu.models.l7_corpus import gen_l7_patterns

    pats = [("(?i)" if icase else "") + pat.removeprefix("^")
            for _, pat, icase, _ in gen_l7_patterns()]
    aut, _ = regexes_to_csr(pats)
    return aut


def l7_flows(rng, n: int, flow_bytes: int) -> list[np.ndarray]:
    """Flows of random bytes with the corpus's protocol samples planted."""
    from regex_fpga_tpu.models.l7_corpus import gen_l7_traffic

    payloads, _ = gen_l7_traffic(n_payloads=600, seed=int(rng.integers(1 << 30)))
    flows = []
    for _ in range(n):
        flow = rng.integers(0, 256, flow_bytes, dtype=np.uint8)
        for _ in range(max(flow_bytes // 4096, 1)):
            p = np.frombuffer(payloads[int(rng.integers(len(payloads)))],
                              np.uint8)[: flow_bytes // 2]
            at = int(rng.integers(0, flow_bytes - len(p) + 1))
            flow[at: at + len(p)] = p
        flows.append(flow)
    return flows


# --------------------------------------------------------------------------
# phases


def phase_device() -> dict:
    """Phase 0: JAX must see a GPU; there is no CPU fallback."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(
            f"no GPU: JAX reports platform {devs[0].platform!r}")
    return {"phase": "device", "platform": devs[0].platform,
            "kind": devs[0].device_kind, "count": len(devs),
            "nvidia_smi": nvidia_smi()}


def phase_tokenizer(seed: int, nbytes: int = 64 * MIB,
                    ends_bytes: int = 16 * MIB) -> list[dict]:
    """Phase 1: GPT-2 pre-split DFA (S=23) — count() on the k-gram route,
    scan() on the k=1 counts route, findall_ends() (full output) and
    presplit() (device position compaction), each equal to the native
    serial walker."""
    from regex_fpga_tpu import api
    from regex_fpga_tpu.models.tokenizer_dfa import boundaries_from_flags
    from regex_fpga_tpu.utils.config import EngineConfig
    from regex_fpga_tpu.utils.native import dfa_scan_native

    rng = np.random.default_rng(seed)
    tok = api.compile_tokenizer(config=EngineConfig(scan_backend="device"))
    text = gen_text(rng, nbytes)
    tab, cls, acc = (np.asarray(tok.tables.table),
                     np.asarray(tok.tables.class_of),
                     np.asarray(tok.tables.accept))

    def ref(stream):
        counts, mask, final = dfa_scan_native(tab, cls, acc, stream,
                                              start=tok.start)
        counts = counts.copy()
        if len(stream) and acc[final]:
            counts[final] += 1  # include_final_match
        return counts, mask, final

    out = []
    s = tok.num_states
    ref_counts, _, _ = ref(text)
    total, first, steady = timed(lambda: tok.count(text))
    out.append(record("tokenizer", "kgram-count", nbytes, first, steady,
                      total == int(ref_counts.sum()), S=s,
                      kgram=tok._kgram() is not None))
    rep, first, steady = timed(lambda: tok.scan(text))
    out.append(record("tokenizer", rep.metrics.engine, nbytes, first,
                      steady, np.array_equal(rep.counts[0], ref_counts),
                      S=s))
    part = text[:ends_bytes]
    _, mask, final = ref(part)
    want = np.nonzero(mask)[0]
    if len(part) and acc[final]:
        want = np.concatenate([want, [len(part)]])
    ends, first, steady = timed(lambda: tok.findall_ends(part))
    out.append(record("tokenizer", "dfa-fast-full", len(part), first,
                      steady, np.array_equal(ends, want), S=s))
    starts, first, steady = timed(lambda: tok.presplit(part))
    out.append(record("tokenizer", "dfa-fast-mask+mask_positions",
                      len(part), first, steady,
                      np.array_equal(starts, boundaries_from_flags(
                          mask, bool(acc[final]))), S=s,
                      pieces=int(len(starts))))
    return out


def phase_dense(seed: int, total: int = 64 * MIB, flows: int = 64,
                sizes: tuple = (150, 300)) -> list[dict]:
    """Phase 2: Aho-Corasick DFAs at IDS sizes (S=440, S=836) over ragged
    heavy-tailed flows on the device route, equal to the native
    multi-cursor walker; then once on the router's own choice."""
    import dataclasses

    from regex_fpga_tpu import api
    from regex_fpga_tpu.utils.config import EngineConfig
    from regex_fpga_tpu.utils.native import dfa_scan_multi_native

    rng = np.random.default_rng(seed + 2)
    words = literal_words(max(sizes))
    text = gen_text(rng, total, extra=words * 20)
    lens = ragged_lengths(rng, flows, total)
    cuts = np.concatenate([[0], np.cumsum(lens)])
    streams = [text[a:b] for a, b in zip(cuts[:-1], cuts[1:])]
    out = []
    for n in sizes:
        m = api.compile_literals(words[:n],
                                 config=EngineConfig(scan_backend="device"))
        tab, cls, acc = (np.asarray(m.tables.table),
                         np.asarray(m.tables.class_of),
                         np.asarray(m.tables.accept))
        want, finals = dfa_scan_multi_native(tab, cls, acc, streams,
                                             starts=m.start)
        eof = np.asarray(m.dfa.eof_accept)
        for i, f in enumerate(finals):
            if len(streams[i]) and eof[f]:
                want[i, f] += 1
        rep, first, steady = timed(lambda: m.scan(streams))
        out.append(record(
            "dense", rep.metrics.engine, total, first, steady,
            np.array_equal(rep.counts, want), S=m.num_states,
            C=m.tables.num_classes, flows=flows, matches=int(rep.total),
            converged=bool(rep.metrics.converged),
        ))
        auto = dataclasses.replace(m.config, scan_backend="auto")
        ma = api.compile_literals(words[:n], config=auto)
        rep, first, steady = timed(lambda: ma.scan(streams), reps=1)
        out.append(record("dense-auto", rep.metrics.engine, total, first,
                          steady, np.array_equal(rep.counts, want),
                          S=ma.num_states, router_choice=rep.metrics.engine))
    return out


def phase_snort(seed: int, n_payloads: int = 400) -> list[dict]:
    """Phase 3: the ~3k-rule community-style Snort corpus on the device
    prefilter: alerts identical to the host-walker build, planted attacks
    all found."""
    from regex_fpga_tpu import api
    from regex_fpga_tpu.models.snort_corpus import (
        gen_community_rules, gen_traffic,
    )
    from regex_fpga_tpu.utils.config import EngineConfig

    rules = gen_community_rules()
    t0 = time.perf_counter()
    dev = api.compile_snort(rules, EngineConfig(scan_backend="device"))
    build_s = time.perf_counter() - t0
    host = api.compile_snort(rules, EngineConfig(scan_backend="host"))
    payloads, planted = gen_traffic(n_payloads=n_payloads, seed=seed + 3)
    rep, first, steady = timed(lambda: dev.scan(payloads))
    ref = host.scan(payloads)

    def alerts(r):
        return [[(a.rule_index, a.sid, a.pcre_checked) for a in per]
                for per in r.alerts]

    recall = sum(1 for i, sid in planted.items() if sid in rep.sids(i))
    agree = alerts(rep) == alerts(ref) and recall == len(planted)
    return [record("snort", "snort-device-prefilter",
                   sum(len(p) for p in payloads), first, steady, agree,
                   rules=dev.num_rules, build_s=round(build_s, 3),
                   recall=f"{recall}/{len(planted)}",
                   alerts=sum(len(a) for a in rep.alerts))]


def phase_nfa(seed: int, flows: int = 16, flow_bytes: int = MIB,
              prefix: int = 64 * 1024) -> list[dict]:
    """Phase 4: the l7-filter-scale NFA (~2k states) on the lazy-DFA device
    engine, per-state counts equal to the host lazy walker; on a prefix
    also equal to the golden oracle and the active-set device engine."""
    from regex_fpga_tpu import api
    from regex_fpga_tpu.models import nfa_scan

    rng = np.random.default_rng(seed + 4)
    aut = l7_ruleset()
    streams = l7_flows(rng, flows, flow_bytes)
    dev = api.compile_ruleset(aut, strategy="lazy-device")
    host = api.compile_ruleset(aut, strategy="lazy")
    ref = host.scan(streams)
    # a long-running scanner has interned the subset states its traffic
    # reaches; warm the device matcher's lazy DFA the same way
    dev.lazy_dfa.host_scan_batch(streams)
    rep, first, steady = timed(lambda: dev.scan(streams), reps=1)
    out = [record("nfa", rep.metrics.engine, flows * flow_bytes, first,
                  steady, np.array_equal(rep.counts, ref.counts),
                  S=aut.num_states, matches=int(rep.total))]
    head = streams[0][:prefix]
    oracle = nfa_scan(aut, head)
    active = api.compile_ruleset(aut, strategy="active-set")
    ra, first, steady = timed(lambda: active.scan([head]), reps=1)
    rl = dev.scan([head])
    out.append(record("nfa-prefix", ra.metrics.engine, len(head), first,
                      steady, np.array_equal(ra.counts[0], oracle)
                      and np.array_equal(rl.counts[0], oracle),
                      S=aut.num_states, matches=int(oracle.sum())))
    return out


def phase_spans(seed: int, nbytes: int = 32 * MIB) -> list[dict]:
    """Phase 5: span extraction (reverse scan + device compaction +
    anchored forward walk) equal to Python ``re.finditer``."""
    from regex_fpga_tpu import api

    rng = np.random.default_rng(seed + 5)
    corpus = gen_text(rng, nbytes).tobytes()
    pat = rb"\d+\.\d+"
    m = api.compile_regex(pat)
    spans, first, steady = timed(lambda: m.finditer(corpus))
    want = [mm.span() for mm in re.finditer(pat, corpus)]
    return [record("spans", "finditer", nbytes, first, steady,
                   spans == want, matches=len(want))]


def phase_numbers(seed: int, nbytes: int = 64 * MIB,
                  nb: int = 65536) -> list[dict]:
    """Phase 6 (for the record, never gating): the f32-HIGHEST route
    against the rule's bf16 / byte-split route, both GEMM orientations,
    k-gram against k=1 at the tokenizer, and the router's probes."""
    import jax

    from regex_fpga_tpu import api
    from regex_fpga_tpu.ops import router
    from regex_fpga_tpu.ops.dfa_fast import StepPlan, dfa_scan_fast, step_plan
    from regex_fpga_tpu.ops.kgram import dfa_scan_kgram, map_kgram_classes

    rng = np.random.default_rng(seed + 6)
    words = literal_words(300)
    text = gen_text(rng, nbytes, extra=words * 20)
    tok = api.compile_tokenizer()
    cases = [("tokenizer", tok)] + [
        (f"ac{n}", api.compile_literals(words[:n])) for n in (150, 300)
    ]
    out = []
    for name, m in cases:
        t = m.tables
        s, c = t.num_states, t.num_classes
        cls = jax.device_put(np.asarray(t.class_of).astype(np.uint8)[text])
        chosen = step_plan(c, s)
        plans = {"rule": chosen, "f32": StepPlan("f32", chosen.transposed)}
        if s > 256:
            plans["other_orientation"] = StepPlan(chosen.encoding,
                                                  not chosen.transposed)
        base = None
        for label, plan in plans.items():
            res, first, steady = timed(lambda p=plan: dfa_scan_fast(
                t, cls, num_blocks=nb, start=m.start, emit="counts",
                plan=p))
            counts = np.asarray(res.counts)
            base = counts if base is None else base
            out.append({
                "phase": "numbers", "table": name, "S": s, "C": c,
                "route": label, "encoding": plan.encoding,
                "transposed": plan.transposed, "bytes": nbytes,
                "compile_s": round(max(first - steady, 0.0), 3),
                "steady_s": round(steady, 4),
                "gbps": round(nbytes / steady / 1e9, 3),
                "same_counts": bool(np.array_equal(counts, base)),
            })
        if m is tok:
            kg, tj, aj = tok._kgram()
            ck = jax.device_put(map_kgram_classes(kg, text[: len(text) // kg.k
                                                           * kg.k]))
            res, first, steady = timed(lambda: dfa_scan_kgram(
                tj, aj, ck, num_blocks=nb, start=tok.start,
                acc_bound=kg.k))
            out.append({
                "phase": "numbers", "table": name, "S": s,
                "route": f"kgram-k{kg.k}", "bytes": nbytes,
                "compile_s": round(max(first - steady, 0.0), 3),
                "steady_s": round(steady, 4),
                "gbps": round(nbytes / steady / 1e9, 3),
            })
        else:
            router.reset_session()
            dev_bps = router.probe_device(t)
            single = router.probe_host(t, 1)
            multi = router.probe_host(t, 16)
            out.append({
                "phase": "numbers", "table": name, "S": s, "C": c,
                "route": "router-probes",
                "device_bps": round(dev_bps, 1),
                "device_tile_bps": round(
                    router.session_rates()["device_tile_bps"], 1),
                "host_single_bps": round(single, 1),
                "host_multi_bps": round(multi, 1),
            })
    router.reset_session()
    return out


def phase_multi(devices, seed: int, stream_bytes: int = 16 * MIB,
                nfa_bytes: int = 16 * 1024) -> list[dict]:
    """The mesh paths, each against its one-device result or the oracle:
    the (data, seq) fast and k-gram scans, chunked ingest with a
    checkpoint resume across a chunk boundary, the state-sharded NFA scan
    and ruleset-parallel scanning over unequal rule sets."""
    import os
    import tempfile

    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from regex_fpga_tpu.models import (
        CsrAutomaton, build_tokenizer_dfa, nfa_scan, prefix_automaton,
    )
    from regex_fpga_tpu.ops import build_dfa_tables, build_nfa_tables
    from regex_fpga_tpu.ops.dfa_fast import dfa_scan_fast
    from regex_fpga_tpu.ops.kgram import (
        build_kgram, dfa_scan_kgram, map_kgram_classes,
    )
    from regex_fpga_tpu.parallel import (
        dfa_scan_fast_dist, dfa_scan_kgram_dist, make_mesh, make_tp_mesh,
        multi_ruleset_scan, nfa_scan_tp, stack_nfa_tables,
    )
    from regex_fpga_tpu.parallel.ingest import (
        CheckpointStore, dist_resilient_scan, iter_batch_chunks,
    )
    from regex_fpga_tpu.parallel.mesh import DATA_AXIS, MODEL_AXIS, SEQ_AXIS

    def place(mesh, array, spec):
        # inputs land in the layout their shard_map reads: no reshard
        return jax.device_put(array, NamedSharding(mesh, spec))

    n = len(devices)
    n_data = 2 if n % 2 == 0 and n >= 2 else 1
    n_seq = n // n_data
    mesh = make_mesh(n_data, n_seq, devices=devices)
    rng = np.random.default_rng(seed + 7)
    tok = build_tokenizer_dfa()
    dt = build_dfa_tables(tok.table, tok.accept)
    lut = np.asarray(dt.class_of).astype(np.uint8)
    batch = 2 * n_data
    bps = max(stream_bytes // (n_seq * 64 * 1024), 1) * 64  # blocks/shard
    l = n_seq * bps * 1024
    text = gen_text(rng, batch * l).reshape(batch, l)
    out = []

    # (data, seq) fast scan vs one device, stream by stream
    cls = place(mesh, lut[text], P(DATA_AXIS, SEQ_AXIS))
    res, first, steady = timed(lambda: dfa_scan_fast_dist(
        mesh, dt, cls, blocks_per_shard=bps, start=tok.start))
    finals, counts, conv = (np.asarray(x) for x in res)
    ok = bool(conv)
    for i in range(batch):
        one = dfa_scan_fast(dt, jax.device_put(lut[text[i]], devices[0]),
                            num_blocks=n_seq * bps, start=tok.start,
                            emit="counts")
        ok &= int(np.asarray(one.counts).sum()) == int(counts[i])
        ok &= int(one.final_state) == int(finals[i])
    out.append(record("multi", "dfa_scan_fast_dist", batch * l, first,
                      steady, ok, mesh=f"{n_data}x{n_seq}"))

    # (data, seq) k-gram scan vs one device
    kg = build_kgram(dt, levels=2)
    ck_np = np.stack([map_kgram_classes(kg, row) for row in text])
    tj, aj = jax.device_put(kg.table), jax.device_put(kg.acc_table)
    ck = place(mesh, ck_np, P(DATA_AXIS, SEQ_AXIS))
    kbps = max(bps // kg.k, 1)
    res, first, steady = timed(lambda: dfa_scan_kgram_dist(
        mesh, tj, aj, ck, blocks_per_shard=kbps, start=tok.start,
        acc_bound=kg.k))
    kfinals, ktotals, kconv = (np.asarray(x) for x in res)
    ok = bool(kconv)
    for i in range(batch):
        one = dfa_scan_kgram(tj, aj, jax.device_put(ck_np[i], devices[0]),
                             num_blocks=n_seq * kbps, start=tok.start,
                             acc_bound=kg.k)
        ok &= int(one.total) == int(ktotals[i])
        ok &= int(one.final_state) == int(kfinals[i])
    out.append(record("multi", "dfa_scan_kgram_dist", batch * l, first,
                      steady, ok, mesh=f"{n_data}x{n_seq}"))

    # chunked ingest: checkpoint after chunk 1, resume across the boundary
    chunk = l // 2
    t0 = time.perf_counter()
    unbroken = dist_resilient_scan(
        mesh, dt, iter_batch_chunks(text, chunk), blocks_per_shard=bps // 2,
        start=tok.start)
    t_unbroken = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "carry.npz")
        dist_resilient_scan(
            mesh, dt, iter_batch_chunks(text[:, :chunk], chunk),
            blocks_per_shard=bps // 2, start=tok.start,
            store=CheckpointStore(path))
        resumed = dist_resilient_scan(
            mesh, dt, iter_batch_chunks(text, chunk),
            blocks_per_shard=bps // 2, start=tok.start,
            store=CheckpointStore(path))
    ok = (int(resumed["offset"]) == l
          and np.array_equal(resumed["counts"], unbroken["counts"])
          and np.array_equal(resumed["states"], unbroken["states"])
          and np.array_equal(unbroken["counts"], counts)
          and np.array_equal(unbroken["states"], finals))
    out.append(record("multi", "dist_resilient_scan", batch * l,
                      t_unbroken, t_unbroken, ok, chunks=2, resumed=True))

    # state-sharded NFA scan vs the oracle
    n_model = min(n, 4)
    tp_data = n // n_model
    tp_mesh = make_tp_mesh(n_model=n_model, n_data=tp_data, devices=devices)
    tp_aut = prefix_automaton(l7_ruleset(), 600)
    tp_streams = np.stack(l7_flows(rng, 2 * tp_data, nfa_bytes))
    tp_in = place(tp_mesh, tp_streams, P(DATA_AXIS, None))
    res, first, steady = timed(lambda: nfa_scan_tp(
        tp_mesh, build_nfa_tables(tp_aut), tp_in)[0], reps=1)
    tp_counts = np.asarray(res)
    ok = all(np.array_equal(tp_counts[i, : tp_aut.num_states],
                            nfa_scan(tp_aut, tp_streams[i]))
             for i in range(len(tp_streams)))
    out.append(record("multi", "nfa_scan_tp", tp_streams.size, first,
                      steady, ok, mesh=f"{tp_data}x{n_model}",
                      S=tp_aut.num_states, axis=MODEL_AXIS))

    # ruleset-parallel: one unequal rule set per device vs the oracle
    def uneven_nfa(i: int) -> CsrAutomaton:
        r = np.random.default_rng(seed + 100 + i)
        ns = 17 + 9 * i
        ne = 6 * ns
        src = np.sort(r.integers(0, ns - 3, size=ne))
        return CsrAutomaton(
            offsets=np.searchsorted(src, np.arange(ns + 1)).astype(np.int64),
            trans_char=r.integers(0, 256, size=ne).astype(np.uint8),
            trans_target=r.integers(0, ns, size=ne).astype(np.int32),
        )

    auts = [uneven_nfa(i) for i in range(n)]
    stacked = stack_nfa_tables([build_nfa_tables(a) for a in auts])
    stream = rng.integers(0, 256, nfa_bytes).astype(np.uint8)
    stream_in = place(mesh, stream, P())
    res, first, steady = timed(lambda: multi_ruleset_scan(
        mesh, stacked, stream_in), reps=1)
    per = np.asarray(res)
    ok = all(np.array_equal(per[i, : a.num_states], nfa_scan(a, stream))
             for i, a in enumerate(auts))
    out.append(record("multi", "multi_ruleset_scan", nfa_bytes, first,
                      steady, ok, rulesets=n,
                      S=[a.num_states for a in auts]))
    return out


# --------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--multi", action="store_true",
                    help="run only the multi-device mesh paths, on every "
                         "visible card")
    args = ap.parse_args(argv)

    import jax

    from regex_fpga_tpu.utils.compile_cache import enable_compile_cache

    dev = phase_device()
    enable_compile_cache()
    emit(dev)
    for line in dev["nvidia_smi"]:
        print(f"gpu: {line}", flush=True)

    if args.multi:
        phases = [("multi", lambda: phase_multi(jax.devices(), args.seed))]
    else:
        phases = [
            ("tokenizer", lambda: phase_tokenizer(args.seed)),
            ("dense", lambda: phase_dense(args.seed)),
            ("snort", lambda: phase_snort(args.seed)),
            ("nfa", lambda: phase_nfa(args.seed)),
            ("spans", lambda: phase_spans(args.seed)),
            ("numbers", lambda: phase_numbers(args.seed)),
        ]
    failed = []
    for name, run in phases:
        t0 = time.perf_counter()
        try:
            records = run()
        except Exception:
            traceback.print_exc()
            emit({"phase": name, "error": traceback.format_exc(limit=3)})
            failed.append(name)
            continue
        for rec in records:
            emit(rec)
        if not all(r.get("agree", True) for r in records):
            failed.append(name)
        print(f"# phase {name}: {time.perf_counter() - t0:.1f} s",
              file=sys.stderr, flush=True)
    if failed:
        print(f"# failed phases: {failed}", file=sys.stderr)
        return 1
    devs = jax.devices()
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
