"""Benchmark entry point — prints a full-detail JSON line, then a FINAL
COMPACT headline JSON line (<=1,500 chars).

Headline: single-device DFA scan throughput (bytes/s) of the block-parallel
speculative engine (Jacobi fixpoint + one-hot GEMM inner loop) on a
synthetic text stream through the GPT-2-style pre-split tokenizer DFA —
BASELINE.json config 3/4 (the reference FPGA's derived ~65-129 KB/s,
SURVEY.md SS6, is reported for context).

Every rate is the MEDIAN of repeated, individually-timed passes and
carries its min/max spread; the host-walker measurement runs BEFORE the
extras worker thread starts, with the device idle.  After the main-thread
measurements every extra section runs on a daemon worker thread and the
main thread joins with a hard deadline; whatever completed lands in the
JSON line, the rest reads null.  This script predates the named-cell
benchmark (ROADMAP S0); ``chip_smoke.py`` is the checked run on the GPU.
"""

import json
import os
import sys
import threading
import time

import numpy as np

_T0 = time.perf_counter()
_BUDGET = float(os.environ.get("BENCH_BUDGET_S", "480"))


def _remaining() -> float:
    return _BUDGET - (time.perf_counter() - _T0)


def _med_spread(fn, reps: int, force, discard_first: bool = False) -> dict:
    """Median + spread of ``reps`` individually timed ``fn()`` calls.
    ``force(result)`` must block until the work is really done (a small
    host transfer).  ``discard_first`` times one extra leading rep and
    excludes it from the stats (recorded as ``first_s``)."""
    times = []
    first = None
    for i in range(reps + (1 if discard_first else 0)):
        t0 = time.perf_counter()
        force(fn())
        dt_ = time.perf_counter() - t0
        if discard_first and i == 0:
            first = dt_
            continue
        times.append(dt_)
    times.sort()
    out = {
        "median_s": times[len(times) // 2],
        "min_s": times[0],
        "max_s": times[-1],
        "reps": reps,
    }
    if first is not None:
        out["first_s"] = first
    return out


def _rate(nbytes: int, ms: dict) -> dict:
    return {
        "bytes_per_sec": round(nbytes / ms["median_s"], 1),
        "bps_min": round(nbytes / ms["max_s"], 1),
        "bps_max": round(nbytes / ms["min_s"], 1),
        "reps": ms["reps"],
    }


def main() -> None:
    # even the HEADLINE runs on a daemon thread behind the budget; if it
    # never completes, the emergency JSON line below is still printed
    state: dict = {}
    t = threading.Thread(target=_measure, args=(state,), daemon=True)
    t.start()
    t.join(timeout=max(30.0, _BUDGET - 10.0))
    if "json" not in state:
        print("# headline path hung — emitting emergency line",
              file=sys.stderr)
        print(json.dumps({
            "metric": "dfa_scan_bytes_per_sec_per_chip",
            "value": 0.0,
            "unit": "B/s",
            "detail": {"error": "headline did not complete in the budget",
                       "progress": state.get("progress")},
        }))
    else:
        # FULL detail first, COMPACT headline LAST: a reader of the tail
        # of stdout parses the final line; it is capped well under 2,000
        # characters and the detail line above it carries everything.
        print(state["json_detail"])
        compact = state["json"]
        if len(compact) > 1500:  # hard cap, belt-and-braces
            print(f"# compact line {len(compact)} chars > 1500 — check "
                  "_compact_line()", file=sys.stderr)
        print(compact)
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)


def _measure(state: dict) -> None:
    import jax
    import jax.numpy as jnp

    from regex_fpga_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    from regex_fpga_tpu.models import build_tokenizer_dfa
    from regex_fpga_tpu.ops import build_dfa_tables
    from regex_fpga_tpu.ops.dfa_fast import dfa_scan_fast

    dev = jax.devices()[0]
    print(f"# device: {dev}", file=sys.stderr)
    state["progress"] = "devices-listed"

    tok = build_tokenizer_dfa()
    dt = build_dfa_tables(tok.table, tok.accept)
    print(
        f"# tokenizer DFA: S={dt.num_states} C={dt.num_classes}", file=sys.stderr
    )

    # synthetic text: word-like structure so the pre-split DFA does real work
    frag = (
        b"The quick brown fox jumps over 1234 lazy dogs, it's 99.5% fine!  "
        b"pre-split   benchmark text \xc3\xa9t\xc3\xa9 2026... "
    )
    # upload class ids as uint8 (engines cast to int32 ON device).  The
    # upload runs behind its own deadline and falls back to a smaller
    # stream rather than eating the whole budget (the size is reported as
    # stream_bytes).
    class_lut = np.asarray(dt.class_of).astype(np.uint8)

    def _upload(nbytes: int, deadline_s: float):
        reps_ = int(np.ceil(nbytes / len(frag)))
        text_ = np.frombuffer(frag * reps_, dtype=np.uint8)[:nbytes]
        box: dict = {}

        def _do():
            try:
                t0u = time.perf_counter()
                arr = jnp.asarray(class_lut[text_])
                np.asarray(arr[:8])  # force the transfer
                box["arr"] = arr
                box["seconds"] = time.perf_counter() - t0u
            except Exception as e:  # pragma: no cover - transfer errors
                box["err"] = e

        th = threading.Thread(target=_do, daemon=True)
        th.start()
        th.join(timeout=deadline_s)
        if "err" in box:  # a REAL error, not a stall — surface it
            print(f"# upload raised (not a stall): {box['err']!r}",
                  file=sys.stderr)
        if "seconds" in box:
            state["upload_bps"] = round(nbytes / box["seconds"], 1)
            state["upload_seconds"] = round(box["seconds"], 3)
        return box.get("arr"), text_

    l = 1 << 26  # 64 MiB per timed pass
    classes, text = _upload(l, min(180.0, max(_remaining() - 260.0, 60.0)))
    degraded = False
    if classes is None:
        print("# 64 MiB upload stalled — degraded 4 MiB fallback",
              file=sys.stderr)
        degraded = True
        l = 1 << 22
        classes, text = _upload(l, min(120.0, max(_remaining() - 90.0,
                                                  30.0)))
        if classes is None:
            raise RuntimeError("all uploads stalled")
    state["progress"] = "classes-uploaded"

    nb = 65536
    run = lambda: dfa_scan_fast(dt, classes, num_blocks=nb, start=tok.start)

    # warmup/compile
    print("# compiling headline full-output graph...", file=sys.stderr)
    r = run()
    np.asarray(r.final_state)
    iters = int(r.iterations)
    print(f"# headline compile+run done at t={time.perf_counter()-_T0:.0f}s",
          file=sys.stderr)

    full_ms = _med_spread(run, 5, lambda rr: np.asarray(rr.final_state))
    full = _rate(l, full_ms)
    full_bps = full["bytes_per_sec"]
    state["progress"] = "headline-measured"

    # ---- host-walker conformance: runs BEFORE the extras worker exists,
    # device idle, so no concurrent section races it for host cores
    conf: dict = {}
    try:
        from regex_fpga_tpu import api
        from regex_fpga_tpu.utils import load_trace_pair, reference_root

        m = api.compile_ruleset(
            os.path.join(reference_root(), "Block_Mem/CSR_BlockMem.coe")
        )
        lo, _ = load_trace_pair("l-7_filter", limit=30_000)
        ok = m.scan(lo).histogram(0) == {443: 1, 1386: 1}

        snort = api.compile_ruleset(
            os.path.join(reference_root(),
                         "Block_Mem/CSR_BlockMem_snort_16.coe")
        )
        s_lo, s_hi = load_trace_pair("snort_16")
        warm = snort.scan([s_lo, s_hi])  # interns the subset automaton
        conf["conf_ok"] = (ok and int(warm.counts[0].sum()) == 13
                           and int(warm.counts[1].sum()) == 678)
        # sustained many-flows IDS workload (native multi-cursor walk)
        flow = np.concatenate([s_lo, s_hi])
        flows = [np.roll(flow, i * 997) for i in range(64)]  # 25.6 MB
        snort.lazy_dfa.host_scan_batch(flows)  # warm
        total = sum(len(f) for f in flows)
        ms = _med_spread(
            lambda: snort.lazy_dfa.host_scan_batch(flows), 5, lambda _: None
        )
        conf["conf_walker"] = _rate(total, ms)
    except Exception as e:
        print(f"# conformance check skipped: {e}", file=sys.stderr)

    # ---- community-scale Snort front-end (r4 verdict item 2): host-only,
    # chip idle.  Offline corpus at the reference ruleset's OWN scale
    # (models/snort_corpus.py, ~3k rules / >10k AC states vs the .coe's
    # 9,514) — build cost, enforcement coverage, traffic scan rate, recall
    try:
        import time as _t

        from regex_fpga_tpu.api import compile_snort
        from regex_fpga_tpu.models.snort_corpus import (
            gen_community_rules, gen_traffic,
        )

        _t0s = _t.perf_counter()
        rules_text = gen_community_rules()
        sm = compile_snort(rules_text)
        build_s = _t.perf_counter() - _t0s
        payloads, planted = gen_traffic()
        sm.scan(payloads[:4])  # warm caches
        _t1s = _t.perf_counter()
        rep = sm.scan(payloads)
        scan_s = _t.perf_counter() - _t1s
        recall = sum(
            1 for idx, sid in planted.items()
            if sid in [a.sid for a in rep.alerts[idx]]
        )
        es = sm.enforcement_report()["summary"]
        conf["snort_scale"] = {
            "n_rules": sm.num_rules,
            "build_seconds": round(build_s, 3),
            "ac_states": sum(
                a.num_states for a in (sm._exact, sm._fold,
                                       sm._uri_exact, sm._uri_fold)
                if a is not None
            ),
            "enforced_pct": round(100.0 * es["enforced"] / es["total"], 1),
            "scan_ms_per_payload": round(
                scan_s / len(payloads) * 1e3, 3),
            "payload_bytes_per_sec": round(
                sum(len(p) for p in payloads) / scan_s),
            "recall": f"{recall}/{len(planted)}",
            "alerts": sum(len(a) for a in rep.alerts),
        }
    except Exception as e:
        print(f"# snort_scale skipped: {e}", file=sys.stderr)

    # ---- everything else runs on a worker thread behind a hard deadline
    # (a hung call inside a section must not eat the JSON line);
    # sections write into ``ext`` as they complete, so partial progress
    # survives a mid-section stall
    ext: dict = {}

    def extras() -> None:
        # k-gram counting mode (4 bytes per step, exact totals) — the usual
        # headline winner
        kg = None
        try:
            from regex_fpga_tpu.ops.kgram import (
                build_kgram, dfa_scan_kgram, map_kgram_classes,
            )

            print("# compiling kgram graph...", file=sys.stderr)
            kg = build_kgram(dt, levels=2)
            ck = jnp.asarray(map_kgram_classes(kg, text).astype(np.int16))
            tj, aj = jnp.asarray(kg.table), jnp.asarray(kg.acc_table)
            nbk = 16384  # measured best: longer blocks amortize the prescan
            runk = lambda: dfa_scan_kgram(
                tj, aj, ck, num_blocks=nbk, start=tok.start, acc_bound=kg.k
            )
            rk = runk()
            np.asarray(rk.final_state)
            ms = _med_spread(runk, 5, lambda rr: np.asarray(rr.final_state))
            ext["kgram"] = _rate(l, ms)
            ext["kgram_converged"] = bool(rk.converged)
        except Exception as e:
            print(f"# kgram bench skipped: {e}", file=sys.stderr)

        # distributed k-gram on a 1x1 (data, seq) mesh: the SAME engine the
        # multi-chip path runs (shard_map + ppermute seams + psum) — r2
        # verdict #1's "headline capability, not just headline number"
        # check: must land within ~10% of the single-device rate
        try:
            if _remaining() < 150:
                raise RuntimeError(f"budget: {_remaining():.0f}s left")
            from regex_fpga_tpu.parallel import (
                dfa_scan_kgram_dist, make_mesh,
            )

            print("# compiling dist-kgram graph...", file=sys.stderr)
            mesh = make_mesh(1, 1)
            ckb = ck[None, :]
            rund = lambda: dfa_scan_kgram_dist(
                mesh, tj, aj, ckb, blocks_per_shard=nbk, start=tok.start,
                acc_bound=kg.k,
            )
            fin, tot, conv = rund()
            np.asarray(fin)
            rk = dfa_scan_kgram(tj, aj, ck, num_blocks=nbk, start=tok.start,
                                acc_bound=kg.k)
            assert int(tot[0]) == int(rk.total) and bool(conv)
            ms = _med_spread(rund, 3, lambda rr: np.asarray(rr[0]))
            ext["dist_kgram"] = _rate(l, ms)
            ext["dist_kgram"]["vs_single_device"] = round(
                ext["dist_kgram"]["bytes_per_sec"]
                / ext["kgram"]["bytes_per_sec"], 3
            ) if ext.get("kgram") else None
        except Exception as e:
            print(f"# dist-kgram bench skipped: {e}", file=sys.stderr)

        # throughput vs automaton size (r1 item 4, r2 verdict #2): k=1
        # counts/full at S=67..213 for round-over-round continuity, k-gram
        # counting through S=836 with composed-class growth per level —
        # the transition-monoid blowup chart (ops/kgram.py header)
        try:
            if _remaining() < 180:
                raise RuntimeError(f"budget: {_remaining():.0f}s left")
            from regex_fpga_tpu.models import build_aho_corasick
            from regex_fpga_tpu.ops.kgram import (
                build_kgram, dfa_scan_kgram, map_kgram_classes,
            )

            words = [
                w % i
                for i in range(300)
                for w in (b"error%04d", b"warning%03d", b"GET /path%d HTTP",
                          b"user-agent: bot%d", b"fail%dure")
            ]
            l_s = min(1 << 24, len(text))  # 16 MiB/pt (degraded: less)
            text_s = text[:l_s]
            sweep = ext.setdefault("size_sweep", [])
            for n_pat in (8, 24, 64, 150, 300):
                if _remaining() < 90:
                    print("# size sweep truncated (budget)", file=sys.stderr)
                    break
                ac = build_aho_corasick(words[:n_pat])
                dts = build_dfa_tables(ac.dfa.table, ac.dfa.accept)
                cls_s = jnp.asarray(
                    np.asarray(dts.class_of).astype(np.uint8)[text_s]
                )
                point = {"S": int(dts.num_states), "C": int(dts.num_classes)}
                k1_total = None
                emits = ("full", "counts") if n_pat <= 64 else ("counts",)
                for emit in emits:
                    runs = lambda: dfa_scan_fast(
                        dts, cls_s, num_blocks=16384, emit=emit
                    )
                    rs = runs()
                    np.asarray(rs.final_state)
                    if emit == "counts":
                        k1_total = int(np.asarray(rs.counts).sum())
                    ms = _med_spread(
                        runs, 5, lambda rr: np.asarray(rr.final_state),
                        discard_first=True,
                    )
                    point[f"k1_{emit}"] = _rate(l_s, ms)
                kgs = build_kgram(dts, levels=2, max_classes=1 << 14)
                if kgs is None:
                    point["kgram"] = "composed-class blowup (> 16384)"
                else:
                    point["kgram_classes_per_level"] = kgs.level_classes
                    # level chooser: padded-MXU-tile cost per byte with
                    # the per-route table widths (packed S / unpacked 2S /
                    # byte-split 3S) — shared with the API layer.  The
                    # REAL engine choice (choose_scan_level: measured
                    # S-gate folded in) is recorded per point and checked
                    # against the measured winner below; the k-gram curve
                    # itself is still measured for the record.
                    from regex_fpga_tpu.ops.kgram import (
                        choose_kgram_level, choose_scan_level,
                    )

                    point["model_level"] = choose_scan_level(
                        dts.num_states, kgs.level_classes
                    )
                    best = choose_kgram_level(
                        dts.num_states, kgs.level_classes
                    )
                    if best != 2:
                        kgs = build_kgram(dts, levels=best,
                                          max_classes=1 << 14)
                    point["kgram_level"] = best
                    cks = jnp.asarray(
                        map_kgram_classes(kgs, text_s).astype(np.int16)
                    )
                    runks = lambda: dfa_scan_kgram(
                        jnp.asarray(kgs.table), jnp.asarray(kgs.acc_table),
                        cks, num_blocks=16384, acc_bound=kgs.k,
                    )
                    rks = runks()
                    np.asarray(rks.final_state)
                    ms = _med_spread(
                        runks, 3, lambda rr: np.asarray(rr.final_state)
                    )
                    point["kgram_counts"] = _rate(l_s, ms)
                    point["kgram_converged"] = bool(rks.converged)
                    # cross-engine exactness ON SILICON: k=1 counting and
                    # k-gram totals are independent paths (incl. the
                    # byte-split bf16 encoding at S > 256) and must agree
                    point["totals_agree"] = (
                        k1_total is not None
                        and int(rks.total) == k1_total
                    )
                    # the model-chosen ENGINE must be the measured winner
                    # (within 5% noise) — the r3 verdict #9 regression on
                    # silicon: choose_scan_level's gate vs the measured
                    # k1/kgram rates at this size
                    if "k1_counts" in point:
                        k1b = point["k1_counts"]["bytes_per_sec"]
                        kgb = point["kgram_counts"]["bytes_per_sec"]
                        chosen = kgb if point["model_level"] else k1b
                        point["model_engine_ok"] = bool(
                            chosen >= 0.95 * max(k1b, kgb)
                        )
                # production-operating-point rate at large S: a 64 MiB
                # stream at nb=65536 (exactly what api's 64 MiB chunk
                # loop runs) amortizes the per-call dispatch cost that
                # the 16 MiB sweep points carry.
                try:
                    if point["S"] >= 200 and len(text) >= (1 << 26)                             and _remaining() > 120:
                        # deadline-threaded like the headline _upload; a
                        # stall skips the point, not the rest of the run
                        ubox: dict = {}

                        def _up_big():
                            try:
                                arr = jnp.asarray(
                                    np.asarray(dts.class_of).astype(
                                        np.uint8)[text]
                                )
                                np.asarray(arr[:8])
                                ubox["arr"] = arr
                            except Exception as ue:
                                ubox["err"] = ue

                        uth = threading.Thread(target=_up_big, daemon=True)
                        uth.start()
                        uth.join(timeout=90.0)
                        if "arr" not in ubox:
                            raise RuntimeError(
                                f"64 MiB class upload stalled/failed: "
                                f"{ubox.get('err')!r}")
                        cls_big = ubox["arr"]
                        runb = lambda: dfa_scan_fast(
                            dts, cls_big, num_blocks=65536, emit="counts"
                        )
                        rb = runb()
                        np.asarray(rb.final_state)
                        msb = _med_spread(
                            runb, 3, lambda rr: np.asarray(rr.final_state),
                            discard_first=True,
                        )
                        point["k1_counts_64mib"] = _rate(len(text), msb)
                        del cls_big
                except Exception as e:
                    print(f"# 64MiB large-S point skipped: {e}",
                          file=sys.stderr)
                # host-vs-device router verdict: device idle here (the
                # extras sections run sequentially on this one thread)
                try:
                    from regex_fpga_tpu.ops.router import (
                        choose_scan_backend,
                    )
                    from regex_fpga_tpu.utils.native import (
                        dfa_scan_multi_native,
                        dfa_scan_speculative_native,
                        native_available,
                    )

                    if native_available():
                        tabh = np.asarray(dts.table)
                        clsh = np.asarray(dts.class_of)
                        acch = np.asarray(dts.accept)
                        parts = np.array_split(
                            np.asarray(text_s[: 1 << 23]), 16
                        )
                        nb_h = sum(len(p) for p in parts)
                        runh = lambda: dfa_scan_multi_native(
                            tabh, clsh, acch, parts
                        )
                        runh()  # warm (thread pool, caches)
                        ms = _med_spread(runh, 5, lambda _: None,
                                         discard_first=True)
                        point["host_multi"] = _rate(nb_h, ms)
                        one_h = np.ascontiguousarray(text_s[: 1 << 23])
                        runsp = lambda: dfa_scan_speculative_native(
                            tabh, clsh, acch, one_h
                        )
                        runsp()
                        ms1 = _med_spread(runsp, 5, lambda _: None,
                                          discard_first=True)
                        point["host_spec_single"] = _rate(len(one_h), ms1)
                        # the router probes BOTH engines at its first
                        # contested call and routes on measured session
                        # rates (ops/router.py) — pass tables + a
                        # probe-qualifying workload as api._host_backend
                        # does
                        point["router_choice"] = choose_scan_backend(
                            dts.num_states, dts.num_classes, 16,
                            tables=dts, workload_bytes=1 << 30,
                        )
                        from regex_fpga_tpu.ops.router import (
                            session_rates,
                        )

                        point["router_session"] = {
                            k: v for k, v in session_rates().items()
                        }
                        # router_ok is only meaningful at the router's
                        # own operating point (big chunked workloads):
                        # emit the check when a production-point
                        # (64 MiB) device rate exists.
                        devb = (point.get("k1_counts_64mib")
                                or {}).get("bytes_per_sec")
                        hostb = point["host_multi"]["bytes_per_sec"]
                        # no 64 MiB device point -> no operating-point-
                        # valid comparison in either direction — skip
                        if devb is not None:
                            chosen = (hostb
                                      if point["router_choice"] == "host"
                                      else devb)
                            # 0.65: the envelope for the drift between
                            # probe time and sweep time (not re-measured
                            # on the GPU, ROADMAP S5); router_drift
                            # quantifies the gap per point.
                            point["router_ok"] = bool(
                                chosen >= 0.65 * max(devb, hostb)
                            )
                            sess = point.get("router_session") or {}
                            if "host_multi_bps" in sess:
                                point["router_drift_host"] = round(
                                    hostb / sess["host_multi_bps"], 3)
                except Exception as e:
                    print(f"# router point skipped: {e}", file=sys.stderr)
                sweep.append(point)
                print(f"# sweep point S={point['S']} done "
                      f"t={time.perf_counter()-_T0:.0f}s", file=sys.stderr)
        except Exception as e:
            print(f"# size sweep skipped: {e}", file=sys.stderr)

        # finditer with device-compacted position readback
        try:
            if _remaining() < 100:
                raise RuntimeError(f"budget: {_remaining():.0f}s left")
            from regex_fpga_tpu import api

            l_f = 1 << 25  # 32 MiB
            base = (b"log line with no hit 2026-xx-xx......  " * 8)[:256]
            rec = base[:-10] + b" id=31.25 "  # one match / 256 B = 131k total
            corpus = np.frombuffer(rec * (l_f // 256), np.uint8)
            mfd = api.compile_regex(rb"[0-9]+\.[0-9]+")
            spans = mfd.finditer_arrays(corpus)  # warm (compiles rev+fwd)
            t1 = time.perf_counter()
            spans = mfd.finditer_arrays(corpus)
            t_find = time.perf_counter() - t1
            mfd.scan(corpus)  # warm the forward counts shape
            t1 = time.perf_counter()
            mfd.scan(corpus)
            t_scan = time.perf_counter() - t1
            assert len(spans) == l_f // 256  # one span per 256 B record
            ext["finditer_32mib"] = {
                "matches": int(len(spans)),
                "finditer_s": round(t_find, 3),
                "scan_s": round(t_scan, 3),
                "finditer_vs_scan": round(t_find / t_scan, 2),
                "note": "backward pass downloads N*4 B compacted positions "
                        "(ops/dfa_fast.mask_positions) instead of the "
                        "2x32 MB masks",
            }
        except Exception as e:
            print(f"# finditer bench skipped: {e}", file=sys.stderr)

        # device prefilter for host-routed \b patterns: envelope DFA
        # scans on device, Pike VM verifies candidates only
        try:
            if _remaining() < 80:
                raise RuntimeError(f"budget: {_remaining():.0f}s left")
            from regex_fpga_tpu import api

            l_p = 1 << 25  # 32 MiB, sparse matches (1 per 8 KiB)
            blockp = b"x" * 8187 + b" cat "  # exactly 8192 B, one match
            corp = np.frombuffer(blockp * (l_p // 8192), np.uint8)
            mh = api.compile_regex(r"\bcat\b")
            spans = mh.finditer(bytes(corp))  # warm (compiles envelope)
            t1 = time.perf_counter()
            spans = mh.finditer(bytes(corp))
            t_pref = time.perf_counter() - t1
            n_expect = l_p // 8192
            assert len(spans) == n_expect
            # pure-host Pike VM reference rate on a 2 MiB slice
            slice_b = bytes(corp[: 1 << 21])
            t1 = time.perf_counter()
            pure = mh._prog.finditer_spans(slice_b)
            t_host = time.perf_counter() - t1
            assert len(pure) == len(slice_b) // 8192
            pref_bps = l_p / t_pref
            host_bps = len(slice_b) / t_host
            ext["host_prefilter"] = {
                "pattern": "\\bcat\\b",
                "prefiltered_bytes_per_sec": round(pref_bps, 1),
                "pure_host_bytes_per_sec": round(host_bps, 1),
                "speedup": round(pref_bps / host_bps, 1),
            }
        except Exception as e:
            print(f"# host prefilter bench skipped: {e}", file=sys.stderr)

        # ingest/compute overlap (median of >=3 pairs, serial/overlapped
        # interleaved so drift hits both equally)
        try:
            if _remaining() < 120:
                raise RuntimeError(f"budget: {_remaining():.0f}s left")
            from regex_fpga_tpu.parallel.ingest import (
                prefetch_chunks, resilient_scan,
            )

            chunk_b = 1 << 24  # 16 MiB x 8 chunks
            big = np.frombuffer(
                frag * int(np.ceil(8 * chunk_b / len(frag))),
                dtype=np.uint8,
            )[: 8 * chunk_b]

            def chunks_iter():
                for off in range(0, len(big), chunk_b):
                    yield off, big[off : off + chunk_b]

            def prepare(raw):  # host class-map + async device upload (uint8)
                return jnp.asarray(class_lut[raw])

            def scan_chunk(cls_dev, carry):
                st = int(carry["state"]) if carry else tok.start
                rr = dfa_scan_fast(dt, cls_dev, num_blocks=16384, start=st,
                                   emit="counts")
                return {"state": np.asarray(rr.final_state),
                        "total": (carry or {}).get("total", 0)
                        + int(np.asarray(rr.counts).sum())}

            scan_chunk(prepare(big[:chunk_b]), None)  # warm the chunk shape
            # self-diagnosis: when the upload dominates BOTH arms, parity is
            # expected — measure the two phases so the artifact says which
            # regime it measured instead of reading as an overlap
            # regression
            t1 = time.perf_counter()
            one_dev = prepare(big[:chunk_b])
            np.asarray(one_dev[:8])
            t_prep = time.perf_counter() - t1
            t1 = time.perf_counter()
            scan_chunk(one_dev, None)
            t_scan1 = time.perf_counter() - t1
            t_ser, t_ovl = [], []
            tot_ser = tot_ovl = None
            for _ in range(3):
                t1 = time.perf_counter()
                tot_ser = resilient_scan(
                    scan_chunk, ((o, prepare(c)) for o, c in chunks_iter())
                )["total"]
                t_ser.append(time.perf_counter() - t1)
                t1 = time.perf_counter()
                tot_ovl = resilient_scan(
                    scan_chunk, prefetch_chunks(chunks_iter(), prepare=prepare)
                )["total"]
                t_ovl.append(time.perf_counter() - t1)
            assert tot_ser == tot_ovl
            t_ser.sort(), t_ovl.sort()
            ext["ingest_overlap"] = {
                "chunks": 8,
                "chunk_bytes": chunk_b,
                "serial_bytes_per_sec": round(len(big) / t_ser[1], 1),
                "overlapped_bytes_per_sec": round(len(big) / t_ovl[1], 1),
                "speedup": round(t_ser[1] / t_ovl[1], 3),
                "speedup_spread": [
                    round(min(t_ser) / max(t_ovl), 3),
                    round(max(t_ser) / min(t_ovl), 3),
                ],
                "reps": 3,
                "upload_s_per_chunk": round(t_prep, 3),
                "scan_s_per_chunk": round(t_scan1, 3),
                "upload_bound": bool(t_prep > 1.5 * t_scan1),
                "note": "median of 3 interleaved serial/overlapped pairs; "
                        "prefetch overlaps class-map+upload of chunk k+1 "
                        "with the scan of chunk k; when upload_bound, "
                        "speedup ~1.0 is the expected ceiling (the "
                        "overlapped arm is serialized on the same link), "
                        "not an overlap regression",
            }
        except Exception as e:
            print(f"# ingest overlap skipped: {e}", file=sys.stderr)


    worker = threading.Thread(target=extras, daemon=True)
    worker.start()
    worker.join(timeout=max(10.0, _remaining() - 15.0))
    if worker.is_alive():
        print("# extras deadline hit — emitting with partial results",
              file=sys.stderr)

    kgram_bps = ext.get("kgram", {}).get("bytes_per_sec", 0.0)
    walker = conf.get("conf_walker")
    bps = max(full_bps, kgram_bps)
    out = {
        "metric": "dfa_scan_bytes_per_sec_per_device",
        "value": round(bps, 1),
        "unit": "B/s",
        "detail": {
            "engine": "dfa-fast (Jacobi + one-hot GEMM)",
            "full_output": full,
            "kgram4_counting": ext.get("kgram"),
            "dist_kgram4_counting_1x1_mesh": ext.get("dist_kgram"),
            "size_sweep": ext.get("size_sweep", []),
            "ingest_overlap": ext.get("ingest_overlap"),
            "finditer_32mib": ext.get("finditer_32mib"),
            "host_prefilter": ext.get("host_prefilter"),
            "kgram4_converged": ext.get("kgram_converged"),
            "stream_bytes": l,
            "degraded_upload": degraded,
            "upload_bps": state.get("upload_bps"),
            "upload_seconds": state.get("upload_seconds"),
            "num_blocks": nb,
            "kgram_num_blocks": 16384,
            "jacobi_iterations": iters,
            "converged": bool(r.converged),
            "dfa_states": dt.num_states,
            "byte_classes": dt.num_classes,
            "reference_fpga_bytes_per_sec": 129e3,
            "vs_reference_fpga": round(bps / 129e3, 1),
            "conformance_exact": conf.get("conf_ok"),
            "snort16_conformance_walker": walker,
            "snort_scale": conf.get("snort_scale"),
            "snort16_vs_reference_fpga": (
                round(walker["bytes_per_sec"] / 37e3, 1) if walker else None
            ),
            "device": {"platform": dev.platform, "kind": dev.device_kind,
                       "count": len(jax.devices())},
        },
    }
    state["json_detail"] = json.dumps(out)
    state["json"] = _compact_line(bps, full, ext, conf, walker, degraded,
                                  state, out["detail"]["device"])
    # main() prints the lines and then os._exit()s — a daemon worker may
    # still hold a hung call and must not outlive the budget


def _r3(x):
    """GB/s with 3 significant digits — compact-line real estate."""
    return round(x / 1e9, 3)


def _compact_line(bps, full, ext, conf, walker, degraded: bool = False,
                  state: dict | None = None, device: dict | None = None
                  ) -> str:
    """The FINAL stdout line: every load-bearing number in <=1,500 chars.
    Rates are GB/s [min,max] spreads; the size sweep is collapsed to the
    model-chosen engine's rate per size."""
    kg = ext.get("kgram")
    dk = ext.get("dist_kgram")
    sweep = ext.get("size_sweep") or []
    sw = {}
    for p in sweep:
        # display the MODEL-CHOSEN engine's rate per size (the k-gram
        # curve is still in the detail line for the record)
        if p.get("model_level", 0) == 0:
            rate = p.get("k1_counts") or p.get("kgram_counts") \
                or p.get("k1_full")
        else:
            rate = p.get("kgram_counts") or p.get("k1_counts") \
                or p.get("k1_full")
        if rate:
            sw[f"S{p['S']}"] = _r3(rate["bytes_per_sec"])
    ing = ext.get("ingest_overlap") or {}
    fi = ext.get("finditer_32mib") or {}
    hp = ext.get("host_prefilter") or {}
    detail = {
        "full_gbps": [_r3(full["bytes_per_sec"]), _r3(full["bps_min"]),
                      _r3(full["bps_max"])],
        "kgram_gbps": ([_r3(kg["bytes_per_sec"]), _r3(kg["bps_min"]),
                        _r3(kg["bps_max"])] if kg else None),
        "dist_kgram_gbps": _r3(dk["bytes_per_sec"]) if dk else None,
        "dist_vs_single": dk.get("vs_single_device") if dk else None,
        "sweep_counts_gbps": sw,
        "ingest_overlap_speedup": ing.get("speedup"),
        "finditer_vs_scan": fi.get("finditer_vs_scan"),
        "host_prefilter_speedup": hp.get("speedup"),
        "model_engine_ok": (lambda meo: all(meo) if meo else None)(
            [p["model_engine_ok"] for p in sweep if "model_engine_ok" in p]
        ),
        "router_ok": (lambda ro: all(ro) if ro else None)(
            [p["router_ok"] for p in sweep if "router_ok" in p]
        ),
        "conformance_exact": conf.get("conf_ok"),
        "snort16_walker_gbps": _r3(walker["bytes_per_sec"]) if walker else None,
        "snort_scale": (lambda ss: {
            "ms_per_payload": ss["scan_ms_per_payload"],
            "recall": ss["recall"],
            "enforced_pct": ss["enforced_pct"],
        } if ss else None)(conf.get("snort_scale")),
        "upload_bps": (state or {}).get("upload_bps"),
        "vs_reference_fpga": round(bps / 129e3, 1),
        "degraded_stream": degraded,
        "device": device,
    }
    line = json.dumps({
        "metric": "dfa_scan_bytes_per_sec_per_device",
        "value": round(bps, 1),
        "unit": "B/s",
        "detail": detail,
    })
    if len(line) > 1500:  # drop the sweep first
        detail["sweep_counts_gbps"] = "see detail line above"
        line = json.dumps({
            "metric": "dfa_scan_bytes_per_sec_per_device",
            "value": round(bps, 1), "unit": "B/s", "detail": detail,
        })
    return line


if __name__ == "__main__":
    main()
