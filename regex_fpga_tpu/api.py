"""Public API: compile rulesets / regexes / tokenizers into Matchers.

The reference's entire user workflow is "synthesize the RTL with a `.coe`
image and feed characters" (SURVEY.md SS3.1); the equivalent here is::

    m = compile_ruleset("CSR_BlockMem.coe")          # NFA engine, bit-exact
    report = m.scan([stream_lo, stream_hi])          # per-state histograms

    m = compile_regex(r"\\d+\\.\\d+", anchored=False)  # DFA fast engine
    report = m.scan(data)                             # counts + positions

    tok = compile_tokenizer()                         # GPT-2-style pre-split
    offsets = tok.presplit(text)

Engine selection: `.coe` rulesets are true NFAs (SURVEY.md SS0) and run on
the bounded-active-set engine; compiled regexes run on the one-hot GEMM
DFA engine with Jacobi seams, falling back to the exact associative engine
when fixpoint iteration does not converge (adversarial automata).
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np

from .models.csr import CsrAutomaton, load_coe
from .models.regex import CompiledDfa, compile_pattern
from .models.tokenizer_dfa import (
    GPT2_PRESPLIT,
    TokenizerDfa,
    boundaries_from_flags,
    build_tokenizer_dfa,
)
from .ops.dfa_engine import dfa_scan_blocked, dfa_scan_serial
from .ops.dfa_fast import dfa_scan_fast
from .ops.nfa_engine import nfa_scan_jax
from .ops.tables import DfaTables, build_dfa_tables, build_nfa_tables
from .utils.config import DEFAULT_CONFIG, EngineConfig
from .utils.metrics import RunMetrics, Timer

__all__ = [
    "ScanReport",
    "Match",
    "NfaMatcher",
    "DfaStreamScanner",
    "DfaMatcher",
    "TokenizerMatcher",
    "LiteralSetMatcher",
    "LiteralReport",
    "compile_ruleset",
    "compile_regex",
    "HostRegexMatcher",
    "HostBacktrackMatcher",
    "compile_regex_set",
    "compile_regex_set_prefiltered",
    "PrefilteredRuleSet",
    "compile_l7",
    "compile_literals",
    "compile_snort",
    "SnortMatcher",
    "SnortReport",
    "SnortAlert",
    "compile_tokenizer",
    "RuleSetMatcher",
]


@dataclasses.dataclass
class ScanReport:
    """Result of scanning one or more byte streams."""

    counts: np.ndarray          # (num_streams, S) per-state match counts
    total: int                  # sum of all matches
    match_positions: list | None  # per stream: byte offsets where a match fired
    metrics: RunMetrics

    def histogram(self, stream: int = 0) -> dict[int, int]:
        """Nonzero per-state counts — the reference testbench's final report
        (``testbench_BLK_Mem.sv:75-85``)."""
        row = self.counts[stream]
        return {int(i): int(c) for i, c in enumerate(row) if c}


class Match:
    """``re.Match``-style result: byte-offset span + capture groups.

    The overall span comes from the device engines (POSIX leftmost-longest);
    group sub-spans are recovered host-side by the tagged Pike VM
    (``models/captures.py``) re-walking just the matched bytes, with greedy
    (Perl-style) disambiguation inside the fixed span.  Matchers without a
    capture program (rulesets, literals, tokenizers) yield group-0-only
    matches."""

    __slots__ = ("string", "_start", "_end", "_spans", "_names",
                 "_lastindex", "pos", "endpos", "re")

    def __init__(self, string: bytes, start: int, end: int,
                 group_spans: list | None = None,
                 group_names: dict | None = None,
                 lastindex: int | None = None):
        self.string = string
        self._start = start
        self._end = end
        self._spans = group_spans or []  # per group 1..n: (a, b) or None
        self._names = group_names or {}
        self._lastindex = lastindex
        #: ``re.Match`` parity attributes (r4 leftover): the search
        #: window and producing pattern.  Defaults cover direct engine
        #: matches; the ``search``/``match``/``fullmatch``/``finditer``
        #: entry points restamp them with the caller's clamped
        #: ``pos``/``endpos`` and ``re_compat.Pattern`` attaches itself.
        self.pos = 0
        self.endpos = len(string)
        self.re = None

    def _idx(self, key) -> int:
        if isinstance(key, str):
            if key not in self._names:
                raise IndexError(f"no such group: {key!r}")
            return self._names[key]
        if key == 0 or 1 <= key <= len(self._spans):
            return key
        raise IndexError(f"no such group: {key}")

    def span(self, idx=0) -> tuple[int, int]:
        idx = self._idx(idx)
        if idx == 0:
            return (self._start, self._end)
        sp = self._spans[idx - 1]
        return (-1, -1) if sp is None else sp

    def start(self, idx=0) -> int:
        return self.span(idx)[0]

    def end(self, idx=0) -> int:
        return self.span(idx)[1]

    def group(self, *idxs):
        if not idxs:
            idxs = (0,)
        out = []
        for i in idxs:
            a, b = self.span(i)
            out.append(None if a < 0 else self.string[a:b])
        return out[0] if len(out) == 1 else tuple(out)

    def groups(self, default=None) -> tuple:
        return tuple(
            default if sp is None else self.string[sp[0]:sp[1]]
            for sp in self._spans
        )

    def groupdict(self, default=None) -> dict:
        return {name: self.group(name) if self._spans[i - 1] is not None
                else default
                for name, i in self._names.items()}

    @property
    def lastindex(self) -> int | None:
        """Index of the chronologically last matched group (``re`` semantics:
        the last capture "mark" written on the winning path)."""
        return self._lastindex

    @property
    def lastgroup(self) -> str | None:
        """Name of the last matched group, None if unnamed/none matched."""
        if self._lastindex is None:
            return None
        for name, i in self._names.items():
            if i == self._lastindex:
                return name
        return None

    @property
    def regs(self) -> tuple:
        """All group spans as ``re``'s ``regs`` tuple ((-1, -1) = no
        match), group 0 first."""
        return ((self._start, self._end),) + tuple(
            (-1, -1) if sp is None else tuple(sp) for sp in self._spans
        )

    def expand(self, template: bytes) -> bytes:
        """Expand a ``re.sub``-style template (``\\1``, ``\\g<name>``, ...)
        against this match."""
        from .re_compat import _expand

        return _expand(template, self)

    def __getitem__(self, idx) -> bytes:
        return self.group(idx)

    def __repr__(self) -> str:
        return (f"<regex_fpga_tpu.Match span=({self._start}, {self._end}) "
                f"match={self.group()!r}>")


def _stamp_pos(m: "Match | None", pos: int) -> "Match | None":
    """Record the caller's clamped ``pos`` on a Match (``re.Match.pos``
    parity).  ``endpos`` needs no stamp: ``Match.string`` is already the
    endpos-truncated subject, so the default ``len(string)`` IS the
    clamped endpos in subject coordinates."""
    if m is not None:
        m.pos = pos
    return m


def _as_streams(data) -> list[np.ndarray]:
    if isinstance(data, (bytes, bytearray, memoryview)):
        return [np.frombuffer(data, dtype=np.uint8)]
    if isinstance(data, np.ndarray):
        if data.ndim == 1:
            return [data.astype(np.uint8)]
        return [row.astype(np.uint8) for row in data]
    return [s if isinstance(s, np.ndarray) else np.frombuffer(s, dtype=np.uint8)
            for s in data]


class NfaMatcher:
    """Bit-exact NFA matcher for CSR rulesets (the conformance engine).

    Strategies:
      - ``"lazy"`` (default): lazy subset determinization — intern the
        workload's reachable subset states (729 / 18.7k on the reference
        traces vs >300k for full determinization) and walk the
        incrementally-built table with the native C++ scanner (serial per
        stream; multi-stream batches run the multi-cursor walker,
        models/lazy_dfa.py);
      - ``"lazy-device"``: same automaton, chunks scanned on-device with
        Jacobi seams + overlap sync (ops/lazy_scan.py);
      - ``"active-set"``: the bounded-active-set device engine
        (ops/nfa_engine.py) — used by the distributed / multi-ruleset paths
        and as the fallback.
    """

    def __init__(self, aut: CsrAutomaton, config: EngineConfig = DEFAULT_CONFIG,
                 strategy: str = "lazy"):
        self.automaton = aut
        self.config = config
        self.strategy = strategy
        self.tables = build_nfa_tables(aut)
        self._lazy = None

    @property
    def lazy_dfa(self):
        if self._lazy is None:
            from .models.lazy_dfa import LazyDfa

            self._lazy = LazyDfa(self.automaton)
        return self._lazy

    @property
    def num_states(self) -> int:
        return self.tables.num_states

    def scan(self, data, collect_positions: bool = False) -> ScanReport:
        streams = _as_streams(data)
        s = self.num_states
        counts = np.zeros((len(streams), s), dtype=np.int64)
        positions: list = []
        with Timer() as t:
            if self.strategy == "lazy" and len(streams) > 1:
                # batch axis: all streams walked concurrently (the
                # reference's dual-stream design generalized; exact per
                # stream, no speculation needed)
                counts[:], _ = self.lazy_dfa.host_scan_batch(streams)
                streams_iter = []
            else:
                streams_iter = list(enumerate(streams))
            for i, stream in streams_iter:
                if self.strategy == "lazy":
                    counts[i], _, _ = self.lazy_dfa.host_scan(stream)
                elif self.strategy == "lazy-device":
                    from .ops.lazy_scan import lazy_nfa_scan

                    counts[i] = lazy_nfa_scan(self.lazy_dfa, stream).counts
                else:
                    res = self._scan_stream(stream)
                    counts[i] = np.asarray(res.counts)
                    if bool(res.overflowed):
                        raise RuntimeError(
                            "active-set bound exceeded; raise "
                            "EngineConfig.active_bound"
                        )
            _ = counts.sum()  # force
        if collect_positions:
            positions = [self._positions(st) for st in streams]
        m = RunMetrics(
            engine=f"nfa-{self.strategy}",
            bytes_scanned=sum(len(s_) for s_ in streams),
            streams=len(streams),
            matches=int(counts.sum()),
            wall_seconds=t.seconds,
        )
        return ScanReport(counts=counts, total=int(counts.sum()),
                          match_positions=positions if collect_positions else None,
                          metrics=m)

    def _scan_stream(self, stream: np.ndarray, carry=None):
        cb = self.config.chunk_bytes
        res = None
        start_active, counts_init = None, None
        if carry is not None:
            start_active, counts_init = carry
        for off in range(0, max(len(stream), 1), cb):
            chunk = jnp.asarray(stream[off : off + cb])
            res = nfa_scan_jax(
                self.tables, chunk, self.config.active_bound,
                start_active=start_active, counts_init=counts_init,
            )
            start_active = res.final_active
            counts_init = jnp.concatenate(
                [res.counts, jnp.zeros(1, jnp.int32)]
            )
        return res

    def _positions(self, stream: np.ndarray) -> np.ndarray:
        """Match byte offsets via the native active-set walk (the Python
        oracle replay is the fallback; it is slow on match-dense streams)."""
        from .utils.native import native_available, nfa_match_positions_native

        if native_available():
            return nfa_match_positions_native(
                np.asarray(self.tables.delta),
                np.asarray(self.tables.class_of),
                np.asarray(self.tables.accept),
                np.ascontiguousarray(stream, dtype=np.uint8),
                active_cap=self.config.active_bound,
            )
        from .models.oracle import nfa_scan_trace

        hist = nfa_scan_trace(self.automaton, stream)
        acc = self.automaton.accept_mask
        return np.array(
            [i for i, states in enumerate(hist[:-1]) if any(acc[s] for s in states)],
            dtype=np.int64,
        )

    # -- streaming / checkpoint (SURVEY.md SS5.3-5.4) ----------------------

    def stream_scanner(self, resume: dict | None = None):
        if self.strategy == "lazy":
            return LazyStreamScanner(self, resume)
        return NfaStreamScanner(self, resume)


class NfaStreamScanner:
    """Incremental scanning with an O(S)-sized serializable carry — the
    device-side version of the observation that the reference's entire matcher
    state is just the active bitmaps + stream offset (``FPGA.v:54-57``)."""

    def __init__(self, matcher: NfaMatcher, resume: dict | None = None):
        self.m = matcher
        if resume is None:
            resume = {}
        # a checkpoint taken before the first feed() has no carry arrays
        active = resume.get("active")
        counts = resume.get("counts")
        self.active = None if active is None else jnp.asarray(active, jnp.int32)
        self.counts = None if counts is None else jnp.asarray(counts, jnp.int32)
        self.offset = int(resume.get("offset", 0))

    def feed(self, data: bytes | np.ndarray) -> None:
        stream = _as_streams(data)[0]
        res = self.m._scan_stream(stream, carry=(self.active, self.counts))
        self.active = res.final_active
        self.counts = jnp.concatenate([res.counts, jnp.zeros(1, jnp.int32)])
        self.offset += len(stream)

    def checkpoint(self) -> dict:
        return {
            "active": np.asarray(self.active) if self.active is not None else None,
            "counts": np.asarray(self.counts) if self.counts is not None else None,
            "offset": self.offset,
        }

    @property
    def state_counts(self) -> np.ndarray:
        if self.counts is None:
            return np.zeros(self.m.num_states, dtype=np.int64)
        return np.asarray(self.counts)[: self.m.num_states].astype(np.int64)


class LazyStreamScanner:
    """Incremental scanning on the lazy subset DFA; the carry is just
    (per-NFA-state counts, subset-state id, offset) — the SS5.4 property that
    the whole matcher state is O(S)."""

    def __init__(self, matcher: "NfaMatcher", resume: dict | None = None):
        self.m = matcher
        if resume is None:
            self.counts = np.zeros(matcher.num_states, dtype=np.int64)
            self.state_id = matcher.lazy_dfa.start
            self.offset = 0
        else:
            self.counts = np.array(resume["counts"], dtype=np.int64)
            # checkpoints carry the subset's NFA MEMBERS (stable across
            # processes), not the interning-order-dependent id
            members = tuple(int(x) for x in np.asarray(resume["state_set"]))
            self.state_id = matcher.lazy_dfa._intern(members)
            self.offset = int(resume["offset"])

    def feed(self, data) -> None:
        stream = _as_streams(data)[0]
        self.counts, self.state_id, n = self.m.lazy_dfa.host_scan(
            stream, self.state_id, self.counts
        )
        self.offset += n

    def checkpoint(self) -> dict:
        return {
            "counts": np.array(self.counts),
            "state_set": np.array(
                self.m.lazy_dfa._sets[self.state_id], dtype=np.int64
            ),
            "offset": self.offset,
        }

    @property
    def state_counts(self) -> np.ndarray:
        return np.array(self.counts)


class DfaMatcher:
    """High-throughput DFA matcher (fast GEMM engine + exact fallback)."""

    def __init__(self, dfa: CompiledDfa, config: EngineConfig = DEFAULT_CONFIG):
        self.dfa = dfa
        self.config = config
        self.tables: DfaTables = build_dfa_tables(dfa.table, dfa.accept)
        # uint8 LUT: class ids always fit one byte (C <= 256), so the
        # host->device upload of a class stream is 1 B/byte instead of 4
        # (the engines cast to int32 ON device)
        self._class_lut = np.asarray(self.tables.class_of).astype(np.uint8)
        # accept mask for the FINAL state: end-anchored patterns ($) carry
        # it separately from the per-position mask (models/regex.py)
        self._accept_eof = np.asarray(dfa.eof_accept)
        self.start = dfa.start
        # populated by compile_regex for finditer support (built lazily)
        self._finditer_source: tuple | None = None
        self._reverse_matcher: "DfaMatcher | None" = None
        self._anchored_np: tuple | None = None
        self._anchored_start: int = 0
        self._capture_prog = None  # lazy CaptureProgram (False = no groups)

    @property
    def num_states(self) -> int:
        return self.tables.num_states

    #: class-level defaults: subclasses that bypass ``__init__`` (e.g.
    #: TokenizerMatcher) still get working ``_make_match`` / mask engines
    _capture_prog = None
    _stall_tables = None  # lazy stall-extended tables (ragged batching)

    #: include a match whose accept state is entered by the very last byte.
    #: The reference timing drops it (SURVEY.md SS3.3 item 4: the harness
    #: stops before the state would be scanned); a general regex API should
    #: report it.  NfaMatcher keeps strict reference semantics.
    include_final_match: bool = True

    def _host_backend(self, n_streams: int,
                      workload_bytes: int = 0) -> bool:
        """True when the engine router sends this counting/histogram scan
        to the native multi-cursor walker instead of the device (measured
        large-S crossover, ``ops/router.py``; the same discipline as the
        k-gram S-gate one level down).  ``workload_bytes`` lets the
        router fire its per-session runtime probe when enough work is at
        stake to amortize it."""
        from .ops.router import choose_scan_backend
        from .utils.native import native_available

        mode = getattr(self.config, "scan_backend", "auto")
        if mode == "device":
            return False
        choice = choose_scan_backend(
            self.tables.num_states, self.tables.num_classes, n_streams,
            mode, tables=self.tables, workload_bytes=workload_bytes,
            chunk_bytes=self.config.chunk_bytes,
            num_blocks=self.config.num_blocks,
            min_block_bytes=self.config.min_block_bytes,
        )
        return choice == "host" and native_available()

    def _host_tables(self):
        """Host-side numpy copies of the device tables, cached: a fresh
        ``np.asarray`` per call would also defeat the int16 downcast memo
        in ``utils.native`` (keyed on array identity)."""
        if not hasattr(self, "_host_np_cache"):
            self._host_np_cache = (
                np.asarray(self.tables.table),
                np.asarray(self.tables.class_of),
                np.asarray(self.tables.accept),
            )
        return self._host_np_cache

    def _host_scan_counts(self, streams):
        """(per-stream per-state counts, final states) via the native
        interleaved walker — bit-identical histograms to the device scan
        (one-char-late accept timing, final accept not counted; the
        include_final_match EOF adjustment is applied by the caller).
        Few big streams can't fill the interleave width on their own, so
        each one is SPLIT speculatively (the device engine's seam trick
        mirrored on the host, ``dfa_scan_speculative_native``)."""
        from .utils.native import (
            dfa_scan_multi_native, dfa_scan_speculative_native,
        )

        tab, cls, acc = self._host_tables()
        if len(streams) < 4:
            counts = np.zeros((len(streams), self.num_states), np.int64)
            finals = np.zeros(len(streams), np.int32)
            for i, st in enumerate(streams):
                counts[i], finals[i] = dfa_scan_speculative_native(
                    tab, cls, acc, st, start=self.start
                )
            return counts, finals
        return dfa_scan_multi_native(tab, cls, acc, streams,
                                     starts=self.start)

    def scan(self, data, collect_positions: bool = False) -> ScanReport:
        streams = _as_streams(data)
        counts = np.zeros((len(streams), self.num_states), dtype=np.int64)
        positions: list = []
        iters = 0
        converged = True
        if len(streams) and self._host_backend(
                len(streams), sum(len(s_) for s_ in streams)):
            from .utils.native import dfa_scan_native

            with Timer() as t:
                if collect_positions:
                    finals = np.zeros(len(streams), dtype=np.int64)
                    tabh, clsh, acch = self._host_tables()
                    for i, stream in enumerate(streams):
                        c, mask, fin = dfa_scan_native(
                            tabh, clsh, acch,
                            stream, start=self.start,
                        )
                        counts[i] = c
                        finals[i] = fin
                        positions.append(np.nonzero(mask)[0])
                else:
                    counts[:], finals = self._host_scan_counts(streams)
                for i, stream in enumerate(streams):
                    if (self.include_final_match and len(stream)
                            and self._accept_eof[finals[i]]):
                        counts[i, finals[i]] += 1
                        if collect_positions:
                            positions[i] = np.concatenate(
                                [positions[i], [len(stream)]]
                            )
            m = RunMetrics(
                engine="dfa-host-native",
                bytes_scanned=sum(len(s_) for s_ in streams),
                streams=len(streams),
                matches=int(counts.sum()),
                wall_seconds=t.seconds,
            )
            return ScanReport(
                counts=counts, total=int(counts.sum()),
                match_positions=positions if collect_positions else None,
                metrics=m,
            )
        if (not collect_positions and len(streams) > 1
                and len({len(s_) for s_ in streams}) == 1
                and len(streams[0]) > 0):
            # equal-length batch: all streams as extra chain lanes in ONE
            # GEMM chain (the reference's dual-stream design generalized)
            with Timer() as t:
                c, iters, converged, cur = self._scan_batch_counts(
                    np.stack(streams)
                )
                counts[:] = c
                for i in range(len(streams)):
                    if self.include_final_match and self._accept_eof[cur[i]]:
                        counts[i, cur[i]] += 1
            m = RunMetrics(
                engine="dfa-fast-batch",
                bytes_scanned=sum(len(s_) for s_ in streams),
                streams=len(streams),
                matches=int(counts.sum()),
                wall_seconds=t.seconds,
                iterations=iters,
                converged=converged,
            )
            return ScanReport(counts=counts, total=int(counts.sum()),
                              match_positions=None, metrics=m)
        if (not collect_positions and len(streams) > 1
                and any(len(s_) for s_ in streams)):
            # RAGGED batch (r4 verdict item 3): variable-length streams
            # pad with the stall class and ride the same one-GEMM-chain
            # lane batching — N independent variable-length flows is the
            # reference's actual workload generalized (FPGA.v:54-57); the
            # old serial loop paid one scan dispatch per stream
            with Timer() as t:
                c, iters, converged, cur = self._scan_ragged_counts(streams)
                counts[:] = c
                for i, stream in enumerate(streams):
                    if (self.include_final_match and len(stream)
                            and self._accept_eof[cur[i]]):
                        counts[i, cur[i]] += 1
            m = RunMetrics(
                engine="dfa-fast-batch-ragged",
                bytes_scanned=sum(len(s_) for s_ in streams),
                streams=len(streams),
                matches=int(counts.sum()),
                wall_seconds=t.seconds,
                iterations=iters,
                converged=converged,
            )
            return ScanReport(counts=counts, total=int(counts.sum()),
                              match_positions=None, metrics=m)
        with Timer() as t:
            for i, stream in enumerate(streams):
                if not collect_positions:
                    # counts-only: per-state histogram computed on device,
                    # per-position arrays never cross the host link
                    c, it, conv = self._scan_stream_counts(stream)
                    counts[i] = c
                else:
                    st, mask, it, conv = self._scan_stream(stream)
                    counts[i] = np.bincount(
                        st[mask], minlength=self.num_states
                    )
                iters = max(iters, it)
                converged &= conv
                pos = (np.nonzero(mask)[0] if collect_positions else None)
                if (self.include_final_match and len(stream)
                        and self._accept_eof[self._last_final]):
                    counts[i, self._last_final] += 1
                    if collect_positions:
                        pos = np.concatenate([pos, [len(stream)]])
                positions.append(pos)
        m = RunMetrics(
            engine="dfa-fast",
            bytes_scanned=sum(len(s_) for s_ in streams),
            streams=len(streams),
            matches=int(counts.sum()),
            wall_seconds=t.seconds,
            iterations=iters,
            converged=converged,
        )
        return ScanReport(counts=counts, total=int(counts.sum()),
                          match_positions=positions if collect_positions else None,
                          metrics=m)

    def _pick_blocks(self, n: int) -> int:
        from .utils.config import shrink_blocks

        return shrink_blocks(n, self.config.num_blocks,
                             self.config.min_block_bytes)

    def _kgram(self):
        """Cached k-gram tables (4 bytes/engine step), or None when the
        k=1 counts engine is the chosen engine: k-gram is used only for
        S <= ``ops.kgram.KGRAM_MAX_STATES`` (the constant is shared with
        the cost model's ``choose_scan_level``)."""
        if not hasattr(self, "_kgram_cache"):
            from .ops.kgram import KGRAM_MAX_STATES, build_kgram

            if self.tables.num_states > KGRAM_MAX_STATES:
                self._kgram_cache = None
                return None
            kg = build_kgram(self.tables, levels=2)
            if kg is None:
                self._kgram_cache = None
            else:
                self._kgram_cache = (
                    kg,
                    jnp.asarray(kg.table),
                    jnp.asarray(kg.acc_table),
                )
        return self._kgram_cache

    def count(self, data) -> int:
        """Total match count — the throughput mode (``grep -c``).

        Uses the k-gram engine (4 bytes per engine step, exact totals; the
        host maps bytes to k-gram classes with the native streaming
        passes) when the composed class count stays small, with any
        non-divisible tail finished by the serial scanner from the k-gram
        carry state.  Always equals ``scan(data).total``.
        """
        from .ops.kgram import dfa_scan_kgram, map_kgram_classes

        streams = _as_streams(data)
        # engine router: realistic-S DFAs (k-gram gated off, padded-tile
        # device rate below the native walker) count on the host — the
        # same crossover discipline as the kgram gate, one level up
        # (ops/router.py)
        if streams and self._kgram() is None and self._host_backend(
                len(streams), sum(len(s_) for s_ in streams)):
            counts, finals = self._host_scan_counts(streams)
            total = int(counts.sum())
            if self.include_final_match:
                for i, stream in enumerate(streams):
                    if len(stream) and self._accept_eof[finals[i]]:
                        total += 1
            return total
        total = 0
        for stream in streams:
            if len(stream) == 0:
                continue
            kgc = self._kgram()
            if kgc is None:
                total += int(self.scan([stream]).counts.sum())
                continue
            kg, tj, aj = kgc
            cb = self.config.chunk_bytes  # corpus-scale: bounded host/HBM use
            cur = self.start
            stream_total = 0
            diverged = False
            off = 0
            while off < len(stream):
                chunk = stream[off : off + cb]
                steps = len(chunk) // kg.k
                nb = self._pick_blocks(max(steps, 1))
                main_steps = (steps // nb) * nb
                main_len = main_steps * kg.k
                if main_len:
                    ck = map_kgram_classes(kg, chunk[:main_len])
                    res = dfa_scan_kgram(
                        tj, aj, jnp.asarray(ck), num_blocks=nb, start=cur,
                        max_iters=self.config.max_iters, acc_bound=kg.k,
                    )
                    if not bool(res.converged):
                        diverged = True
                        break
                    stream_total += int(res.total)
                    cur = int(res.final_state)
                tail = chunk[main_len:]
                if len(tail):
                    ser = dfa_scan_serial(
                        self.tables, jnp.asarray(tail), start=cur
                    )
                    stream_total += int(np.asarray(ser.counts).sum())
                    cur = int(ser.final_state)
                off += cb
            if diverged:  # rare: non-synchronizing automaton — exact
                # fallback over the WHOLE stream (partial totals discarded)
                total += int(self.scan([stream]).counts.sum())
                continue
            if self.include_final_match and bool(self._accept_eof[cur]):
                stream_total += 1
            total += stream_total
        return total

    def _scan_stream(self, stream: np.ndarray, start=None):
        """Returns (states (L,), match_mask (L,), iterations, converged).
        ``states[i]`` is the state before byte i; the final state is stored
        in ``self._last_final`` (state after the whole stream)."""
        start = self.start if start is None else start
        classes = self._class_lut[stream]
        states = np.empty(len(stream), dtype=np.int32)
        mask = np.empty(len(stream), dtype=bool)
        iters, converged = 0, True
        off = 0
        cb = self.config.chunk_bytes
        cur = start
        while off < len(stream):
            chunk = classes[off : off + cb]
            nb = self._pick_blocks(len(chunk))
            res = dfa_scan_fast(
                self.tables, jnp.asarray(chunk), num_blocks=nb,
                start=cur, max_iters=self.config.max_iters,
            )
            if not bool(res.domain_ok):
                raise RuntimeError(
                    "device DFA pass produced out-of-domain state ids — "
                    "corrupt table or broken exactness contract "
                    "(SURVEY.md SS5.2 guard)"
                )
            if not bool(res.converged):
                converged = False
                res = self._exact_fallback(stream[off : off + cb], cur)
            states[off : off + cb] = np.asarray(res.states)
            mask[off : off + cb] = np.asarray(res.match_mask)
            cur = int(res.final_state)
            iters = max(iters, int(getattr(res, "iterations", 0)))
            off += cb
        self._last_final = cur
        return states, mask, iters, converged

    def _mask_chunk_device(self, raw_chunk, cur: int):
        """One chunk's (match_mask device/host array, final_state, converged)
        via the k=1 mask scan (docs/ENGINE_GRAVEYARD.md records the
        pair-composed "mask2" engine that was pruned from here).
        Non-convergence falls back to the exact path (host mask)."""
        n = len(raw_chunk)
        chunk_cls = self._class_lut[raw_chunk]
        nb = self._pick_blocks(n)
        res = dfa_scan_fast(
            self.tables, jnp.asarray(chunk_cls), num_blocks=nb,
            start=cur, max_iters=self.config.max_iters, emit="mask",
        )
        if not bool(res.domain_ok):
            raise RuntimeError(
                "device DFA pass produced out-of-domain state ids "
                "(SURVEY.md SS5.2 guard)"
            )
        if not bool(res.converged):
            fb = self._exact_fallback(np.asarray(raw_chunk), cur)
            return np.asarray(fb.match_mask), int(fb.final_state), False
        return res.match_mask, int(res.final_state), True

    def _scan_match_positions(self, stream: np.ndarray, start=None) -> np.ndarray:
        """Byte offsets where the accept mask is set, via DEVICE-side
        compaction (``ops.dfa_fast.mask_positions``): each chunk downloads a
        4-byte count plus a geometric bucket of int32 positions instead of
        the full 1 B/byte mask — N*4 bytes for N matches.  Chunks denser
        than cap/chunk fall back to mask readback (cheaper at that
        density).
        Sets ``self._last_final``.  Returns ascending int64 offsets."""
        from .ops.dfa_fast import mask_positions

        start = self.start if start is None else start
        out = [np.empty(0, np.int64)]
        off, cur = 0, start
        cb = self.config.chunk_bytes
        while off < len(stream):
            chunk = stream[off : off + cb]
            mask_dev, cur_next, dev_ok = self._mask_chunk_device(chunk, cur)
            if not dev_ok:  # exact fallback already host-side
                pos = np.nonzero(mask_dev)[0]
            else:
                cap = max(1024, len(chunk) // 4)
                pos_dev, count_dev = mask_positions(mask_dev, cap)
                count = int(count_dev)
                if count > cap:  # dense chunk: the mask IS the cheaper read
                    pos = np.nonzero(np.asarray(mask_dev))[0]
                else:
                    # geometric bucket keeps the compiled-slice shape count
                    # small (each new shape is a fresh compile)
                    b = 1024
                    while b < count:
                        b *= 4
                    pos = (np.asarray(pos_dev[: min(b, cap)])[:count]
                           if count else np.empty(0, np.int32))
            out.append(pos.astype(np.int64) + off)
            cur = cur_next
            off += cb
        self._last_final = cur
        return np.concatenate(out)

    def _scan_mask(self, stream: np.ndarray, start=None) -> np.ndarray:
        """Match-mask chunked scan, reconstructed host-side from the
        compacted device positions (``_scan_match_positions``) — one code
        path for both representations.  Sets ``self._last_final``."""
        pos = self._scan_match_positions(stream, start)
        mask = np.zeros(len(stream), dtype=bool)
        mask[pos] = True
        return mask

    def _scan_batch_counts(self, arr: np.ndarray):
        """Chunked batch scan of (N, L) equal-length streams via
        ``dfa_scan_fast_multi`` (per-stream device-side histograms).
        Returns (counts (N, S), iterations, converged, final_states (N,))."""
        from .ops.dfa_fast import dfa_scan_fast_multi

        n, l = arr.shape
        classes = self._class_lut[arr]
        counts = np.zeros((n, self.num_states), dtype=np.int64)
        cur = np.full(n, self.start, dtype=np.int32)
        iters, converged = 0, True
        off = 0
        cb = self.config.chunk_bytes
        while off < l:
            chunk = classes[:, off : off + cb]
            nb = self._pick_blocks(chunk.shape[1])
            res = dfa_scan_fast_multi(
                self.tables, jnp.asarray(chunk), num_blocks=nb,
                starts=jnp.asarray(cur), max_iters=self.config.max_iters,
                emit="counts",
            )
            if not bool(res.converged):
                converged = False
                # exact per-stream fallback for this chunk only
                for i in range(n):
                    r = self._exact_fallback(arr[i, off : off + cb], int(cur[i]))
                    counts[i] += np.bincount(
                        np.asarray(r.states)[np.asarray(r.match_mask)],
                        minlength=self.num_states,
                    )
                    cur[i] = r.final_state
            else:
                counts += np.asarray(res.counts)
                cur = np.asarray(res.final_states).copy()
            iters = max(iters, int(res.iterations))
            off += cb
        return counts, iters, converged, cur

    def _scan_ragged_counts(self, streams):
        """Variable-length batch in ONE multi-lane chain (r4 verdict
        item 3): streams pad AT THE FRONT to a common bucket with the
        STALL class (identity table column, ``ops.tables.stall_extend``)
        and run through ``dfa_scan_fast_multi`` with per-lane pinned
        entries exactly like the equal-length path.

        Front padding is the load-bearing choice (r5 review finding 2):
        stall lanes then carry the stream's ENTRY state — which is
        exactly what the engine's speculative replay (seeded from the
        per-lane start) predicts for an all-stall tail — so the seam
        induction passes on the usual single pass.  Tail padding instead
        froze the UNKNOWN final state across the stall lanes, which
        speculation (replay from start) can never guess and the Jacobi
        fixpoint only propagates ONE lane per iteration: any stream
        padded by more than ``max_iters`` blocks forced 16 wasted device
        passes plus the per-byte host fallback (measured 50x slower than
        the serial loop this path replaced).

        The only side effect is exact: during the pad steps the lane
        sits in the stream's entry state, so the overcount is precisely
        ``pad_steps`` visits of the ENTRY state, subtracted afterwards.
        Returns (counts (N, S) int64, iters, converged, finals (N,))."""
        from .ops.dfa_fast import dfa_scan_fast_multi
        from .ops.tables import stall_extend

        if self._stall_tables is None:
            self._stall_tables = stall_extend(self.tables)
        stall_id = self.tables.num_classes
        n = len(streams)
        lens = np.array([len(s_) for s_ in streams], dtype=np.int64)
        lmax = int(lens.max())
        counts = np.zeros((n, self.num_states), dtype=np.int64)
        cur = np.full(n, self.start, dtype=np.int32)
        iters, converged = 0, True
        accept_np = np.asarray(self.tables.accept)
        off = 0
        cb = self.config.chunk_bytes
        while off < lmax:
            w = min(cb, lmax - off)
            from .utils.config import shrink_blocks

            nb = shrink_blocks(w, self.config.num_blocks,
                               self.config.min_block_bytes,
                               divisible=False)
            w_pad = -(-w // nb) * nb  # round up to a block multiple
            chunk = np.full((n, w_pad), stall_id, dtype=np.int32)
            real = np.clip(lens - off, 0, w_pad).astype(np.int64)
            entries = cur.copy()  # pre-chunk states (stall correction)
            for i, s_ in enumerate(streams):
                if real[i]:
                    # FRONT padding: the stream slice sits at the chunk's
                    # end; the leading stalls carry the entry state
                    chunk[i, w_pad - real[i]:] = self._class_lut[
                        s_[off : off + real[i]]
                    ]
            res = dfa_scan_fast_multi(
                self._stall_tables, jnp.asarray(chunk), num_blocks=nb,
                starts=jnp.asarray(cur), max_iters=self.config.max_iters,
                emit="counts",
            )
            if not bool(res.converged):
                converged = False
                for i, s_ in enumerate(streams):
                    if real[i] == 0:
                        continue
                    r = self._exact_fallback(
                        s_[off : off + real[i]], int(cur[i])
                    )
                    counts[i] += np.bincount(
                        np.asarray(r.states)[np.asarray(r.match_mask)],
                        minlength=self.num_states,
                    )
                    cur[i] = r.final_state
            else:
                c = np.asarray(res.counts, dtype=np.int64)
                finals = np.asarray(res.final_states)
                # exact stall correction: the ENTRY state was counted
                # once per leading padded step
                pad = w_pad - real
                stall_hit = pad * accept_np[entries]
                c[np.arange(n), entries] -= stall_hit
                counts += c
                cur = finals.astype(np.int32).copy()
            iters = max(iters, int(res.iterations))
            off += w_pad
        return counts, iters, converged, cur

    def _scan_stream_counts(self, stream: np.ndarray, start=None):
        """Counts-only chunked scan (device-side histogram, no per-position
        readback).  Returns (counts (S,), iterations, converged)."""
        start = self.start if start is None else start
        classes = self._class_lut[stream]
        counts = np.zeros(self.num_states, dtype=np.int64)
        iters, converged = 0, True
        off, cur = 0, start
        cb = self.config.chunk_bytes
        while off < len(stream):
            chunk = classes[off : off + cb]
            nb = self._pick_blocks(len(chunk))
            res = dfa_scan_fast(
                self.tables, jnp.asarray(chunk), num_blocks=nb,
                start=cur, max_iters=self.config.max_iters, emit="counts",
            )
            if not bool(res.converged):
                converged = False
                res = self._exact_fallback(stream[off : off + cb], cur)
                counts += np.bincount(
                    np.asarray(res.states)[np.asarray(res.match_mask)],
                    minlength=self.num_states,
                )
            else:
                counts += np.asarray(res.counts)
            cur = int(res.final_state)
            iters = max(iters, int(getattr(res, "iterations", 0)))
            off += cb
        self._last_final = cur
        return counts, iters, converged

    def _exact_fallback(self, chunk_bytes: np.ndarray, start):
        """Exact associative-composition path for non-synchronizing automata."""
        stream = jnp.asarray(chunk_bytes)
        block = 1024
        if len(chunk_bytes) % block == 0:
            res = dfa_scan_blocked(self.tables, stream, block_size=block, start=start)
        else:
            res = dfa_scan_serial(self.tables, stream, start=start)
        # the blocked engine does not emit per-position states; rebuild them
        # with a host walk (exact path is a rare corner: adversarial automata)
        states = np.empty(len(chunk_bytes), dtype=np.int32)
        # serial engine emits mask only; rebuild states on host (exact path
        # is a corner case — adversarial automata)
        t = np.asarray(self.tables.table)
        cls = np.asarray(self.tables.class_of)
        s = int(start) if not isinstance(start, int) else start
        for i, b in enumerate(chunk_bytes.tolist()):
            states[i] = s
            s = int(t[cls[b], s])

        class R:  # match FastScanResult fields
            pass

        r = R()
        r.states = states
        r.match_mask = np.asarray(res.match_mask)
        r.final_state = s
        r.iterations = 0
        r.converged = True
        return r

    def _ensure_anchored(self) -> None:
        """Lazily build the reversed-pattern and anchored automata used by
        span extraction (finditer/search/match) — scan-only users never pay
        for them."""
        if self._finditer_source is not None and self._reverse_matcher is None:
            pattern, max_states, config = self._finditer_source
            rev = compile_pattern(
                pattern, max_states=max_states, anchored=False, reverse=True
            )
            self._reverse_matcher = DfaMatcher(rev, config)
            fwd = compile_pattern(pattern, max_states=max_states, anchored=True)
            self._anchored_np = (
                np.ascontiguousarray(fwd.table), fwd.accept, fwd.dead,
                fwd.eof_accept,
            )
            self._anchored_start = fwd.start
        if self._reverse_matcher is None or self._anchored_np is None:
            raise NotImplementedError(
                "span extraction requires a pattern-compiled matcher "
                "(compile_regex)"
            )

    def _anchored_longest_end(self, stream: np.ndarray, s0: int) -> int:
        """Longest match end for a match anchored at byte offset ``s0``
        (host walk with the anchored DFA), or -1 if no match starts there."""
        table, accept, dead, accept_eof = self._anchored_np
        st = self._anchored_start
        last_end = s0 if accept[st] else -1
        l = len(stream)
        for i in range(s0, l):
            st = int(table[stream[i], st])
            if st == dead:
                return last_end
            if accept[st]:
                last_end = i + 1
        if accept_eof[st] and not accept[st]:
            last_end = l  # end-anchored: match closes at EOF only
        return last_end

    def _make_match(self, raw: bytes, a: int, b: int) -> "Match":
        """Build a Match, recovering capture-group spans when the source
        pattern has groups (lazy tagged-Pike-VM re-walk of ``raw[a:b]``)."""
        if self._capture_prog is None:
            if self._finditer_source is None:
                self._capture_prog = False
            else:
                from .models.captures import CaptureProgram

                prog = CaptureProgram(self._finditer_source[0])
                self._capture_prog = prog if prog.num_groups else False
        if self._capture_prog is False:
            return Match(raw, a, b)
        prog = self._capture_prog
        spans, lastindex = prog.extract(raw, a, b)
        return Match(raw, a, b, spans, prog.group_names, lastindex)

    @property
    def num_groups(self) -> int:
        self._make_match(b"", 0, 0)  # force lazy program build
        return 0 if self._capture_prog is False else self._capture_prog.num_groups

    def stream_scanner(self, resume: dict | None = None) -> "DfaStreamScanner":
        """Incremental scanning on the fast engine; carry = (state, counts,
        offset) — the §5.4 O(S) property, same contract as the NFA/lazy
        stream scanners."""
        return DfaStreamScanner(self, resume)

    def finditer(self, data, limit: int | None = None,
                 pos: int = 0, endpos: int | None = None
                 ) -> list[tuple[int, int]]:
        """Non-overlapping (start, end) spans, POSIX leftmost-longest.

        Two-pass design: a backward scan with the reversed-pattern DFA marks
        every position where some match STARTS (device-parallel, same
        engines);
        then short anchored forward walks (host-side, bounded by match
        length) pick the longest match at each leftmost start.  Differs from
        Python re for patterns like ``ab|abc`` where backtracking picks the
        first alternative, not the longest.  ``limit`` stops after that many
        spans (used by ``search``).  ``pos``/``endpos`` follow
        ``re.Pattern.finditer`` (device-routed patterns are context-free,
        so the suffix scan + shift is exact; ``^`` cannot match at
        ``pos > 0``).
        """
        if pos or endpos is not None:
            raw, pos, ok = self._clip(bytes(_as_streams(data)[0]), pos,
                                      endpos)
            if not ok or (pos and self._pattern_start_anchored()):
                return []
            return [(a + pos, b + pos)
                    for a, b in self.finditer(raw[pos:], limit)]
        self._ensure_anchored()
        stream = _as_streams(data)[0]
        if len(stream) == 0:
            # a nullable pattern matches the empty string once
            end = self._anchored_longest_end(stream, 0)
            return [(0, 0)] if end == 0 else []
        starts = self._match_starts(stream)

        # forward stage: native anchored walk over all candidate starts
        # (the per-byte Python loop below runs ~1 MB/s on match-dense
        # corpora; the C walk runs at table-load speed)
        from .utils.native import anchored_spans_native, native_available

        if native_available() and limit is None:
            table, accept, dead, accept_eof = self._anchored_np
            out = anchored_spans_native(
                table, accept, accept_eof, self._anchored_start, dead,
                stream, starts,
            )
            spans = [(int(a), int(b)) for a, b in out]
            return self._append_tail_empty(spans, stream)

        spans: list[tuple[int, int]] = []
        p = 0
        si = 0
        while si < len(starts):
            s0 = int(starts[si])
            if s0 < p:
                si += 1
                continue
            last_end = self._anchored_longest_end(stream, s0)
            if last_end >= 0:
                spans.append((s0, last_end))
                if limit is not None and len(spans) >= limit:
                    return spans
                p = max(last_end, s0 + 1)  # empty match: advance one byte
            si += 1
        return self._append_tail_empty(spans, stream)

    def _match_starts(self, stream: np.ndarray) -> np.ndarray:
        """Ascending candidate match-start offsets from the backward pass
        (shared by ``finditer`` and ``finditer_arrays``).

        Ends of reverse matches in the reversed stream are starts of
        forward matches: the reverse engine reports accept at position p =
        state BEFORE byte p of the reversed stream, i.e. a reverse match
        ending at reversed position p-1 = original start L-p;
        ``accept_eof`` of the reverse final state covers start 0.  The
        positions arrive device-compacted (N*4 bytes, not an L-byte mask).
        """
        self._ensure_anchored()
        return _starts_from_reverse(self._reverse_matcher, stream)

    def _append_tail_empty(self, spans, stream):
        """A nullable pattern matches EMPTY at end-of-buffer (re yields
        ``(l, l)``); the backward pass has no slot for start == l, so it is
        appended here when the suppression point allows it."""
        l = len(stream)
        if spans:
            a, b = spans[-1]
            p = max(b, a + 1)
        else:
            p = 0
        if p <= l and self._anchored_longest_end(stream, l) == l:
            spans.append((l, l))
        return spans

    def finditer_arrays(self, data) -> np.ndarray:
        """Spans as an (N, 2) int64 ndarray — identical content to
        ``finditer`` without materializing N Python tuples (match-dense
        corpora produce millions; the list conversion alone costs seconds)."""
        self._ensure_anchored()
        stream = _as_streams(data)[0]
        from .utils.native import anchored_spans_native, native_available

        if len(stream) and native_available():
            l = len(stream)
            starts = self._match_starts(stream)
            table, accept, dead, accept_eof = self._anchored_np
            out = anchored_spans_native(
                table, accept, accept_eof, self._anchored_start, dead,
                stream, starts,
            )
            l_out = len(out)
            if l_out:
                a, b = int(out[-1, 0]), int(out[-1, 1])
                p = max(b, a + 1)
            else:
                p = 0
            if p <= l and self._anchored_longest_end(stream, l) == l:
                out = np.concatenate([out, [[l, l]]], axis=0)
            return out
        return np.asarray(self.finditer(stream), dtype=np.int64).reshape(-1, 2)

    def finditer_matches(self, data, limit: int | None = None) -> list["Match"]:
        """Like ``finditer`` but yields full ``Match`` objects (with capture
        groups when the pattern has any) instead of bare spans."""
        raw = bytes(_as_streams(data)[0])
        return [self._make_match(raw, a, b)
                for a, b in self.finditer(raw, limit)]

    # -- re-module-style conveniences (span semantics: leftmost-longest) ----

    def _pattern_start_anchored(self) -> bool:
        """Leading ``^`` (non-multiline): re's ``Pattern.search``/``match``
        with ``pos > 0`` can never match — ``pos`` does NOT make ``^``
        match there (it is not equivalent to slicing)."""
        cached = getattr(self, "_start_anchored_cache", None)
        if cached is None:
            from .models.regex import parse_pattern

            cached = False
            if self._finditer_source:
                try:
                    cached = parse_pattern(
                        self._finditer_source[0]
                    ).start_anchored
                except Exception:
                    cached = False
            self._start_anchored_cache = cached
        return cached

    @staticmethod
    def _clip(raw, pos: int, endpos):
        """re's pos/endpos normalization (works on bytes and ndarrays):
        ``pos`` clamps to ``[0, len]`` FIRST (``search('xx', 7)`` still
        finds the empty match at 2), ``endpos`` truncates the subject
        (``$``/lookahead behave as if the string ended there), and
        ``pos > endpos`` after clamping means NO match at all (re returns
        None/[] there, not an empty match).  Returns
        (subject, clamped_pos, ok)."""
        n = len(raw)
        pos = min(max(int(pos), 0), n)
        if endpos is not None:
            e = min(max(int(endpos), 0), n)
            if pos > e:
                return raw[:e], pos, False
            raw = raw[:e]
        return raw, pos, True

    def search(self, data, pos: int = 0, endpos: int | None = None
               ) -> "Match | None":
        """First (leftmost-longest) match in the stream, or None.
        ``pos``/``endpos`` follow ``re.Pattern.search``."""
        raw, pos, ok = self._clip(bytes(_as_streams(data)[0]), pos, endpos)
        if not ok:
            return None
        if pos:
            # device-routed patterns carry no context assertions (those
            # route to the host matchers, which override this), so
            # searching the suffix and shifting is exact — except ^
            if self._pattern_start_anchored():
                return None
            spans = self.finditer(raw[pos:], limit=1)
            spans = [(a + pos, b + pos) for a, b in spans]
        else:
            spans = self.finditer(raw, limit=1)
        if not spans:
            return None
        a, b = spans[0]
        return _stamp_pos(self._make_match(raw, a, b), pos)

    def match(self, data, pos: int = 0, endpos: int | None = None
              ) -> "Match | None":
        """Longest match anchored at ``pos``, or None (like ``re.match``)."""
        self._ensure_anchored()
        stream, pos, ok = self._clip(_as_streams(data)[0], pos, endpos)
        if not ok or (pos and self._pattern_start_anchored()):
            return None
        end = self._anchored_longest_end(stream, pos)
        if end < 0:
            return None
        return _stamp_pos(self._make_match(bytes(stream), pos, end), pos)

    def fullmatch(self, data, pos: int = 0, endpos: int | None = None
                  ) -> "Match | None":
        """Match spanning ``[pos, endpos)``, or None (``re.fullmatch``)."""
        self._ensure_anchored()
        stream, pos, ok = self._clip(_as_streams(data)[0], pos, endpos)
        if not ok or (pos and self._pattern_start_anchored()):
            return None
        l = len(stream)
        table, accept, dead, accept_eof = self._anchored_np
        st = self._anchored_start
        for b in stream[pos:].tolist():
            st = int(table[b, st])
            if st == dead:
                return None
        if accept[st] or accept_eof[st]:
            return _stamp_pos(self._make_match(bytes(stream), pos, l), pos)
        return None

    def split(self, data, maxsplit: int = 0) -> list[bytes]:
        """Split the stream on matches (like ``re.split`` without groups).
        Empty matches split like Python 3.7+ ``re`` (between characters)."""
        raw = bytes(_as_streams(data)[0])
        out: list[bytes] = []
        p = 0
        n = 0
        for a, b in self.finditer(raw):
            if maxsplit and n >= maxsplit:
                break
            out.append(raw[p:a])
            p = b
            n += 1
        out.append(raw[p:])
        return out

    def sub(self, repl, data, count: int = 0) -> bytes:
        """Replace matches with ``repl`` (bytes or callable(Match) -> bytes)."""
        return self.subn(repl, data, count)[0]

    def subn(self, repl, data, count: int = 0) -> tuple[bytes, int]:
        raw = bytes(_as_streams(data)[0])
        pieces: list[bytes] = []
        p = 0
        n = 0
        for a, b in self.finditer(raw):
            if count and n >= count:
                break
            pieces.append(raw[p:a])
            pieces.append(
                repl(self._make_match(raw, a, b)) if callable(repl) else repl
            )
            p = b
            n += 1
        pieces.append(raw[p:])
        return b"".join(pieces), n

    def findall(self, data) -> list[bytes]:
        raw = bytes(_as_streams(data)[0])
        return [raw[a:b] for a, b in self.finditer(data)]

    def findall_ends(self, data) -> np.ndarray:
        """Byte offsets at which a match ends (position just past the last
        matched byte, like ``re.Match.end()``)."""
        stream = _as_streams(data)[0]
        _, mask, _, _ = self._scan_stream(stream)
        ends = np.nonzero(mask)[0]
        if (self.include_final_match and len(stream)
                and self._accept_eof[self._last_final]):
            ends = np.concatenate([ends, [len(stream)]])
        return ends


class DfaStreamScanner:
    """Incremental scanning on the fast DFA engines with a serializable
    O(S) carry: (current state, per-state counts, byte offset).

    Chunked feeding is exact because match timing is accept-BEFORE-byte
    (SURVEY.md §3.3): resuming from the carried state reproduces the
    one-shot scan bit-for-bit at any chunk alignment.  The end-of-stream
    accept (``include_final_match``) is applied by ``total``/``histogram``
    without mutating the carry, so feeding may continue afterwards."""

    def __init__(self, matcher: DfaMatcher, resume: dict | None = None):
        self.m = matcher
        if resume is None:
            self.state = matcher.start
            self.counts = np.zeros(matcher.num_states, dtype=np.int64)
            self.offset = 0
        else:
            self.state = int(resume["state"])
            self.counts = np.array(resume["counts"], dtype=np.int64)
            self.offset = int(resume["offset"])

    def feed(self, data) -> None:
        stream = _as_streams(data)[0]
        if len(stream) == 0:
            return
        c, _, _ = self.m._scan_stream_counts(stream, start=self.state)
        self.counts += c
        self.state = self.m._last_final
        self.offset += len(stream)

    def checkpoint(self) -> dict:
        return {
            "state": self.state,
            "counts": np.array(self.counts),
            "offset": self.offset,
        }

    @property
    def state_counts(self) -> np.ndarray:
        """Per-state counts WITH the end-of-stream accept applied (as if the
        stream ended here)."""
        out = self.counts.copy()
        if (self.m.include_final_match and self.offset
                and self.m._accept_eof[self.state]):
            out[self.state] += 1
        return out

    @property
    def total(self) -> int:
        return int(self.state_counts.sum())

    def histogram(self) -> dict[int, int]:
        return {int(i): int(c) for i, c in enumerate(self.state_counts) if c}


class TokenizerMatcher(DfaMatcher):
    """Regex pre-split stage for tokenization pipelines."""

    def __init__(self, tok: TokenizerDfa, config: EngineConfig = DEFAULT_CONFIG):
        self.tok = tok
        self.config = config
        self.tables = build_dfa_tables(tok.table, tok.accept)
        # uint8 LUT: class ids always fit one byte (C <= 256), so the
        # host->device upload of a class stream is 1 B/byte instead of 4
        # (the engines cast to int32 ON device)
        self._class_lut = np.asarray(self.tables.class_of).astype(np.uint8)
        self._accept_eof = np.asarray(self.tables.accept)
        self.start = tok.start
        self.dfa = None
        self._finditer_source = None
        self._reverse_matcher = None
        self._anchored_np = None
        self._anchored_start = 0

    def presplit(self, text: bytes | np.ndarray) -> np.ndarray:
        """Token-start byte offsets for ``text`` (maximal-munch, see
        models/tokenizer_dfa.py for semantics)."""
        stream = _as_streams(text)[0]
        if len(stream) == 0:
            return np.zeros(0, dtype=np.int64)
        # mask-only scan (pair-mask engine when available): presplit needs
        # just the accept bits + the state after the last byte
        mask = self._scan_mask(stream)
        acc = np.asarray(self.tables.accept)
        return boundaries_from_flags(mask, bool(acc[self._last_final]))

    def pieces(self, text: bytes) -> list[bytes]:
        starts = self.presplit(text).tolist()
        return [text[a:b] for a, b in zip(starts, starts[1:] + [len(text)])]


def compile_ruleset(source: str | CsrAutomaton,
                    config: EngineConfig = DEFAULT_CONFIG,
                    strategy: str = "lazy") -> NfaMatcher:
    """Load a reference-format ``.coe`` ruleset (or CsrAutomaton) into the
    bit-exact NFA engine."""
    aut = load_coe(source) if isinstance(source, str) else source
    return NfaMatcher(aut, config, strategy=strategy)


def _starts_from_reverse(rm: "DfaMatcher", stream: np.ndarray) -> np.ndarray:
    """Ascending candidate match starts from one backward device pass with
    reversed-pattern matcher ``rm`` — THE single home of the tricky index
    mapping (shared by ``DfaMatcher._match_starts`` and the Host matcher's
    envelope prefilter): a reverse match ending at reversed position p-1 is
    an original start l-p, and ``accept_eof`` of the reverse final state
    covers start 0.  Positions arrive device-compacted (N*4 bytes)."""
    l = len(stream)
    pos = rm._scan_match_positions(stream[::-1])
    starts = (l - pos[pos > 0])[::-1]  # ascending, unique
    if rm._accept_eof[rm._last_final]:
        starts = np.concatenate([np.zeros(1, np.int64), starts])
    return starts


_UNSET = object()


class HostRegexMatcher(DfaMatcher):
    """Matcher for patterns containing ``\\b``/``\\B`` word boundaries.

    Boundary assertions are not expressible in the streaming DFA engines,
    whose accept is a pure function of the state AT a position — a trailing
    ``\\b`` needs the NEXT byte (``foo\\b`` on ``food`` vs ``foo!``).  Span
    search therefore runs in two stages (the Snort prefilter architecture
    applied to the re layer, r2 verdict #6):

    1. **device prefilter**: the assertion-STRIPPED envelope DFA
       (``models/regex.strip_assertions`` — a superset language) is scanned
       backward on the device exactly like ``DfaMatcher.finditer``'s
       reversed pass, yielding every candidate match start;
    2. **host verify**: the Pike VM (``models/captures.py``) checks the
       assertions only at those candidates, with the SAME POSIX
       leftmost-longest span semantics as the device path (leftmost-FIRST
       for lazy quantifiers — Python ``re``).

    Patterns whose envelope is nullable (e.g. a bare ``\\b``) or fails to
    compile fall back to the pure-host walk.  The device-throughput APIs
    (``scan``, ``count``, ``stream_scanner``, ``findall_ends``) raise with
    guidance.
    """

    def __init__(self, pattern: str | bytes,
                 config: EngineConfig = DEFAULT_CONFIG):
        from .models.captures import CaptureProgram
        from .models.regex import contains_lazy, parse_pattern

        # 2-state all-dead dummy DFA satisfies base-class plumbing; the
        # device engines are never invoked on it (see overrides below)
        dummy = CompiledDfa(
            table=np.ones((256, 2), dtype=np.int32),
            accept=np.zeros(2, dtype=bool), start=0, dead=1,
        )
        super().__init__(dummy, config)
        pp = parse_pattern(pattern)
        self._prog = CaptureProgram(pp)
        #: non-greedy quantifiers switch span disambiguation to
        #: leftmost-FIRST (PCRE/Python re); otherwise POSIX leftmost-longest,
        #: identical to the device engines
        self._first_mode = contains_lazy(pp.node)
        self._finditer_source = (pattern, 0, config)
        self._capture_prog = (
            self._prog if self._prog.num_groups else False
        )
        self._pattern_src = pattern
        self._envelope = _UNSET  # lazy: reversed envelope DFA or None

    def _ensure_envelope(self):
        """Lazily compile the reversed assertion-stripped envelope used by
        the device prefilter; None when it has no pruning power (nullable)
        or does not compile (blowup)."""
        if self._envelope is _UNSET:
            from .models.regex import (
                compile_pattern as _cp,
                nullable,
                parse_pattern,
                strip_assertions,
            )

            env = None
            try:
                pp = parse_pattern(self._pattern_src)
                if not nullable(strip_assertions(pp.node)):
                    rev = _cp(self._pattern_src, anchored=False,
                              reverse=True, strip=True)
                    env = DfaMatcher(rev, self.config)
            except Exception:
                env = None
            self._envelope = env
        return self._envelope

    def _candidate_starts(self, stream: np.ndarray) -> np.ndarray | None:
        """Ascending candidate match starts from the device envelope scan
        (superset of the true starts), or None when unavailable."""
        env = self._ensure_envelope()
        if env is None or len(stream) == 0:
            return None
        return _starts_from_reverse(env, stream)

    def _no_device(self, name: str):
        raise NotImplementedError(
            f"{name}() runs on the streaming DFA engines, which cannot "
            "express \\b/\\B (accept would depend on the next byte); use "
            "search/match/fullmatch/finditer/findall/split/sub, or drop "
            "the boundary assertion for device-rate scanning"
        )

    def scan(self, data, collect_positions: bool = False):
        self._no_device("scan")

    def count(self, data):
        self._no_device("count")

    def stream_scanner(self, resume: dict | None = None):
        self._no_device("stream_scanner")

    def findall_ends(self, data):
        self._no_device("findall_ends")

    # poison every internal device entry point too: the dummy 2-state DFA
    # exists only to satisfy base-class plumbing, and a future base-class
    # method that reaches one of these must FAIL LOUDLY rather than silently
    # scan a dead automaton (r1 review finding)
    def _scan_stream(self, stream, start=None):
        self._no_device("_scan_stream")

    def _scan_mask(self, stream, start=None):
        self._no_device("_scan_mask")

    def _scan_match_positions(self, stream, start=None):
        self._no_device("_scan_match_positions")

    def _scan_stream_counts(self, stream, start=None):
        self._no_device("_scan_stream_counts")

    def _scan_batch_counts(self, arr):
        self._no_device("_scan_batch_counts")

    def _anchored_longest_end(self, stream, s0: int) -> int:
        # base finditer helpers must not consult the dummy anchored tables
        end = (self._prog.first_end_at(bytes(stream), s0) if self._first_mode
               else self._prog.longest_end_at(bytes(stream), s0))
        return end

    def finditer(self, data, limit: int | None = None,
                 pos: int = 0, endpos: int | None = None
                 ) -> list[tuple[int, int]]:
        raw, pos, ok = self._clip(bytes(_as_streams(data)[0]), pos, endpos)
        if not ok or (pos and self._pattern_start_anchored()):
            return []
        stream = np.frombuffer(raw, dtype=np.uint8)
        starts = self._candidate_starts(stream)
        if starts is None:  # nullable/uncompilable envelope: pure host
            if self._first_mode:
                return self._prog.finditer_spans_first(raw, limit,
                                                       start_at=pos)
            return self._prog.finditer_spans(raw, limit, start_at=pos)
        # Pike-VM verification ONLY at device candidates.  Equivalence to
        # the pure-host walk: candidates are a superset of true match
        # starts (envelope language is a superset), and both walks take the
        # leftmost matching start then the longest (or lazy-first) end,
        # non-overlapping.  A non-nullable envelope also implies the
        # pattern cannot match empty.
        end_at = (self._prog.first_end_at if self._first_mode
                  else self._prog.longest_end_at)
        spans: list[tuple[int, int]] = []
        p = pos  # assertion context BEFORE pos stays visible (re rule)
        for s0 in starts.tolist():
            if s0 < p:
                continue
            end = end_at(raw, s0)
            if end >= 0:
                spans.append((s0, end))
                if limit is not None and len(spans) >= limit:
                    return spans
                p = max(end, s0 + 1)
        return spans

    def finditer_arrays(self, data) -> np.ndarray:
        # the base implementation compiles reversed/anchored device tables,
        # which these host-routed patterns cannot (it raised RegexError
        # before this override); span content is identical to finditer
        return np.asarray(self.finditer(data), dtype=np.int64).reshape(-1, 2)

    def search(self, data, pos: int = 0, endpos: int | None = None
               ) -> "Match | None":
        # native pos: the Pike VM keeps assertion context before pos
        raw, pos, ok = self._clip(bytes(_as_streams(data)[0]), pos, endpos)
        if not ok:
            return None
        spans = self.finditer(raw, limit=1, pos=pos)
        if not spans:
            return None
        a, b = spans[0]
        return _stamp_pos(self._make_match(raw, a, b), pos)

    def match(self, data, pos: int = 0, endpos: int | None = None
              ) -> "Match | None":
        raw, pos, ok = self._clip(bytes(_as_streams(data)[0]), pos, endpos)
        if not ok or (pos and self._pattern_start_anchored()):
            return None
        end = (self._prog.first_end_at(raw, pos) if self._first_mode
               else self._prog.longest_end_at(raw, pos))
        return None if end < 0 else _stamp_pos(
            self._make_match(raw, pos, end), pos)

    def fullmatch(self, data, pos: int = 0, endpos: int | None = None
                  ) -> "Match | None":
        raw, pos, ok = self._clip(bytes(_as_streams(data)[0]), pos, endpos)
        if not ok or (pos and self._pattern_start_anchored()):
            return None
        if self._prog.longest_end_at(raw, pos) == len(raw):
            return _stamp_pos(self._make_match(raw, pos, len(raw)), pos)
        return None


class HostBacktrackMatcher(HostRegexMatcher):
    """Matcher for patterns with backreferences or lookaround.

    Neither is expressible in the device engines (backrefs are not a
    regular language; lookaround consults bytes past the position) NOR in
    the tagged Pike VM, whose thread merge assumes the future depends only
    on (state, position).  These patterns run the host backtracking engine
    (``models/backtrack.py``) with end-to-end Python ``re`` semantics:
    leftmost-FIRST spans, greedy/lazy backtracking order, fixed-width
    lookbehind, capture persistence out of positive lookahead.  The
    device-throughput APIs raise, same contract as ``HostRegexMatcher``."""

    def __init__(self, pattern: str | bytes,
                 config: EngineConfig = DEFAULT_CONFIG,
                 max_steps: int | None = None):
        from .models.backtrack import BacktrackProgram
        from .models.regex import parse_pattern

        dummy = CompiledDfa(
            table=np.ones((256, 2), dtype=np.int32),
            accept=np.zeros(2, dtype=bool), start=0, dead=1,
        )
        DfaMatcher.__init__(self, dummy, config)
        #: ``max_steps``: opt-in catastrophic-backtracking budget per
        #: search/match (None = unlimited, strict ``re`` parity); exceeding
        #: it raises ``models.backtrack.BacktrackLimitExceeded``
        self._bt = BacktrackProgram(parse_pattern(pattern),
                                    max_steps=max_steps)
        self._pattern_src = pattern
        self._finditer_source = (pattern, 0, config)
        self._envelope = None   # no device prefilter (see _ensure_envelope)
        self._capture_prog = False  # groups come from the engine itself

    @property
    def num_groups(self) -> int:
        return self._bt.num_groups

    def _make_match(self, raw: bytes, a: int, b: int) -> "Match":
        m = self._bt.match_at(raw, a)
        if (m is None or m[0] != b) and b > a:
            # The span may have been produced under the 3.7+ empty-match
            # iteration ban (finditer resumes AT an empty match's end
            # with the empty match there refused).  An unbanned re-run
            # can prefer the empty match (e.g. ``(a)?(?(1)|b??)`` on
            # ``b"b"`` at 0 → span (0,0) not (0,1)) — retry with the
            # empty match banned so group extraction tracks the span
            # actually emitted (advisor r4 finding 3).
            m = self._bt.match_at(raw, a, ban_empty=True)
        if m is None or m[0] != b:  # defensive: engine is deterministic
            return Match(raw, a, b)
        _, groups, lastindex = m
        return Match(raw, a, b, groups[1:], self._bt.group_names, lastindex)

    def search(self, data, pos: int = 0, endpos: int | None = None
               ) -> "Match | None":
        # native pos: the backtracker keeps assertion/lookbehind context
        raw, pos, ok = self._clip(bytes(_as_streams(data)[0]), pos, endpos)
        if not ok:
            return None
        m = self._bt.search_spans(raw, pos)
        if m is None:
            return None
        # groups were already computed by the producing search — no
        # re-run, no ban_empty mismatch
        groups, lastindex = m[2], m[3]
        return _stamp_pos(
            Match(raw, m[0], m[1], groups[1:], self._bt.group_names,
                  lastindex), pos)

    def finditer(self, data, limit: int | None = None,
                 pos: int = 0, endpos: int | None = None
                 ) -> list[tuple[int, int]]:
        # Python 3.7+ empty-match iteration rule (mirrors
        # BacktrackProgram.finditer_spans): resume AT an empty match's
        # end with only the empty match there banned
        raw, start, ok = self._clip(bytes(_as_streams(data)[0]), pos,
                                    endpos)
        if not ok:
            return []
        spans: list[tuple[int, int]] = []
        pos, ban, n = start, -1, len(raw)
        while pos <= n:
            m = self._bt.search_spans(raw, pos, ban_empty_at=ban)
            if m is None:
                break
            s, e = m[0], m[1]
            spans.append((s, e))
            if limit is not None and len(spans) >= limit:
                break
            if self._bt.pp.start_anchored:
                break
            pos = e
            ban = e if s == e else -1
            if s == e and e == n:
                break
        return spans

    def finditer_arrays(self, data) -> np.ndarray:
        return np.asarray(self.finditer(data), dtype=np.int64).reshape(-1, 2)

    def match(self, data, pos: int = 0, endpos: int | None = None
              ) -> "Match | None":
        raw, pos, ok = self._clip(bytes(_as_streams(data)[0]), pos, endpos)
        if not ok or (pos and self._bt.pp.start_anchored):
            return None
        m = self._bt.match_at(raw, pos)
        if m is None:
            return None
        end, groups, lastindex = m
        return _stamp_pos(
            Match(raw, pos, end, groups[1:], self._bt.group_names,
                  lastindex), pos)

    def fullmatch(self, data, pos: int = 0, endpos: int | None = None
                  ) -> "Match | None":
        raw, pos, ok = self._clip(bytes(_as_streams(data)[0]), pos, endpos)
        if not ok or (pos and self._bt.pp.start_anchored):
            return None
        m = self._bt.match_at(raw, pos, full=True)
        if m is None:
            return None
        end, groups, lastindex = m
        return _stamp_pos(
            Match(raw, pos, end, groups[1:], self._bt.group_names,
                  lastindex), pos)

    def _anchored_longest_end(self, stream, s0: int) -> int:
        m = self._bt.match_at(bytes(stream), s0)
        return -1 if m is None else m[0]


def compile_regex(pattern: str | bytes, anchored: bool = False,
                  max_states: int = 100_000,
                  config: EngineConfig = DEFAULT_CONFIG,
                  max_steps: int | None = None) -> DfaMatcher:
    """Compile a pattern to the fast DFA engine.  Default is scanning
    (unanchored) mode: a match is reported wherever it ends in the stream.
    The matcher also supports ``finditer``/``findall`` (leftmost-longest
    spans) via a reversed-pattern backward scan.  Patterns with ``\\b``/
    ``\\B``, ``(?m)`` anchors, or non-greedy quantifiers return a
    ``HostRegexMatcher`` (host Pike VM: POSIX-longest spans for assertions,
    leftmost-first for lazy quantifiers — Python ``re`` semantics);
    patterns with backreferences, lookaround, or conditionals
    ``(?(id)yes|no)`` return a ``HostBacktrackMatcher`` (host backtracking
    engine, Python ``re`` semantics end to end; ``max_steps`` opt-in
    bounds its catastrophic-backtracking worst case — ignored for the
    linear-time engines, which need no budget)."""
    from .models.regex import (
        contains_backtrack, contains_bound, contains_lazy, parse_pattern,
    )

    node = parse_pattern(pattern).node
    if contains_backtrack(node):
        return HostBacktrackMatcher(pattern, config, max_steps=max_steps)
    if contains_bound(node) or contains_lazy(node):
        return HostRegexMatcher(pattern, config)
    dfa = compile_pattern(pattern, max_states=max_states, anchored=anchored)
    m = DfaMatcher(dfa, config)
    # finditer's reversed + anchored automata compile lazily on first use
    m._finditer_source = (pattern, max_states, config)
    return m


@dataclasses.dataclass
class LiteralReport:
    """Per-pattern occurrence counts (streams x patterns) + the per-state
    report underneath."""

    pattern_counts: np.ndarray  # (num_streams, num_patterns) int64
    report: ScanReport

    def histogram(self, stream: int = 0) -> dict[int, int]:
        row = self.pattern_counts[stream]
        return {int(i): int(c) for i, c in enumerate(row) if c}


class LiteralSetMatcher(DfaMatcher):
    """Multi-literal (Aho–Corasick) matcher on the fast DFA engines.

    Reports EVERY occurrence of every literal (overlapping and nested —
    Snort content-match semantics), unlike the regex path's non-overlapping
    leftmost-longest spans.  ``scan``/``count`` (inherited) count match-
    ENDING positions; ``scan_patterns`` folds them into exact per-pattern
    totals via the automaton's output-set membership matrix."""

    def __init__(self, ac, config: EngineConfig = DEFAULT_CONFIG):
        super().__init__(ac.dfa, config)
        self.ac = ac

    @property
    def num_patterns(self) -> int:
        return len(self.ac.patterns)

    def scan_patterns(self, data) -> LiteralReport:
        rep = self.scan(data)
        per = self.ac.pattern_counts(rep.counts)
        return LiteralReport(pattern_counts=per, report=rep)

    def finditer(self, data, limit: int | None = None,
                 pos: int = 0, endpos: int | None = None):
        """All (start, end, pattern_id) occurrences, sorted by end then id
        (overlapping included).  ``pos``/``endpos`` follow ``re`` (spans
        must lie fully inside ``[pos, endpos)``; literals are
        context-free, so suffix-scan + shift is exact)."""
        if pos or endpos is not None:
            raw, pos, ok = self._clip(bytes(_as_streams(data)[0]), pos,
                                      endpos)
            if not ok:
                return []
            return [(a + pos, b + pos, pid)
                    for a, b, pid in self.finditer(raw[pos:], limit)]
        stream = _as_streams(data)[0]
        if len(stream) == 0:
            return []
        states, mask, _, _ = self._scan_stream(stream)
        l = len(stream)
        ends = np.nonzero(mask)[0].tolist()  # state-before-byte-e accepts
        if self._accept_eof[self._last_final]:
            ends.append(l)
        spans: list[tuple[int, int, int]] = []
        outputs = self.ac.outputs
        for e in ends:
            st = int(states[e]) if e < l else self._last_final
            for pid in outputs[st]:
                spans.append((e - len(self.ac.patterns[pid]), e, pid))
                if limit is not None and len(spans) >= limit:
                    return spans
        return spans

    def findall(self, data) -> list[bytes]:
        raw = bytes(_as_streams(data)[0])
        return [raw[a:b] for a, b, _ in self.finditer(raw)]

    def search(self, data, pos: int = 0, endpos: int | None = None
               ) -> "Match | None":
        """Earliest-ending occurrence of any literal, or None."""
        raw, pos, ok = self._clip(bytes(_as_streams(data)[0]), pos, endpos)
        if not ok:
            return None
        hits = self.finditer(raw, limit=1, pos=pos)
        if not hits:
            return None
        a, b, _ = hits[0]
        return _stamp_pos(Match(raw, a, b), pos)

    def match(self, data) -> "Match | None":
        """Longest literal that is a prefix of the stream, or None."""
        raw = bytes(_as_streams(data)[0])
        best = -1
        for p in self.ac.patterns:
            if len(p) > best and raw.startswith(p):
                best = len(p)
        return Match(raw, 0, best) if best >= 0 else None

    def fullmatch(self, data) -> "Match | None":
        raw = bytes(_as_streams(data)[0])
        return Match(raw, 0, len(raw)) if raw in self.ac.patterns else None


def compile_literals(patterns, config: EngineConfig = DEFAULT_CONFIG
                     ) -> LiteralSetMatcher:
    """Compile a set of literal byte strings (Aho–Corasick) into one dense
    DFA on the fast device engines, with per-pattern occurrence counts."""
    from .models.literals import build_aho_corasick

    return LiteralSetMatcher(build_aho_corasick(patterns), config)


def compile_tokenizer(pattern: str = GPT2_PRESPLIT,
                      config: EngineConfig = DEFAULT_CONFIG) -> TokenizerMatcher:
    return TokenizerMatcher(build_tokenizer_dfa(pattern), config)


@dataclasses.dataclass
class RuleSetReport:
    """Per-rule match counts (streams x rules) + the underlying per-state
    report (reference testbench semantics).

    ``report`` is None when no single per-state report exists: mixed
    anchored/unanchored rule sets scan as TWO CSR partitions whose state
    spaces do not line up, so only the per-rule counts are meaningful
    there (ADVICE r2: callers touching ``.report`` must handle None)."""

    rule_counts: np.ndarray         # (num_streams, num_rules) int64
    report: "ScanReport | None"

    def histogram(self, stream: int = 0) -> dict[int, int]:
        row = self.rule_counts[stream]
        return {int(i): int(c) for i, c in enumerate(row) if c}


class RuleSetMatcher:
    """Multi-rule matcher: a set of regexes compiled into reference-
    convention CSR NFA(s) (the ruleset compiler the reference never
    shipped, SURVEY.md SS0) and scanned by the bit-exact conformance
    engine with per-rule match attribution.

    Anchored (``^``) and unanchored rules cannot share one CSR hub (the
    always-active hub would re-fire anchored rules at every byte —
    models/export_csr.py), so a mixed set compiles into TWO partitions
    scanned back to back; counts merge by original rule index.  Pure sets
    stay a single automaton and remain ``.coe``-exportable."""

    def __init__(self, patterns, config: EngineConfig = DEFAULT_CONFIG,
                 strategy: str = "lazy"):
        from .models.export_csr import regexes_to_csr
        from .models.regex import parse_pattern

        self.patterns = list(patterns)
        flags = [parse_pattern(p).start_anchored for p in self.patterns]
        #: list of (rule_indices, owner, NfaMatcher) — one per partition
        self._parts = []
        for anchored in (False, True):
            idx = [i for i, a in enumerate(flags) if a == anchored]
            if idx:
                aut, owner = regexes_to_csr([self.patterns[i] for i in idx])
                self._parts.append(
                    (idx, owner, NfaMatcher(aut, config, strategy=strategy))
                )
        if len(self._parts) == 1:
            # single-partition compatibility surface
            self.owner = self._parts[0][1]
            self.matcher = self._parts[0][2]
            self.automaton = self.matcher.automaton
        else:
            self.owner = self.matcher = self.automaton = None

    @property
    def num_rules(self) -> int:
        return len(self.patterns)

    def scan(self, data) -> RuleSetReport:
        streams = _as_streams(data)
        per = np.zeros((len(streams), self.num_rules), np.int64)
        rep = None
        for idx, owner, matcher in self._parts:
            rep = matcher.scan(streams)
            for k, i in enumerate(idx):
                per[:, i] = rep.counts[:, owner == k].sum(axis=1)
        return RuleSetReport(
            rule_counts=per,
            report=rep if len(self._parts) == 1 else None,
        )

    def export_coe(self, path: str) -> None:
        """Write the combined ruleset as a reference-loadable .coe image."""
        if self.automaton is None:
            raise ValueError(
                "mixed anchored/unanchored rulesets compile to two CSR "
                "partitions and have no single .coe image — export pure "
                "subsets separately"
            )
        from .models.coe import write_coe

        write_coe(path, self.automaton.to_words())


def compile_regex_set(patterns, config: EngineConfig = DEFAULT_CONFIG,
                      strategy: str = "lazy") -> RuleSetMatcher:
    """Compile a list of patterns into one multi-rule NFA ruleset with
    per-rule match counts (IDS-style)."""
    return RuleSetMatcher(patterns, config, strategy=strategy)


class PrefilteredRuleSet:
    """Hyperscan-style literal-prefiltered regex-set matcher.

    Each pattern with a ``required_literal`` (a byte string guaranteed to
    appear in every match — ``models/regex.py``) is guarded by one
    Aho–Corasick prefilter scanned on the fast device DFA engine; a
    stream only pays the full NFA ruleset machinery for the rules whose
    literals it actually contains (plus the rules with no usable literal).
    Counts are EXACTLY ``compile_regex_set(...).scan(...)`` — pruning is
    sound because a stream without a rule's required literal cannot match
    that rule.  Sub-rulesets are compiled lazily and cached per candidate
    subset (alert-style traffic keeps the subsets tiny and few).
    """

    def __init__(self, patterns, config: EngineConfig = DEFAULT_CONFIG,
                 strategy: str = "lazy", min_literal: int = 3):
        from .models.regex import parse_pattern, required_literal

        self.patterns = list(patterns)
        self.config = config
        self.strategy = strategy
        lits: list[bytes] = []
        self._lit_owner: list[int] = []
        self.always_check: list[int] = []
        for i, p in enumerate(self.patterns):
            lit = required_literal(parse_pattern(p).node)
            if lit is not None and len(lit) >= min_literal:
                lits.append(lit)
                self._lit_owner.append(i)
            else:
                self.always_check.append(i)
        self._ac = compile_literals(lits, config) if lits else None
        #: LRU-bounded subset cache: diverse traffic could otherwise drive
        #: up to 2^num_prefiltered distinct compiles (ADVICE r2).  On
        #: overflow the FULL ruleset matcher (always sound, one compile)
        #: serves the request instead of evicting into thrash.
        self._subs: "dict[tuple, RuleSetMatcher]" = {}
        self.max_cached_subsets = 64
        self._full: RuleSetMatcher | None = None

    @property
    def num_rules(self) -> int:
        return len(self.patterns)

    @property
    def num_prefiltered(self) -> int:
        return len(self._lit_owner)

    def _sub(self, subset: tuple) -> "tuple[RuleSetMatcher, tuple]":
        """Matcher for a candidate subset + the rule indices it reports.
        Past the cache cap, returns the full-ruleset matcher (scanning a
        superset of rules is sound; counts are sliced by the caller)."""
        m = self._subs.get(subset)
        if m is not None:
            return m, subset
        if len(self._subs) < self.max_cached_subsets:
            m = RuleSetMatcher([self.patterns[i] for i in subset],
                               self.config, strategy=self.strategy)
            self._subs[subset] = m
            return m, subset
        if self._full is None:
            self._full = RuleSetMatcher(self.patterns, self.config,
                                        strategy=self.strategy)
        return self._full, tuple(range(self.num_rules))

    def scan(self, data) -> RuleSetReport:
        streams = _as_streams(data)
        per = np.zeros((len(streams), self.num_rules), np.int64)
        counts_all = np.zeros((len(streams), 0), np.int64)
        # one device AC pass over every stream decides the candidates
        lit_hits = (
            self._ac.scan_patterns(streams).pattern_counts
            if self._ac is not None
            else np.zeros((len(streams), 0), np.int64)
        )
        groups: dict[tuple, list[int]] = {}
        for s, row in enumerate(lit_hits):
            cand = sorted(
                self.always_check
                + [self._lit_owner[j] for j in np.nonzero(row)[0]]
            )
            groups.setdefault(tuple(cand), []).append(s)
        for subset, members in groups.items():
            if not subset:
                continue
            m, scanned = self._sub(subset)
            rep = m.scan([streams[s] for s in members])
            if scanned == subset:
                for k, s in enumerate(members):
                    per[s, list(subset)] = rep.rule_counts[k]
            else:  # full-ruleset fallback: slice the candidate columns
                cols = list(subset)
                for k, s in enumerate(members):
                    per[s, cols] = rep.rule_counts[k][cols]
        report = ScanReport(
            counts=counts_all, total=int(per.sum()),
            match_positions=None,
            metrics=RunMetrics(
                engine=f"prefiltered-{self.strategy}",
                bytes_scanned=sum(len(s) for s in streams),
                streams=len(streams), matches=int(per.sum()),
                wall_seconds=0.0,
            ),
        )
        return RuleSetReport(rule_counts=per, report=report)


def compile_regex_set_prefiltered(
    patterns, config: EngineConfig = DEFAULT_CONFIG,
    strategy: str = "lazy", min_literal: int = 3,
) -> PrefilteredRuleSet:
    """Literal-prefiltered variant of ``compile_regex_set`` (same counts,
    device-rate rejection of streams that cannot match)."""
    return PrefilteredRuleSet(patterns, config, strategy, min_literal)


@dataclasses.dataclass
class SnortAlert:
    rule_index: int
    sid: int | None
    msg: str
    pcre_checked: bool  # False = content-verified only (pcre outside subset)


@dataclasses.dataclass
class SnortReport:
    """Per-stream alert lists + the device-side prefilter counts."""

    alerts: list  # per stream: list[SnortAlert]
    prefilter_candidates: list  # per stream: list[int] rule indices
    content_report: "LiteralReport | None"

    def sids(self, stream: int = 0) -> list[int]:
        return [a.sid for a in self.alerts[stream] if a.sid is not None]


#: byte_test comparison operators (Snort: ``&``/``^`` are true when the
#: bitwise result is non-zero)
_BYTE_OPS = {
    "<": lambda v, x: v < x,
    ">": lambda v, x: v > x,
    "=": lambda v, x: v == x,
    "<=": lambda v, x: v <= x,
    ">=": lambda v, x: v >= x,
    "&": lambda v, x: (v & x) != 0,
    "^": lambda v, x: (v ^ x) != 0,
}


def _byte_convert(raw: bytes, pos: int, op) -> tuple[int, int] | None:
    """Read + convert ``op.count`` bytes at ``pos`` per byte_test/byte_jump
    conversion rules: binary big/little endian, or ``string`` (ASCII
    digits in ``op.base``, ``strtoul``-style — leading spaces and an
    optional sign, stop at the first non-digit; no digits = fail).
    Returns (value, read_end) or None when the read falls outside the
    payload."""
    n = len(raw)
    if op.string:
        if pos < 0 or pos >= n:
            return None
        end = min(pos + op.count, n)
        i = pos
        while i < end and raw[i] in b" \t":
            i += 1
        sign = 1
        if i < end and raw[i] in b"+-":
            sign = -1 if raw[i] == 0x2D else 1
            i += 1
        v, start_digits = 0, i
        while i < end:
            try:
                d = int(chr(raw[i]), op.base)
            except ValueError:
                break
            v = v * op.base + d
            i += 1
        if i == start_digits:
            return None
        return sign * v, end
    if pos < 0 or pos + op.count > n:
        return None
    return int.from_bytes(raw[pos : pos + op.count], op.endian), pos + op.count


def _apply_bitmask(v: int, mask: int) -> int:
    """AND with ``mask`` then right-shift by its trailing zero count
    (Snort bitmask semantics)."""
    v &= mask
    return v >> ((mask & -mask).bit_length() - 1)


#: rule options the pipeline ENFORCES (affect matching and are applied).
#: ``rawbytes`` is enforced AS A NO-OP: it pins inspection to the raw
#: (undecoded) payload, which is exactly and only what this stream
#: scanner inspects.
_MATCH_ENFORCED_OPTS = frozenset({
    "content", "nocase", "offset", "depth", "distance", "within", "pcre",
    "byte_test", "byte_jump", "byte_extract", "isdataat", "rawbytes",
    # HTTP sticky buffers (conservative verbatim carve, models/http.py);
    # byte ops chained relative to a buffered content are NOT enforced
    # (dropped at parse, flagged via the byte-op counts)
    "http_uri", "http_raw_uri", "http_method", "http_header",
    "http_raw_header", "http_client_body", "http_cookie",
    "http_raw_cookie",
    "dsize",  # payload-size predicate (inclusive bounds, Snort 2.9 rules)
    "urilen",  # URI-length predicate (normalized by default, ",raw" raw)
})
#: options that do not constrain MATCHING on a payload stream (labels,
#: bookkeeping, performance hints) — a rule carrying only these +
#: enforced options is fully enforced.  Plain ``fast_pattern`` only
#: selects which content seeds the engine's own prefilter (ours uses ALL
#: non-negated contents, a strict superset); the ``fast_pattern:only``
#: FORM changes matching (MPSE-only, case-insensitive) and is classified
#: unenforced in ``enforcement_report``.
_METADATA_OPTS = frozenset({
    "msg", "sid", "rev", "gid", "classtype", "reference", "metadata",
    "priority", "service", "rem", "target", "fast_pattern",
})
#: session-scope predicates: constrain WHICH stream/direction the rule
#: applies to (like the header's addresses/ports), not what the payload
#: must contain — a single-payload matcher can't evaluate them and Snort
#: wouldn't either without the TCP/session context.  Reported per rule
#: as ``scope_options`` (visible, not silently ignored) but not counted
#: against payload-level enforcement.  ``flowbits`` is NOT here: isset/
#: set gate alerting across packets, so ignoring them would change
#: match output (they classify as partial).
_SCOPE_OPTS = frozenset({"flow"})


class SnortMatcher:
    """Snort-rules scanner: device AC prefilter + host per-rule verify.

    Stage 1 runs every rule's content literals through the fast device literal
    engines (one automaton for case-sensitive contents, one over the
    case-folded stream for ``nocase`` ones); only rules whose non-negated
    contents ALL occur — the same multi-pattern prefilter architecture
    Snort uses — reach stage 2, which checks ordered occurrence WITH the
    positional modifiers ``offset``/``depth``/``distance``/``within``
    enforced (backtracking across occurrences), negated-content absence
    (stream-wide, or window-scoped when positionally constrained),
    ``byte_test``/``byte_jump`` span arithmetic (binary/string
    conversion, relative anchoring, bitmask/multiplier/align — the
    verify-program walk in ``_verify``), and the rule's ``pcre`` via the
    framework's own DFA compiler (``models/snort.py`` documents the
    supported subset).  ``enforcement_report()`` classifies every rule as
    fully enforced vs partially (content/pcre-only) verified."""

    def __init__(self, rules, config: EngineConfig = DEFAULT_CONFIG):
        from .models.snort import SnortRule  # noqa: F401 (typing only)

        self.rules = list(rules)
        self.config = config
        # dedupe content literals across rules, split by case sensitivity;
        # uri-buffered contents get their OWN automata scanned over the
        # normalized URI (their decoded form need not occur literally in
        # the raw stream — "/%61dmin" normalizes to "/admin" — so they
        # cannot gate the raw-stream prefilter; without any gate every
        # http_uri rule reached _verify on every payload, measured
        # 22 ms/payload at community scale)
        exact: dict[bytes, int] = {}
        fold: dict[bytes, int] = {}
        uri_exact: dict[bytes, int] = {}
        uri_fold: dict[bytes, int] = {}
        self._rule_contents: list[list[tuple[str, int, bool]]] = []
        for r in self.rules:
            entries = []
            for c in r.contents:
                if c.negated and (
                    c.offset is not None or c.depth is not None
                    or c.distance is not None or c.within is not None
                    or c.buffer is not None
                ):
                    # windowed (or buffer-scoped) negation asserts absence
                    # only INSIDE its window/buffer — stream-wide presence
                    # must not prefilter the rule away; _verify alone
                    # enforces it
                    continue
                if c.buffer == "uri":
                    if c.nocase:
                        pid = uri_fold.setdefault(c.pattern.lower(),
                                                  len(uri_fold))
                        entries.append(("uri_fold", pid, c.negated))
                    else:
                        pid = uri_exact.setdefault(c.pattern,
                                                   len(uri_exact))
                        entries.append(("uri_exact", pid, c.negated))
                    continue
                if c.nocase:
                    key = c.pattern.lower()
                    pid = fold.setdefault(key, len(fold))
                    entries.append(("fold", pid, c.negated))
                else:
                    pid = exact.setdefault(c.pattern, len(exact))
                    entries.append(("exact", pid, c.negated))
            self._rule_contents.append(entries)
        self._exact = (compile_literals(list(exact), config)
                       if exact else None)
        self._fold = (compile_literals(list(fold), config)
                      if fold else None)
        # normalized-URI prefilter automata: URIs are tens of bytes, so
        # these are walked host-side per carved request (models/literals
        # AC; the walk is O(len(uri)))
        from .models.literals import build_aho_corasick

        self._uri_exact = (build_aho_corasick(list(uri_exact))
                           if uri_exact else None)
        self._uri_fold = (build_aho_corasick(list(uri_fold))
                          if uri_fold else None)
        # vectorized gate arrays: the per-rule Python entry loop measured
        # 0.5 us * n_rules * n_payloads (0.66 s for 3k rules x 400
        # payloads); one fancy-indexed compare per automaton replaces it
        self._gate: dict[str, tuple] = {}
        for kind in ("exact", "fold", "uri_exact", "uri_fold"):
            rows, pids, negs = [], [], []
            for ri, entries in enumerate(self._rule_contents):
                for k, pid, neg in entries:
                    if k == kind:
                        rows.append(ri)
                        pids.append(pid)
                        negs.append(neg)
            if rows:
                self._gate[kind] = (np.asarray(rows), np.asarray(pids),
                                    np.asarray(negs, dtype=bool))
        self._lower_lut = np.arange(256, dtype=np.uint8)
        self._lower_lut[ord("A"):ord("Z") + 1] += 32
        self._pcre_cache: dict[int, tuple | None] = {}
        self._pcre_by_text: dict[str, tuple | None] = {}

    @property
    def num_rules(self) -> int:
        return len(self.rules)

    def export_coe(self, path: str):
        """Compile this ruleset's content literals into a reference-format
        ``.coe`` memory image — the "Snort rules → CSR_BlockMem" pipeline
        whose output the reference SHIPS but whose tooling it never
        published (``CSR_BlockMem_snort_16.coe`` derives from exactly such
        a ruleset, SURVEY.md §2.1 #14 / §0).

        Every rule's non-negated content literals (raw and buffered —
        the buffer/negation/pcre/byte-op constraints are host-verify
        stages with no RTL analogue) become one merged unanchored CSR
        NFA with per-literal accept states, loadable by the reference
        engine (accept = out-degree 0, per-state match counters =
        per-literal counters).  Returns ``(automaton, owner, literals)``
        where ``owner[s]`` is the literal index owning state ``s`` (-1
        for the shared hub)."""
        from .models.coe import write_coe
        from .models.export_csr import regexes_to_csr

        special = set(rb"\^$.[]()*+?{}|")
        literals = sorted({
            c.pattern for r in self.rules for c in r.contents
            if not c.negated and c.pattern
        })
        if not literals:
            raise RegexError("ruleset has no non-negated content literals")
        pats = [
            bytes(b for ch in lit
                  for b in ((0x5C, ch) if ch in special else (ch,)))
            for lit in literals
        ]
        aut, owner = regexes_to_csr(pats)
        write_coe(path, aut.to_words())
        return aut, owner, literals

    @staticmethod
    def _ac_presence(ac, data: bytes) -> np.ndarray:
        """Per-pattern occurrence counts of an AC automaton host-walked
        over a short derived buffer (normalized URI — tens of bytes, so
        a Python table walk beats any engine dispatch)."""
        table, accept = ac.dfa.table, ac.dfa.accept
        sc = np.zeros(ac.num_states, np.int64)
        s = 0
        for b in data:
            s = int(table[b, s])
            if accept[s]:
                sc[s] += 1
        return ac.pattern_counts(sc)

    def _pcre_tables(self, idx: int):
        """(table, accept, eof) for rule idx's pcre in scanning mode, or
        None when absent/outside the subset.  Compiled objects are shared
        across rules with identical pcre TEXT (community rulesets repeat
        boilerplate patterns; compiling per rule measured redundant)."""
        if idx not in self._pcre_cache:
            from .models.snort import pcre_to_pattern

            r = self.rules[idx]
            if r.pcre is not None and r.pcre in self._pcre_by_text:
                self._pcre_cache[idx] = self._pcre_by_text[r.pcre]
                return self._pcre_cache[idx]
            out = None
            if r.pcre is not None:
                pat = pcre_to_pattern(r.pcre)
                if pat is not None:
                    try:
                        d = compile_pattern(pat.encode(), anchored=False)
                        out = ("dfa", np.ascontiguousarray(d.table), d.accept,
                               d.eof_accept, d.start)
                    except Exception:
                        # \b/\B (or DFA blowup): host Pike-VM existence check
                        try:
                            from .models.captures import CaptureProgram

                            out = ("host", CaptureProgram(pat.encode()))
                        except Exception:
                            out = None
            self._pcre_cache[idx] = out
            if r.pcre is not None:
                self._pcre_by_text[r.pcre] = out
        return self._pcre_cache[idx]

    def _pcre_hit(self, idx: int, raw: bytes,
                  memo: dict | None = None) -> bool | None:
        """True/False = verified; None = pcre absent or outside subset.
        ``memo`` (per stream) dedupes by pcre TEXT: content-less pcre
        rules are always prefilter candidates, and community corpora
        repeat the same pattern across many rules — unmemoized this
        measured 26k native scans for 400 payloads."""
        r = self.rules[idx]
        if r.pcre is None:
            return None
        if memo is not None and r.pcre in memo:
            return memo[r.pcre]
        t = self._pcre_tables(idx)
        if t is None:
            return None
        res = self._pcre_run(t, raw)
        if memo is not None:
            memo[r.pcre] = res
        return res

    @staticmethod
    def _pcre_run(t, raw: bytes) -> bool:
        if t[0] == "host":  # \b/\B patterns: Pike-VM match existence
            return bool(t[1].finditer_spans(raw, limit=1))
        _, table, accept, eof, start = t
        from .utils.native import dfa_scan_native, native_available

        if native_available():
            # native walk (identity byte classes — pcre tables are raw-byte
            # indexed); the per-byte Python loop below runs ~1 MB/s and
            # does not scale to stream payloads
            counts, _, final = dfa_scan_native(
                table, np.arange(256, dtype=np.int32), accept,
                np.frombuffer(raw, dtype=np.uint8),
                start=start, want_mask=False,
            )
            return bool(counts.sum() > 0 or accept[final] or eof[final])
        s = start
        for b in raw:
            if accept[s]:
                return True
            s = int(table[b, s])
        return bool(accept[s] or eof[s])

    def _verify(self, idx: int, raw: bytes, low: bytes,
                http_cache: dict | None = None) -> bool:
        """Ordered-occurrence check over the rule's VERIFY PROGRAM
        (``SnortRule.verify_ops``: contents + byte_test/byte_jump in rule
        order) with the positional content modifiers ENFORCED
        (``models/snort.py``): ``offset``/``depth`` window the
        search absolutely — anchored to PAYLOAD START, independent of the
        ordered-walk cursor, depth measured from offset (Snort semantics);
        ``distance``/``within`` window it relative to the previous content
        match's end (``within`` bounds the current match's END).  Negated
        contents assert absence — stream-wide by default, inside their
        window when positionally constrained.  ``byte_test`` is a
        zero-width predicate on converted payload bytes (cursor
        unchanged); ``byte_jump`` converts, scales, aligns, and MOVES the
        cursor — out-of-payload reads or jump targets fail the rule.
        Fuzz-validated against a brute-force all-assignments oracle
        (``tests/test_snort.py::test_verify_fuzz_vs_bruteforce_oracle``).

        The walk BACKTRACKS over occurrences of content ``i`` ONLY when a
        later op is positioned relative to it (``distance``/``within`` on
        a content, ``relative`` on a byte op, somewhere after ``i``):
        there the occurrence choice matters (greedy first-occurrence would
        wrongly refuse e.g. ``content:"A"; content:"B"; within:3;`` on
        ``b"A....A..B"``), and the windows bound the retry cost.  When no
        later op is relative, the earliest occurrence is provably optimal
        (every later content searches FROM the previous match end, so an
        earlier end only widens its window) and the walk stays greedy —
        this also keeps the verify stage LINEAR on attacker-controlled
        payloads (unbounded backtracking measured quadratic: 5 s on a
        160 KB crafted packet)."""
        from .models.snort import (
            ByteExtract, ByteJump, ByteTest, IsDataAt, SnortContent,
        )

        rule = self.rules[idx]
        contents = rule.verify_ops or rule.contents
        n = len(raw)
        dsz = getattr(rule, "dsize", None)
        if dsz is not None:
            lo, hi = dsz
            if (lo is not None and n < lo) or (hi is not None and n > hi):
                return False
        http_bufs = None
        ul = getattr(rule, "urilen", None)
        if ul is not None or any(
                isinstance(c, SnortContent) and c.buffer for c in contents):
            if http_cache is None:
                http_cache = {}
            if "bufs" not in http_cache:  # carve once per stream
                from .models.http import parse_http_request

                http_cache["bufs"] = parse_http_request(raw)
            http_bufs = http_cache["bufs"]
        if ul is not None:
            # urilen: inclusive URI-length predicate against the
            # normalized (default) or raw URI; no parseable request ->
            # no URI -> the rule cannot fire (Snort: buffer absent)
            if http_bufs is None:
                return False
            lo, hi, mode = ul
            u0, u1 = http_bufs.uri
            if mode == "norm" and http_bufs.uri_norm is not None:
                ulen = len(http_bufs.uri_norm)
            else:
                ulen = u1 - u0
            if (lo is not None and ulen < lo) \
                    or (hi is not None and ulen > hi):
                return False
        # later_relative[i]: some op at index >= i anchors to the cursor
        # (distance/within content, or a relative byte op); queried at
        # [ci + 1] to ask "does any LATER op depend on where op ci ended?"
        later_relative = [False] * (len(contents) + 1)
        for i in range(len(contents) - 1, -1, -1):
            c = contents[i]
            rel = (c.relative
                   if isinstance(c, (ByteTest, ByteJump, ByteExtract,
                                     IsDataAt))
                   else (c.distance is not None or c.within is not None))
            later_relative[i] = later_relative[i + 1] or rel

        _missing = object()  # unresolved byte_extract variable sentinel

        def ok_from(ci: int, prev_end: int, env: dict,
                    bufpos: dict) -> bool:
            if ci == len(contents):
                return True
            c = contents[ci]

            def rv(x):
                # int | None pass through; variable name -> bound value
                return env.get(x, _missing) if isinstance(x, str) else x

            if isinstance(c, ByteTest):
                off, val = rv(c.offset), rv(c.value)
                if off is _missing or val is _missing:
                    return False
                got = _byte_convert(raw, (prev_end if c.relative else 0)
                                    + off, c)
                if got is None:
                    return False
                v, _ = got
                if c.bitmask is not None:
                    v = _apply_bitmask(v, c.bitmask)
                res = _BYTE_OPS[c.op](v, val)
                if c.negate:
                    res = not res
                return bool(res) and ok_from(ci + 1, prev_end, env, bufpos)
            if isinstance(c, ByteExtract):
                off = rv(c.offset)
                if off is _missing:
                    return False
                got = _byte_convert(raw, (prev_end if c.relative else 0)
                                    + off, c)
                if got is None:
                    return False
                v, read_end = got
                # bindings are IMMUTABLE per path: backtracking into an
                # earlier content re-runs the extract with the new cursor
                return ok_from(ci + 1, read_end,
                               {**env, c.name: v * c.multiplier}, bufpos)
            if isinstance(c, IsDataAt):
                pos = rv(c.pos)
                if pos is _missing:
                    return False
                base = prev_end if c.relative else 0
                exists = 0 <= base + pos < n
                if exists == c.negate:
                    return False
                return ok_from(ci + 1, prev_end, env, bufpos)
            if isinstance(c, ByteJump):
                off = rv(c.offset)
                if off is _missing:
                    return False
                pos = (prev_end if c.relative else 0) + off
                if c.count == 0:
                    v, read_end = 0, pos
                else:
                    got = _byte_convert(raw, pos, c)
                    if got is None:
                        return False
                    v, read_end = got
                if c.bitmask is not None:
                    v = _apply_bitmask(v, c.bitmask)
                v *= c.multiplier
                if c.align:
                    v = (v + 3) & ~3
                if c.from_beginning:
                    target = v
                elif c.from_end:
                    target = n + v
                else:
                    target = read_end + v
                target += c.post_offset
                if target < 0 or target > n:
                    return False
                return ok_from(ci + 1, target, env, bufpos)
            c_off, c_dep = rv(c.offset), rv(c.depth)
            c_dist, c_win = rv(c.distance), rv(c.within)
            if _missing in (c_off, c_dep, c_dist, c_win):
                return False
            # HTTP buffer carve: a buffered content searches only its
            # buffer's payload SLICE, with buffer-relative windows and a
            # per-buffer cursor (Snort per-buffer DOE; models/http.py).
            # A payload that isn't a parseable HTTP request has no
            # buffers, so buffered contents fail (Snort: buffer absent).
            bhay = None  # non-None: buffer-local haystack (normalized URI)
            if c.buffer is not None:
                if http_bufs is None:
                    return False
                if c.buffer == "uri" and http_bufs.uri_norm is not None:
                    # http_uri matches the NORMALIZED buffer (r4 verdict
                    # item 9): percent-decoded + path-compressed bytes,
                    # buffer-relative coordinates, per-buffer DOE cursor.
                    # No raw span exists for these matches; the alert
                    # surface carries rule ids, not spans, so nothing is
                    # lost.  http_raw_uri stays the verbatim slice.
                    norm = http_bufs.uri_norm
                    if c.nocase:
                        if "uri_norm_low" not in http_cache:
                            http_cache["uri_norm_low"] = norm.lower()
                        bhay = http_cache["uri_norm_low"]
                    else:
                        bhay = norm
                    base_off, blen = 0, len(norm)
                else:
                    span = getattr(http_bufs, c.buffer)
                    if span is None:
                        return False
                    base_off, buf_end = span
                    blen = buf_end - base_off
                cur = bufpos.get(c.buffer, 0)
            else:
                base_off, blen, cur = 0, n, prev_end
            hay = bhay if bhay is not None else (low if c.nocase else raw)
            needle = c.pattern.lower() if c.nocase else c.pattern
            relative = c_dist is not None or c_win is not None
            absolute = (
                (c_off is not None or c_dep is not None)
                and not relative
            )
            if absolute:
                # Snort semantics: offset/depth anchor to PAYLOAD (or
                # buffer) START, independent of the ordered-walk cursor
                start = c_off or 0
            elif relative:
                start = cur + (c_dist or 0)
                if c_off is not None:  # mixed: both constraints apply
                    start = max(start, c_off)
            else:
                start = cur  # ordered-occurrence walk
            end_limit = (
                cur + c_win if c_win is not None else None
            )
            if c_dep is not None:
                dl = (c_off or 0) + c_dep
                end_limit = dl if end_limit is None else min(end_limit, dl)
            start = max(start, 0)

            def advance(rel_end: int):
                if c.buffer is not None:
                    return ok_from(ci + 1, prev_end, env,
                                   {**bufpos, c.buffer: rel_end})
                return ok_from(ci + 1, rel_end, env, bufpos)

            if c.negated:
                windowed = (relative or c_off is not None
                            or c_dep is not None)
                seg_end = (min(end_limit, blen) if end_limit is not None
                           else blen)
                frm = start if windowed else 0
                if hay.find(needle, base_off + frm,
                            base_off + (seg_end if windowed else blen)
                            ) != -1:
                    return False
                # a negated content matches "nothing": cursor stays put
                return ok_from(ci + 1, prev_end, env, bufpos)
            # bound the search by end_limit so find() never scans past the
            # window: an occurrence must END by end_limit, which is exactly
            # bytes.find's slice-end semantics.  Without the bound, each
            # backtracking retry of an earlier content re-scans to payload
            # end (measured quadratic again: 4 s on a 160 KB crafted
            # b"A"*n + b"BB" packet against `content:"AA"; content:"BB";
            # within:4;`)
            bound = blen if end_limit is None else min(end_limit, blen)
            at = hay.find(needle, base_off + start, base_off + bound)
            if not later_relative[ci + 1]:
                # greedy: earliest occurrence is optimal (see docstring)
                if at == -1:
                    return False
                return advance(at - base_off + len(needle))
            while at != -1:
                if advance(at - base_off + len(needle)):
                    return True
                at = hay.find(needle, at + 1, base_off + bound)
            return False

        return ok_from(0, 0, {}, {})

    def enforcement_report(self) -> dict:
        """Per-rule enforcement coverage: which rules this pipeline fully
        enforces vs verifies partially (content/pcre only), and why.

        ``status`` per rule: ``"enforced"`` — every match-constraining
        option is applied (byte ops parsed into the verify program, pcre
        compiled into the engine subset); ``"partial"`` — some match
        constraint is not applied (names in ``unenforced_options``,
        byte ops whose modifiers fell outside the parsed subset in
        ``byte_ops_unparsed``, or a pcre outside the compiler subset).
        Metadata options (msg/sid/rev/classtype/reference/...) never
        affect matching and don't count against a rule."""
        from .models.snort import (
            ByteExtract, ByteJump, ByteTest, IsDataAt,
        )

        rows = []
        for i, r in enumerate(self.rules):
            scope = sorted({nm for nm, _ in r.options if nm in _SCOPE_OPTS})
            unenforced = sorted({
                nm for nm, v in r.options
                if (nm not in _MATCH_ENFORCED_OPTS
                    and nm not in _METADATA_OPTS
                    and nm not in _SCOPE_OPTS)
                # fast_pattern:only is NOT a pure hint: Snort then skips
                # the rule-option content check and matches it
                # case-insensitively via the MPSE — semantics this
                # pipeline does not reproduce
                or (nm == "fast_pattern" and v and "only" in v)
                or (nm == "dsize"
                    and getattr(r, "dsize", None) is None)
                or (nm == "urilen"
                    and getattr(r, "urilen", None) is None)
            })
            byte_opt_names = ("byte_test", "byte_jump", "byte_extract",
                              "isdataat")
            n_byte_opts = sum(
                1 for nm, _ in r.options if nm in byte_opt_names
            )
            n_byte_ops = sum(
                1 for o in (r.verify_ops or ())
                if isinstance(o, (ByteTest, ByteJump, ByteExtract, IsDataAt))
            )
            byte_unparsed = n_byte_opts - n_byte_ops
            dropped_mods = list(getattr(r, "unenforced_modifiers", ()))
            pcre_state = "none"
            if r.pcre is not None:
                pcre_state = ("enforced" if self._pcre_tables(i) is not None
                              else "outside-subset")
            full = (not unenforced and byte_unparsed == 0
                    and not dropped_mods
                    and pcre_state != "outside-subset")
            rows.append({
                "rule": i,
                "sid": r.sid,
                "status": "enforced" if full else "partial",
                "unenforced_options": unenforced,
                "scope_options": scope,
                "byte_ops_unparsed": byte_unparsed,
                "dropped_modifiers": dropped_mods,
                "pcre": pcre_state,
            })
        summary = {
            "total": len(rows),
            "enforced": sum(r["status"] == "enforced" for r in rows),
            "partial": sum(r["status"] == "partial" for r in rows),
            "with_scope_options": sum(
                bool(r["scope_options"]) for r in rows
            ),
            "pcre_outside_subset": sum(
                r["pcre"] == "outside-subset" for r in rows
            ),
            "byte_ops_unparsed": sum(r["byte_ops_unparsed"] for r in rows),
            "dropped_modifiers": sum(
                len(r["dropped_modifiers"]) for r in rows
            ),
        }
        return {"rules": rows, "summary": summary}

    def scan(self, data) -> SnortReport:
        streams = _as_streams(data)
        alerts, cands = [], []
        content_report = None
        # prefilter the WHOLE batch in one engine call per automaton:
        # per-payload dispatch (router + native-call setup) measured
        # ~5 ms/payload of pure overhead at community scale (400
        # payloads, 3k rules) — the multi-stream engines amortize it
        ecs = fcs = None
        if streams:
            if self._exact is not None:
                ecs = self._exact.scan_patterns(streams).pattern_counts
            if self._fold is not None:
                lows = [self._lower_lut[s] for s in streams]
                fcs = self._fold.scan_patterns(lows).pattern_counts
        for si, stream in enumerate(streams):
            raw = bytes(stream)
            low = bytes(self._lower_lut[stream])
            http_cache: dict = {}  # per-stream carve memo (_verify fills
            # it on the FIRST buffered rule that survives the prefilter)
            pcre_memo: dict = {}   # per-stream pcre-text result memo
            ec = ecs[si] if ecs is not None else None
            fc = fcs[si] if fcs is not None else None
            uce = ucf = None
            if self._uri_exact is not None or self._uri_fold is not None:
                # normalized-URI prefilter: carve once (shared with
                # _verify via http_cache), walk the short buffer through
                # the uri AC automata host-side
                from .models.http import parse_http_request

                carve = parse_http_request(raw)
                http_cache["bufs"] = carve
                if carve is not None:
                    u0, u1 = carve.uri
                    ub = (carve.uri_norm if carve.uri_norm is not None
                          else raw[u0:u1])
                    if self._uri_exact is not None:
                        uce = self._ac_presence(self._uri_exact, ub)
                    if self._uri_fold is not None:
                        ucf = self._ac_presence(self._uri_fold,
                                                ub.lower())
            vecs = {"exact": ec, "fold": fc,
                    "uri_exact": uce, "uri_fold": ucf}
            ok = np.ones(len(self.rules), dtype=bool)
            for kind, (rows, pids, negs) in self._gate.items():
                vec = vecs[kind]
                # an absent vector = the haystack itself is absent (no
                # HTTP request -> no uri buffer): non-negated contents
                # there can never match
                present = (np.zeros(len(pids), dtype=bool) if vec is None
                           else np.asarray(vec)[pids] > 0)
                # a rule fails when a content's presence equals its
                # negation flag ((n == 0) != negated in scalar form)
                ok[rows[present == negs]] = False
            out: list[SnortAlert] = []
            hits = np.nonzero(ok)[0].tolist()
            for i in hits:
                if not self._verify(i, raw, low, http_cache=http_cache):
                    continue
                ph = self._pcre_hit(i, raw, memo=pcre_memo)
                if ph is False:
                    continue
                r = self.rules[i]
                out.append(SnortAlert(rule_index=i, sid=r.sid, msg=r.msg,
                                      pcre_checked=ph is True))
            alerts.append(out)
            cands.append(hits)
        return SnortReport(alerts=alerts, prefilter_candidates=cands,
                           content_report=content_report)


def compile_snort(source: str, config: EngineConfig = DEFAULT_CONFIG
                  ) -> SnortMatcher:
    """Load a Snort ``.rules`` file (path) or rules text into the
    prefilter+verify pipeline."""
    import os

    from .models.snort import load_snort_rules, parse_snort_rules

    rules = (load_snort_rules(source) if os.path.exists(source)
             else parse_snort_rules(source))
    if not rules:
        raise ValueError("no rules parsed")
    return SnortMatcher(rules, config)


def compile_l7(path: str, config: EngineConfig = DEFAULT_CONFIG,
               strategy: str = "lazy", prefilter: bool = False):
    """Compile l7-filter ``.pat`` protocol pattern file(s) — the upstream
    source format of the reference's l-7_filter ruleset (models/l7.py) —
    into one multi-rule matcher.  ``path`` is one ``.pat`` file or a
    directory of them; rule names land in ``matcher.rule_names``.
    ``prefilter=True`` guards literal-bearing protocols behind the device
    AC prefilter (``PrefilteredRuleSet``; identical counts)."""
    import os

    from .models.l7 import load_l7_dir, load_l7_pattern

    pats = (load_l7_dir(path) if os.path.isdir(path)
            else [load_l7_pattern(path)])
    if not pats:
        raise ValueError(f"no .pat files under {path!r}")
    patterns = [p.compile_pattern for p in pats]
    if prefilter:
        m = PrefilteredRuleSet(patterns, config, strategy=strategy)
    else:
        m = RuleSetMatcher(patterns, config, strategy=strategy)
    m.rule_names = [p.name for p in pats]
    return m
