"""Host-vs-device engine router for counting/histogram scans.

The framework has TWO viable engines for a plain count/histogram pass over
a dense DFA (reference behavior: ``Design/FPGA.v`` per-state hit counting):

* **device** (``ops.dfa_fast``): block-parallel Jacobi + one-hot GEMMs.
  The cost model is padded 128x128 tiles per step — ``ceil(C/128) *
  ceil(W/128) + 1`` with table width ``W = S`` (<= 256) or ``2S``
  (byte-split) — so the modeled per-byte rate FALLS as S grows.
* **host** (``native/golden_scan.cpp::dfa_scan_multi``): interleaved
  multi-cursor table walk over the host's cores (GIL-released threads).
  Rate is independent of S while the table stays cache-resident.

This module extends the crossover discipline that routes k-gram vs k=1
(``ops.kgram.choose_scan_level``, gate ``KGRAM_MAX_STATES``) one level up:
k=1 device vs native host.  The static priors below are the router
probes' own readings on one H100 machine (``chip_smoke.py`` phase 6); a
per-process probe replaces them at the first contested scan.
"""

from __future__ import annotations

import time

import numpy as np

__all__ = [
    "DEVICE_TILE_BPS",
    "HOST_SINGLE_BPS",
    "HOST_MULTI_BPS",
    "PROBE_BAND",
    "PROBE_MIN_WORKLOAD",
    "device_count_bps",
    "host_count_bps",
    "choose_scan_backend",
    "probe_host",
    "probe_device",
    "session_rates",
    "record_device_rate",
    "record_host_rate",
    "reset_session",
]

#: Static priors: the mean of the ``probe_device``/``probe_host`` readings
#: at S=440 and S=836 (C=36; 64 MiB device chunk, 16 MiB host stream) in
#: ``chip_smoke.py`` phase 6 on one NVIDIA H100 80GB HBM3 at a 700 W power
#: limit, with that machine's 16 host cores.
#: device rate * padded tiles per step (``step_orientation_costs`` + 1);
#: read 3.70e9 at S=440 and 4.32e9 at S=836
DEVICE_TILE_BPS = 4.01e9
#: native single-stream walk (speculative segmented variant,
#: ``dfa_scan_speculative_native``); read 1.01e9 and 0.92e9
HOST_SINGLE_BPS = 0.96e9
#: native multi-cursor walk, >= 4 streams, all host cores; read 1.12e9
#: and 0.88e9
HOST_MULTI_BPS = 1.00e9


def device_count_bps(num_states: int, num_classes: int) -> float:
    """Modeled k=1 counting rate of the fast device engine: padded-tile
    cost per step (GEMM + one select) at the BEST orientation.  The tile
    arithmetic is the engine's own (``dfa_fast.step_orientation_costs``,
    shared with ``transposed_step``), so the router's model cannot drift
    from what the engine emits."""
    from .dfa_fast import step_orientation_costs

    cur, tr, _, _ = step_orientation_costs(num_classes, num_states)
    tile_bps = _session.get("device_tile_bps", DEVICE_TILE_BPS)
    return tile_bps / (min(cur, tr) + 1)


def host_count_bps(n_streams: int) -> float:
    """Modeled native-walker rate: multi-cursor aggregate when streams
    fill the interleave width, else the speculative segmented
    single-stream walk (api._host_scan_counts routes accordingly).
    Session-measured when a probe has run, static prior before."""
    if n_streams >= 4:
        return _session.get("host_multi_bps", HOST_MULTI_BPS)
    return _session.get("host_single_bps", HOST_SINGLE_BPS)


# --------------------------------------------------------------------------
# Per-session runtime calibration
#
# The static constants above are priors from one machine; rates differ
# across cards, power limits and hosts.  At the first contested scan with
# enough work at stake both engines are measured once per process on a
# synthetic chunk, the rates are cached, and the router routes on them.
# ``scan_backend`` force still bypasses everything.  The device probe
# uploads its class stream once outside the timed region and uses the scan
# loop's own chunk geometry, so its compile is the one the scan reuses.
# The host walker's cost depends on the data (real traffic concentrates on
# cache-hot states), so the random probe stream measures its worst case.
# --------------------------------------------------------------------------

#: contested band of S: outside it the static priors decide without a
#: probe.  Carried over from the design's first target; not yet
#: re-measured on the GPU (ROADMAP S5).
PROBE_BAND = (200, 1500)
#: probe only when at least this much work (>= 2 default chunks) is at
#: stake: below it, a mis-route costs less than the probe itself.  The
#: device probe uses THE SCAN'S OWN chunk shape (uint8 classes,
#: chunk_bytes length, the same block-shrink rule), so its jit compile is
#: the one the chunked scan loop pays anyway.
PROBE_MIN_WORKLOAD = 128 << 20
PROBE_HOST_BYTES = 16 << 20
PROBE_DEVICE_BYTES = 1 << 26   # = EngineConfig.chunk_bytes default
PROBE_DEVICE_BLOCKS = 65536    # = EngineConfig.num_blocks default
PROBE_MIN_BLOCK_BYTES = 64     # = EngineConfig.min_block_bytes default
PROBE_REPS = 3
#: margin the DEVICE must clear over the host in the contested band once
#: a probe has run: the tile model extrapolating across S and the host
#: probe's cache-worst random stream both flatter the device there.
#: Carried over from the design's first target (ROADMAP S5).
DEVICE_MARGIN = 1.25

#: process-wide measured rates; keys: "device_tile_bps",
#: "host_multi_bps", "host_single_bps"
_session: dict = {}


def session_rates() -> dict:
    """Copy of the session's measured-rate cache (bench reporting)."""
    return dict(_session)


def reset_session() -> None:
    _session.clear()


def record_device_rate(num_states: int, num_classes: int,
                       bytes_per_sec: float) -> None:
    """Fold an OBSERVED device k=1 counting rate into the session cache.

    Normalized to rate-per-padded-tile via the engine's own cost model,
    so one observation at any (S, C) calibrates the whole band."""
    from .dfa_fast import step_orientation_costs

    cur, tr, _, _ = step_orientation_costs(num_classes, num_states)
    _session["device_tile_bps"] = float(bytes_per_sec) * (min(cur, tr) + 1)


def record_host_rate(n_streams: int, bytes_per_sec: float) -> None:
    key = "host_multi_bps" if n_streams >= 4 else "host_single_bps"
    _session[key] = float(bytes_per_sec)


def probe_host(tables, n_streams: int) -> float:
    """Measure the native walker on a synthetic stream; cache + return
    bytes/s."""
    from ..utils.native import (
        dfa_scan_multi_native, dfa_scan_speculative_native,
    )

    key = "host_multi_bps" if n_streams >= 4 else "host_single_bps"
    if key in _session:
        return _session[key]
    tab = np.asarray(tables.table)
    cls = np.asarray(tables.class_of)
    acc = np.asarray(tables.accept)
    data = np.random.default_rng(0).integers(
        0, 256, PROBE_HOST_BYTES, dtype=np.uint8
    )
    if n_streams >= 4:
        parts = np.array_split(data, 16)
        run = lambda: dfa_scan_multi_native(tab, cls, acc, parts)
    else:
        run = lambda: dfa_scan_speculative_native(tab, cls, acc, data)
    run()  # warm (thread pool, table into cache)
    ts = []
    for _ in range(PROBE_REPS):
        t0 = time.perf_counter()
        run()
        ts.append(time.perf_counter() - t0)
    bps = PROBE_HOST_BYTES / float(np.median(ts))
    _session[key] = bps
    return bps


def probe_device(tables, chunk_bytes: int | None = None,
                 num_blocks: int | None = None,
                 min_block_bytes: int | None = None) -> float:
    """Measure the fast device engine's k=1 counting rate; cache (as a
    normalized tile rate) + return bytes/s at THIS (S, C).

    The probe chunk replicates the chunked scan loop's own geometry —
    uint8 class stream of ``chunk_bytes``, block count from the same
    shrink rule — so the jit compile it triggers is the one the
    subsequent scan reuses.  Upload happens once outside the timed
    region; each rep ends in ``block_until_ready``."""
    from .dfa_fast import dfa_scan_fast, step_orientation_costs

    s, c = tables.num_states, tables.num_classes
    cur, tr, _, _ = step_orientation_costs(c, s)
    tiles = min(cur, tr) + 1
    if "device_tile_bps" in _session:
        return _session["device_tile_bps"] / tiles
    import jax

    from ..utils.config import shrink_blocks

    nbytes = chunk_bytes or PROBE_DEVICE_BYTES
    nb = shrink_blocks(nbytes, num_blocks or PROBE_DEVICE_BLOCKS,
                       min_block_bytes or PROBE_MIN_BLOCK_BYTES)
    classes = np.random.default_rng(0).integers(
        0, c, nbytes, dtype=np.uint8 if c <= 256 else np.int32
    )
    cj = jax.device_put(classes)
    run = lambda: jax.block_until_ready(
        dfa_scan_fast(tables, cj, num_blocks=nb, emit="counts").counts
    )
    run()  # compile (cached per table shape for the rest of the session)
    ts = []
    for _ in range(PROBE_REPS):
        t0 = time.perf_counter()
        run()
        ts.append(time.perf_counter() - t0)
    bps = nbytes / max(float(np.median(ts)), 1e-9)
    _session["device_tile_bps"] = bps * tiles
    return bps


def choose_scan_backend(num_states: int, num_classes: int,
                        n_streams: int = 1, mode: str = "auto",
                        tables=None, workload_bytes: int | None = None,
                        chunk_bytes: int | None = None,
                        num_blocks: int | None = None,
                        min_block_bytes: int | None = None,
                        ) -> str:
    """``"device"`` or ``"host"`` for a counting/histogram scan.

    ``mode`` is ``EngineConfig.scan_backend``: "auto" applies the
    measured rates (session probe cache first, static priors before any
    probe has run); "device"/"host" force.  The host side
    additionally requires the native library (the caller falls back to
    device when it is unavailable).

    When ``tables`` is supplied, the decision falls in the contested
    band, ``workload_bytes`` is large enough to amortize a probe, and no
    measured rate is cached yet, both engines are probed NOW (~150 ms
    host + one compile-then-milliseconds device chunk) and the measured
    rates decide.  A probe that fails raises: a broken device must not
    be mistaken for a slow one."""
    if mode in ("device", "host"):
        return mode
    host_key = "host_multi_bps" if n_streams >= 4 else "host_single_bps"
    if tables is not None and PROBE_BAND[0] <= num_states <= PROBE_BAND[1] \
            and (workload_bytes or 0) >= PROBE_MIN_WORKLOAD \
            and ("device_tile_bps" not in _session
                 or host_key not in _session):
        from ..utils.native import native_available

        if native_available():
            if host_key not in _session:
                probe_host(tables, n_streams)
            if "device_tile_bps" not in _session:
                probe_device(tables, chunk_bytes, num_blocks,
                             min_block_bytes)
    # session-measured rates when a probe (or an explicit record_*) has
    # run, static priors otherwise
    dev_bps = device_count_bps(num_states, num_classes)
    host_bps = host_count_bps(n_streams)
    if "device_tile_bps" in _session \
            and PROBE_BAND[0] <= num_states <= PROBE_BAND[1]:
        # probed contested band: the device must clear the measured
        # model-bias margin (DEVICE_MARGIN docstring)
        return "device" if dev_bps >= DEVICE_MARGIN * host_bps else "host"
    if dev_bps >= host_bps:
        return "device"
    return "host"
