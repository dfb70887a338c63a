"""Chunked corpus ingest with checkpointed, fault-tolerant scanning.

SURVEY.md SS5.3-5.4: the reference's only recovery primitive is the reset
wire (``Design/FPGA.v:118-153``); here the matcher state between chunks is a
tiny serializable carry (DFA: one state int + counts; NFA: the active list +
counts), so recovery is "reload last carry, rescan from that chunk".  Chunk
scans that raise (device preemption, OOM) are retried; a persistent failure
surfaces after ``max_retries``.

For multi-host runs each host ingests its own file shard (DCN does not see
byte streams, only the small seam/count collectives ride the network —
SURVEY.md SS5.8).
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Callable, Iterable, Iterator

import numpy as np

__all__ = [
    "iter_file_chunks",
    "shard_files",
    "CheckpointStore",
    "NonRetryableScanError",
    "resilient_scan",
    "prefetch_chunks",
    "iter_batch_chunks",
    "dist_resilient_scan",
]


class NonRetryableScanError(RuntimeError):
    """A deterministic scan failure (e.g. seam fixpoint non-convergence):
    re-running the identical chunk cannot succeed, so ``resilient_scan``
    surfaces it immediately instead of burning retries."""


def prefetch_chunks(
    chunks: Iterable[tuple[int, np.ndarray]],
    prepare: Callable[[np.ndarray], object] | None = None,
    depth: int = 2,
) -> Iterator[tuple[int, object]]:
    """Overlap ingest with compute: a worker thread reads (and ``prepare``s)
    up to ``depth`` chunks ahead while the caller scans the current one —
    the device-side analogue of the reference's fetch/compare overlap
    (``Design/FPGA.v:229-242``), applied at the chunk level.

    ``prepare`` runs on the worker thread; the intended use is host-side
    byte-class mapping + ``jnp.asarray`` so the host→device upload of chunk
    k+1 is in flight during the device scan of chunk k (JAX dispatch is
    async, so the caller's scan does not block the worker).  Order is
    preserved; a worker exception re-raises at the consumption point.
    Composes with ``resilient_scan``:

        resilient_scan(scan_chunk, prefetch_chunks(iter_file_chunks(p, n),
                                                   prepare=cls_map))
    """
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
    sentinel = object()
    failure: list[BaseException] = []
    stop = threading.Event()

    def worker():
        try:
            for off, chunk in chunks:
                item = (off, prepare(chunk) if prepare else chunk)
                # bounded put with cancellation: if the consumer abandoned
                # the generator, drop the prepared chunks instead of
                # blocking on a full queue forever (thread/buffer leak)
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if stop.is_set():
                    return
        except BaseException as e:  # surfaced to the consumer below
            failure.append(e)
        finally:
            while True:  # same bounded put: never block on a gone consumer
                try:
                    q.put(sentinel, timeout=0.1)
                    break
                except queue.Full:
                    if stop.is_set():
                        break

    threading.Thread(target=worker, daemon=True).start()
    try:
        while True:
            item = q.get()
            if item is sentinel:
                if failure:
                    raise failure[0]
                return
            yield item
    finally:
        stop.set()


def iter_file_chunks(
    path: str, chunk_bytes: int, offset: int = 0
) -> Iterator[tuple[int, np.ndarray]]:
    """Yield (offset, uint8 chunk) via mmap — no double buffering in RAM."""
    data = np.memmap(path, dtype=np.uint8, mode="r")
    for off in range(offset, len(data), chunk_bytes):
        yield off, np.asarray(data[off : off + chunk_bytes])


def shard_files(paths: list[str], host_index: int, host_count: int) -> list[str]:
    """Static per-host file sharding (round-robin by size rank)."""
    ranked = sorted(paths, key=lambda p: -os.path.getsize(p))
    return [p for i, p in enumerate(ranked) if i % host_count == host_index]


@dataclasses.dataclass
class CheckpointStore:
    """npz-on-disk checkpoint of a streaming scan carry."""

    path: str

    def save(self, carry: dict) -> None:
        tmp = self.path + ".tmp.npz"  # np.savez keeps names ending in .npz
        np.savez(tmp, **{k: v for k, v in carry.items() if v is not None})
        os.replace(tmp, self.path)

    def load(self) -> dict | None:
        if not os.path.exists(self.path):
            return None
        with np.load(self.path, allow_pickle=False) as z:
            return {k: z[k] for k in z.files}


def resilient_scan(
    scan_chunk: Callable[[np.ndarray, dict | None], dict],
    chunks: Iterable[tuple[int, np.ndarray]],
    store: CheckpointStore | None = None,
    max_retries: int = 3,
    retry_delay: float = 1.0,
    span: Callable[[object], int] | None = None,
) -> dict:
    """Run ``scan_chunk(chunk, carry) -> carry`` over chunks with retry +
    checkpointing.  ``carry`` must be a dict of numpy arrays / scalars and
    must fully determine resumption (the SS5.4 property: matcher state is
    O(S)).

    ``span(chunk)`` converts a chunk to its advance in the same units as
    the iterable's offsets (default: trailing-axis length, which is the
    byte count for 1-D byte chunks and (BATCH, L) slabs alike; pass an
    explicit span when ``prepare`` changed the unit — e.g. k-gram class
    streams advance ``len * k`` bytes)."""
    if span is None:
        span = lambda c: int(np.shape(c)[-1]) if np.ndim(c) else len(c)
    carry: dict | None = store.load() if store else None
    start_off = int(carry["offset"]) if carry and "offset" in carry else 0
    for off, chunk in chunks:
        if off < start_off:
            continue
        attempt = 0
        while True:
            try:
                carry = scan_chunk(chunk, carry)
                break
            except NonRetryableScanError:
                raise  # deterministic: identical retry cannot succeed
            except Exception:
                attempt += 1
                if attempt > max_retries:
                    raise
                time.sleep(retry_delay * attempt)
        carry["offset"] = np.int64(off + span(chunk))
        if store:
            store.save(carry)
    return carry if carry is not None else {}


def iter_batch_chunks(
    data: np.ndarray, chunk_len: int, offset: int = 0
) -> Iterator[tuple[int, np.ndarray]]:
    """Yield (byte_offset, (BATCH, chunk_len) slab) slices of a (BATCH, L)
    corpus — the batched analogue of ``iter_file_chunks`` (use that + a
    reshape for single on-disk files).  ``offset`` counts per-stream bytes."""
    batch, l = data.shape
    assert l % chunk_len == 0, "corpus length must be divisible by chunk_len"
    for off in range(offset, l, chunk_len):
        yield off, np.ascontiguousarray(data[:, off : off + chunk_len])


def dist_resilient_scan(
    mesh,
    tables,
    chunks: Iterable[tuple[int, np.ndarray]],
    *,
    kgram=None,
    blocks_per_shard: int = 8192,
    start: int = 0,
    max_iters: int = 16,
    overlap: int = 64,
    store: CheckpointStore | None = None,
    max_retries: int = 3,
    retry_delay: float = 1.0,
    prefetch_depth: int = 2,
) -> dict:
    """BASELINE config 5 end-to-end: chunked ingest -> distributed scan,
    with carry-across-chunks ON THE MESH, checkpointing, and retry.

    ``chunks`` yields (offset, (BATCH, chunk_len) uint8 slabs) — e.g.
    ``iter_batch_chunks`` — for a corpus far larger than device memory;
    BATCH must divide over the mesh ``data`` axis.  Host-side byte-class
    (or k-gram class) mapping runs on a prefetch thread so the upload of
    chunk k+1 overlaps the device scan of chunk k (``prefetch_chunks``);
    each chunk then runs ``dfa_scan_fast_dist`` (counting mode) — or
    ``dfa_scan_kgram_dist`` when ``kgram`` (a ``KgramTables``) is given —
    with every stream's entry state carried from the previous chunk via
    the per-stream ``start`` vector.  The carry (per-stream states +
    running totals + offset) is O(BATCH) and checkpointed through
    ``CheckpointStore`` after every chunk, so recovery replays from the
    last chunk boundary exactly (SURVEY.md SS5.3-5.4, SS7.4 item 5).

    Returns the final carry: {"states": (BATCH,), "counts": (BATCH,),
    "offset": scalar}.  Raises RuntimeError if a chunk's seam fixpoint
    does not converge (non-synchronizing automaton: fall back to the exact
    associative engine instead of trusting speculative totals).
    """
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from .dist_scan import dfa_scan_fast_dist, dfa_scan_kgram_dist
    from .mesh import DATA_AXIS, SEQ_AXIS

    # chunks land on the mesh in the scans' own (data, seq) layout, so the
    # shard_map starts without a reshard
    layout = NamedSharding(mesh, P(DATA_AXIS, SEQ_AXIS))

    if kgram is not None:
        from ..ops.kgram import map_kgram_classes

        kt = jnp.asarray(kgram.table)
        ka = jnp.asarray(kgram.acc_table)

        def prepare(slab: np.ndarray):
            # ship class ids at the narrowest exact width: build_kgram caps
            # classes at max_classes (<= 16384 in every caller), so int16
            # halves/quarters the host->device bytes; the device scan
            # upcasts to int32 (dfa_scan_kgram_dist)
            ck = np.stack([map_kgram_classes(kgram, row) for row in slab])
            return jax.device_put(ck.astype(np.int16), layout)

        def scan_chunk(classes_k, carry):
            batch = classes_k.shape[0]
            if carry is None:
                carry = {
                    "states": np.full(batch, start, np.int32),
                    "counts": np.zeros(batch, np.int64),
                }
            finals, totals, converged = dfa_scan_kgram_dist(
                mesh, kt, ka, classes_k,
                blocks_per_shard=blocks_per_shard,
                start=jnp.asarray(carry["states"]),
                max_iters=max_iters, overlap=overlap, acc_bound=kgram.k,
            )
            if not bool(converged):
                raise NonRetryableScanError(
                    "k-gram seam fixpoint did not converge; use the exact "
                    "associative engine for this automaton"
                )
            return {
                "states": np.asarray(finals),
                "counts": carry["counts"] + np.asarray(totals),
            }
    else:
        class_lut = np.asarray(tables.class_of).astype(np.uint8)

        def prepare(slab: np.ndarray):
            return jax.device_put(class_lut[slab], layout).astype(jnp.int32)

        def scan_chunk(classes, carry):
            batch = classes.shape[0]
            if carry is None:
                carry = {
                    "states": np.full(batch, start, np.int32),
                    "counts": np.zeros(batch, np.int64),
                }
            finals, counts, converged = dfa_scan_fast_dist(
                mesh, tables, classes,
                blocks_per_shard=blocks_per_shard,
                start=jnp.asarray(carry["states"]),
                max_iters=max_iters, overlap=overlap,
            )
            if not bool(converged):
                raise NonRetryableScanError(
                    "seam fixpoint did not converge; use the exact "
                    "associative engine for this automaton"
                )
            return {
                "states": np.asarray(finals),
                "counts": carry["counts"] + np.asarray(counts),
            }

    # resume filter BEFORE the prefetch pipeline: already-scanned chunks
    # must not pay class-mapping + device upload just to be discarded by
    # resilient_scan's own skip
    if store is not None:
        loaded = store.load()
        if loaded and "offset" in loaded:
            start_off = int(loaded["offset"])
            chunks = (
                (off, c) for off, c in chunks if off >= start_off
            )

    k = kgram.k if kgram is not None else 1
    return resilient_scan(
        scan_chunk,
        prefetch_chunks(chunks, prepare=prepare, depth=prefetch_depth),
        store=store,
        max_retries=max_retries,
        retry_delay=retry_delay,
        span=lambda c: int(np.shape(c)[-1]) * k,  # offsets are BYTE units
    )
