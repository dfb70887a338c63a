"""Exact collective-traffic accounting for the distributed scan engines.

The ≥85% scaling-efficiency target (SURVEY.md §5.8 / BASELINE config 5) is
grounded ANALYTICALLY here: every byte the distributed scans move per
collective is exact from shapes (the shard_map bodies in
``parallel/dist_scan.py`` contain NO other communication — module header
there), and projecting link time against a per-device compute rate yields
a "≥85% at N devices for shards ≥ X bytes" statement.

Collective inventory of ``dfa_scan_fast_dist`` (``dist_scan.py:125-179``),
per DEVICE per scan, with ``b_loc = batch / n_data`` streams per data
shard and 4-byte int32 elements:

===========================  ===========================================
collective                   payload bytes (per device)
===========================  ===========================================
seam-tail ppermute (1x)      ``b_loc * overlap * 4`` (speculation seed)
finals ppermute (per iter)   ``b_loc * 4``
convergence psum (per iter)  ``4`` per hop, latency-bound
counts psum over seq (1x)    ring allreduce ``2 * (n-1)/n * b_loc * 4``
finals all_gather (1x)       ring ``(n-1) * b_loc * 4`` received
===========================  ===========================================

``dfa_scan_kgram_dist`` is identical in structure with k-gram STEPS as
the unit (overlap counts steps; each step covers k bytes).

The link constant is the H100's NVLink figure from NVIDIA's data sheet;
the compute rate is the caller's (``comm_model_report`` takes it as an
argument — no device rate is built in).  Latency per collective phase
dominates at these payloads (hundreds of bytes), which is exactly why the
seam design scales: traffic per scanned byte is ``O(1/l_shard)``.
"""

from __future__ import annotations

__all__ = [
    "NVLINK_BPS",
    "COLLECTIVE_LATENCY_S",
    "fast_dist_comm_bytes",
    "project_efficiency",
    "min_shard_bytes_for_efficiency",
    "comm_model_report",
]

#: H100 SXM NVLink: 900 GB/s per card to its peers, 450 GB/s each way
#: (NVIDIA H100 data sheet); the cards of one host are joined all to all
NVLINK_BPS = 450e9
#: per-collective-phase launch+hop latency budget.  5 us per phase is a
#: conservative envelope covering XLA/NCCL launch overhead and ring hops
#: at small n; not measured on the GPU yet (ROADMAP S8).
COLLECTIVE_LATENCY_S = 5e-6


def fast_dist_comm_bytes(
    batch: int,
    shard_bytes: int,
    n_data: int,
    n_seq: int,
    overlap: int = 64,
    iters: int = 2,
    elem_bytes: int = 4,
) -> dict:
    """Exact per-device collective traffic of one ``dfa_scan_fast_dist``
    call (see module table).  ``shard_bytes`` is the per-device share of
    the stream(s): ``batch/n_data * L/n_seq`` elements.  ``iters`` is the
    Jacobi seam-fixpoint iteration count (1 when the automaton
    synchronizes within a block — the measured common case — plus one
    verification pass)."""
    b_loc = max(batch // max(n_data, 1), 1)
    seed = b_loc * overlap * elem_bytes
    per_iter = b_loc * elem_bytes + 2 * elem_bytes  # finals ppermute + psum
    counts = (2 * (n_seq - 1) / max(n_seq, 1)) * b_loc * elem_bytes
    gather = (n_seq - 1) * b_loc * elem_bytes
    total = seed + iters * per_iter + counts + gather
    phases = 1 + 2 * iters + 2
    return {
        "per_device_bytes": {
            "seam_tail_ppermute": seed,
            "finals_ppermute_x_iters": iters * b_loc * elem_bytes,
            "convergence_psum_x_iters": iters * 2 * elem_bytes,
            "counts_psum": round(counts, 1),
            "finals_all_gather": gather,
            "total": round(total, 1),
        },
        "collective_phases": phases,
        "bytes_per_scanned_byte": total / max(shard_bytes, 1),
        "shard_bytes": shard_bytes,
    }


def project_efficiency(
    comm: dict,
    compute_bps: float,
    link_bps: float = NVLINK_BPS,
    latency_s: float = COLLECTIVE_LATENCY_S,
) -> dict:
    """Scaling efficiency = T_compute / (T_compute + T_comm) with
    T_comm = phases * latency + bytes / link_bw (collectives here are
    NOT overlapped with compute — worst case; XLA typically hides the
    per-iteration ppermute behind the next chain pass)."""
    t_compute = comm["shard_bytes"] / compute_bps
    t_comm = (comm["collective_phases"] * latency_s
              + comm["per_device_bytes"]["total"] / link_bps)
    return {
        "t_compute_s": t_compute,
        "t_comm_s": t_comm,
        "efficiency": t_compute / (t_compute + t_comm),
        "compute_bps": compute_bps,
        "link_bps": link_bps,
        "latency_s": latency_s,
    }


def min_shard_bytes_for_efficiency(
    target: float,
    batch: int,
    n_data: int,
    n_seq: int,
    compute_bps: float,
    overlap: int = 64,
    iters: int = 2,
    link_bps: float = NVLINK_BPS,
    latency_s: float = COLLECTIVE_LATENCY_S,
) -> int:
    """Smallest per-device shard for which projected efficiency >= target.
    T_comm is (nearly) shard-size independent, so this is direct: require
    T_compute >= T_comm * target / (1 - target)."""
    comm = fast_dist_comm_bytes(batch, 1, n_data, n_seq, overlap, iters)
    t_comm = (comm["collective_phases"] * latency_s
              + comm["per_device_bytes"]["total"] / link_bps)
    t_compute_needed = t_comm * target / (1.0 - target)
    return int(t_compute_needed * compute_bps) + 1


def comm_model_report(compute_bps: float) -> dict:
    """Projected link-vs-compute efficiency of representative shapes at
    4/8/64 devices, plus the minimum shard for the ≥85% (and 99%)
    targets, at a per-device compute rate ``compute_bps`` supplied by the
    caller (a rate measured on the card, e.g. ``chip_smoke.py``'s k-gram
    phase)."""
    out: dict = {
        "assumptions": {
            "link_bps": NVLINK_BPS,
            "collective_latency_s": COLLECTIVE_LATENCY_S,
            "compute_bps": compute_bps,
            "iters": 2,
            "overlap": 64,
            "note": "per-collective bytes are EXACT from shapes "
                    "(dist_scan.py shard_map bodies contain no other "
                    "communication); link bandwidth is the H100 NVLink "
                    "data-sheet figure; collectives counted as "
                    "unoverlapped (worst case)",
        },
        "configs": [],
    }
    batch = 8
    for n_dev, shard in [(4, 1 << 26), (4, 1 << 22), (8, 1 << 26),
                         (64, 1 << 26), (64, 1 << 22)]:
        n_data, n_seq = (2, n_dev // 2) if n_dev > 1 else (1, 1)
        comm = fast_dist_comm_bytes(batch, shard, n_data, n_seq)
        out["configs"].append({
            "devices": n_dev,
            "mesh": f"{n_data}x{n_seq}",
            "shard_bytes_per_device": shard,
            "comm": comm,
            "efficiency": round(
                project_efficiency(comm, compute_bps)["efficiency"], 5
            ),
        })
    for target in (0.85, 0.99):
        out[f"min_shard_bytes_eff_{int(target * 100)}"] = (
            min_shard_bytes_for_efficiency(target, batch, 2, 2, compute_bps)
        )
    out["statement"] = (
        "projected >=85% weak-scaling efficiency on a 2x2 mesh for "
        f"per-device shards >= {out['min_shard_bytes_eff_85']} bytes at "
        f"{compute_bps:.3g} B/s per device — the seam design moves O(1) "
        "collective phases and O(overlap + batch + n_seq) ints per "
        "device per scan, independent of shard length"
    )
    return out
