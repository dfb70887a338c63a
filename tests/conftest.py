"""Test configuration: an 8-device virtual CPU mesh.

Multi-device sharding is tested without accelerators (SURVEY.md SS4.4) by
running JAX on the host platform with 8 virtual devices.  Must be set before
jax is imported anywhere.  Tests that only the GPU can run carry the ``gpu``
marker and the ``gpu_device`` fixture, which skips them here.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

# CLI entry points turn the persistent compile cache on; tests keep every
# compile in-process so parallel workers never share cache files
jax.config.update("jax_enable_compilation_cache", False)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def reference_available():
    from regex_fpga_tpu.utils import reference_root

    if not os.path.isdir(reference_root()):
        pytest.skip("reference fixtures not available")
    return reference_root()


@pytest.fixture
def gpu_device():
    """The first GPU device; skips when JAX sees none (decided here, at
    run time, never at import)."""
    gpus = [d for d in jax.devices() if d.platform == "gpu"]
    if not gpus:
        pytest.skip("needs a GPU (run on the card: python chip_smoke.py)")
    return gpus[0]


def random_nfa(rng: np.random.Generator, n_states: int, n_edges: int, n_accept: int):
    """Random CSR NFA with reference-style accept semantics (out-degree 0)."""
    from regex_fpga_tpu.models import CsrAutomaton

    accept = rng.choice(np.arange(1, n_states), size=n_accept, replace=False)
    nonaccept = np.setdiff1d(np.arange(n_states), accept)
    src = rng.choice(nonaccept, size=n_edges)
    chars = rng.integers(0, 256, size=n_edges, dtype=np.int64)
    targets = rng.integers(0, n_states, size=n_edges, dtype=np.int64)
    order = np.argsort(src, kind="stable")
    src, chars, targets = src[order], chars[order], targets[order]
    offsets = np.searchsorted(src, np.arange(n_states + 1)).astype(np.int64)
    return CsrAutomaton(
        offsets=offsets,
        trans_char=chars.astype(np.uint8),
        trans_target=targets.astype(np.int32),
    )


def random_dfa_table(rng: np.random.Generator, n_states: int, n_accept: int):
    """Random dense DFA (256, S) table + accept mask with reference timing:
    accepting states are absorbing into a dead state (state S-1)."""
    table = rng.integers(0, n_states, size=(256, n_states), dtype=np.int64)
    accept = np.zeros(n_states, dtype=bool)
    if n_accept:
        acc = rng.choice(np.arange(1, n_states - 1), size=n_accept, replace=False)
        accept[acc] = True
        table[:, acc] = n_states - 1  # accepting -> dead
    table[:, n_states - 1] = n_states - 1  # dead self-loop
    accept[n_states - 1] = False
    return table.astype(np.int32), accept


@pytest.fixture
def rng():
    return np.random.default_rng(0)
