"""chip_smoke.py at tiny sizes on the CPU: the device gate refuses the CPU,
and every phase agrees with its reference on the virtual devices."""

import importlib.util
import json
import os

import jax
import pytest

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(_ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _agree(records):
    assert records
    for r in records:
        assert r["agree"], r
    return records


def test_main_refuses_cpu(smoke, capsys):
    with pytest.raises(SystemExit) as exc:
        smoke.main([])
    assert exc.value.code not in (0, None)
    out = capsys.readouterr().out
    assert '"ok": true' not in out
    for line in out.splitlines():
        assert not json.loads(line).get("ok")


def test_phase_tokenizer_tiny(smoke):
    recs = _agree(smoke.phase_tokenizer(0, nbytes=96 * 1024,
                                        ends_bytes=32 * 1024))
    assert [r["engine"] for r in recs][:2] == ["kgram-count", "dfa-fast"]


def test_phase_dense_tiny(smoke):
    recs = _agree(smoke.phase_dense(0, total=192 * 1024, flows=8,
                                    sizes=(24, 64)))
    assert recs[0]["engine"] == "dfa-fast-batch-ragged"
    assert recs[0]["matches"] > 0


def test_phase_snort_tiny(smoke):
    recs = _agree(smoke.phase_snort(0, n_payloads=40))
    assert recs[0]["recall"] == "4/4"


def test_phase_nfa_tiny(smoke):
    recs = _agree(smoke.phase_nfa(0, flows=2, flow_bytes=8192,
                                  prefix=2048))
    assert recs[0]["engine"] == "nfa-lazy-device"
    assert recs[0]["S"] > 1000


def test_phase_spans_tiny(smoke):
    recs = _agree(smoke.phase_spans(0, nbytes=64 * 1024))
    assert recs[0]["matches"] > 0


def test_phase_numbers_tiny(smoke, monkeypatch):
    from regex_fpga_tpu.ops import router

    monkeypatch.setattr(router, "PROBE_HOST_BYTES", 1 << 16)
    monkeypatch.setattr(router, "PROBE_DEVICE_BYTES", 1 << 16)
    monkeypatch.setattr(router, "PROBE_DEVICE_BLOCKS", 64)
    recs = smoke.phase_numbers(0, nbytes=64 * 1024, nb=64)
    routes = {(r["table"], r["route"]) for r in recs}
    assert ("tokenizer", "f32") in routes and ("ac300", "router-probes") in routes
    assert ("ac150", "other_orientation") in routes
    # every route is exact, so every route reproduces the rule's counts
    assert all(r["same_counts"] for r in recs if "same_counts" in r)


def test_phase_multi_four_virtual_devices(smoke):
    _agree(smoke.phase_multi(jax.devices()[:4], 0, stream_bytes=128 * 1024,
                             nfa_bytes=1024))


@pytest.mark.gpu
def test_chip_smoke_on_gpu(smoke, gpu_device):
    """The whole one-card run; only the card can run it."""
    assert smoke.main([]) == 0
