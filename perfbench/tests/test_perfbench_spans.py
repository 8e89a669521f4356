"""The readers of the program's own spans and counters
(`regione_tpu_torch.utils.telemetry`): `pipeline.dense_host_ms`,
`pipeline.rags_host_ms`, `kernels.wrapper_host_us`.

  * each returns None on an empty recorder, with no edits, and where the
    recorder holds another number of `pipeline.edit` spans than the run
    has edits;
  * each reads its number off a recorder filled by hand.

    python -m pytest perfbench/tests -q
"""

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from perfbench import harness  # noqa: E402
from regione_tpu_torch.utils import telemetry  # noqa: E402

PB = ROOT / "perfbench"
READERS = ("pipeline.dense_host_ms", "pipeline.rags_host_ms",
           "kernels.wrapper_host_us")


@pytest.fixture(autouse=True)
def empty_recorder():
    telemetry.clear()
    yield
    telemetry.clear()


def _read(name, n_edits):
    conf = json.loads((PB / "configs" / "flux-kontext.json").read_text())
    run = harness.RunRecord(config=conf, mix={}, grid=64,
                            edits=[{"request": i} for i in range(n_edits)],
                            window_s=1.0, setup_s=1.0, peak_window_bytes=0,
                            spans=[], trace=None, groups=[])
    return harness.load_reader(PB / "metrics" / f"{name}.py")(run)


def _fill(edits):
    """One `pipeline.edit` span per entry of `edits`, each (launches,
    host_ns, [(forward kind, host ms)]), the host times set by hand."""
    with telemetry.recording():
        for launches, host_ns, forwards in edits:
            with telemetry.span("pipeline.edit", edit=True) as e:
                for kind, ms in forwards:
                    with telemetry.span(f"pipeline.{kind}_forward") as f:
                        with telemetry.span("model.double_block", index=0):
                            pass
                    f.t1_ns = f.t0_ns + int(ms * 1e6)
            e.attrs.update(launches=launches, host_ns=host_ns)


@pytest.mark.parametrize("name", READERS)
def test_reader_finds_nothing_and_returns_none(name):
    assert _read(name, 2) is None                  # an empty recorder
    _fill([(10, 5000, [("dense", 1.0), ("rags", 2.0)])])
    assert _read(name, 0) is None                  # no edits
    assert _read(name, 2) is None                  # 1 edit span, 2 edits
    assert _read(name, 1) is not None


def test_readers_on_a_recorder_filled_by_hand():
    _fill([(100, 3_000_000, [("dense", 30.0)] * 3 + [("rags", 8.0)] * 2),
           (300, 9_000_000, [("dense", 36.0)] + [("rags", 11.0)] * 2)])
    got = {name: _read(name, 2) for name in READERS}
    assert got["pipeline.dense_host_ms"] == pytest.approx(
        (3 * 30.0 + 36.0) / 4, abs=1e-6)
    assert got["pipeline.rags_host_ms"] == pytest.approx(
        (2 * 8.0 + 2 * 11.0) / 4, abs=1e-6)
    assert got["kernels.wrapper_host_us"] == pytest.approx(
        12_000_000 / 400 / 1e3)


def test_edits_without_launches_give_no_wrapper_time():
    _fill([(0, 0, [("dense", 1.0)])])
    assert _read("kernels.wrapper_host_us", 1) is None
    assert _read("pipeline.rags_host_ms", 1) is None
    assert _read("pipeline.dense_host_ms", 1) == pytest.approx(1.0, abs=1e-6)
