"""FLUX.2 [dev] in the benchmark, on the CPU: its configuration's count
(`reference/flux2.py`'s `forward_items`), its kernel group and
`kernels.swiglu_roofline`, and its tiny cell end to end.

  * a dense 1024^2 forward at the published widths counts 4.7839e14
    block-GEMM FLOPs (13 hidden^2 products a block and token) and 1.043e14
    attention FLOPs, the modulation once a forward;
  * each SwiGLU gate is an op of the `swiglu` group whose bytes are K11's
    reads and writes at its two blocks' shapes, and every item of the
    count belongs to a kernel group of `kernel_groups/`;
  * `kernels.swiglu_roofline` reads None with nothing to read and the
    share of the gates' least time in the group's device time otherwise;
  * the tiny cell (the `tiny-flux2` widths) is correct against the
    reference through `harness.run_once`, and its control is not.

    python -m pytest perfbench/tests -q
"""

import json
import sys
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from perfbench import devtrace, harness, work  # noqa: E402
from perfbench.reference import flux2  # noqa: E402

PB = ROOT / "perfbench"
DATA = Path(__file__).resolve().parent / "data"
CONF = "tiny-flux2-dev"
CELL = f"{CONF}.tiny-local"
SEED = 2**31 + 26
FLUX2 = json.loads((PB / "configs" / "flux2-dev.json").read_text())


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _block_gemm_flops(conf, items, batch):
    """FLOPs of the linears over token rows inside the blocks: not the
    embedders (their K) and not the output projection (its N)."""
    m = conf["model"]
    return sum(work.gemm_work(*it[1:])[0] for it in items
               if it[0] == "gemm" and it[1] > batch
               and it[3] not in (m["in_channels"], m["txt_in_dim"])
               and it[2] != m["out_channels"])


def test_a_dense_forward_at_the_published_widths():
    h, rows, tokens, blocks = 6144, 8192, 8704, 56
    dense = flux2.forward_items(FLUX2, rows, rows, 1, False)
    assert _block_gemm_flops(FLUX2, dense, 1) == \
        2 * 13 * h * h * blocks * tokens
    assert _block_gemm_flops(FLUX2, dense, 1) == pytest.approx(4.7839e14,
                                                               rel=1e-4)
    assert work.totals(dense, "attn")[0] == pytest.approx(1.043e14,
                                                          rel=1e-3)
    # modulation once a forward: three shared linears over the batch row
    mods = [it for it in dense if it[0] == "gemm" and it[1] == 1
            and it[3] == h and it[2] in (6 * h, 3 * h)]
    assert sorted(it[2] for it in mods) == [3 * h, 6 * h, 6 * h]


def test_the_gate_bytes_are_k11s_reads_and_writes():
    m = FLUX2["model"]
    inner, mlp, t = m["heads"] * m["head_dim"], 3 * m["hidden"], 512
    rows = 8192
    items = flux2.forward_items(FLUX2, rows, rows, 1, False)
    ops = [it for it in items if it[0] == "op"]
    assert {it[1] for it in ops} == {"swiglu"}

    def k11(n, attn):
        """bf16 bytes of K11 over n rows: h [n, 2 mlp] and attn [n, inner]
        read, [n, (inner) + mlp] written."""
        return 2 * n * (2 * mlp + mlp + (2 * inner if attn else 0))
    want = ([k11(rows, False), k11(t, False)] * m["depth_double"]
            + [k11(t + rows, True)] * m["depth_single"])
    assert [it[2] for it in ops] == want
    assert work.totals(items, "swiglu") == (
        0.0, pytest.approx(sum(want) / work.HBM_BYTES_PER_S))


def test_every_item_has_a_kernel_group():
    known = {g for g, _ in devtrace.load_groups(PB / "kernel_groups")}
    stats = {"edited_tokens": 1100, "capacity": 1152, "dense_steps": 9,
             "rags_steps": 19, "reuse_steps": 13}
    items = work.edit_items(FLUX2, 64, stats)
    assert {work.group(it) for it in items} == {"gemm", "attention",
                                                "swiglu"} <= known
    groups = devtrace.load_groups(PB / "kernel_groups")
    name = "void (anonymous namespace)::fused_swiglu_pack_kernel(SwigluArgs)"
    assert devtrace.group_of(name, groups) == "swiglu"


def _record(trace=None, stats=None):
    edits = [] if stats is None else [{"request": 0, "stats": stats,
                                       "wall_s": 9.0}]
    return harness.RunRecord(config=FLUX2, mix={}, grid=64, edits=edits,
                             window_s=9.0, setup_s=1.0, peak_window_bytes=0,
                             spans=[], trace=trace, groups=[])


def test_swiglu_roofline_reads():
    read = harness.load_reader(PB / "metrics" / "kernels.swiglu_roofline.py")
    stats = {"edited_tokens": 1100, "capacity": 1152, "dense_steps": 9,
             "rags_steps": 19, "reuse_steps": 13}
    assert read(_record()) is None
    assert read(_record({"by_group": {"gemm": 1.0}}, stats)) is None
    got = read(_record({"by_group": {"swiglu": 0.25}}, stats))
    least = work.totals(work.edit_items(FLUX2, 64, stats), "swiglu")[1]
    assert got == pytest.approx(100 * least / 0.25)


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    """The tests' benchmark with the tiny FLUX.2 configuration and cell
    added (the file under data/ is left as it is)."""
    bench = json.loads((DATA / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": CONF, "source": "tiny",
                             "file": f"configs/{CONF}.json", "reduced": [],
                             "why": "CPU tests"})
    bench["workloads"].append({"name": CELL, "config": CONF,
                               "traffic": "tiny-local", "chips": 1,
                               "why": "CPU tests"})
    path = tmp_path_factory.mktemp("bench") / "BENCHMARK.json"
    path.write_text(json.dumps(bench))
    return harness.Paths(bench=path, root=DATA, mixes=DATA / "mixes",
                         limits=DATA / "limits")


def test_the_tiny_cell_is_correct_and_its_control_is_not(paths):
    run = [harness.run_once(CELL, SEED, 0.0, False, time.perf_counter(),
                            paths=paths, device="cpu", system=s)
           for s in ("program", "control")]
    assert run[0]["correct"] and run[0]["attempted"] >= 2
    assert run[0]["checks"]["plan_diff"] == [0.0, 0]
    assert run[0]["checks"]["latent_err"][0] < 1e-6
    assert not run[1]["correct"]
