"""The port's `utils.telemetry` and `utils.memplan`.

  * `StageTimer` accumulates named segments; `log_stats` appends one JSON
    line per record, tensors and dataclasses included; `trace` writes a
    Chrome trace;
  * `memplan.plan` counts the same parameter, KV-cache and activation
    bytes as the JAX package's `memplan.plan` at tp 1 (its `jax.eval_shape`
    allocates nothing; the port's `meta` tensors neither) for `tiny`,
    `step1x-edit` and `qwen-image-edit`, each cache format; a group of B
    requests holds B cache sets; what is not ported yet raises.
"""

import dataclasses
import json
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from regione_tpu.utils import memplan as jmemplan
from regione_tpu_torch.core.sampler import SampleStats
from regione_tpu_torch.utils import memplan, telemetry

JAX_CACHE = {"bf16": dict(cache_dtype=None),
             "int8": dict(cache_dtype=jnp.int8, cache_bits=8),
             "int4": dict(cache_dtype=jnp.int8, cache_bits=4)}


def test_stage_timer_accumulates_named_segments():
    timer = telemetry.StageTimer()
    for _ in range(2):
        with timer.stage("a", sync_on=torch.zeros(2)):
            time.sleep(0.01)
    with timer.stage("b", sync_on={"x": torch.ones(1)}):
        pass
    seg = timer.as_dict()
    assert set(seg) == {"a", "b"} and seg["a"] >= 0.02 and seg["b"] >= 0
    seg["a"] = 0.0
    assert timer.as_dict()["a"] >= 0.02       # a copy


def test_log_stats_appends_json_lines(tmp_path):
    path = tmp_path / "sub" / "stats.jsonl"
    st = SampleStats(edited_tokens=7, capacity=8, seq_len=64, reuse_steps=9,
                     dense_steps=9, rags_steps=19)
    telemetry.log_stats(path, {"stats": st, "count": torch.tensor(3),
                               "lat": torch.ones(2), "f": np.float32(0.5),
                               "shape": (1, 2), "dev": torch.device("cpu")})
    telemetry.log_stats(path, {"n": 1})
    lines = [json.loads(x) for x in path.read_text().splitlines()]
    assert len(lines) == 2 and lines[1]["n"] == 1
    rec = lines[0]
    assert rec["stats"] == dataclasses.asdict(st)
    assert rec["count"] == 3 and rec["lat"] == [1.0, 1.0]
    assert rec["f"] == 0.5 and rec["shape"] == [1, 2]
    assert rec["dev"] == "cpu" and rec["ts"] > 0


def test_trace_writes_a_chrome_trace(tmp_path):
    with telemetry.trace(str(tmp_path / "prof")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    events = json.loads((tmp_path / "prof" / "trace.json").read_text())
    assert any("mm" in ev.get("name", "") for ev in events["traceEvents"])


@pytest.mark.parametrize("cache", ["bf16", "int8", "int4"])
@pytest.mark.parametrize("preset", ["tiny", "step1x-edit", "qwen-image-edit"])
def test_plan_counts_the_jax_bytes(preset, cache):
    want = jmemplan.plan(preset, grid=16, t_txt=32, **JAX_CACHE[cache])
    got = memplan.plan(preset, grid=16, t_txt=32, cache=cache)
    assert got.param_bytes == want.param_bytes_per_device
    assert got.params_total == want.params_total
    assert got.cache_bytes == want.cache_bytes_per_device
    assert got.activation_bytes_est == want.activation_bytes_est
    assert got.total_bytes == want.total_bytes_per_device


def test_plan_of_a_group_holds_one_cache_set_per_image():
    one = memplan.plan("step1x-edit", grid=32, t_txt=128)
    three = memplan.plan("step1x-edit", grid=32, t_txt=128, batch=3)
    assert three.param_bytes == one.param_bytes
    assert three.cache_bytes == 3 * one.cache_bytes
    # the cache of `init_cache` for 3 requests x 2 CFG rows over 2048 rows
    assert three.cache_bytes == 57 * 2 * 6 * 24 * 2048 * 128 * 2
    assert three.activation_bytes_est == 3 * one.activation_bytes_est
    assert one.fits("h100") and memplan.HBM_BYTES["h100"] == 80 * 1024**3
    d = three.as_dict()
    assert d["total_bytes_gib"] == round(three.total_bytes / 1024**3, 3)


def test_plan_refuses_what_is_not_ported():
    with pytest.raises(NotImplementedError, match="sharding"):
        memplan.plan("tiny", tp=2)
    with pytest.raises(NotImplementedError, match="quantized weights"):
        memplan.plan("tiny", int8=True)
    with pytest.raises(ValueError, match="cache format"):
        memplan.plan("tiny", cache="fp8")


def test_memplan_cli_prints_the_plan(capsys):
    memplan.main(["--preset", "tiny", "--grid", "8", "--t-txt", "4",
                  "--batch", "2", "--cache", "int4"])
    out = json.loads(capsys.readouterr().out)
    assert out["batch"] == 2 and out["cache"] == "int4"
    assert out["fits_h100"] is True
