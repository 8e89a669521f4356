"""The port's K/V cache module (`models.kv_cache`), in each of its formats.

For the model dtype, int8 and int4 at the tiny preset: the format a config
names round-trips through `cache_format` / `with_cache_format`; K and V
rows stored into a layer read back (exactly in the model dtype, within half
a quantization step of their row's scale when quantized); `reset_cache`
leaves a cache equal to a new `init_cache`; and the bytes a cache holds are
those `utils.memplan` counts for it.
"""

import pytest
import torch

from regione_tpu_torch.models import kv_cache
from regione_tpu_torch.models.presets import get_config
from regione_tpu_torch.ops.quant import dequantize_cache
from regione_tpu_torch.utils import memplan
from torch_cpu import one_torch_thread  # noqa: F401 (autouse)

GRID = 2                   # memplan's S_kv = 2 * GRID^2 image rows
BATCH_CFG = 2


@pytest.mark.parametrize("fmt", kv_cache.CACHE_FORMATS)
def test_each_format_stores_reads_resets_and_counts(fmt):
    base = get_config("tiny")
    cfg = kv_cache.with_cache_format(base, fmt)
    assert kv_cache.cache_format(cfg) == fmt
    assert kv_cache.with_cache_format(cfg, kv_cache.cache_format(cfg)) == cfg
    assert kv_cache.cache_format(base) == "bf16"
    with pytest.raises(ValueError, match="cache format"):
        kv_cache.with_cache_format(base, "fp8")

    s = 2 * GRID * GRID
    cache = kv_cache.init_cache(cfg, BATCH_CFG, s, "cpu")
    assert kv_cache.image_rows(cache) == s
    gen = torch.Generator().manual_seed(0)
    written = {}
    for key in cache:
        if key.endswith(kv_cache.SCALE_SUFFIX):
            continue
        x = torch.randn((BATCH_CFG, cfg.heads, s, cfg.head_dim),
                        generator=gen).to(cfg.dtype)
        kv_cache.store_kv(cfg, cache, key, 1, x)
        written[key] = x
    for k_key, v_key in (("dk", "dv"), ("sk", "sv")):
        k, v, scales = kv_cache.attention_args(
            kv_cache.layer_kv(cache, k_key, 1),
            kv_cache.layer_kv(cache, v_key, 1))
        for rows, key, scale in ((k, k_key, scales.get("k_scale")),
                                 (v, v_key, scales.get("v_scale"))):
            want = written[key]
            if fmt == "bf16":
                assert scales == {} and torch.equal(rows, want)
                continue
            assert rows.dtype == torch.int8
            assert rows.shape[2] == (s // 2 if fmt == "int4" else s)
            got = dequantize_cache(rows, scale, torch.float32)
            assert ((got - want.float()).abs()
                    <= 0.5 * scale[..., None] * (1 + 1e-5)).all()
        layer0 = kv_cache.attention_args(kv_cache.layer_kv(cache, k_key, 0),
                                         kv_cache.layer_kv(cache, v_key, 0))
        assert not layer0[0].any()            # only layer 1 was written

    fresh = kv_cache.init_cache(cfg, BATCH_CFG, s, "cpu")
    assert kv_cache.reset_cache(cache) is cache
    assert cache.keys() == fresh.keys()
    assert all(torch.equal(cache[key], fresh[key]) for key in cache)

    plan = memplan.plan(cfg, grid=GRID, t_txt=4, batch_cfg=BATCH_CFG,
                        cache=fmt)
    assert sum(x.numel() * x.element_size()
               for x in cache.values()) == plan.cache_bytes
    assert kv_cache.cache_bytes(cfg, BATCH_CFG, s) == plan.cache_bytes
