"""The plain references of the benchmark's configurations, one module each,
found by name.

A configuration file may name its module under the key "reference"; where
it names none, the module is `sampler` (the FLUX.1 Kontext and
Step1X-Edit edit).  A module gives

  * `Reference(config, weights, grid, device, lower=None)`, with
    `x0_estimate(lat0, req)`, `edit(lat0, req)` returning (latents,
    info: `mask`, `cos` and the plan statistics) and `knobs.threshold`;
  * optionally `layout(config)`: the weight layout (as `inputs.layout`
    gives it) that the seed's weights are drawn in; without it,
    `inputs.layout`;
  * optionally `forward_items(config, rows, s_kv, batch, rags)`: the
    work items of one forward (see `perfbench/work.py`), for a block
    whose operations `work.forward_items` does not count; without it,
    `work.forward_items`.  Its "op" items name groups of
    `kernel_groups/*.json`, and a test pins its block's products to the
    published widths.

A module that needs `inputs` imports it; this package imports nothing
below it until `load` is called, so the import graph has no cycle.  Like
every module here, a reference imports nothing of the program and nothing
of JAX.
"""

from __future__ import annotations

import importlib

DEFAULT = "sampler"


def load(config: dict):
    """The reference module that `config` names; a name with no file here
    stops the run before anything is drawn."""
    name = config.get("reference", DEFAULT)
    full = f"{__name__}.{name}"
    try:
        return importlib.import_module(full)
    except ModuleNotFoundError as e:
        if e.name != full:
            raise
        raise SystemExit(
            f"configuration {config.get('name')!r} names the reference "
            f"{name!r}, and there is no file perfbench/reference/{name}.py"
        ) from None
