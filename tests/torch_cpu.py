"""Fixtures shared by the port's CPU tests (`tests/test_torch_*.py`).

A test module imports `one_torch_thread` to run each of its tests with one
intra-op torch thread.  The tests' shapes are tiny and the test files run
in parallel processes: a full thread pool in every process oversubscribes
the cores, and each small op then waits on its pool far longer than it
computes (about twice the wall time of these files with 6 processes on 8
cores).  A test that holds a Qwen edit to the JAX package's uses
`jax_schedule` (below).
"""

import pytest
import torch


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# The JAX package runs FLUX.1's flow-match schedule for every backend (its
# `calculate_shift` defaults, 256 -> 4096 tokens and 0.5 -> 1.15, with no
# terminal stretch); the port's Qwen pipelines run Qwen-Image's published
# one (`schedule.QWEN_IMAGE_SHIFT`), whose other sigmas give another stage
# plan.  A test that holds a Qwen edit of the port to the JAX package's
# gives the port's pipelines JAX's schedule with `jax_schedule`, so that
# both run one plan: in the test's process, and in the rank processes that
# `bench.common.spawn_ranks` starts (the code each runs is prefixed with
# `JAX_SCHEDULE`).
JAX_SCHEDULE = ("from regione_tpu_torch.core.schedule import FLUX_SHIFT; "
                "from regione_tpu_torch.pipelines.qwen_image_edit import "
                "QwenImageEditPipeline; "
                "QwenImageEditPipeline.flow_shift = FLUX_SHIFT; ")


@pytest.fixture
def jax_schedule(monkeypatch):
    from regione_tpu_torch.bench import common
    from regione_tpu_torch.core.schedule import FLUX_SHIFT
    from regione_tpu_torch.pipelines.qwen_image_edit import (
        QwenImageEditPipeline)
    monkeypatch.setattr(QwenImageEditPipeline, "flow_shift", FLUX_SHIFT)
    spawn = common.spawn_ranks
    monkeypatch.setattr(common, "spawn_ranks", lambda code, *args, **kw:
                        spawn(JAX_SCHEDULE + code, *args, **kw))
