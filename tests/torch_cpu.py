"""Fixtures shared by the port's CPU tests (`tests/test_torch_*.py`).

A test module imports `one_torch_thread` to run each of its tests with one
intra-op torch thread.  The tests' shapes are tiny and the test files run
in parallel processes: a full thread pool in every process oversubscribes
the cores, and each small op then waits on its pool far longer than it
computes (about twice the wall time of these files with 6 processes on 8
cores).  A test that holds a Qwen edit to the JAX package's uses
`jax_schedule` (below).  A test that rehearses the kernel wrappers' kernel
path over CPU tensors uses `fake_lib` (below).
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


class FakeLib:
    """Stands in for the kernels' library (`ops._build.load`): records each
    call of a C entry as (entry, args) and returns 0 (success), leaving
    the outputs as allocated."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if not name.startswith("regione_"):
            raise AttributeError(name)
        return lambda *args: self.calls.append((name, args)) or 0


@pytest.fixture
def fake_lib(monkeypatch):
    """The wrappers' kernel path over CPU tensors, faked at the one launch
    seam (`ops.launch`): `on_card` says launch, the library is a `FakeLib`
    (returned), and the current stream's handle reads as 0."""
    from regione_tpu_torch.ops import _build, launch
    lib = FakeLib()
    monkeypatch.setattr(_build, "load", lambda: lib)
    monkeypatch.setattr(launch, "on_card", lambda x, what: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: None)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda index: 0, raising=False)
    return lib
