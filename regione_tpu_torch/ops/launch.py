"""The one seam between the kernel wrappers and the hand-written CUDA kernels.

Every wrapper (K1/K2/K2q/K5/K6 in `ops.flash_attention`, K3 in
`ops.partition_kernel`, K7-K9 in `ops.fused`, K10, the K/V cache's
quantizer, in `ops.quant.store_quantized`) dispatches on its tensor's
device with `on_card` (CPU: its plain `*_reference` version; CUDA: its
kernel; any other device raises), checks its tensors against the kernels'
limits with `check` (bf16 unless stated, `HEAD_DIM`, a dense last dim,
16-byte aligned rows) and calls its C entry through `launch`: the one place
the wrappers' counters (`telemetry.register_counters`) are lapped and
counted.
"""

from __future__ import annotations

import torch

from regione_tpu_torch.ops import _build
from regione_tpu_torch.utils import telemetry

HEAD_DIM = 128
ROW_ALIGN = 16          # bytes: the kernels' vector loads of a row


def on_card(x, what: str) -> bool:
    """True for a CUDA tensor (launch), False for a CPU one (plain
    version); any other device raises."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"no {what} kernel for device {x.device}")
    return True


def lead_strides(x, n: int) -> list[int]:
    """The first n element strides; a size-1 dim is never stepped over, so
    its stride (which torch leaves arbitrary) is taken as 0."""
    return [0 if x.shape[i] == 1 else x.stride(i) for i in range(n)]


def ptr(x):
    """A tensor's device address, None for an absent one."""
    return None if x is None else x.data_ptr()


def check(name, x, device, shape, dtype=torch.bfloat16) -> list[int]:
    """x on `device`, of `dtype` and `shape` (None: any size), with a dense
    last dim and 16-byte aligned rows.  Returns the element strides of the
    leading dims, 0 for a size-1 dim.  Written for a low host cost: the
    wrappers run a few hundred times a step."""
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, not {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name}: the kernel takes {dtype}, got {x.dtype}")
    size, stride = x.shape, x.stride()
    fits = len(size) == len(shape)
    if fits:
        for got, want in zip(size, shape):
            if want is not None and got != want:
                fits = False
    if not fits:
        raise ValueError(f"{name}: shape {tuple(size)} is not "
                         f"{list(shape)}")
    if stride[-1] != 1:
        raise ValueError(f"{name}: the last dim must be dense")
    step = ROW_ALIGN // x.element_size()
    misaligned = x.data_ptr() % ROW_ALIGN or size[-1] % step
    lead = []
    for n, st in zip(size[:-1], stride[:-1]):
        lead.append(0 if n == 1 else st)
        misaligned = misaligned or st % step
    if misaligned:
        raise ValueError(f"{name}: rows must be {ROW_ALIGN}-byte aligned "
                         f"(shape {tuple(size)}, strides {stride})")
    return lead


def launch(counter, t0: int, entry: str, device, *args) -> None:
    """Call the C entry `entry` with `args` and the raw handle of `device`'s
    current stream (read as PyTorch's own kernel launchers read it: a
    `torch.cuda.Stream` object each call costs host time that RAGS steps,
    host-bound, cannot spare); raise on a non-zero return.  Laps
    `counter.host_ns` from `t0` (`telemetry.clock()` at the wrapper's entry)
    to the call and `.launch_ns` over it, and counts one launch."""
    t = telemetry.lap(counter, t0)
    fn = getattr(_build.load(), entry)
    index = device.index
    if index == torch.cuda.current_device():
        code = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(device):
            code = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    telemetry.lap(counter, t, "launch_ns")
    if code != 0:
        raise RuntimeError(f"{entry}: CUDA launch failed with error {code}")
    counter.launches += 1
