"""The port's checkpoint files: safetensors, read and written without the
`safetensors` package.

Counterpart of `regione_tpu/weights/checkpoint.py` (orbax pytrees): `save`
persists a converted state dict (quantized codes and scales included) and
`load` reads it back onto a device.  The format is safetensors': an 8-byte
little-endian header length, a JSON header mapping each name to its
`dtype`, `shape` and `data_offsets` (byte range after the header; the
optional "__metadata__" entry is skipped), then the raw little-endian
bytes.  `SafetensorsFile` maps a file and reads each tensor with
`torch.frombuffer` over the mapping, so a tensor costs no host copy until
it is cast or moved: `weights.convert` streams diffusers checkpoints
through it one tensor at a time, and a tensor-parallel rank reads only its
slices (`mmdit_from_checkpoint(..., mesh=)`, `convert.load_converted(...,
mesh=)`).
"""

from __future__ import annotations

import json
import mmap
import struct
from pathlib import Path

import torch

DTYPES = {"BF16": torch.bfloat16, "F16": torch.float16,
          "F32": torch.float32, "I8": torch.int8, "U8": torch.uint8,
          "I32": torch.int32}
_NAMES = {v: k for k, v in DTYPES.items()}


class SafetensorsFile:
    """One .safetensors file, memory-mapped (copy-on-write, so the tensors
    it hands out are writable and the file is never written)."""

    def __init__(self, path):
        self.path = Path(path)
        with open(self.path, "rb") as fh:
            (n,) = struct.unpack("<Q", fh.read(8))
            header = json.loads(fh.read(n))
            self._mm = mmap.mmap(fh.fileno(), 0, access=mmap.ACCESS_COPY)
        header.pop("__metadata__", None)
        self._header = header
        self._start = 8 + n

    def keys(self):
        return list(self._header)

    def get(self, name: str) -> torch.Tensor:
        """The tensor `name` as a CPU view of the mapped file."""
        info = self._header[name]
        if info["dtype"] not in DTYPES:
            raise ValueError(f"{self.path}: {name} has dtype "
                             f"{info['dtype']}, not one of {sorted(DTYPES)}")
        dtype = DTYPES[info["dtype"]]
        lo, hi = info["data_offsets"]
        shape = tuple(info["shape"])
        numel = (hi - lo) // dtype.itemsize
        if numel != torch.Size(shape).numel():
            raise ValueError(f"{self.path}: {name} holds {hi - lo} bytes, "
                             f"not a {info['dtype']} tensor of {shape}")
        if numel == 0:
            return torch.empty(shape, dtype=dtype)
        return torch.frombuffer(self._mm, dtype=dtype, count=numel,
                                offset=self._start + lo).reshape(shape)


def save(path, state: dict) -> None:
    """Write `state` ({name: tensor}, on any device) to the file `path`,
    one tensor at a time."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    header, offset = {}, 0
    for name, t in state.items():
        if t.dtype not in _NAMES:
            raise ValueError(f"{name}: dtype {t.dtype} has no safetensors "
                             f"name here ({sorted(DTYPES)})")
        n = t.numel() * t.element_size()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)       # the data starts 8-byte aligned
    with open(path, "wb") as fh:
        fh.write(struct.pack("<Q", len(raw)))
        fh.write(raw)
        for t in state.values():
            if t.numel():
                fh.write(t.detach().reshape(-1).contiguous().cpu()
                         .view(torch.uint8).numpy())


def load(path, device="cuda") -> dict:
    """{name: tensor} of the file `path`, each tensor moved to `device` as
    it is read (on the CPU: views of the mapped file)."""
    f = SafetensorsFile(path)
    return {name: f.get(name).to(device) for name in f.keys()}


def mmdit_from_checkpoint(path, cfg, device="cuda", mesh=None):
    """An `MMDiT` of `cfg` holding the state dict `save` wrote to `path`,
    quantized linears included (told by their "w_q" / "w_qp" names): the
    model is built on the meta device and takes the loaded tensors as its
    own, so nothing is allocated twice.  `mesh`: a (dp, tp) mesh
    (`parallel.sharding`): this rank's shard, each tensor cut to its
    slices before it leaves the mapped file (`model.loaded_bytes`: the
    bytes cut out)."""
    from regione_tpu_torch.models.mmdit import MMDiT
    from regione_tpu_torch.ops.quant import quantized_shells
    from regione_tpu_torch.parallel.sharding import load_shards
    model = MMDiT(cfg, torch.device("meta"))
    if mesh is not None:
        f = SafetensorsFile(path)
        views = {name: f.get(name) for name in f.keys()}
        quantized_shells(model, views)
        return load_shards(model, mesh, lambda shard: {
            n: shard(n, t).to(device) for n, t in views.items()})
    state = load(path, device)
    quantized_shells(model, state)
    model.load_state_dict(state, strict=True, assign=True)
    return model.eval()
