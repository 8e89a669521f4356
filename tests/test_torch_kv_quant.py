"""K10, the K/V cache's quantizer: `ops.quant.store_quantized`, which writes
a layer's K or V rows into an int8 or int4 cache in place.

On the CPU the wrapper takes its plain version, `quantize_kv_heads{,4}`
followed by `copy_`: its codes and scales equal those, bit for bit, in
layer i of a stacked cache, from the strided view `x[:, :, t_len:]` of a
joint buffer, at B 1 and 2 and H 2 and 6, with rows of zeros and rows whose
values fall on .5 ties of x / scale.  The kernel path is rehearsed at the
launch seam (`fake_lib`): the arguments it hands the C entry, an empty
batch that launches nothing, and the arguments it refuses before any
launch.  The `cuda`-marked tests hold K10 bit-equal (`torch.equal`) to the
eager quantizer on the same CUDA tensor at Qwen's write, a FLUX single
block's, a tensor-parallel rank's and ragged shapes.
"""

import re

import pytest
import torch

from regione_tpu_torch.models import kv_cache
from regione_tpu_torch.ops import _build, quant
from torch_cpu import fake_lib  # noqa: F401 (fixture)
from torch_cpu import one_torch_thread  # noqa: F401 (autouse)

HEAD_DIM = 128
QMAX = {8: 127, 4: 7}
ENTRY = "regione_kv_quant_store_fwd"


def image_rows(b, h, t_len, s, bits, device="cpu", seed=0):
    """The image rows x[:, :, t_len:] (a strided view) of a joint bf16
    [B, H, t_len + S, 128] buffer: random rows, but for rows 0 and S // 2
    (zeros) and rows 1 and S // 2 + 1, whose amax is qmax / 8 so that the
    scale is 1 / 8 exactly and the other values, (k + 0.5) / 8, fall on
    ties of x / scale."""
    gen = torch.Generator().manual_seed(seed)
    joint = 3.0 * torch.randn((b, h, t_len + s, HEAD_DIM), generator=gen)
    x = joint[:, :, t_len:]
    qmax = QMAX[bits]
    k = torch.arange(HEAD_DIM) % qmax
    ties = (k + 0.5) / 8 * (1 - 2 * (torch.arange(HEAD_DIM) % 2))
    ties[0] = qmax / 8
    for row in (0, s // 2):
        x[:, :, row] = 0.0
    for row in (1, s // 2 + 1):
        x[:, :, row] = ties
    return joint.to(device, torch.bfloat16)[:, :, t_len:]


def stacked_cache(b, h, s, bits, layers=3, device="cpu"):
    """A cache leaf of `layers` layers and its scale leaf, filled with
    values no write produces (so an untouched layer shows)."""
    rows = torch.full((layers, b, h, s // 2 if bits == 4 else s, HEAD_DIM),
                      99, dtype=torch.int8, device=device)
    scales = torch.full((layers, b, h, s), -1.0, device=device)
    return rows, scales


def eager(x, bits):
    return (quant.quantize_kv_heads4 if bits == 4
            else quant.quantize_kv_heads)(x)


def assert_written(rows, scales, i, want):
    assert torch.equal(rows[i], want[0])
    assert torch.equal(scales[i], want[1])
    others = [j for j in range(rows.shape[0]) if j != i]
    assert bool((rows[others] == 99).all())
    assert bool((scales[others] == -1.0).all())


def assert_ties(x, scales):
    """The tie rows do put x / scale on .5 (the scales as written)."""
    r = x.float() / scales[..., None]
    assert bool(((r - r.floor()) == 0.5).any())


@pytest.mark.parametrize("b,h", [(1, 2), (2, 2), (1, 6), (2, 6)])
@pytest.mark.parametrize("bits", [8, 4])
def test_plain_path_is_the_quantizer_then_copy(bits, b, h):
    s, t_len, i = 10, 3, 1
    x = image_rows(b, h, t_len, s, bits, seed=b * 10 + h)
    assert not x.is_contiguous()
    rows, scales = stacked_cache(b, h, s, bits)
    quant.store_quantized(x, rows[i], scales[i], bits=bits)
    want = eager(x, bits)
    assert_written(rows, scales, i, want)
    assert_ties(x, want[1])
    assert bool((want[1][:, :, 0] == kv_cache.EMPTY_SCALE).all())
    assert not want[0][:, :, 0].any()


@pytest.mark.parametrize("path", ["plain", "kernel"])
def test_odd_rows_raise_for_int4(request, path):
    lib = request.getfixturevalue("fake_lib") if path == "kernel" else None
    x = torch.zeros(1, 2, 5, HEAD_DIM, dtype=torch.bfloat16)
    rows = torch.zeros(1, 2, 2, HEAD_DIM, dtype=torch.int8)
    with pytest.raises(ValueError, match="even row count"):
        quant.store_quantized(x, rows, torch.zeros(1, 2, 5), bits=4)
    if lib is not None:
        assert lib.calls == []


def test_a_cpu_call_counts_no_launch():
    quant.store_quantized.launches = 0
    for bits in (8, 4):
        x = image_rows(2, 2, 3, 6, bits)
        rows, scales = stacked_cache(2, 2, 6, bits)
        quant.store_quantized(x, rows[0], scales[0], bits=bits)
    assert quant.store_quantized.launches == 0


@pytest.mark.parametrize("bits", [8, 4])
def test_kernel_path_hands_the_views_to_the_entry(fake_lib, bits):
    """Rehearsed at the launch seam: one call of the C entry with the
    view's and the cache layer's pointers and element strides, B, H, S and
    the bits, on the current stream; one launch counted.  An empty batch
    neither launches nor counts."""
    quant.store_quantized.launches = 0
    x = image_rows(2, 6, 3, 8, bits)
    rows, scales = stacked_cache(2, 6, 8, bits)
    quant.store_quantized(x, rows[1], scales[1], bits=bits)
    ((name, args),) = fake_lib.calls
    assert name == ENTRY
    assert args[:3] == (x.data_ptr(), rows[1].data_ptr(),
                        scales[1].data_ptr())
    assert list(args[3]) == [*x.stride()[:3], *rows[1].stride()[:3],
                             *scales[1].stride()[:2]]
    assert args[4:] == (2, 6, 8, bits, 0)
    assert quant.store_quantized.launches == 1
    empty = torch.zeros(2, 6, 0, HEAD_DIM, dtype=torch.bfloat16)
    quant.store_quantized(empty, rows[1, :, :, :0], scales[1, :, :, :0],
                          bits=bits)
    assert len(fake_lib.calls) == 1
    assert quant.store_quantized.launches == 1


def _refused(bits):
    x = image_rows(1, 2, 3, 8, bits)
    rows, scales = stacked_cache(1, 2, 8, bits)
    r, sc = rows[0], scales[0]
    half = 4 if bits == 4 else 8
    return {
        "bits": (ValueError, lambda: quant.store_quantized(x, r, sc, 6)),
        "x dtype": (TypeError, lambda: quant.store_quantized(
            x.float(), r, sc, bits)),
        "head_dim": (ValueError, lambda: quant.store_quantized(
            x[..., :64], r[..., :64], sc, bits)),
        "rows dtype": (TypeError, lambda: quant.store_quantized(
            x, r.to(torch.uint8), sc, bits)),
        "rows count": (ValueError, lambda: quant.store_quantized(
            x, torch.zeros(1, 2, 12 - half, HEAD_DIM, dtype=torch.int8),
            sc, bits)),
        "scales dtype": (TypeError, lambda: quant.store_quantized(
            x, r, sc.to(torch.bfloat16), bits)),
        "scales shape": (ValueError, lambda: quant.store_quantized(
            x, r, sc[:, :, :7], bits)),
        "scales strided": (ValueError, lambda: quant.store_quantized(
            x, r, torch.zeros(1, 2, 16)[..., ::2], bits)),
    }


@pytest.mark.parametrize("case", list(_refused(8)))
@pytest.mark.parametrize("bits", [8, 4])
def test_refused_arguments_raise_before_any_launch(fake_lib, bits, case):
    quant.store_quantized.launches = 0
    err, call = _refused(bits)[case]
    with pytest.raises(err):
        call()
    assert fake_lib.calls == []
    assert quant.store_quantized.launches == 0


def test_entry_binds_as_many_arguments_as_it_declares():
    src = (_build.CSRC / "kv_quant.cu").read_text()
    (params,) = re.findall(rf'extern "C" int {ENTRY}\(([^)]*)\)', src)
    assert len(_build._SIGNATURES[ENTRY]) == len(params.split(","))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA kernel has no CPU mode")
    return torch.device("cuda")


# (B, H, text rows before the image rows, image rows S, bits): Qwen's write
# forward (int8 and int4), a FLUX single block's image rows, a Qwen tp 4
# rank's 6 heads, and ragged row counts off the kernel's 64-row blocks
CARD_SHAPES = [(2, 24, 1392, 8192, 8), (2, 24, 1392, 8192, 4),
               (1, 24, 512, 8192, 8), (2, 6, 1392, 8192, 8),
               (1, 2, 5, 37, 8), (3, 2, 5, 38, 4)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,t_len,s,bits", CARD_SHAPES)
def test_kernel_is_bit_equal_to_the_eager_quantizer_on_the_card(
        cuda_device, b, h, t_len, s, bits):
    x = image_rows(b, h, t_len, s, bits, device=cuda_device, seed=s + h)
    rows, scales = stacked_cache(b, h, s, bits, layers=2,
                                 device=cuda_device)
    before = quant.store_quantized.launches
    quant.store_quantized(x, rows[1], scales[1], bits=bits)
    assert quant.store_quantized.launches == before + 1
    want = eager(x, bits)
    torch.cuda.synchronize()
    assert_written(rows, scales, 1, want)
    assert_ties(x, want[1])


@pytest.mark.cuda
def test_the_card_divides_by_a_python_float_as_by_its_reciprocal(
        cuda_device):
    """What K10 reproduces: on the card, `amax / 127.0` (a Python float)
    is a multiply by the fp32 reciprocal, which differs from an IEEE
    division for some values."""
    gen = torch.Generator().manual_seed(0)
    a = torch.rand(1 << 20, generator=gen).mul(40.0).to(cuda_device)
    for qmax in (127.0, 7.0):
        inv = torch.tensor(1.0 / qmax, dtype=torch.float32)
        assert torch.equal(a / qmax, a * inv.item())
        assert not torch.equal(a / qmax, a / torch.full_like(a, qmax))
